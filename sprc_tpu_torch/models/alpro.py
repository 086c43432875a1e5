"""The ALPRO video-text models (counterpart of ``sprc_tpu/models/alpro.py``;
reference lavis/models/alpro_models/alpro_retrieval.py:29-241,
alpro_qa.py:25-141).

Both hold a TimeSformer video tower (:mod:`.timesformer`, ``visual_encoder``)
and a 12-layer med-BERT (:class:`~sprc_tpu_torch.models.albef.MedEncoder`,
``text_encoder``) whose first ``fusion_layer`` layers are text-only and whose
others self-attend over the concatenation ``[text rows; video rows]`` under
a padding mask: ALPRO's BERT has no cross-attention
(bert_config_alpro.json), so the encoder is built with ``cross_from`` past
its last layer and holds no cross-attention weights, as the JAX tree holds
none. The fusion passes are masked, so they take the plain einsum path in
both packages; the tower's spatial attention launches kernel K8 on the card.

- :class:`AlproRetrieval` (``alpro_retrieval``): the in-batch VTC loss and
  the hard-negative VTM loss (:meth:`AlproRetrieval.forward`); the negatives
  are drawn by :func:`~sprc_tpu_torch.models.albef.sample_negatives` from
  the caller's generator (``torch.multinomial`` where JAX draws
  ``jax.random.categorical``), the videos' first as JAX splits its key, or
  taken as the argmax without one (JAX without a ``sample`` rng), or handed
  in. The evaluation's helpers :meth:`~AlproRetrieval.video_feats`,
  :meth:`~AlproRetrieval.text_feats`, :meth:`~AlproRetrieval.vtm_score`.
- :class:`AlproQA` (``alpro_qa``): LAVIS's ``classifier`` (``Linear(H, 2H)``,
  ReLU, ``Linear(2H, num_classes)``) over the fusion CLS
  (:meth:`AlproQA.predict`); its loss leaves out the targets below 0 (the
  answers outside the vocabulary), so that a batch keeps its shape.
- :class:`TimeSformerModel` (``timesformer``): the tower alone under
  ``model``, as LAVIS's wrapper holds it.

The med-BERT's hidden dropout is drawn from the caller's generator in
training mode (the JAX steps apply these models with a dropout rng); the
tower's ``dropout_rate`` is 0.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from sprc_tpu_torch.models.albef import MedEncoder, sample_negatives
from sprc_tpu_torch.models.generation import stage
from sprc_tpu_torch.models.qformer import QFormerConfig
from sprc_tpu_torch.models.timesformer import TimeSformer, TimeSformerConfig
from sprc_tpu_torch.ops.layers import Linear, l2_normalize
from sprc_tpu_torch.registry import registry

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class AlproConfig:
    image_size: int = 224
    num_frames: int = 8
    embed_dim: int = 256
    max_txt_len: int = 35
    temp_init: float = 0.07
    vocab_size: int = 30522
    fusion_layer: int = 6  # bert_config_alpro.json
    num_classes: int = 0  # the QA answer vocabulary (msrvtt: 1500, msvd: 2423)
    vit_dtype: torch.dtype = torch.float32
    text_dtype: torch.dtype = torch.float32
    video_config_override: Optional[TimeSformerConfig] = None
    text_config_override: Optional[QFormerConfig] = None

    def video_config(self) -> TimeSformerConfig:
        return self.video_config_override or TimeSformerConfig(
            image_size=self.image_size, num_frames=self.num_frames, dtype=self.vit_dtype)

    def text_config(self) -> QFormerConfig:
        return self.text_config_override or QFormerConfig(
            vocab_size=self.vocab_size, encoder_width=self.video_config().width,
            dtype=self.text_dtype)


class _AlproBase(nn.Module):
    CONFIG = AlproConfig
    # its LAVIS checkpoints: the trunk under visual_encoder.model., BERT's
    # token-type table (loader.read_checkpoint)
    ALPRO_LAYOUT = True

    def _towers(self, cfg: AlproConfig) -> None:
        tcfg = cfg.text_config()
        self.visual_encoder = TimeSformer(cfg.video_config())
        self.text_encoder = MedEncoder(tcfg, cfg.fusion_layer, cross_from=tcfg.num_layers)

    def encode_video(self, video: Tensor, generator: Optional[torch.Generator] = None) -> Tensor:
        """[B, T, H, W, 3] -> the pooled video rows [B, 1 + N, C] fp32."""
        return self.visual_encoder(video, generator)

    def encode_text(self, input_ids: Tensor, text_mask: Tensor,
                    generator: Optional[torch.Generator] = None) -> Tensor:
        """The text-only layers ``[0, fusion_layer)``."""
        return self.text_encoder(input_ids=input_ids, attention_mask=text_mask, mode="text",
                                 generator=generator)

    def fuse(self, text_embeds: Tensor, text_mask: Tensor, video_embeds: Tensor,
             generator: Optional[torch.Generator] = None) -> Tensor:
        """The fusion layers over ``[text; video]`` -> hidden [B, St + Sv, H]
        (reference alpro_retrieval.py:155-168, mode 'fusion')."""
        emb = torch.cat([text_embeds, video_embeds.to(text_embeds.dtype)], dim=1)
        ones = torch.ones(video_embeds.shape[:2], dtype=text_mask.dtype,
                          device=text_mask.device)
        return self.text_encoder(inputs_embeds=emb, attention_mask=torch.cat([text_mask, ones], 1),
                                 mode="fusion", generator=generator)


@registry.register_model("alpro_retrieval")
class AlproRetrieval(_AlproBase):
    """Video-text retrieval: the towers, ``vision_proj``, ``text_proj``,
    ``itm_head`` and ``temp``."""

    def __init__(self, cfg: AlproConfig):
        super().__init__()
        self.cfg = cfg
        self._towers(cfg)
        tcfg = cfg.text_config()
        self.vision_proj = Linear(cfg.video_config().width, cfg.embed_dim, dtype=tcfg.dtype)
        self.text_proj = Linear(tcfg.hidden_size, cfg.embed_dim, dtype=tcfg.dtype)
        self.itm_head = Linear(tcfg.hidden_size, 2, dtype=tcfg.dtype)
        self.temp = nn.Parameter(torch.empty(()))

    def video_feats(self, video: Tensor,
                    generator: Optional[torch.Generator] = None) -> Tuple[Tensor, Tensor]:
        """(video rows, their normalised projection [B, E])."""
        emb = self.encode_video(video, generator)
        return emb, l2_normalize(self.vision_proj(emb[:, 0, :]))

    def text_feats(self, input_ids: Tensor, text_mask: Tensor,
                   generator: Optional[torch.Generator] = None) -> Tuple[Tensor, Tensor]:
        emb = self.encode_text(input_ids, text_mask, generator)
        return emb, l2_normalize(self.text_proj(emb[:, 0, :]))

    def vtm_score(self, text_embeds: Tensor, text_mask: Tensor, video_embeds: Tensor,
                  generator: Optional[torch.Generator] = None) -> Tensor:
        """The match logit [B] (the rescoring of compute_sim_matrix)."""
        cls = self.fuse(text_embeds, text_mask, video_embeds, generator)[:, 0, :]
        return self.itm_head(cls)[:, 1]

    def forward(self, video: Tensor, input_ids: Tensor, text_mask: Tensor, *,
                generator: Optional[torch.Generator] = None,
                negatives: Optional[Tuple[Tensor, Tensor]] = None) -> Dict[str, Tensor]:
        """``{loss, loss_vtc, loss_vtm}`` (alpro_retrieval.py:66-240).
        ``negatives``: ``(neg_vid, neg_txt)`` [B] each, else drawn."""
        bs = video.shape[0]
        temp = self.temp.clamp(0.001, 0.5)
        video_embeds, video_feat = self.video_feats(video, generator)
        text_embeds, text_feat = self.text_feats(input_ids, text_mask, generator)
        # in-batch VTC: the identity targets
        sim_v2t = video_feat @ text_feat.t() / temp
        sim_t2v = text_feat @ video_feat.t() / temp
        loss_vtc = (-torch.log_softmax(sim_v2t, dim=-1).diagonal().mean()
                    - torch.log_softmax(sim_t2v, dim=-1).diagonal().mean()) / 2
        # hard-negative VTM (:152-240)
        if negatives is None:
            with torch.no_grad():
                eye = torch.eye(bs, dtype=torch.bool, device=video.device)
                w_v2t = torch.softmax(sim_v2t.masked_fill(eye, -1e9), dim=1)
                w_t2v = torch.softmax(sim_t2v.masked_fill(eye, -1e9), dim=1)
                negatives = (sample_negatives(w_t2v, generator),
                             sample_negatives(w_v2t, generator))
        neg_vid, neg_txt = negatives
        pos = self.fuse(text_embeds, text_mask, video_embeds, generator)[:, 0, :]
        neg = self.fuse(torch.cat([text_embeds, text_embeds[neg_txt]]),
                        torch.cat([text_mask, text_mask[neg_txt]]),
                        torch.cat([video_embeds[neg_vid], video_embeds]), generator)[:, 0, :]
        logits = self.itm_head(torch.cat([pos, neg])).float()
        labels = torch.cat([torch.ones(bs, dtype=torch.int64, device=logits.device),
                            torch.zeros(2 * bs, dtype=torch.int64, device=logits.device)])
        loss_vtm = -torch.log_softmax(logits, dim=-1).gather(-1, labels[:, None]).mean()
        return {"loss": loss_vtc + loss_vtm, "loss_vtc": loss_vtc, "loss_vtm": loss_vtm}


@registry.register_model("alpro_qa")
class AlproQA(_AlproBase):
    """Video QA as classification over the answer vocabulary."""

    def __init__(self, cfg: AlproConfig):
        super().__init__()
        if cfg.num_classes <= 0:
            raise ValueError("AlproQA needs num_classes > 0 (its model YAMLs: msrvtt 1500, "
                             "msvd 2423)")
        self.cfg = cfg
        self._towers(cfg)
        H = cfg.text_config().hidden_size
        dtype = cfg.text_config().dtype
        self.classifier = nn.Sequential(Linear(H, 2 * H, dtype=dtype), nn.ReLU(),
                                        Linear(2 * H, cfg.num_classes, dtype=dtype))

    def predict(self, video: Tensor, input_ids: Tensor, text_mask: Tensor, *,
                generator: Optional[torch.Generator] = None,
                stats: Optional[Dict[str, float]] = None) -> Tensor:
        """The answer logits [B, num_classes] (alpro_qa.py:54-105): the text
        pass, the tower, the fusion CLS, the classifier. ``stats``: seconds
        by stage (``text_s``, ``tower_s``, ``fusion_s``), added to."""
        with stage(stats, "text_s", video.device):
            text_embeds = self.encode_text(input_ids, text_mask, generator)
        with stage(stats, "tower_s", video.device):
            video_embeds = self.encode_video(video, generator)
        with stage(stats, "fusion_s", video.device):
            logits = self.classifier(
                self.fuse(text_embeds, text_mask, video_embeds, generator)[:, 0, :])
        return logits

    def forward(self, video: Tensor, input_ids: Tensor, text_mask: Tensor, targets: Tensor, *,
                generator: Optional[torch.Generator] = None) -> Dict[str, Tensor]:
        """``{loss, logits}``: the mean cross-entropy over the targets >= 0."""
        logits = self.predict(video, input_ids, text_mask, generator=generator)
        valid = targets >= 0
        nll = -torch.log_softmax(logits.float(), dim=-1).gather(
            -1, torch.where(valid, targets, 0).long()[:, None])[:, 0]
        loss = (nll * valid).sum() / valid.sum().clamp_min(1)
        return {"loss": loss, "logits": logits}


@registry.register_model("timesformer")
class TimeSformerModel(nn.Module):
    """The TimeSformer alone (a feature extractor), its trunk under ``model``."""

    CONFIG = AlproConfig

    def __init__(self, cfg: AlproConfig):
        super().__init__()
        self.cfg = cfg
        self.model = TimeSformer(cfg.video_config())

    def forward(self, video: Tensor, generator: Optional[torch.Generator] = None) -> Tensor:
        return self.model(video, generator)
