"""BLIP-1's CIR feature extractor, retrieval, pretraining, ITM scorer and
captioner (counterpart of ``sprc_tpu/models/blip1.py``; reference
lavis/models/blip_models/blip_cir_base.py, blip_retrieval.py,
blip_pretrain.py, blip_image_text_matching.py, blip_caption.py).

Each holds BLIP-1's timm ViT (:func:`~sprc_tpu_torch.models.vit.blip_vit_b_config`,
or the ViT-L/16 of the ``large`` YAMLs: kernel K2 on the card) and a
med-BERT (:class:`~sprc_tpu_torch.models.albef.MedEncoder`, cross-attention
on every layer, unfused fp32 as in the JAX package):

- :class:`BlipRetrieval` (``blip_retrieval``): the momentum-queue training
  forward (queue ITC with multi-positive targets by image id and
  distillation by ``alpha``, in-batch hard negatives, ITM over ``[ENC]``
  ids for 3B rows) and the two passes its evaluation runs (``unimodal``,
  ``itm_logits``); :func:`blip_retrieval_train_step` threads the momentum
  state of :mod:`sprc_tpu_torch.models.albef`;
- :class:`BlipPretrain` (``blip_pretrain``): those losses plus the
  captioning loss of a causal med decoder (``text_decoder.bert`` /
  ``text_decoder.cls``) with label smoothing 0.1; the tower runs once a
  step and both heads read its rows (JAX calls it twice and XLA merges the
  calls); :func:`blip_pretrain_train_step`;
- :class:`BlipITM` (``blip_image_text_matching``): ``itm``, ``itc``,
  ``itm_gradcam`` and ``itm_embeds``;
- :class:`BlipCaption` (``blip_caption``): ``decode_logits``, the
  captioning loss (the prompt's ``prompt_length`` positions masked) and
  ``generate_ids``, the greedy decode from the ``[DEC]``-prefixed prompt;
- :class:`BlipCirBase` (``blip_cir_base``, ``blip_feature_extractor``): the
  tower's CLS projection and the prompt-conditioned feature of a med-BERT in
  text mode with the prompts prepended, the Q-Former's no-image pass
  (:class:`~sprc_tpu_torch.models.qformer.QFormer` without its image side:
  kernel K3 on the card).

The retrieval models and the captioner train their tower (no
``FROZEN_PREFIXES``): with a graph it runs through kernel K2's
``FusedViTBlock`` on the card; the ITM scorer, the caption decode and the
feature extractor run it without one. Module names are LAVIS's
(``visual_encoder.blocks.{i}.attn.qkv``,
``text_encoder.encoder.layer.{i}.crossattention.self.key``,
``text_decoder.bert.embeddings.word_embeddings``,
``text_decoder.cls.predictions.decoder``, ``itm_head``, ``temp``), so a
released checkpoint loads through ``loader.read_checkpoint`` with
``strict=True``; a LAVIS ``blip_cir_base`` file also holds med's
cross-attention, which the text-mode forward never reads and the loader
drops, as the JAX reader skips it. Ranked VQA is
:mod:`sprc_tpu_torch.models.vqa`'s.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from sprc_tpu_torch.models.albef import (MedEncoder, MedTowers, MedWithHead, _QueueModel,
                                         itm_loss, queue_step, tower_rows)
from sprc_tpu_torch.models.generation import stage
from sprc_tpu_torch.models.qformer import QFormer, QFormerConfig
from sprc_tpu_torch.models.vit import ViTConfig, blip_vit_b_config, build_tower
from sprc_tpu_torch.ops.layers import Linear, l2_normalize
from sprc_tpu_torch.registry import registry

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Blip1Config:
    image_size: int = 224
    embed_dim: int = 256
    max_txt_len: int = 40
    vocab_size: int = 30523  # bert-base-uncased + [DEC]
    num_prompts: int = 32
    vit_dtype: torch.dtype = torch.bfloat16
    text_dtype: torch.dtype = torch.float32
    vit_config_override: Optional[ViTConfig] = None
    text_config_override: Optional[QFormerConfig] = None

    def vit_config(self) -> ViTConfig:
        return self.vit_config_override or blip_vit_b_config(self.image_size, dtype=self.vit_dtype)

    def text_config(self) -> QFormerConfig:
        # med-BERT = bert-base in text mode: no cross-attention or query FFN
        return self.text_config_override or QFormerConfig(
            vocab_size=self.vocab_size, encoder_width=self.vit_config().width,
            cross_attention_freq=1, query_length=self.num_prompts, dtype=self.text_dtype)


@registry.register_model("blip_cir_base")
@registry.register_model("blip_feature_extractor")
class BlipCirBase(torch.nn.Module):
    """BLIP-1's CIR feature extractor (reference blip_cir_base.py:20-141):
    the timm ViT-B/16's CLS projection and the prompt-conditioned text
    feature of a med-BERT in text mode."""

    CONFIG = Blip1Config

    def __init__(self, cfg: Blip1Config):
        super().__init__()
        self.cfg = cfg
        tcfg = cfg.text_config()
        self.visual_encoder = build_tower(cfg.vit_config())
        self.text_encoder = QFormer(tcfg, image=False)
        self.vision_proj = Linear(cfg.vit_config().width, cfg.embed_dim, dtype=tcfg.dtype)
        self.text_proj = Linear(tcfg.hidden_size, cfg.embed_dim, dtype=tcfg.dtype)
        self.temp = torch.nn.Parameter(torch.empty(()))

    def forward(self, target_images: Tensor, input_ids: Tensor, text_mask: Tensor,
                prompts: Tensor):
        """``extract_cir_features`` (:58-88): (text_feat [B, E], image_feat [B, E])."""
        return (self.extract_cir_txt_feats(input_ids, text_mask, prompts),
                self.extract_target_features(target_images))

    def extract_target_features(self, images: Tensor) -> Tensor:
        """The L2-normalised CLS projection (:113-118); the tower without a graph."""
        return l2_normalize(self.vision_proj(tower_rows(self.visual_encoder, images)[:, 0, :]))

    def extract_cir_txt_feats(self, input_ids: Tensor, text_mask: Tensor,
                              prompts: Tensor) -> Tensor:
        """The L2-normalised projection of the first text position after the
        ``prompts`` [B, P, H] (:91-111): the prompts prepended without
        positions, the mask ones over them, every row through the text FFN."""
        P = prompts.shape[1]
        attn = torch.cat([torch.ones(prompts.shape[:2], dtype=text_mask.dtype,
                                     device=text_mask.device), text_mask], dim=1)
        hidden = self.text_encoder(input_ids=input_ids, query_embeds=prompts,
                                   attention_mask=attn)
        return l2_normalize(self.text_proj(hidden[:, P, :]))


@dataclasses.dataclass(frozen=True)
class BlipRetrievalConfig(MedTowers):
    image_size: int = 384
    embed_dim: int = 256
    max_txt_len: int = 35
    vocab_size: int = 30524  # bert-base + [DEC] + [ENC]
    queue_size: int = 57600
    momentum: float = 0.995
    alpha: float = 0.4
    temp_init: float = 0.07
    vit_dtype: torch.dtype = torch.bfloat16
    text_dtype: torch.dtype = torch.float32
    vit_config_override: Optional[ViTConfig] = None
    text_config_override: Optional[QFormerConfig] = None


@dataclasses.dataclass(frozen=True)
class BlipCaptionConfig(MedTowers):
    image_size: int = 384
    max_txt_len: int = 40
    vocab_size: int = 30524
    prompt_length: int = 4  # tokens of "a picture of " minus the final [SEP]
    vit_dtype: torch.dtype = torch.bfloat16
    text_dtype: torch.dtype = torch.float32
    vit_config_override: Optional[ViTConfig] = None
    text_config_override: Optional[QFormerConfig] = None


@registry.register_model("blip_retrieval")
class BlipRetrieval(_QueueModel):
    """BLIP-1 retrieval (reference blip_retrieval.py:47-330): ALBEF's
    momentum-distilled queue ITC and hard-negative ITM, with cross-attention
    on every med layer and the ITM pass over ``[ENC]``-prefixed ids."""

    CONFIG = BlipRetrievalConfig

    def __init__(self, cfg: BlipRetrievalConfig):
        super().__init__()
        self.cfg = cfg
        tcfg = cfg.text_config()
        # BLIP med: cross-attention on every layer; mode "text" spans them all
        self._build(cfg, MedEncoder(tcfg, fusion_layer=tcfg.num_layers, cross_from=0))

    def itm_logits(self, enc_input_ids: Tensor, text_mask: Tensor,
                   image_embeds: Tensor) -> Tensor:
        """The multimodal pass over ``[ENC]``-prefixed ids -> itm head on CLS [B, 2]."""
        hidden = self.text_encoder(input_ids=enc_input_ids, attention_mask=text_mask,
                                   image_embeds=image_embeds, mode="multimodal")
        return self.itm_head(hidden[:, 0, :])

    def retrieval_losses(self, rows, text_mask, enc_input_ids, image_ids, image_feat_m,
                         text_feat_m, image_queue, text_queue, idx_queue, alpha, generator=None,
                         negatives=None) -> Dict[str, Tensor]:
        image_embeds, image_feat, _, text_feat = rows
        bs = image_embeds.shape[0]
        loss_itc, (neg_img, neg_txt) = self.queue_losses(
            image_feat, text_feat, image_ids, image_feat_m, text_feat_m, image_queue,
            text_queue, idx_queue, alpha, generator, negatives)
        logits = self.itm_logits(
            torch.cat([enc_input_ids, enc_input_ids, enc_input_ids[neg_txt]]),
            torch.cat([text_mask, text_mask, text_mask[neg_txt]]),
            torch.cat([image_embeds, image_embeds[neg_img], image_embeds]))
        return {"loss_itc": loss_itc, "loss_itm": itm_loss(logits, bs)}

    def forward(self, images, input_ids, text_mask, enc_input_ids, image_ids, image_feat_m,
                text_feat_m, image_queue, text_queue, idx_queue, alpha, *, generator=None,
                negatives=None) -> Dict[str, Tensor]:
        """``{loss_itc, loss_itm}``. ``negatives``: ``(neg_img, neg_txt)``
        [B] each, else drawn from ``generator``."""
        return self.retrieval_losses(self.unimodal(images, input_ids, text_mask), text_mask,
                                     enc_input_ids, image_ids, image_feat_m, text_feat_m,
                                     image_queue, text_queue, idx_queue, alpha, generator,
                                     negatives)


@registry.register_model("blip_pretrain")
class BlipPretrain(BlipRetrieval):
    """BLIP-1 pretraining (reference blip_pretrain.py:114-345): the
    retrieval losses (their idx-based targets are the reference's diagonal
    as long as ``image_ids`` are globally unique, which the JAX collate
    does not make them) plus the smoothed next-token loss of a causal med
    decoder over ``[DEC]``-prefixed captions (:317-333)."""

    def __init__(self, cfg: BlipRetrievalConfig):
        super().__init__(cfg)
        tcfg = cfg.text_config()
        self.text_decoder = MedWithHead(tcfg, fusion_layer=tcfg.num_layers, cross_from=0)

    def lm_loss(self, image_embeds: Tensor, dec_input_ids: Tensor, text_mask: Tensor, *,
                pad_token_id: int = 0) -> Tensor:
        hidden = self.text_decoder.bert(input_ids=dec_input_ids, attention_mask=text_mask,
                                        image_embeds=image_embeds, mode="multimodal",
                                        is_decoder=True)
        logits = self.text_decoder.cls(hidden)
        labels = torch.where(dec_input_ids == pad_token_id, -100, dec_input_ids)
        logp = torch.log_softmax(logits[:, :-1, :].float(), dim=-1)
        shifted = labels[:, 1:]
        valid = shifted != -100
        nll = -logp.gather(-1, torch.where(valid, shifted, 0).long()[..., None])[..., 0]
        per_tok = 0.9 * nll + 0.1 * (-logp.mean(dim=-1))  # med.py:1246 label smoothing
        return (per_tok * valid).sum() / valid.sum().clamp_min(1)

    def forward(self, images, input_ids, text_mask, enc_input_ids, dec_input_ids, image_ids,
                image_feat_m, text_feat_m, image_queue, text_queue, idx_queue, alpha, *,
                pad_token_id: int = 0, generator=None, negatives=None) -> Dict[str, Tensor]:
        rows = self.unimodal(images, input_ids, text_mask)
        losses = self.retrieval_losses(rows, text_mask, enc_input_ids, image_ids, image_feat_m,
                                       text_feat_m, image_queue, text_queue, idx_queue, alpha,
                                       generator, negatives)
        losses["loss_lm"] = self.lm_loss(rows[0], dec_input_ids, text_mask,
                                         pad_token_id=pad_token_id)
        losses["loss"] = losses["loss_itc"] + losses["loss_itm"] + losses["loss_lm"]
        return losses


def blip_retrieval_train_step(model, params, state, batch, **kw):
    return queue_step(model, params, state, batch, ("images", "input_ids", "text_mask",
                                                    "enc_input_ids", "image_ids"), **kw)


def blip_pretrain_train_step(model, params, state, batch, **kw):
    """``batch['image_ids']`` should be globally unique (the diagonal ITC)."""
    return queue_step(model, params, state, batch, ("images", "input_ids", "text_mask",
                                                    "enc_input_ids", "dec_input_ids",
                                                    "image_ids"), **kw)


@registry.register_model("blip_image_text_matching")
class BlipITM(BlipRetrieval):
    """BLIP-1's ITM / ITC scorer (reference blip_image_text_matching.py)."""

    MOMENTUM_LAYOUT = False  # LAVIS's ITM checkpoints hold no momentum state

    def itm(self, images: Tensor, enc_input_ids: Tensor, text_mask: Tensor) -> Tensor:
        return self.itm_logits(enc_input_ids, text_mask, self.encode_image(images))

    def itc(self, images: Tensor, input_ids: Tensor, text_mask: Tensor) -> Tensor:
        _, image_feat, _, text_feat = self.unimodal(images, input_ids, text_mask,
                                                    self.encode_image(images))
        return (image_feat * text_feat).sum(dim=-1) / self.temp.clamp(0.001, 0.5)

    def itm_gradcam(self, images: Optional[Tensor], enc_input_ids: Tensor, text_mask: Tensor,
                    probe: Tensor, block_num: int, image_embeds: Optional[Tensor] = None):
        """(the ITM match logits' sum, the cross-attention probabilities at
        ``block_num`` with the zero-valued ``probe`` [B, heads, L, S] added):
        the gradient of the first with respect to the probe is GradCAM's
        (reference compute_gradcam :151-199). The tower runs without a graph,
        or not at all where its rows are given (``image_embeds``)."""
        if image_embeds is None:
            image_embeds = self.encode_image(images)
        hidden, probs = self.text_encoder(
            input_ids=enc_input_ids, attention_mask=text_mask, image_embeds=image_embeds,
            mode="multimodal", gradcam_layer=block_num, gradcam_probe=probe)
        logits = self.itm_head(hidden[:, 0, :])
        return logits[:, 1].sum(), probs

    def itm_embeds(self, enc_input_ids: Tensor, text_mask: Tensor,
                   image_embeds: Tensor) -> Tensor:
        """The match probability [B] for given image rows (Img2Prompt's
        caption filter)."""
        return torch.softmax(self.itm_logits(enc_input_ids, text_mask, image_embeds), dim=-1)[:, 1]


class MedLMHeadModel(MedWithHead):
    """``BertLMHeadModel``'s names over a med-BERT with cross-attention on
    every layer."""

    def __init__(self, cfg: QFormerConfig):
        super().__init__(cfg, fusion_layer=cfg.num_layers, cross_from=0)


@registry.register_model("blip_caption")
class BlipCaption(torch.nn.Module):
    """BLIP-1's captioner (reference blip_caption.py:40-135): the tower, a
    causal med decoder cross-attending the image on every layer, and the
    BERT LM head."""

    CONFIG = BlipCaptionConfig

    def __init__(self, cfg: BlipCaptionConfig):
        super().__init__()
        self.cfg = cfg
        self.visual_encoder = build_tower(cfg.vit_config())
        self.text_decoder = MedLMHeadModel(cfg.text_config())

    def encode_image(self, images: Tensor) -> Tensor:
        return tower_rows(self.visual_encoder, images)

    def decode_logits(self, input_ids: Tensor, text_mask: Tensor, image_embeds: Tensor,
                      generator: Optional[torch.Generator] = None) -> Tensor:
        """[B, L] ids over image rows [B, S, W] -> logits [B, L, vocab]."""
        hidden = self.text_decoder.bert(input_ids=input_ids, attention_mask=text_mask,
                                        image_embeds=image_embeds, mode="multimodal",
                                        is_decoder=True, generator=generator)
        return self.text_decoder.cls(hidden)

    def forward(self, images: Tensor, input_ids: Tensor, text_mask: Tensor, *,
                pad_token_id: int = 0,
                generator: Optional[torch.Generator] = None) -> Dict[str, Tensor]:
        """The captioning loss over bos-prefixed caption ids: next-token CE
        with label smoothing 0.1 (med.py:1246), pads and the first
        ``prompt_length`` positions masked. The tower records a graph where
        autograd records (it trains: JAX's captioner has no
        ``FROZEN_PREFIXES``)."""
        image_embeds = self.visual_encoder(images).float()
        logits = self.decode_logits(input_ids, text_mask, image_embeds, generator)
        labels = torch.where(input_ids == pad_token_id, -100, input_ids)
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)[None, :]
        labels = torch.where(pos < self.cfg.prompt_length, -100, labels)
        logp = torch.log_softmax(logits[:, :-1, :].float(), dim=-1)
        shifted = labels[:, 1:]
        valid = shifted != -100
        nll = -logp.gather(-1, torch.where(valid, shifted, 0)[..., None])[..., 0]
        per_tok = 0.9 * nll + 0.1 * (-logp.mean(dim=-1))
        loss = (per_tok * valid).sum() / valid.sum().clamp_min(1)
        return {"loss": loss, "loss_lm": loss}

    @torch.no_grad()
    def generate_ids(self, images: Optional[Tensor], prompt_ids: Tensor, *, eos_token_id: int,
                     pad_token_id: int = 0, max_new_tokens: int = 30,
                     image_embeds: Optional[Tensor] = None,
                     stats: Optional[Dict[str, float]] = None) -> Tensor:
        """Greedy caption decode from the prompt prefix [B, L] (reference
        blip_caption.py:175-220; ``sprc_tpu/models/blip1.py:515``) -> the
        generated ids [B, max_new_tokens] (int64), pads after ``[SEP]``.

        As the JAX function: the tower runs once (or its rows are given,
        ``image_embeds``), then every step recomputes the decoder over the
        whole buffer of ``L + max_new_tokens`` positions (the mask zero past
        each row's length), takes the argmax at each row's last position,
        writes it there, and stops when every row has emitted ``eos``; a
        finished row gets ``pad_token_id``. ``stats`` collects the seconds
        of ``tower`` and ``decode`` and the ``steps`` taken."""
        B, L = prompt_ids.shape
        device = prompt_ids.device
        with stage(stats, "tower", device):
            if image_embeds is None:
                image_embeds = self.encode_image(images)
        total = L + max_new_tokens
        ids = torch.full((B, total), pad_token_id, dtype=torch.long, device=device)
        ids[:, :L] = prompt_ids
        mask = torch.zeros((B, total), dtype=torch.long, device=device)
        mask[:, :L] = 1
        lengths = torch.full((B,), L, dtype=torch.long, device=device)
        finished = torch.zeros(B, dtype=torch.bool, device=device)
        rows = torch.arange(B, device=device)
        steps = 0
        with stage(stats, "decode", device):
            for _ in range(max_new_tokens):
                logits = self.decode_logits(ids, mask, image_embeds)
                nxt = logits[rows, lengths - 1].float().argmax(-1)
                nxt = torch.where(finished, pad_token_id, nxt)
                ids[rows, lengths] = nxt
                mask[rows, lengths] = (~finished).long()
                lengths = lengths + (~finished).long()
                finished = finished | (nxt == eos_token_id)
                steps += 1
                if bool(finished.all()):
                    break
        if stats is not None:
            stats["steps"] = stats.get("steps", 0) + steps
        return ids[:, L:]
