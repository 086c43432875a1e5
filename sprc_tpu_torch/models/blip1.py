"""BLIP-1's ITM scorer and captioner (counterpart of
``sprc_tpu/models/blip1.py:216-510``; reference
lavis/models/blip_models/blip_image_text_matching.py, blip_caption.py).

Both hold BLIP-1's timm ViT (:func:`~sprc_tpu_torch.models.vit.blip_vit_b_config`,
or the ViT-L/16 at 384 px of the ``large`` / ``large_coco`` YAMLs: 24 blocks
of width 1024 through kernel K2 on the card) and a med-BERT
(:class:`~sprc_tpu_torch.models.albef.MedEncoder`, cross-attention on every
layer, unfused fp32 as in the JAX package):

- :class:`BlipITM` (``blip_image_text_matching``): ``itm`` (the multimodal
  pass over ``[ENC]``-prefixed ids, ``itm_head`` on its CLS row), ``itc``
  (the cosine of the unimodal projections over the temperature),
  ``itm_gradcam`` (the match logits' sum and the cross-attention
  probabilities of one layer, with the GradCAM probe) and ``itm_embeds``
  (the match probability for given image rows);
- :class:`BlipCaption` (``blip_caption``): ``decode_logits`` (the causal
  multimodal pass and the BERT LM head) and the forward's next-token loss
  with label smoothing 0.1, pads and the prompt's ``prompt_length``
  positions masked.

The tower runs without a graph (``torch.no_grad()``): it is frozen on every
path of this slice, and on the card its blocks are the K2 wrapper, which
refuses autograd. Module names are LAVIS's (``visual_encoder.blocks.{i}.attn.
qkv``, ``text_encoder.encoder.layer.{i}.crossattention.self.key``,
``text_decoder.bert.embeddings.word_embeddings``,
``text_decoder.cls.predictions.decoder``, ``itm_head``, ``temp``), so a
released checkpoint loads through ``loader.read_checkpoint`` with
``strict=True`` (its tied ``cls.predictions.bias`` is the same tensor as
``cls.predictions.decoder.bias``, which this module holds). BLIP-1's
retrieval training (the momentum encoders and queues), pretraining,
``generate_ids`` and ranked VQA come with that family (ROADMAP A8.6):
:class:`BlipRetrieval` holds the modules and the two passes the ITM scorer
shares with it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch import nn

from sprc_tpu_torch.models.albef import MedEncoder
from sprc_tpu_torch.models.lm import QFormerLMHead
from sprc_tpu_torch.models.qformer import QFormerConfig
from sprc_tpu_torch.models.vit import ViTConfig, blip_vit_b_config, build_tower
from sprc_tpu_torch.ops.layers import Linear, l2_normalize
from sprc_tpu_torch.registry import registry

Tensor = torch.Tensor


class _Towers:
    """The two sub-configs of a BLIP-1 config: its override, else BLIP-1's
    ViT-B/16 and the med-BERT over its width."""

    def vit_config(self) -> ViTConfig:
        return self.vit_config_override or blip_vit_b_config(self.image_size, dtype=self.vit_dtype)

    def text_config(self) -> QFormerConfig:
        return self.text_config_override or QFormerConfig(
            vocab_size=self.vocab_size, encoder_width=self.vit_config().width,
            dtype=self.text_dtype)


@dataclasses.dataclass(frozen=True)
class BlipRetrievalConfig(_Towers):
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
class BlipCaptionConfig(_Towers):
    image_size: int = 384
    max_txt_len: int = 40
    vocab_size: int = 30524
    prompt_length: int = 4  # tokens of "a picture of " minus the final [SEP]
    vit_dtype: torch.dtype = torch.bfloat16
    text_dtype: torch.dtype = torch.float32
    vit_config_override: Optional[ViTConfig] = None
    text_config_override: Optional[QFormerConfig] = None


def _encode_image(tower: nn.Module, images: Tensor) -> Tensor:
    """NHWC images -> the tower's rows [B, S, W] in fp32, without a graph."""
    with torch.no_grad():
        return tower(images).float()


class BlipRetrieval(nn.Module):
    """BLIP-1 retrieval's modules (reference blip_retrieval.py:47-330) and
    its two eval passes; the training step comes with ROADMAP A8.6."""

    CONFIG = BlipRetrievalConfig

    def __init__(self, cfg: BlipRetrievalConfig):
        super().__init__()
        self.cfg = cfg
        tcfg = cfg.text_config()
        self.visual_encoder = build_tower(cfg.vit_config())
        # BLIP med: cross-attention on every layer; mode "text" spans them all
        self.text_encoder = MedEncoder(tcfg, fusion_layer=tcfg.num_layers, cross_from=0)
        width = cfg.vit_config().width
        self.vision_proj = Linear(width, cfg.embed_dim, dtype=tcfg.dtype)
        self.text_proj = Linear(tcfg.hidden_size, cfg.embed_dim, dtype=tcfg.dtype)
        self.itm_head = Linear(tcfg.hidden_size, 2, dtype=tcfg.dtype)
        self.temp = nn.Parameter(torch.empty(()))

    def encode_image(self, images: Tensor) -> Tensor:
        return _encode_image(self.visual_encoder, images)

    def unimodal(self, images: Tensor, input_ids: Tensor, text_mask: Tensor):
        """-> (image rows [B, S, W] fp32, image feature [B, E], text rows,
        text feature [B, E]); the features L2-normalised."""
        image_embeds = self.encode_image(images)
        image_feat = l2_normalize(self.vision_proj(image_embeds[:, 0, :]))
        text_embeds = self.text_encoder(input_ids=input_ids, attention_mask=text_mask,
                                        mode="text")
        text_feat = l2_normalize(self.text_proj(text_embeds[:, 0, :]))
        return image_embeds, image_feat, text_embeds, text_feat

    def itm_logits(self, enc_input_ids: Tensor, text_mask: Tensor,
                   image_embeds: Tensor) -> Tensor:
        """The multimodal pass over ``[ENC]``-prefixed ids -> itm head on CLS [B, 2]."""
        hidden = self.text_encoder(input_ids=enc_input_ids, attention_mask=text_mask,
                                   image_embeds=image_embeds, mode="multimodal")
        return self.itm_head(hidden[:, 0, :])


@registry.register_model("blip_image_text_matching")
class BlipITM(BlipRetrieval):
    """BLIP-1's ITM / ITC scorer (reference blip_image_text_matching.py)."""

    def itm(self, images: Tensor, enc_input_ids: Tensor, text_mask: Tensor) -> Tensor:
        return self.itm_logits(enc_input_ids, text_mask, self.encode_image(images))

    def itc(self, images: Tensor, input_ids: Tensor, text_mask: Tensor) -> Tensor:
        _, image_feat, _, text_feat = self.unimodal(images, input_ids, text_mask)
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


class MedLMHeadModel(nn.Module):
    """``BertLMHeadModel``'s names: the med-BERT under ``bert``, its LM head
    under ``cls`` (``cls.predictions.transform.dense``, ``...decoder``)."""

    def __init__(self, cfg: QFormerConfig):
        super().__init__()
        self.bert = MedEncoder(cfg, fusion_layer=cfg.num_layers, cross_from=0)
        self.cls = QFormerLMHead(cfg)


@registry.register_model("blip_caption")
class BlipCaption(nn.Module):
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
        return _encode_image(self.visual_encoder, images)

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
        ``prompt_length`` positions masked."""
        logits = self.decode_logits(input_ids, text_mask, self.encode_image(images), generator)
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
