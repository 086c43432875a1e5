"""The med-BERT of ALBEF and BLIP-1 (counterpart of
``sprc_tpu/models/albef.py:39-135``, ``MedEncoder``; reference
lavis/models/med.py).

A BERT-base encoder whose layers may cross-attend image rows over every
text position:

- mode ``"text"`` runs layers ``[0, fusion_layer)`` without cross-attention,
  mode ``"fusion"`` runs ``[fusion_layer, n)`` with it, mode ``"multimodal"``
  runs every layer, cross-attending from ``cross_from`` (ALBEF:
  ``fusion_layer``; BLIP-1: every layer has cross-attention, ``fusion_layer =
  n`` and ``cross_from = 0``, med.py:406-420);
- padding masks are the additive ``(1 - m) * -10000`` bias, an
  ``image_mask`` gives the cross-attention's;
- ``is_decoder`` adds the causal ``-10000`` bias (the captioner);
- ``gradcam_layer`` / ``gradcam_probe``: that layer's cross-attention also
  returns its softmax probabilities, with the zero-valued probe added to
  them (:func:`sprc_tpu_torch.utils.gradcam.compute_gradcam` takes the
  gradient with respect to it).

Every layer is the JAX package's unfused composition
(``QFormerAttention`` / ``QFormerFFN``; no Pallas kernel runs there), here
the port's :class:`~sprc_tpu_torch.models.qformer.QFormerAttention` through
its ``train_forward`` (``torch.matmul`` dense ops, attention through
:func:`~sprc_tpu_torch.ops.attention.dot_product_attention`, exact GELU,
post-LN residuals) and, in training mode with autograd recording, hidden
dropout at the JAX package's places. Module names are the reference's
(``embeddings.word_embeddings``, ``encoder.layer.{i}.attention.self.query``,
``crossattention.output.LayerNorm``, ``intermediate.dense``,
``output.LayerNorm``), so a released BLIP-1 checkpoint's text tower loads by
name. The rest of ALBEF (its retrieval and pretraining models, the momentum
state) comes with that family (ROADMAP A8.6).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from sprc_tpu_torch.models.qformer import (NEG_INF, Dense, DenseLN, QFormerAttention,
                                           QFormerConfig, QFormerEmbeddings, _ffn_train,
                                           make_additive_mask, training)

MODES = ("text", "fusion", "multimodal")


class MedLayer(nn.Module):
    def __init__(self, cfg: QFormerConfig, has_cross_attention: bool):
        super().__init__()
        H, M, eps = cfg.hidden_size, cfg.intermediate_size, cfg.layer_norm_eps
        self.attention = QFormerAttention(cfg, H)
        if has_cross_attention:
            self.crossattention = QFormerAttention(cfg, cfg.encoder_width)
        self.intermediate = Dense(H, M, False)
        self.output = DenseLN(M, H, eps, False)


class MedEncoderLayers(nn.Module):
    def __init__(self, cfg: QFormerConfig, cross_from: int):
        super().__init__()
        self.layer = nn.ModuleList(MedLayer(cfg, i >= cross_from) for i in range(cfg.num_layers))


class MedEncoder(nn.Module):
    """The med-BERT (BertModel without its pooler). ``fusion_layer`` and
    ``cross_from`` as in the JAX module; layers from ``cross_from`` on hold
    cross-attention weights."""

    def __init__(self, cfg: QFormerConfig, fusion_layer: int, cross_from: Optional[int] = None):
        super().__init__()
        self.cfg = cfg
        self.fusion_layer = fusion_layer
        self.cross_from = fusion_layer if cross_from is None else cross_from
        self.embeddings = QFormerEmbeddings(cfg)
        self.encoder = MedEncoderLayers(cfg, self.cross_from)

    def forward(self, input_ids: Optional[torch.Tensor] = None,
                inputs_embeds: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None,
                image_embeds: Optional[torch.Tensor] = None,
                image_mask: Optional[torch.Tensor] = None, *, mode: str = "multimodal",
                is_decoder: bool = False, generator: Optional[torch.Generator] = None,
                gradcam_layer: Optional[int] = None,
                gradcam_probe: Optional[torch.Tensor] = None):
        """-> hidden [B, L, H] in the config's dtype; with ``gradcam_layer``,
        ``(hidden, that layer's cross-attention probabilities [B, heads, L,
        Si] or None where it has none)``."""
        cfg = self.cfg
        if mode not in MODES:
            raise ValueError(f"mode {mode!r}: expected one of {MODES}")
        hidden = (self.embeddings(input_ids, None, generator=generator) if inputs_embeds is None
                  else inputs_embeds.to(cfg.dtype))
        S = hidden.shape[1]
        bias = None
        if attention_mask is not None:
            bias = make_additive_mask(attention_mask)[:, None, None, :]
        cross_bias = None if image_mask is None else make_additive_mask(image_mask)[:, None, None, :]
        if is_decoder:
            causal = torch.tril(torch.ones((S, S), dtype=torch.float32, device=hidden.device))
            causal_bias = ((1.0 - causal) * NEG_INF)[None, None]
            bias = causal_bias if bias is None else bias + causal_bias
        start, end = {"text": (0, self.fusion_layer), "fusion": (self.fusion_layer, cfg.num_layers),
                      "multimodal": (0, cfg.num_layers)}[mode]
        image = None if image_embeds is None else image_embeds.to(cfg.dtype)
        run = cfg if training(self) else dataclasses.replace(cfg, dropout_rate=0.0)
        probs = None
        for i in range(start, end):
            layer = self.encoder.layer[i]
            hidden = layer.attention.train_forward(hidden, hidden, bias, run, generator)
            if i >= self.cross_from and image is not None:
                if gradcam_layer == i:
                    hidden, probs = layer.crossattention.train_forward(
                        hidden, image, cross_bias, run, generator, return_probs=True,
                        probs_offset=gradcam_probe)
                else:
                    hidden = layer.crossattention.train_forward(hidden, image, cross_bias, run,
                                                                generator)
            hidden = _ffn_train(layer.intermediate, layer.output, hidden, run, generator)
        if gradcam_layer is not None:
            return hidden, probs
        return hidden
