"""NLVR2 two-image reasoning (counterpart of ``sprc_tpu/models/nlvr.py``;
reference lavis/models/albef_models/albef_nlvr.py:24-232,
blip_models/blip_nlvr.py:24-147 and nlvr_encoder.py:256-379).

- :class:`AlbefNLVRMed`: the med-BERT whose layer ``i >= fusion_layer``
  cross-attends image ``(i - fusion_layer) % 2``, alternating image0 and
  image1, with the cross-attention's key and value projections TIED over
  each layer pair (6, 7), (8, 9), (10, 11) (``share_cross_attention``,
  :198-211): the pair's second layer holds the first one's modules, so both
  names are in the state dict (as in a LAVIS checkpoint) and one tensor is
  trained.
- :class:`BlipNLVRMed`: every layer carries twin cross-attention
  (``crossattention.self0`` over image0, ``self1`` over image1, output
  ``dense0`` / ``dense1``); the two contexts are averaged below
  ``merge_from`` and concatenated then projected by ``merge_layer`` (no
  activation) from it on, then dropout and ``LayerNorm(out + hidden)``.
- :class:`NLVRClassifier` (``albef_nlvr``, ``blip_nlvr``): one tower call
  over the stacked 2B images (kernel K2 on the card), the med-BERT over
  both halves, the MLP head on ``[CLS]``; :func:`nlvr_train_step` (ALBEF's
  distillation: the momentum tower and head with the ONLINE med-BERT, a
  reference quirk the JAX step keeps) and the TWO-epoch alpha ramp.

The cross-attention calls ``dot_product_attention`` without a bias, as the
JAX ``_mha`` does; NLVR's 35 to 40 text rows are below the attention
kernel's 128-row floor, so it runs its plain composition there in both
packages. The med-BERTs are unfused fp32 and run without dropout (the JAX
train steps apply the model deterministically).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
from torch import nn

from sprc_tpu_torch.models.albef import (MedEncoder, MedTowers, momentum_copies, momentum_update,
                                         momentum_weights)
from sprc_tpu_torch.models.classification import _Deterministic, cls_head, distilled_ce
from sprc_tpu_torch.models.generation import stage
from sprc_tpu_torch.models.qformer import (Dense, DenseLN, QFormerAttention, QFormerConfig,
                                           QFormerEmbeddings, SelfProjections, _ffn_train,
                                           make_additive_mask)
from sprc_tpu_torch.models.vit import ViTConfig, build_tower
from sprc_tpu_torch.ops.attention import dot_product_attention
from sprc_tpu_torch.ops.layers import LayerNormFP32, Linear
from sprc_tpu_torch.registry import registry

Tensor = torch.Tensor


def _no_dropout(cfg: QFormerConfig) -> QFormerConfig:
    return dataclasses.replace(cfg, dropout_rate=0.0)


def _mha(proj: SelfProjections, hidden: Tensor, image: Tensor, num_heads: int) -> Tensor:
    """Multi-head attention of the projections' q over the image rows' k / v."""
    B, S, C = hidden.shape
    D = C // num_heads
    q = proj.query(hidden).view(B, S, num_heads, D)
    k = proj.key(image).view(B, image.shape[1], num_heads, D)
    v = proj.value(image).view(B, image.shape[1], num_heads, D)
    return dot_product_attention(q, k, v, None).reshape(B, S, C)


class AlbefNLVRMed(MedEncoder):
    """ALBEF's NLVR med-BERT: alternating-image cross-attention, the key and
    value projections tied over each layer pair."""

    def __init__(self, cfg: QFormerConfig, fusion_layer: int = 6):
        super().__init__(cfg, fusion_layer)
        layers = self.encoder.layer
        for i in range(fusion_layer + 1, cfg.num_layers, 2):
            first, second = layers[i - 1].crossattention.self, layers[i].crossattention.self
            second.key, second.value = first.key, first.value

    def forward(self, input_ids: Tensor, attention_mask: Tensor, image0_embeds: Tensor,
                image1_embeds: Tensor) -> Tensor:
        cfg = _no_dropout(self.cfg)
        hidden = self.embeddings(input_ids, None)
        bias = make_additive_mask(attention_mask)[:, None, None, :]
        images = (image0_embeds.to(cfg.dtype), image1_embeds.to(cfg.dtype))
        for i, layer in enumerate(self.encoder.layer):
            hidden = layer.attention.train_forward(hidden, hidden, bias, cfg, None)
            if i >= self.fusion_layer:
                hidden = layer.crossattention.train_forward(
                    hidden, images[(i - self.fusion_layer) % 2], None, cfg, None)
            hidden = _ffn_train(layer.intermediate, layer.output, hidden, cfg, None)
        return hidden


class TwinCrossOutput(nn.Module):
    def __init__(self, hidden: int, eps: float, merge: bool):
        super().__init__()
        self.dense0 = Linear(hidden, hidden)
        self.dense1 = Linear(hidden, hidden)
        if merge:
            self.merge_layer = Linear(2 * hidden, hidden)
        self.LayerNorm = LayerNormFP32(hidden, eps)


class TwinCrossAttention(nn.Module):
    """nlvr_encoder.py's ``BertAttention`` with twin cross-attention."""

    def __init__(self, cfg: QFormerConfig, merge: bool):
        super().__init__()
        H = cfg.hidden_size
        self.self0 = SelfProjections(H, cfg.encoder_width, False)
        self.self1 = SelfProjections(H, cfg.encoder_width, False)
        self.output = TwinCrossOutput(H, cfg.layer_norm_eps, merge)

    def forward(self, hidden: Tensor, images, num_heads: int) -> Tensor:
        out = self.output
        ctx0 = out.dense0(_mha(self.self0, hidden, images[0], num_heads))
        ctx1 = out.dense1(_mha(self.self1, hidden, images[1], num_heads))
        if hasattr(out, "merge_layer"):  # concat + merge, no activation (:277-281)
            mixed = out.merge_layer(torch.cat([ctx0, ctx1], dim=-1))
        else:
            mixed = (ctx0 + ctx1) / 2.0
        return out.LayerNorm(mixed + hidden)


class BlipNLVRLayer(nn.Module):
    def __init__(self, cfg: QFormerConfig, merge: bool):
        super().__init__()
        H = cfg.hidden_size
        self.attention = QFormerAttention(cfg, H)
        self.crossattention = TwinCrossAttention(cfg, merge)
        self.intermediate = Dense(H, cfg.intermediate_size, False)
        self.output = DenseLN(cfg.intermediate_size, H, cfg.layer_norm_eps, False)


class _Layers(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layer = nn.ModuleList(layers)


class BlipNLVRMed(nn.Module):
    """BLIP's NLVR med-BERT: twin cross-attention on every layer, averaged
    below ``merge_from``, merged from it on."""

    def __init__(self, cfg: QFormerConfig, merge_from: int = 6):
        super().__init__()
        self.cfg = cfg
        self.merge_from = merge_from
        self.embeddings = QFormerEmbeddings(cfg)
        self.encoder = _Layers(BlipNLVRLayer(cfg, i >= merge_from) for i in range(cfg.num_layers))

    def forward(self, input_ids: Tensor, attention_mask: Tensor, image0_embeds: Tensor,
                image1_embeds: Tensor) -> Tensor:
        cfg = _no_dropout(self.cfg)
        hidden = self.embeddings(input_ids, None)
        bias = make_additive_mask(attention_mask)[:, None, None, :]
        images = (image0_embeds.to(cfg.dtype), image1_embeds.to(cfg.dtype))
        for layer in self.encoder.layer:
            hidden = layer.attention.train_forward(hidden, hidden, bias, cfg, None)
            hidden = layer.crossattention(hidden, images, cfg.num_heads)
            hidden = _ffn_train(layer.intermediate, layer.output, hidden, cfg, None)
        return hidden


@dataclasses.dataclass(frozen=True)
class NLVRConfig(MedTowers):
    flavor: str = "albef"  # 'albef' | 'blip'
    num_classes: int = 2
    image_size: int = 384
    max_txt_len: int = 40
    vocab_size: int = 30523
    fusion_layer: int = 6
    momentum: float = 0.995
    alpha: float = 0.4
    use_distill: bool = True  # ALBEF only; BLIP's NLVR has no distillation
    vit_dtype: torch.dtype = torch.bfloat16
    text_dtype: torch.dtype = torch.float32
    vit_config_override: Optional[ViTConfig] = None
    text_config_override: Optional[QFormerConfig] = None


@registry.register_model("albef_nlvr")
@registry.register_model("blip_nlvr")
class NLVRClassifier(_Deterministic):
    """Two-image entailment classifier (reference forward :108-197)."""

    CONFIG = NLVRConfig
    MOMENTUM_KEYS = ("visual_encoder.", "text_encoder.", "cls_head.")
    MOMENTUM_LAYOUT = True  # its LAVIS checkpoints hold the momentum modules

    def __init__(self, cfg: NLVRConfig):
        super().__init__()
        self.cfg = cfg
        tcfg = cfg.text_config()
        self.visual_encoder = build_tower(cfg.vit_config())
        if cfg.flavor == "blip":
            self.text_encoder = BlipNLVRMed(tcfg, merge_from=cfg.fusion_layer)
        else:
            self.text_encoder = AlbefNLVRMed(tcfg, fusion_layer=cfg.fusion_layer)
        self.cls_head = cls_head(tcfg.hidden_size, cfg.num_classes)

    @property
    def distills(self) -> bool:
        return self.cfg.use_distill and self.cfg.flavor == "albef"

    def predict(self, image0: Tensor, image1: Tensor, input_ids: Tensor, text_mask: Tensor, *,
                stats: Optional[Dict[str, float]] = None) -> Tensor:
        """-> [B, num_classes]: one tower call over the stacked 2B images
        (reference :120-126); ``stats``: ``tower_s``, ``text_s``."""
        B = image0.shape[0]
        with stage(stats, "tower_s", image0.device):
            embeds = self.encode_image(torch.cat([image0, image1]))
        with stage(stats, "text_s", image0.device):
            out = self.text_encoder(input_ids, text_mask, embeds[:B], embeds[B:])
            logits = self.cls_head(out[:, 0, :].float())
        return logits

    def forward(self, image0: Tensor, image1: Tensor, input_ids: Tensor, text_mask: Tensor,
                labels: Tensor, logits_m: Optional[Tensor] = None, alpha=0.0) -> Dict[str, Tensor]:
        logits = self.predict(image0, image1, input_ids, text_mask)
        return {"loss": distilled_ce(logits, labels, logits_m, alpha), "logits": logits}


# ------------------------------------------------- functional momentum state


def init_nlvr_state(params: Dict[str, Tensor]) -> Dict[str, Any]:
    return momentum_copies(params, NLVRClassifier.MOMENTUM_KEYS)


def nlvr_train_step(model: NLVRClassifier, params: Dict[str, Tensor], state: Dict[str, Any],
                    batch: Dict[str, Tensor], *, alpha,
                    generator: Optional[torch.Generator] = None):
    """One step's forward. ALBEF with ``use_distill``: the momentum update,
    then the momentum logits from the momentum tower and head over the
    ONLINE med-BERT (reference :150-159), without a graph. Returns ``(out,
    new state)``."""
    logits_m = None
    if model.distills:
        state = momentum_update(params, state, model.cfg.momentum)
        kept = {n: m for n, m in state["params_m"].items()
                if n.startswith(("visual_encoder.", "cls_head."))}
        with torch.no_grad(), momentum_weights(model, kept):
            logits_m = model.predict(batch["image0"], batch["image1"], batch["input_ids"],
                                     batch["text_mask"])
    out = model(batch["image0"], batch["image1"], batch["input_ids"], batch["text_mask"],
                batch["labels"], logits_m, torch.as_tensor(alpha, dtype=torch.float32))
    return out, state


def nlvr_rampup_alpha(cfg, epoch: int, iters: int, iters_per_epoch: int) -> float:
    """The TWO-epoch ramp (reference albef_nlvr.py:76-77)."""
    return cfg.alpha * min(1.0, (epoch * iters_per_epoch + iters) / (2 * iters_per_epoch))
