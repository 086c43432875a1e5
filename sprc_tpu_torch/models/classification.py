"""Multimodal classification heads (counterpart of
``sprc_tpu/models/classification.py``; reference
lavis/models/albef_models/albef_classification.py:26-147 and
blip_models/blip_classification.py:25-147).

:class:`MultimodalClassifier` (``albef_classification``,
``blip_classification``): the ViT-B/16 tower (kernel K2 on the card), a
med-BERT over the sentence cross-attending the image rows (ALBEF: from
``fusion_layer``; BLIP, ``cross_on_all_layers``: every layer) and a 2-layer
ReLU MLP on ``[CLS]`` (LAVIS's ``cls_head.0`` / ``cls_head.2``). The loss is
``(1 - alpha) CE - alpha E[log p . softmax(momentum logits)]``;
:func:`classifier_train_step` updates the fp32 momentum copies of the
tower, the med-BERT and the head (``use_distill``) and runs the momentum
forward without a graph; alpha ramps over ONE epoch
(:func:`classifier_rampup_alpha`). The JAX train steps apply the model
deterministically, so the med-BERT runs without dropout in training too.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
from torch import nn

from sprc_tpu_torch.models.albef import (MedEncoder, MedTowers, momentum_copies, momentum_update,
                                         momentum_weights)
from sprc_tpu_torch.models.generation import stage
from sprc_tpu_torch.models.qformer import QFormerConfig
from sprc_tpu_torch.models.vit import ViTConfig, build_tower
from sprc_tpu_torch.ops.layers import Linear
from sprc_tpu_torch.registry import registry

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class ClassifierConfig(MedTowers):
    num_classes: int = 3  # visual entailment
    image_size: int = 384
    max_txt_len: int = 40
    vocab_size: int = 30523
    fusion_layer: int = 6
    cross_on_all_layers: bool = False  # True: the BLIP flavour
    momentum: float = 0.995
    alpha: float = 0.4
    use_distill: bool = True
    vit_dtype: torch.dtype = torch.bfloat16
    text_dtype: torch.dtype = torch.float32
    vit_config_override: Optional[ViTConfig] = None
    text_config_override: Optional[QFormerConfig] = None


def cls_head(hidden: int, num_classes: int) -> nn.Sequential:
    """``Linear -> ReLU -> Linear`` under LAVIS's ``cls_head.0`` /
    ``cls_head.2`` names."""
    return nn.Sequential(Linear(hidden, hidden), nn.ReLU(), Linear(hidden, num_classes))


def distilled_ce(logits: Tensor, labels: Tensor, logits_m: Optional[Tensor], alpha) -> Tensor:
    """CE of ``labels``, mixed with the soft targets of ``logits_m`` (no
    gradient) by ``alpha`` where they are given (reference :117-128)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ce = -logp.gather(-1, labels.long()[:, None]).mean()
    if logits_m is None:
        return ce
    soft = torch.softmax(logits_m.detach().float(), dim=-1)
    return (1.0 - alpha) * ce - alpha * (logp * soft).sum(-1).mean()


class _Deterministic(nn.Module):
    """The JAX train steps apply the classifiers deterministically: the
    text side stays in eval mode (no dropout) whatever ``mode`` is."""

    def train(self, mode: bool = True):
        super().train(mode)
        self.text_encoder.eval()
        return self

    def encode_image(self, images: Tensor) -> Tensor:
        """NHWC images -> the tower's rows [B, S, W] in fp32 (with a graph
        where autograd records)."""
        return self.visual_encoder(images).float()


@registry.register_model("albef_classification")
@registry.register_model("blip_classification")
class MultimodalClassifier(_Deterministic):
    """ViT + multimodal med-BERT + MLP class head (reference :83-147)."""

    CONFIG = ClassifierConfig
    MOMENTUM_KEYS = ("visual_encoder.", "text_encoder.", "cls_head.")
    MOMENTUM_LAYOUT = True  # its LAVIS checkpoints hold the momentum modules

    def __init__(self, cfg: ClassifierConfig):
        super().__init__()
        self.cfg = cfg
        tcfg = cfg.text_config()
        self.visual_encoder = build_tower(cfg.vit_config())
        if cfg.cross_on_all_layers:  # BLIP's med: every layer cross-attends
            self.text_encoder = MedEncoder(tcfg, tcfg.num_layers, cross_from=0)
        else:
            self.text_encoder = MedEncoder(tcfg, cfg.fusion_layer)
        self.cls_head = cls_head(tcfg.hidden_size, cfg.num_classes)

    def predict(self, images: Tensor, input_ids: Tensor, text_mask: Tensor, *,
                stats: Optional[Dict[str, float]] = None) -> Tensor:
        """-> [B, num_classes] logits (reference :96-101); ``stats``: seconds
        by stage (``tower_s``, ``text_s``), added to."""
        with stage(stats, "tower_s", images.device):
            rows = self.encode_image(images)
        with stage(stats, "text_s", images.device):
            out = self.text_encoder(input_ids=input_ids, attention_mask=text_mask,
                                    image_embeds=rows, mode="multimodal")
            logits = self.cls_head(out[:, 0, :].float())
        return logits

    def forward(self, images: Tensor, input_ids: Tensor, text_mask: Tensor, labels: Tensor,
                logits_m: Optional[Tensor] = None, alpha=0.0) -> Dict[str, Tensor]:
        logits = self.predict(images, input_ids, text_mask)
        return {"loss": distilled_ce(logits, labels, logits_m, alpha), "logits": logits}


# ------------------------------------------------- functional momentum state


def init_classifier_state(params: Dict[str, Tensor]) -> Dict[str, Any]:
    return momentum_copies(params, MultimodalClassifier.MOMENTUM_KEYS)


def classifier_train_step(model: MultimodalClassifier, params: Dict[str, Tensor],
                          state: Dict[str, Any], batch: Dict[str, Tensor], *, alpha,
                          generator: Optional[torch.Generator] = None):
    """One step's forward: with ``use_distill`` the momentum update and the
    momentum model's logits (no graph), then the distilled loss. Returns
    ``(out, new state)``."""
    logits_m = None
    if model.cfg.use_distill:
        state = momentum_update(params, state, model.cfg.momentum)
        with torch.no_grad(), momentum_weights(model, state["params_m"]):
            logits_m = model.predict(batch["images"], batch["input_ids"], batch["text_mask"])
    out = model(batch["images"], batch["input_ids"], batch["text_mask"], batch["labels"],
                logits_m, torch.as_tensor(alpha, dtype=torch.float32))
    return out, state


def classifier_rampup_alpha(cfg, epoch: int, iters: int, iters_per_epoch: int) -> float:
    """The alpha ramp over ONE epoch (reference :80-81)."""
    return cfg.alpha * min(1.0, (epoch * iters_per_epoch + iters) / iters_per_epoch)
