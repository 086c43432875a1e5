"""Model building and loading (counterpart of ``sprc_tpu/loader.py``).

``build_model(name, model_type)`` resolves the class from the registry and
its configuration from :data:`MODEL_CONFIGS`, which mirrors the model
sections of ``configs/models/<name>/<model_type>.yaml`` (a test pins them
equal to what ``sprc_tpu.loader`` builds from the YAML; the port reads no
YAML, so it needs no PyYAML). ``load_model`` fills the weights: from a
reference-layout state dict (``checkpoint_path``, loaded with
``strict=True``) or at random from a seeded ``torch.Generator``. Both run
on the GPU unless the caller asks for another device.

The int8 serving configuration is ``load_model(..., vit_quant="int8_calib",
qformer_int8=True)`` followed by :func:`calibrate_vit_act_scales` on that
model, or, with scales kept from an earlier calibration, ``load_model(...,
vit_quant="int8_static", vit_act_scales=scales, qformer_int8=True)``.
Either way of filling the weights also derives the int8 codes of the dense
weights from the fp32 source values, before they are cast to the tower's
compute dtype (:mod:`sprc_tpu_torch.ops.quant`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch
from torch import nn

from sprc_tpu_torch import models as _models  # noqa: F401  (registers the models)
from sprc_tpu_torch.models.cir_base import CirConfig
from sprc_tpu_torch.models.vit import calibrate_act_scales
from sprc_tpu_torch.ops import quant
from sprc_tpu_torch.ops.layers import LayerNormFP32, Linear
from sprc_tpu_torch.registry import registry

# (name, model_type) -> CirConfig fields, as configs/models/<name>/<type>.yaml
# gives them (vit_precision bf16 -> vit_dtype, qformer_precision fp32).
MODEL_CONFIGS = {
    ("blip2_cir_align_prompt", "pretrain_vitL"): dict(
        vit_model="clip_L", image_size=224, num_query_token=32, cross_attention_freq=2,
        embed_dim=256, max_txt_len=32, vit_dtype=torch.bfloat16,
        qformer_dtype=torch.float32,
    ),
}


def model_config(name: str, model_type: str = "pretrain_vitL", **overrides: Any) -> CirConfig:
    try:
        base = MODEL_CONFIGS[(name, model_type)]
    except KeyError:
        raise ValueError(
            f"no port configuration for ({name!r}, {model_type!r}); ported: "
            f"{sorted(MODEL_CONFIGS)}") from None
    return CirConfig(**{**base, **overrides})


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r}: no CUDA device is available; the port "
                           "runs on the GPU unless asked for another device (device='cpu')")
    return device


def build_model(name: str, model_type: str = "pretrain_vitL", *, device="cuda",
                **overrides: Any) -> nn.Module:
    """The model on ``device`` with UNINITIALISED weights (``load_model``
    fills them). ``overrides`` replace CirConfig fields."""
    device = _device(device)
    cls = registry.get_model_class(name)
    cfg = model_config(name, model_type, **overrides)
    with torch.device("meta"):
        model = cls(cfg)
    return model.to_empty(device=device)


@torch.no_grad()
def init_weights(model: nn.Module, seed: int = 0) -> None:
    """Random weights from ``torch.Generator(device).manual_seed(seed)``, with
    the JAX package's initialisers: normal(0.02) for dense, embedding, token
    and position tables; fan-in normal for the patch conv; zero biases; unit
    LayerNorms; temperature 0.07."""
    device = next(model.parameters()).device
    gen = torch.Generator(device=device).manual_seed(seed)
    done = set()
    # weights whose int8 codes are derived from the fp32 draw, before the cast
    int8_owner = {id(mod.get_parameter(key)): (mod, name) for mod in model.modules()
                  for name, key in getattr(mod, "int8_sources", {}).items()}
    int8_buffers = {id(b) for mod, _ in int8_owner.values()
                    for b in mod.buffers(recurse=False)}

    def normal(p, std):
        draw = torch.empty(p.shape, device=device).normal_(0.0, std, generator=gen)
        p.copy_(draw)
        if id(p) in int8_owner:
            quant.set_int8_weight(*int8_owner[id(p)], draw)
        done.add(id(p))

    def const(p, value):
        p.fill_(value)
        done.add(id(p))

    for mod in model.modules():
        if isinstance(mod, LayerNormFP32):
            const(mod.weight, 1.0)
            const(mod.bias, 0.0)
        elif isinstance(mod, Linear):
            normal(mod.weight, 0.02)
            const(mod.bias, 0.0)
        elif isinstance(mod, nn.Embedding):
            normal(mod.weight, 0.02)
        elif isinstance(mod, nn.Conv2d):
            normal(mod.weight, mod.weight[0].numel() ** -0.5)
    for name, p in model.named_parameters():
        if id(p) in done:
            continue
        if name == "temp":
            const(p, 0.07)
        elif name.endswith("in_proj_bias"):
            const(p, 0.0)
        else:  # in_proj_weight, class/positional embeddings, query/prompt tokens
            normal(p, 0.02)
    for name, buf in model.named_buffers():
        if id(buf) in int8_buffers:
            continue
        if name.endswith("position_ids"):
            buf.copy_(torch.arange(buf.shape[-1], device=device)[None])
        else:
            raise ValueError(f"init_weights: no rule for buffer {name}")


def load_model(name: str, model_type: str = "pretrain_vitL",
               checkpoint_path: Optional[str] = None, *, device="cuda", seed: int = 0,
               **overrides: Any) -> nn.Module:
    """Build a model and fill its weights; returns it in eval mode."""
    model = build_model(name, model_type, device=device, **overrides)
    if checkpoint_path is None:
        init_weights(model, seed)
    else:
        state = torch.load(checkpoint_path, map_location="cpu", weights_only=True)
        if "model" in state and isinstance(state["model"], dict):
            state = state["model"]
        model.load_state_dict(state, strict=True)
    return model.eval()


def calibrate_vit_act_scales(model: nn.Module, images: np.ndarray, *,
                             batch: int = 16) -> Tuple[Tuple[str, float], ...]:
    """The static activation scales of the int8 tower, calibrated on the
    loaded ``model`` itself: its tower, built in any int8 mode
    (``load_model(..., vit_quant="int8_calib")``), runs ``images`` [n, H, W, 3]
    float32 in ``"int8_calib"``, ``batch`` at a time, and then serves in
    ``"int8_static"`` with the scales found, which are returned
    (``model.cfg`` says the same). They are also the ``vit_act_scales`` of a
    later ``load_model(..., vit_quant="int8_static")``. The pass runs the
    dynamic-int8 unfused block in plain PyTorch: it is set-up, no kernel is
    launched."""
    tower = model.visual_encoder
    device = next(model.parameters()).device
    tower.set_quant("int8_calib")

    def run():
        with torch.inference_mode():
            for s in range(0, len(images), batch):
                chunk = np.ascontiguousarray(images[s: s + batch], np.float32)
                model.encode_tower(torch.from_numpy(chunk).to(device))

    scales = calibrate_act_scales(tower, run)
    tower.set_quant("int8_static", scales)
    model.cfg = dataclasses.replace(model.cfg, vit_quant="int8_static", vit_act_scales=scales)
    return scales


__all__ = ["MODEL_CONFIGS", "model_config", "build_model", "init_weights", "load_model",
           "calibrate_vit_act_scales"]
