"""Model building and loading (counterpart of ``sprc_tpu/loader.py``).

``build_model(name, model_type)`` resolves the class from the registry and
its configuration from :data:`MODEL_CONFIGS`, which mirrors the model
sections of ``configs/models/<name>/<model_type>.yaml`` (a test pins them
equal to what ``sprc_tpu.loader`` builds from the YAML; the port reads no
YAML, so it needs no PyYAML). Overrides may come as the validate CLI's
``--model-overrides`` gives them: precisions as ``"fp32"`` / ``"bf16"`` and the
two sub-configs as dicts. ``load_model`` fills the weights: from a
reference-layout checkpoint (``checkpoint_path``: a bare state dict, a
``{"model": ...}`` file or the released ``{epoch, ClassName: state_dict}``
layout; keys the model does not hold are dropped, as the reference's
``strict=False`` load and the JAX importer's template filter drop them, and
what is left is loaded with ``strict=True``, so a missing weight raises) or
at random from a seeded ``torch.Generator``. Both run on the GPU unless the
caller asks for another device.

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
from sprc_tpu_torch.models.llama import LlamaConfig
from sprc_tpu_torch.models.llm_presets import LLM_KEYS
from sprc_tpu_torch.models.opt import OPTConfig
from sprc_tpu_torch.models.qformer import QFormerConfig
from sprc_tpu_torch.models.t5 import T5Config, T5LayerNorm
from sprc_tpu_torch.models.vit import ViTConfig, calibrate_act_scales
from sprc_tpu_torch.ops import quant
from sprc_tpu_torch.ops.layers import LayerNormFP32, Linear
from sprc_tpu_torch.registry import registry

# (name, model_type) -> CirConfig fields, as configs/models/<name>/<type>.yaml
# gives them (vit_precision bf16 -> vit_dtype, qformer_precision fp32): the
# same knobs for the eleven CIR models (their YAMLs differ only in ``arch``)
_VIT_MODELS = {"pretrain": "eva_clip_g", "pretrain_vitL": "clip_L"}
CIR_MODELS = ("blip2_cir_align_prompt", "blip2_cir_cat", "blip2_cir_rel",
              "blip2_cir_z_learn_pos_align", "blip2_cir_neg", "blip2_cir_neg_rel",
              "blip2_cir_full", "blip2_cir_rerank", "blip2_cir_cls", "blip2_cir_slt",
              "blip2_cir_prompt")
MODEL_CONFIGS = {
    (name, model_type): dict(
        vit_model=vit_model, image_size=224, num_query_token=32, cross_attention_freq=2,
        embed_dim=256, max_txt_len=32, vit_dtype=torch.bfloat16,
        qformer_dtype=torch.float32,
    )
    for name in CIR_MODELS
    for model_type, vit_model in _VIT_MODELS.items()
}
# the BLIP-2 stage-1 family, as configs/models/{blip2,blip2_feature_extractor,
# blip2_image_text_matching}/*.yaml give it: pretrain (EVA ViT-g 224 px, bf16
# tower, frozen) and coco (364 px, an fp32 tower, which that YAML trains:
# freeze_vit false, the rows of UNFROZEN_VIT)
STAGE1_MODELS = ("blip2", "blip2_feature_extractor", "blip2_image_text_matching")
_STAGE1_TYPES = {"pretrain": (224, torch.bfloat16), "coco": (364, torch.float32)}
UNFROZEN_VIT = {("blip2", "coco"), ("blip2_image_text_matching", "coco")}
MODEL_CONFIGS.update({
    (name, model_type): dict(
        vit_model="eva_clip_g", image_size=size, num_query_token=32, cross_attention_freq=2,
        embed_dim=256, max_txt_len=32, vit_dtype=vit_dtype, qformer_dtype=torch.float32,
        freeze_vit=(name, model_type) not in UNFROZEN_VIT,
    )
    for name in STAGE1_MODELS
    for model_type, (size, vit_dtype) in _STAGE1_TYPES.items()
    if (name, model_type) != ("blip2_feature_extractor", "coco")
})

# BLIP-2 stage 2, the LLM caption heads, as configs/models/{blip2_opt,blip2_t5}/*.yaml
# give them: EVA ViT-g (ViT-L for pretrain_flant5xl_vitL), bf16 and frozen at
# 224 px (pretrain), fp32 at 364 px with freeze_vit false (the COCO caption
# fine-tunes); the LLM tower by its HF name, resolved through
# models/llm_presets.py. The YAMLs' ``prompt`` is a generation key (below).
LLM_HEADS = ("blip2_opt", "blip2_t5", "blip2_t5_instruct")
_LLM_ROWS = {
    ("blip2_opt", "pretrain_opt2.7b"): ("eva_clip_g", 224, "opt_model", "facebook/opt-2.7b"),
    ("blip2_opt", "pretrain_opt6.7b"): ("eva_clip_g", 224, "opt_model", "facebook/opt-6.7b"),
    ("blip2_opt", "caption_coco_opt2.7b"): ("eva_clip_g", 364, "opt_model", "facebook/opt-2.7b"),
    ("blip2_opt", "caption_coco_opt6.7b"): ("eva_clip_g", 364, "opt_model", "facebook/opt-6.7b"),
    ("blip2_t5", "pretrain_flant5xl"): ("eva_clip_g", 224, "t5_model", "google/flan-t5-xl"),
    ("blip2_t5", "pretrain_flant5xl_vitL"): ("clip_L", 224, "t5_model", "google/flan-t5-xl"),
    ("blip2_t5", "pretrain_flant5xxl"): ("eva_clip_g", 224, "t5_model", "google/flan-t5-xxl"),
    ("blip2_t5", "caption_coco_flant5xl"): ("eva_clip_g", 364, "t5_model", "google/flan-t5-xl"),
}
MODEL_CONFIGS.update({
    key: {"vit_model": vit_model, "image_size": size, "num_query_token": 32,
          "freeze_vit": size == 224,
          "vit_dtype": torch.bfloat16 if size == 224 else torch.float32, llm_key: llm_name}
    for key, (vit_model, size, llm_key, llm_name) in _LLM_ROWS.items()
})
# the InstructBLIP rows, as configs/models/{blip2_vicuna_instruct,blip2_instruct_cir,
# blip2_t5_instruct}/*.yaml give them: EVA ViT-g, bf16 and frozen at 224 px, 32
# queries; the LLM by its HF name (LLaMA / Vicuna under ``llm_model``, fp32 as
# the JAX preset leaves it: Vicuna-7B is 26.95 GB) and the YAML's max_txt_len
# (blip2_instruct_cir's YAML sets none: the default 32).
# ``blip2_t5_instruct`` is ``blip2_t5``'s class (an LLM head above)
INSTRUCT_MODELS = ("blip2_vicuna_instruct", "blip2_instruct_cir")
_INSTRUCT_ROWS = {
    ("blip2_vicuna_instruct", "vicuna7b"): ("llm_model", "lmsys/vicuna-7b-v1.1", 128),
    ("blip2_vicuna_instruct", "vicuna13b"): ("llm_model", "lmsys/vicuna-13b-v1.1", 128),
    ("blip2_instruct_cir", "vicuna7b"): ("llm_model", "lmsys/vicuna-7b-v1.1", 32),
    ("blip2_t5_instruct", "flant5xl"): ("t5_model", "google/flan-t5-xl", 128),
    ("blip2_t5_instruct", "flant5xxl"): ("t5_model", "google/flan-t5-xxl", 128),
}
MODEL_CONFIGS.update({
    key: {"vit_model": "eva_clip_g", "image_size": 224, "num_query_token": 32,
          "freeze_vit": True, "vit_dtype": torch.bfloat16, "max_txt_len": max_txt_len,
          llm_key: llm_name}
    for key, (llm_key, llm_name, max_txt_len) in _INSTRUCT_ROWS.items()
})
# decoding keys of the model YAMLs (blip2_caption_opt2.7b.yaml's ``prompt``):
# the JAX loader drops them from the model section; the caption glue reads
# the run section's
GENERATION_KEYS = ("prompt", "max_output_txt_len", "num_beams")
# an LLM tower in a model row or override: its HF name (the YAML key) or its
# config (a dict or the dataclass) on the model's keyword
_LLM_CONFIGS = {"opt_config": OPTConfig, "t5_config": T5Config, "llama_config": LlamaConfig}

_PRECISIONS = {"fp32": torch.float32, "fp16": torch.bfloat16, "bf16": torch.bfloat16}
# sub-configs that an override may give as a dict, with the fields of the JAX
# package's dataclass that the port does not read (attention dropout: the JAX
# model never applies it; initialisers; scanned blocks): dropped here, where
# any other unknown field raises
_SUB_CONFIGS = {
    "vit_config_override": (ViTConfig, {"scan_blocks"}),
    "qformer_config_override": (QFormerConfig, {"attention_dropout_rate",
                                                "initializer_range"}),
}


def _precision(key: str, value: Any) -> Any:
    if key.endswith("dtype") and isinstance(value, str):
        return _PRECISIONS[value]
    return value


def coerce_overrides(overrides: dict) -> dict:
    """YAML-friendly overrides (the JAX loader's ``_coerce``): precision
    names on ``*dtype`` fields become dtypes, and a dict for
    ``vit_config_override`` / ``qformer_config_override`` becomes that
    dataclass; the YAML's ``use_grad_checkpoint`` becomes ``vit_remat``, as
    the JAX loader translates it."""
    out = {}
    for key, value in overrides.items():
        if key == "use_grad_checkpoint":
            key, value = "vit_remat", bool(value)
        if key in _SUB_CONFIGS and isinstance(value, dict):
            cls, jax_only = _SUB_CONFIGS[key]
            value = cls(**{k: _precision(k, v) for k, v in value.items() if k not in jax_only})
        out[key] = _precision(key, value)
    return out


def _split_llm(fields: dict) -> dict:
    """Pop the LLM tower from ``fields`` -> the model's keyword arguments
    (``{"opt_config": OPTConfig}``, ``{"t5_config": T5Config}``,
    ``{"llama_config": LlamaConfig}`` or none), as the JAX loader resolves
    ``opt_model`` / ``t5_model`` / ``llm_model`` and ``opt_config`` /
    ``t5_config`` / ``llama_config`` (each a dict or the dataclass)."""
    out = {}
    for key, (field, resolve) in LLM_KEYS.items():
        if key in fields:
            out[field] = resolve(fields.pop(key))
    for field, cls in _LLM_CONFIGS.items():
        if field in fields:
            value = fields.pop(field)
            out[field] = cls(**{k: _precision(k, v) for k, v in value.items()}) \
                if isinstance(value, dict) else value
    return out


def _fields(name: str, model_type: str, overrides: dict) -> dict:
    try:
        base = MODEL_CONFIGS[(name, model_type)]
    except KeyError:
        raise ValueError(
            f"no port configuration for ({name!r}, {model_type!r}); ported: "
            f"{sorted(MODEL_CONFIGS)}") from None
    return {**base, **coerce_overrides(overrides)}


def model_config(name: str, model_type: str = "pretrain", **overrides: Any) -> CirConfig:
    fields = _fields(name, model_type, overrides)
    _split_llm(fields)
    return CirConfig(**fields)


def llm_config(name: str, model_type: str = "pretrain", **overrides: Any) -> dict:
    """The LLM tower of an LLM head's row (with ``overrides``) as the model's
    keyword argument: ``{"opt_config": ...}``, ``{"t5_config": ...}`` or
    ``{"llama_config": ...}``; empty for every other model."""
    return _split_llm(_fields(name, model_type, overrides))


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r}: no CUDA device is available; the port "
                           "runs on the GPU unless asked for another device (device='cpu')")
    return device


def build_model(name: str, model_type: str = "pretrain", *, device="cuda",
                **overrides: Any) -> nn.Module:
    """The model on ``device`` with UNINITIALISED weights (``load_model``
    fills them). ``overrides`` replace CirConfig fields. The modules are made
    on the meta device and then given storage on ``device``, so a 7B LLaMA
    is never materialised on the host."""
    device = _device(device)
    cls = registry.get_model_class(name)
    cfg = model_config(name, model_type, **overrides)
    llm = llm_config(name, model_type, **overrides)
    with torch.device("meta"):
        model = cls(cfg, **llm)
    return model.to_empty(device=device)


@torch.no_grad()
def init_weights(model: nn.Module, seed: int = 0) -> None:
    """Random weights from ``torch.Generator(device).manual_seed(seed)``, with
    the JAX package's initialisers: normal(0.02) for dense, embedding, token
    and position tables (OPT's among them), normal(1.0) for an embedding that
    says so in its ``init_std`` (T5's ``shared`` and relative-position
    tables); fan-in normal for the patch conv; zero biases; unit LayerNorms
    and RMS scales (T5's, LLaMA's); temperature 0.07. The rerank model's frozen twin is drawn
    like every other module, independently of the tower it copies (as a
    JAX init draws ``fformer``); ``CirRerank.sync_fformer`` on the state
    dict makes it a copy."""
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
        elif isinstance(mod, T5LayerNorm):
            const(mod.weight, 1.0)
        elif isinstance(mod, Linear):
            normal(mod.weight, 0.02)
            if mod.bias is not None:
                const(mod.bias, 0.0)
        elif isinstance(mod, nn.Embedding):
            normal(mod.weight, getattr(mod, "init_std", 0.02))
        elif isinstance(mod, nn.Conv2d):
            normal(mod.weight, mod.weight[0].numel() ** -0.5)
            if mod.bias is not None:
                const(mod.bias, 0.0)
    for name, p in model.named_parameters():
        if id(p) in done:
            continue
        if name in ("temp", "temp2"):
            const(p, 0.07)
        elif name.endswith(("in_proj_bias", "q_bias", "v_bias")):
            const(p, 0.0)
        else:  # in_proj_weight, class/positional embeddings, query/prompt/rel tokens
            normal(p, 0.02)
    for name, buf in model.named_buffers():
        if id(buf) in int8_buffers:
            continue
        if name.endswith("position_ids"):
            buf.copy_(torch.arange(buf.shape[-1], device=device)[None])
        else:
            raise ValueError(f"init_weights: no rule for buffer {name}")


def load_model(name: str, model_type: str = "pretrain",
               checkpoint_path: Optional[str] = None, *, device="cuda", seed: int = 0,
               **overrides: Any) -> nn.Module:
    """Build a model and fill its weights; returns it in eval mode."""
    model = build_model(name, model_type, device=device, **overrides)
    if checkpoint_path is None:
        init_weights(model, seed)
    else:
        model.load_state_dict(read_checkpoint(checkpoint_path, model), strict=True)
    return model.eval()


def read_checkpoint(path: str, model: nn.Module) -> dict:
    """The state dict of any of the reference checkpoint flavours, cut to the
    keys ``model`` holds (a released checkpoint also carries the LM head and
    buffers that this model has no module for)."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if "model" in state and isinstance(state["model"], dict):
        state = state["model"]  # blip2_pretrained.pth style
    else:  # fine-tuned {epoch, ClassName: state_dict} style (reference utils.py:219-222)
        for value in state.values():
            if isinstance(value, dict) and any(torch.is_tensor(v) for v in value.values()):
                state = value
                break
    own = model.state_dict()
    state = {k: v for k, v in state.items() if k in own}
    if "temp" in state:  # some save paths write the scalar as [1]
        state["temp"] = state["temp"].reshape(())
    return state


def calibrate_vit_act_scales(model: nn.Module, images: np.ndarray, *,
                             batch: int = 16) -> Tuple[Tuple[str, float], ...]:
    """The static activation scales of the int8 tower, calibrated on the
    loaded ``model`` itself: its tower, built in any int8 mode
    (``load_model(..., vit_quant="int8_calib")``), runs ``images`` [n, H, W, 3]
    float32 in ``"int8_calib"``, ``batch`` at a time, and then serves in
    ``"int8_static"`` with the scales found, which are returned
    (``model.cfg`` says the same). They are also the ``vit_act_scales`` of a
    later ``load_model(..., vit_quant="int8_static")``. The pass runs the
    dynamic-int8 unfused block: its dense ops in plain PyTorch (it is
    set-up), its attention through ``dot_product_attention``, which on the
    card launches the ``flash_attention`` kernel, as in the JAX package."""
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


__all__ = ["CIR_MODELS", "STAGE1_MODELS", "UNFROZEN_VIT", "LLM_HEADS", "INSTRUCT_MODELS",
           "GENERATION_KEYS",
           "MODEL_CONFIGS", "model_config", "llm_config", "coerce_overrides", "build_model",
           "init_weights",
           "load_model", "read_checkpoint", "calibrate_vit_act_scales"]
