"""Model building and loading (counterpart of ``sprc_tpu/loader.py``).

``build_model(name, model_type)`` resolves the class from the registry and
its configuration from :data:`MODEL_CONFIGS` (the BLIP-2 family's
CirConfig), :data:`FAMILY_CONFIGS` (BLIP-1's and ALBEF's models, CLIP, the
FiD reader: their own dataclasses) or, for the ``pnp_vqa`` and
``img2prompt_vqa`` pipelines, :data:`PIPELINE_CONFIGS`, which mirror the model sections of
``configs/models/<name>/<model_type>.yaml`` (tests pin them equal to what
``sprc_tpu.loader`` builds from the YAML; the port reads no YAML, so it
needs no PyYAML). Overrides may come as the validate CLI's
``--model-overrides`` gives them: precisions as ``"fp32"`` / ``"bf16"`` and the
sub-configs (``vit_config_override``, ``qformer_config_override``,
``text_config_override``, CLIP's ``vision`` / ``text`` / ``vision_resnet``) as
dicts. ``load_model`` fills the weights: from a
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
import re
from typing import Any, Optional, Tuple

import numpy as np
import torch
from torch import nn

from sprc_tpu_torch import models as _models  # noqa: F401  (registers the models)
from sprc_tpu_torch.models.cir_base import CirConfig
from sprc_tpu_torch.models.clip import LOGIT_SCALE_INIT, ClipTextConfig, clip_state_from_hf
from sprc_tpu_torch.models.gpt_dialogue import Conv1D, GPT2Config
from sprc_tpu_torch.models.llama import LlamaConfig
from sprc_tpu_torch.models.llm_presets import LLM_KEYS
from sprc_tpu_torch.models.opt import OPTConfig
from sprc_tpu_torch.models.qformer import QFormerConfig
from sprc_tpu_torch.models.resnet_clip import FrozenBatchNorm2d, ResNetConfig
from sprc_tpu_torch.models.t5 import T5Config, T5LayerNorm
from sprc_tpu_torch.models.timesformer import TimeSformerConfig
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
# the models with a configuration of their own (not CirConfig), as
# configs/models/{blip_image_text_matching,blip_caption,pnp_unifiedqav2_fid}/*.yaml
# give them: BLIP-1's ITM scorer and captioner (ViT-B/16, or the ViT-L/16 at 384
# px of ``large`` / ``large_coco``: the YAMLs' vit_config_override, bf16) and the
# UnifiedQA-v2 FiD reader (its ``t5_model``, the T5 v1.0 of that size, fp32)
_BLIP_VIT_L = ViTConfig(image_size=384, patch_size=16, width=1024, depth=24, num_heads=16,
                        mlp_hidden=4096, layer_norm_eps=1e-6, final_norm=True,
                        dtype=torch.bfloat16)
FAMILY_CONFIGS = {
    ("blip_image_text_matching", "base"): {"image_size": 384, "max_txt_len": 35},
    ("blip_image_text_matching", "large"): {"image_size": 384, "embed_dim": 256,
                                            "vit_config_override": _BLIP_VIT_L},
    ("blip_caption", "base_coco"): {"image_size": 384, "max_txt_len": 40, "prompt_length": 4},
    ("blip_caption", "large_coco"): {"image_size": 384, "max_txt_len": 40, "prompt_length": 4,
                                     "vit_config_override": _BLIP_VIT_L},
    **{("pnp_unifiedqav2_fid", size): {"t5_model": f"allenai/unifiedqa-v2-t5-{size}-1363200"}
       for size in ("base", "large", "3b")},
}
# the momentum-queue families, as configs/models/{blip_retrieval,albef_retrieval}/
# {coco,flickr}.yaml, blip_pretrain/{base,large}.yaml, albef_pretrain/base.yaml and
# albef_feature_extractor/base.yaml give them (ViT-B/16, bf16; blip_pretrain large:
# the ViT-L/16 at 224 px); ``pretrain`` is the type a run YAML without one names,
# which the JAX loader builds from the dataclass's defaults (no such YAML)
MOMENTUM_MODELS = ("blip_retrieval", "blip_pretrain", "albef_retrieval",
                   "albef_feature_extractor", "albef_pretrain")
_QUEUE = {"blip": 57600, "albef": 65536}
FAMILY_CONFIGS.update({
    **{(f"{fam}_retrieval", "pretrain"): {} for fam in _QUEUE},
    **{(f"{fam}_retrieval", "coco"): {"image_size": 384, "queue_size": q, "momentum": 0.995,
                                      "alpha": 0.4} for fam, q in _QUEUE.items()},
    **{(f"{fam}_retrieval", "flickr"): {"image_size": 384, "queue_size": q}
       for fam, q in _QUEUE.items()},
    ("albef_feature_extractor", "base"): {"image_size": 224, "embed_dim": 256},
    ("blip_pretrain", "base"): {"image_size": 224, "queue_size": 57600},
    ("blip_pretrain", "large"): {"image_size": 224, "embed_dim": 256,
                                 "vit_config_override": dataclasses.replace(_BLIP_VIT_L,
                                                                            image_size=224)},
    ("albef_pretrain", "base"): {"image_size": 224, "queue_size": 65536},
})
# BLIP-1 / ALBEF's VQA, classification and NLVR heads, as configs/models/{blip_vqa,
# albef_vqa,blip_classification,albef_classification,blip_nlvr,albef_nlvr}/*.yaml give
# them (ViT-B/16, bf16; BLIP's VQA tower at 480 px, the others at 384); ``pretrain`` is
# the type a run YAML without one names (the dataclass's defaults, as in JAX)
VQA_MODELS = ("blip_vqa", "albef_vqa")
CLASSIFICATION_MODELS = ("blip_classification", "albef_classification", "blip_nlvr",
                         "albef_nlvr")
FAMILY_CONFIGS.update({
    **{(name, "pretrain"): {} for name in VQA_MODELS + CLASSIFICATION_MODELS},
    ("blip_vqa", "vqav2"): {"flavor": "blip", "image_size": 480, "max_txt_len": 35},
    ("blip_vqa", "okvqa"): {"flavor": "blip", "image_size": 480},
    ("blip_vqa", "aokvqa"): {"flavor": "blip", "image_size": 480},
    ("albef_vqa", "vqav2"): {"flavor": "albef", "image_size": 384, "fusion_layer": 6,
                             "use_distill": True, "momentum": 0.995, "alpha": 0.4},
    ("blip_classification", "base"): {"num_classes": 3, "image_size": 384,
                                      "cross_on_all_layers": True},
    ("albef_classification", "ve"): {"num_classes": 3, "image_size": 384, "fusion_layer": 6},
    ("blip_nlvr", "nlvr"): {"flavor": "blip", "num_classes": 2, "image_size": 384},
    ("albef_nlvr", "nlvr"): {"flavor": "albef", "num_classes": 2, "image_size": 384},
})
# BLIP-1's captioner as configs/runs/caption_coco_ft{,_iter}.yaml name it (no model
# type: the dataclass's defaults, as the JAX loader builds them), and its CIR feature
# extractor, as configs/models/{blip_cir_base,blip_feature_extractor}/base.yaml give
# it (ViT-B/16 at 224 px, bf16; the med-BERT in text mode, fp32)
CIR_FEATURE_MODELS = ("blip_cir_base", "blip_feature_extractor")
FAMILY_CONFIGS.update({
    ("blip_caption", "pretrain"): {},
    **{(name, "pretrain"): {} for name in CIR_FEATURE_MODELS},
    ("blip_cir_base", "base"): {"image_size": 224, "embed_dim": 256, "max_txt_len": 40,
                                "num_prompts": 32},
    ("blip_feature_extractor", "base"): {"image_size": 224, "embed_dim": 256},
})
# CLIP, as configs/models/{clip,clip_feature_extractor}/*.yaml give it: the ViT towers
# (fp32, ln_pre, QuickGELU, ln_post, no patch bias) or the RN50 (``vision_resnet``),
# the text tower at each row's width; ``vit_base16`` and ``pretrain`` are the
# dataclass's ViT-B/16
CLIP_MODELS = ("clip", "clip_feature_extractor")


def _clip_vit(size: int, patch: int, width: int, depth: int, heads: int) -> ViTConfig:
    return ViTConfig(image_size=size, patch_size=patch, width=width, depth=depth,
                     num_heads=heads, mlp_hidden=4 * width, layer_norm_eps=1e-5,
                     use_ln_pre=True, quick_gelu=True, final_norm=True, patch_bias=False,
                     dtype=torch.float32)


_CLIP_TEXT_L = ClipTextConfig(width=768, heads=12)
FAMILY_CONFIGS.update({
    **{(name, "pretrain"): {} for name in CLIP_MODELS},
    **{(name, "vit_base16"): {"embed_dim": 512, "image_size": 224} for name in CLIP_MODELS},
    ("clip", "vit_base32"): {"embed_dim": 512, "image_size": 224,
                             "vision": _clip_vit(224, 32, 768, 12, 12)},
    ("clip", "vit_large14"): {"embed_dim": 768, "image_size": 224,
                              "vision": _clip_vit(224, 14, 1024, 24, 16),
                              "text": _CLIP_TEXT_L},
    ("clip", "vit_large14_336"): {"embed_dim": 768, "image_size": 336,
                                  "vision": _clip_vit(336, 14, 1024, 24, 16),
                                  "text": _CLIP_TEXT_L},
    ("clip", "resnet50"): {"embed_dim": 1024, "image_size": 224,
                           "vision_resnet": ResNetConfig(layers=(3, 4, 6, 3), width=64,
                                                         heads=32, output_dim=1024,
                                                         image_size=224)},
})
# the video families, as configs/models/{alpro_retrieval,alpro_qa,timesformer}/*.yaml
# give them (the TimeSformer ViT-B/16 at 224 px and the med-BERT, both fp32): the QA
# rows build 16 time_embed rows (their runs sample 8 frames) and the answer
# vocabulary's classes; ``pretrain`` is the type a run YAML without one names
VIDEO_MODELS = ("alpro_retrieval", "alpro_qa", "timesformer")
FAMILY_CONFIGS.update({
    **{(name, "pretrain"): {} for name in VIDEO_MODELS},
    **{("alpro_retrieval", ds): {"num_frames": 8, "image_size": 224}
       for ds in ("msrvtt", "didemo")},
    ("alpro_qa", "msrvtt"): {"num_classes": 1500, "num_frames": 16, "image_size": 224},
    ("alpro_qa", "msvd"): {"num_classes": 2423, "num_frames": 16, "image_size": 224},
    ("timesformer", "base"): {},
})
# the GPT-2 video dialogue, as configs/models/gpt_dialogue/base.yaml gives it (the
# dataclass's GPT-2 base, len_video_ft 4224); its run YAMLs name no model type and
# override ``gpt: {vocab_size: 50264}`` (GPT-2's 50,257 and the 7 dialogue tokens)
DIALOGUE_MODELS = ("gpt_dialogue",)
FAMILY_CONFIGS.update({("gpt_dialogue", "pretrain"): {}, ("gpt_dialogue", "base"): {}})
# the composed pipelines, as configs/models/{pnp_vqa,img2prompt_vqa}/*.yaml give
# them: the three sub-models by (arch, model_type); PNP-VQA's reader's size is the
# model type, Img2Prompt's question generator the plain t5-large (``arch: t5``)
_PIPELINE_TOWERS = {
    "prompt": "a picture of ",
    "image_question_matching_model": {"arch": "blip_image_text_matching",
                                      "model_type": "large"},
    "image_captioning_model": {"arch": "blip_caption", "model_type": "large_coco"}}
PIPELINE_CONFIGS = {
    ("pnp_vqa", size): {
        **_PIPELINE_TOWERS,
        "question_answering_model": {"arch": "pnp_unifiedqav2_fid", "model_type": size}}
    for size in ("base", "large", "3b")}
PIPELINE_CONFIGS[("img2prompt_vqa", "base")] = {
    **_PIPELINE_TOWERS, "question_answering_model": {"arch": "t5", "t5_model": "t5-large"}}
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
    "text_config_override": (QFormerConfig, {"attention_dropout_rate", "initializer_range"}),
    "decoder_config_override": (QFormerConfig, {"attention_dropout_rate", "initializer_range"}),
    # CLIP's towers (configs/models/clip/*.yaml)
    "vision": (ViTConfig, {"scan_blocks"}),
    "text": (ClipTextConfig, set()),
    "vision_resnet": (ResNetConfig, set()),
    # ALPRO's TimeSformer (configs/models/alpro_*)
    "video_config_override": (TimeSformerConfig, set()),
    # the dialogue's GPT-2 (run YAMLs: ``gpt: {vocab_size: 50264}``); the JAX field
    # ``dtype`` is fp32 there, and the port's model is fp32 throughout
    "gpt": (GPT2Config, {"dtype"}),
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


def family_config(name: str, model_type: str, **overrides: Any):
    """The configuration of a model of :data:`FAMILY_CONFIGS` with
    ``overrides``: its class's ``CONFIG`` dataclass, or for the FiD reader
    the preset of its ``t5_model`` with the T5Config fields replaced. An
    unknown field raises, as in the JAX loader."""
    try:
        fields = {**FAMILY_CONFIGS[(name, model_type)], **coerce_overrides(overrides)}
    except KeyError:
        raise ValueError(f"no port configuration for ({name!r}, {model_type!r}); ported: "
                         f"{sorted(FAMILY_CONFIGS)}") from None
    if "t5_model" in fields:
        base = LLM_KEYS["t5_model"][1](fields.pop("t5_model"))
        return dataclasses.replace(base, **fields)
    return registry.get_model_class(name).CONFIG(**fields)


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
    if (name, model_type) in PIPELINE_CONFIGS:
        raise ValueError(f"{name!r} is a pipeline of three models with their weights: "
                         "load_model assembles it")
    if (name, model_type) in FAMILY_CONFIGS:
        cfg, llm = family_config(name, model_type, **overrides), {}
    else:
        cfg = model_config(name, model_type, **overrides)
        llm = llm_config(name, model_type, **overrides)
    with torch.device("meta"):
        model = cls(cfg, **llm)
    return model.to_empty(device=device)


@torch.no_grad()
def init_weights(model: nn.Module, seed: int = 0) -> None:
    """Random weights from ``torch.Generator(device).manual_seed(seed)``, with
    the JAX package's initialisers: normal(0.02) for dense (the GPT
    dialogue's ``nn.Linear`` and ``Conv1D`` among them), embedding, token
    and position tables (OPT's among them), the std an embedding gives in its
    ``init_std`` (1.0: T5's ``shared`` and relative-position tables; 0.01:
    GPT-2's ``wpe``), zeros for a dense weight whose ``init_std`` is 0 (TimeSformer's
    ``temporal_fc`` after the first block); fan-in normal for the patch conv; zero biases; unit LayerNorms
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
        if isinstance(mod, (LayerNormFP32, FrozenBatchNorm2d, nn.LayerNorm)):
            const(mod.weight, 1.0)
            const(mod.bias, 0.0)
        elif isinstance(mod, (nn.Linear, Conv1D)):  # the GPT dialogue's
            normal(mod.weight, 0.02)
            const(mod.bias, 0.0)
        elif isinstance(mod, T5LayerNorm):
            const(mod.weight, 1.0)
        elif isinstance(mod, Linear):
            if getattr(mod, "init_std", 0.02) == 0.0:  # TimeSformer's later temporal_fc
                const(mod.weight, 0.0)
            else:
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
        elif name == "logit_scale":  # CLIP's log(1 / 0.07)
            const(p, LOGIT_SCALE_INIT)
        elif name.endswith(("in_proj_bias", "q_bias", "v_bias")):
            const(p, 0.0)
        else:  # in_proj_weight, class/positional embeddings, query/prompt/rel tokens
            normal(p, 0.02)
    for name, buf in model.named_buffers():
        if id(buf) in int8_buffers:
            continue
        if name.endswith("position_ids"):
            buf.copy_(torch.arange(buf.shape[-1], device=device)[None])
        elif name.endswith(("running_mean", "running_var")):  # a frozen BatchNorm
            buf.fill_(1.0 if name.endswith("var") else 0.0)
        else:
            raise ValueError(f"init_weights: no rule for buffer {name}")


def load_model(name: str, model_type: str = "pretrain",
               checkpoint_path: Optional[str] = None, *, device="cuda", seed: int = 0,
               **overrides: Any) -> nn.Module:
    """Build a model and fill its weights; returns it in eval mode. A
    pipeline of :data:`PIPELINE_CONFIGS` (``pnp_vqa``, ``img2prompt_vqa``)
    comes from its class's ``from_config`` over its row with ``overrides``
    (each sub-section a dict; ``vocab_path`` for its BERT tokenizer,
    ``qa_tokenizer`` and Img2Prompt's ``tagger`` passed on to the pipeline),
    its sub-models from ``seed``; it takes no ``checkpoint_path`` (a
    sub-section's ``finetuned:`` names its weights)."""
    if (name, model_type) in PIPELINE_CONFIGS:
        if checkpoint_path is not None:
            raise ValueError(f"{name!r} loads each model's weights from its sub-section's "
                             "`finetuned: <path>`, not from one checkpoint")
        mcfg = {**PIPELINE_CONFIGS[(name, model_type)], **overrides}
        kw = {k: mcfg.pop(k) for k in ("vocab_path", "qa_tokenizer", "tagger") if k in mcfg}
        return registry.get_model_class(name).from_config(mcfg, device=_device(device),
                                                          seed=seed, **kw)
    model = build_model(name, model_type, device=device, **overrides)
    if checkpoint_path is None:
        init_weights(model, seed)
    else:
        model.load_state_dict(read_checkpoint(checkpoint_path, model), strict=True)
    return model.eval()


def read_checkpoint(path: str, model: nn.Module) -> dict:
    """The state dict of any of the reference checkpoint flavours, cut to the
    keys ``model`` holds (a released checkpoint also carries the LM head and
    buffers that this model has no module for).

    The HF and LAVIS layouts the JAX readers take (``t5_params_from_hf``,
    ``opt_params_from_hf``, ``llama_params_from_hf``,
    ``blip2_llm_params_from_torch``) load by name, the port's modules having
    HF's names: a T5 v1.0 (``shared.weight``; the ``encoder.`` /
    ``decoder.embed_tokens.weight`` aliases and the tied ``lm_head.weight``
    dropped), a FlanT5 (its own ``lm_head``), an OPT (the tied
    ``lm_head.weight`` dropped, ``embed_positions`` with its offset rows), a
    LLaMA (``rotary_emb.inv_freq`` buffers dropped), and LAVIS's stage-2
    ``blip2_opt`` / ``blip2_t5`` checkpoints, which hold no ``temp``: it
    takes its init value 0.07, as the JAX reader gives it. CLIP reads
    OpenAI's layout (the port's names; a file's ``num_batches_tracked``
    dropped) or an HF ``CLIPModel`` (:func:`~sprc_tpu_torch.models.clip.
    clip_state_from_hf`), as ``sprc_tpu/interop/lavis_import.py:464-474``
    dispatches them; a LAVIS ``blip_cir_base`` file holds med's
    cross-attention, which the text-mode model does not hold (the JAX
    reader skips it too). Any other weight that is missing raises at the
    strict load."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if "model" in state and isinstance(state["model"], dict):
        state = state["model"]  # blip2_pretrained.pth style
    else:  # fine-tuned {epoch, ClassName: state_dict} style (reference utils.py:219-222)
        for value in state.values():
            if isinstance(value, dict) and any(torch.is_tensor(v) for v in value.values()):
                state = value
                break
    own = model.state_dict()
    if "text_model.embeddings.token_embedding.weight" in state and hasattr(model, "ln_final"):
        state = clip_state_from_hf(state, model.cfg)  # an HF CLIPModel file (OpenAI's: by name)
    if getattr(model, "MOMENTUM_LAYOUT", False):
        state = _momentum_family_state(state, model, own)
    if getattr(model, "ALPRO_LAYOUT", False):
        state = _alpro_state(state, own)
    state = {k: v for k, v in state.items() if k in own}
    if "temp" in state:  # some save paths write the scalar as [1]
        state["temp"] = state["temp"].reshape(())
    elif "temp" in own and getattr(model, "LLM_HEAD", False):  # LAVIS stage 2 keeps none
        state["temp"] = torch.tensor(0.07)
    return state


# what a LAVIS checkpoint of the momentum-queue, VQA and classification families
# holds that the port's models do not: the momentum modules and the queue buffers
# (sprc_tpu/interop/lavis_import.py reads neither)
MOMENTUM_CHECKPOINT_DROPS = re.compile(
    r"^(?:(?:visual_encoder_m|text_encoder_m|text_decoder_m|vision_proj_m|text_proj_m|"
    r"cls_head_m)\.|(?:image_queue|text_queue|idx_queue|ptr_queue|queue_ptr)$)")


def _momentum_family_state(state: dict, model: nn.Module, own: dict) -> dict:
    """A LAVIS ``blip_retrieval`` / ``blip_pretrain`` / ``albef_retrieval`` /
    ``albef_pretrain`` / ``blip_vqa`` / ``albef_vqa`` / ``*_classification``
    / ``*_nlvr`` state dict for ``model``, strict: the momentum modules and
    queues (:data:`MOMENTUM_CHECKPOINT_DROPS`) and the LM heads' tied
    ``cls.predictions.bias`` are dropped (a file that holds only that
    bias gives it to ``decoder.bias``, as the JAX readers read it); a
    wrapped ``text_encoder.bert.`` (ALBEF's VQA) feeds a model's
    ``text_encoder.``; an ALBEF pretraining file
    (``text_encoder.bert.``) feeds a retrieval model's ``text_encoder.``,
    its MLM head (``text_encoder.cls.``) dropped, and a BLIP-1 pretraining
    file's decoder (``text_decoder.``) is dropped for a retrieval model, as
    the JAX readers (``albef_retrieval_params_from_torch``,
    ``blip_retrieval_params_from_torch``) take them; any other key the model
    does not hold raises."""
    wraps = any(k.startswith("text_encoder.bert.") for k in own)
    out, unknown = {}, []
    for key, value in state.items():
        if MOMENTUM_CHECKPOINT_DROPS.match(key):
            continue
        if key.endswith("cls.predictions.bias"):
            tied = key.replace("predictions.bias", "predictions.decoder.bias")
            if tied in state:
                continue
            key = tied
        if not wraps and key.startswith("text_encoder.bert."):
            key = "text_encoder." + key[len("text_encoder.bert."):]
        if key not in own and key.startswith(("text_encoder.cls.", "text_decoder.")):
            continue
        if key not in own:
            unknown.append(key)
        out[key] = value
    if unknown:
        raise ValueError(f"{type(model).__name__}: checkpoint keys the model does not hold: "
                         f"{sorted(unknown)[:8]} ({len(unknown)} in all)")
    return out


def _alpro_state(state: dict, own: dict) -> dict:
    """A LAVIS ALPRO state dict (the released msrvtt / didemo / msvd weights,
    as ``sprc_tpu/models/alpro.py::alpro_params_from_torch`` reads it) in the
    port's names: the trunk under ``visual_encoder.model.`` (LAVIS's
    TimeSformer wrapper) or ``visual_encoder.`` feeds ``visual_encoder.``;
    row 0 of the med-BERT's ``token_type_embeddings`` (ALPRO passes all-zero
    type ids) is folded into every position-embedding row, and the table
    dropped; a file without ``position_ids`` gets ``0..n-1``. The keys the
    model does not hold (the BERT pooler, the tower's head) are dropped by
    :func:`read_checkpoint`."""
    out = {}
    for key, value in state.items():
        if key.startswith("visual_encoder.model."):
            key = "visual_encoder." + key[len("visual_encoder.model."):]
        out[key] = value
    types = out.pop("text_encoder.embeddings.token_type_embeddings.weight", None)
    pos = "text_encoder.embeddings.position_embeddings.weight"
    if types is not None and pos in out:
        out[pos] = out[pos] + types[0][None, :]
    ids = "text_encoder.embeddings.position_ids"
    if ids in own and ids not in out:
        out[ids] = torch.arange(own[ids].shape[-1])[None]
    return out


def _image_size(name: str, model_type: str) -> int:
    """The image size of a row's configuration (224 where it has none: the
    pipelines, the dialogue), as the JAX factory reads ``cfg.image_size``."""
    if (name, model_type) in MODEL_CONFIGS:
        return model_config(name, model_type).image_size
    if (name, model_type) in FAMILY_CONFIGS:
        return getattr(family_config(name, model_type), "image_size", 224)
    return 224


def preprocessors(name: str, model_type: str) -> Tuple[dict, dict]:
    """(image processors, text processors), each ``{"train", "eval"}``, as
    the JAX ``load_model_and_preprocess`` gives them (``sprc_tpu/loader.py:
    351-411``): the ALPRO clip processors for the video families (ALPRO,
    TimeSformer); the target-pad transform (ratio 1.25) for the CIR models
    and every ``blip2*`` name; BLIP's train and eval image processors for
    every other model (the dialogue and the pipelines at 224 px); the
    question processor for BLIP-1 / ALBEF's VQA, the caption processor for
    every other model."""
    from sprc_tpu_torch.text.processors import CaptionProcessor, QuestionProcessor

    size = _image_size(name, model_type)
    if name in VIDEO_MODELS:
        from sprc_tpu_torch.data.video_processors import (AlproVideoEvalProcessor,
                                                          AlproVideoTrainProcessor)

        vis = {"train": AlproVideoTrainProcessor(image_size=size),
               "eval": AlproVideoEvalProcessor(image_size=size)}
    elif "cir" in name or name.startswith("blip2"):
        from sprc_tpu_torch.data.transforms import targetpad_transform

        vis = {"train": targetpad_transform(1.25, size), "eval": targetpad_transform(1.25, size)}
    else:
        from sprc_tpu_torch.data.processors import (BlipImageEvalProcessor,
                                                    BlipImageTrainProcessor)

        vis = {"train": BlipImageTrainProcessor(image_size=size),
               "eval": BlipImageEvalProcessor(image_size=size)}
    # the VQA families resolve blip_question for train and eval
    # (configs/models/{blip_vqa,albef_vqa}/*.yaml), the others blip_caption
    text = QuestionProcessor if name in VQA_MODELS else CaptionProcessor
    return vis, {"train": text(), "eval": text()}


def load_model_and_preprocess(name: str, model_type: str = "pretrain",
                              checkpoint_path: Optional[str] = None, *, device="cuda",
                              seed: int = 0, **overrides: Any) -> Tuple[nn.Module, dict, dict]:
    """``(model, vis_processors, txt_processors)``: :func:`load_model` and
    :func:`preprocessors` (the reference factory's return; the JAX one's
    4-tuple also carries ``params``, which the port's module holds)."""
    model = load_model(name, model_type, checkpoint_path, device=device, seed=seed, **overrides)
    vis, txt = preprocessors(name, model_type)
    return model, vis, txt


def load_gpt2_trunk(model: nn.Module, path: str) -> nn.Module:
    """An HF GPT-2 file (``GPT2LMHeadModel`` or ``GPT2Model`` state dict)
    into a ``gpt_dialogue`` model's ``transformer``, strict
    (:func:`~sprc_tpu_torch.models.gpt_dialogue.gpt2_state_from_hf`).
    The file's ``wte`` rows fill the first rows of the model's; the rows
    past them (the dialogue's special tokens: 50264 against GPT-2's 50257)
    keep their seeded init, as after the reference's
    ``resize_token_embeddings``. ``video_ff`` and ``video_ff_out`` keep
    their weights, as JAX's reader reads the trunk only."""
    from sprc_tpu_torch.models.gpt_dialogue import gpt2_state_from_hf

    sd = torch.load(path, map_location="cpu", weights_only=True)
    prefix = "transformer." if any(k.startswith("transformer.") for k in sd) else ""
    state = gpt2_state_from_hf(sd, prefix)
    own = model.transformer.wte.weight
    rows = state["wte.weight"].shape[0]
    if rows > own.shape[0]:
        raise ValueError(f"{path}: wte has {rows} rows, more than the model's "
                         f"vocab_size {own.shape[0]}")
    state["wte.weight"] = torch.cat([state["wte.weight"].to(own.dtype),
                                     own.detach().cpu()[rows:]])
    model.transformer.load_state_dict(state, strict=True)
    return model


class ModelZoo:
    """Every (architecture, model type) of the YAML library
    (``configs/models/<arch>/<type>.yaml``), as ``sprc_tpu.loader.ModelZoo``
    lists them (the reference ``lavis.models.model_zoo``); each one builds in
    the port."""

    def __init__(self) -> None:
        import os

        from sprc_tpu_torch.config import CONFIG_ROOT

        root = os.path.join(CONFIG_ROOT, "models")
        zoo = {}
        for arch in sorted(os.listdir(root)):
            adir = os.path.join(root, arch)
            if os.path.isdir(adir):
                types = sorted(f[:-len(".yaml")] for f in os.listdir(adir) if f.endswith(".yaml"))
                if types:
                    zoo[arch] = types
        self.model_zoo = zoo

    def __str__(self) -> str:
        return ("=" * 50 + "\n" + f"{'Architectures':<30} {'Types'}\n" + "=" * 50 + "\n"
                + "\n".join(f"{name:<30} {', '.join(types)}"
                            for name, types in self.model_zoo.items()))

    def __iter__(self):
        return iter(self.model_zoo.items())

    def __len__(self) -> int:
        return sum(len(v) for v in self.model_zoo.values())


model_zoo = ModelZoo()


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
           "MOMENTUM_MODELS", "VQA_MODELS", "CLASSIFICATION_MODELS", "CIR_FEATURE_MODELS",
           "CLIP_MODELS", "VIDEO_MODELS", "DIALOGUE_MODELS",
           "MOMENTUM_CHECKPOINT_DROPS", "preprocessors", "load_model_and_preprocess",
           "load_gpt2_trunk", "ModelZoo", "model_zoo",
           "GENERATION_KEYS", "FAMILY_CONFIGS", "PIPELINE_CONFIGS", "family_config",
           "MODEL_CONFIGS", "model_config", "llm_config", "coerce_overrides", "build_model",
           "init_weights",
           "load_model", "read_checkpoint", "calibrate_vit_act_scales"]
