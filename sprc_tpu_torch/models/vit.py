"""Frozen CLIP ViT-L vision tower (counterpart of ``sprc_tpu/models/vit.py``).

CLIP ViT-L/14 as BLIP-2 uses it (reference clip_vit.py:242-263): patch 14,
width 1024, 23 blocks (the 24th dropped), 16 heads, MLP 4096, QuickGELU,
``ln_pre``, packed qkv with bias, no final LayerNorm. Module and parameter
names follow the reference torch module, so the state-dict keys are the ones
``sprc_tpu/interop/torch_export.py::clip_vit_to_torch`` emits
(``visual_encoder.transformer.resblocks.{i}.attn.in_proj_weight``, ...).

Images enter NHWC, as in the JAX package; the patchify conv transposes them
internally. The tower runs in ``config.dtype`` (bf16 on the card): its
matmul weights are held in that dtype, LayerNorms and biases in fp32.
Every block calls kernel K2's wrapper
(:func:`sprc_tpu_torch.ops.fused_block.fused_vit_block`), which launches the
kernel on CUDA tensors and is inference-only; only inside
:func:`sprc_tpu_torch.ops.primitives.plain_reference` does a block run its
plain PyTorch version.

``ViTConfig.quant`` switches the four dense ops of every block to int8
(serving only; the tower is frozen), as in the JAX package:

- ``"int8_static"``: calibrated per-tensor activation scales from
  ``ViTConfig.act_scales``; every block calls kernel K5's wrapper
  (:func:`sprc_tpu_torch.ops.fused_block.fused_vit_block_i8`);
- ``"int8"``: dynamic per-token activation scales, the unfused block in plain
  PyTorch over :mod:`sprc_tpu_torch.ops.quant` (XLA ops in the JAX package,
  no kernel there or here);
- ``"int8_calib"``: the same, and each dense op's input amax is recorded for
  :func:`calibrate_act_scales`.

The int8 codes and scales of the weights are derived state (non-persistent
buffers, made from the fp32 source in ``load_state_dict`` and
``loader.init_weights``), so the state-dict keys are the same in every mode.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from sprc_tpu_torch.ops import primitives, quant
from sprc_tpu_torch.ops.fused_block import (fused_vit_block, fused_vit_block_i8,
                                            fused_vit_block_i8_plain, fused_vit_block_plain)
from sprc_tpu_torch.ops.layers import LayerNormFP32, Linear

QUANT_MODES = (None, "int8", "int8_calib", "int8_static")
DENSE_NAMES = ("qkv", "proj", "mlp_fc1", "mlp_fc2")  # the JAX package's names


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 14
    width: int = 1024
    depth: int = 23
    num_heads: int = 16
    mlp_hidden: int = 4096
    layer_norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    quant: Optional[str] = None  # one of QUANT_MODES
    # (("mlp_fc1", s), ("mlp_fc2", s), ("proj", s), ("qkv", s)), shared by all
    # blocks: what calibrate_act_scales returns
    act_scales: Optional[Tuple[Tuple[str, float], ...]] = None

    def __post_init__(self):
        if self.quant not in QUANT_MODES:
            raise ValueError(f"quant {self.quant!r}: expected one of {QUANT_MODES}")

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def seq_len(self) -> int:
        return self.num_patches + 1

    @property
    def head_dim(self) -> int:
        return self.width // self.num_heads


def clip_vit_l_config(image_size: int = 224, dtype: torch.dtype = torch.bfloat16) -> ViTConfig:
    # width/layers/heads per create_clip_vit_L (clip_vit.py:242-250)
    return ViTConfig(image_size=image_size, patch_size=14, width=1024, depth=23, num_heads=16,
                     mlp_hidden=4096, layer_norm_eps=1e-5, dtype=dtype)


class ViTAttention(nn.Module):
    """Parameters of the packed-qkv attention (``nn.MultiheadAttention``
    names); the block applies them."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        W = cfg.width
        self.in_proj_weight = nn.Parameter(torch.empty(3 * W, W, dtype=cfg.dtype))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * W))
        self.out_proj = Linear(W, W, dtype=cfg.dtype, int8=cfg.quant is not None)
        if cfg.quant is not None:
            quant.register_int8_weights(self, {"in_proj": "in_proj_weight"})

    def _load_from_state_dict(self, state_dict, prefix, *args):
        quant.load_int8_weights(self, state_dict, prefix)
        super()._load_from_state_dict(state_dict, prefix, *args)


class Mlp(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        int8 = cfg.quant is not None
        self.c_fc = Linear(cfg.width, cfg.mlp_hidden, dtype=cfg.dtype, int8=int8)
        self.c_proj = Linear(cfg.mlp_hidden, cfg.width, dtype=cfg.dtype, int8=int8)


class ViTBlock(nn.Module):
    """Pre-LN block: ``x + attn(ln_1 x)``, then ``y + mlp(ln_2 y)``."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        self.calib_amax: Dict[str, torch.Tensor] = {}  # filled under quant="int8_calib"
        self.ln_1 = LayerNormFP32(cfg.width, cfg.layer_norm_eps)
        self.attn = ViTAttention(cfg)
        self.ln_2 = LayerNormFP32(cfg.width, cfg.layer_norm_eps)
        self.mlp = Mlp(cfg)

    def kernel_params(self):
        a, m = self.attn, self.mlp
        return (self.ln_1.weight, self.ln_1.bias, a.in_proj_weight, a.in_proj_bias,
                a.out_proj.weight, a.out_proj.bias, self.ln_2.weight, self.ln_2.bias,
                m.c_fc.weight, m.c_fc.bias, m.c_proj.weight, m.c_proj.bias)

    def kernel_params_i8(self):
        """K5's parameters: each dense weight as (codes, scale, bias)."""
        a, m = self.attn, self.mlp
        return (self.ln_1.weight, self.ln_1.bias, *quant.int8_weight(a, "in_proj"),
                a.in_proj_bias, *a.out_proj.int8_params(), self.ln_2.weight, self.ln_2.bias,
                *m.c_fc.int8_params(), *m.c_proj.int8_params())

    def _forward_dynamic_int8(self, x: torch.Tensor) -> torch.Tensor:
        """The unfused block with dynamic per-token int8 dense ops (the JAX
        package's ``_block_dense`` route for ``"int8"`` / ``"int8_calib"``),
        in plain PyTorch on any device. Under ``"int8_calib"`` the amax of
        each dense op's input is kept in ``self.calib_amax``."""
        cfg, a, m = self.cfg, self.attn, self.mlp
        W = cfg.width

        def dense(name, h, w8, ws, b):
            if cfg.quant == "int8_calib":
                amax = h.float().abs().max()
                prev = self.calib_amax.get(name)
                self.calib_amax[name] = amax if prev is None else torch.maximum(prev, amax)
            return quant.int8_matmul(h, w8, ws, b, out_dtype=cfg.dtype)

        h = self.ln_1(x)
        qkv = dense("qkv", h, *quant.int8_weight(a, "in_proj"), a.in_proj_bias)
        ctx = primitives.attention_plain(qkv[..., :W], qkv[..., W:2 * W], qkv[..., 2 * W:],
                                         cfg.num_heads, cfg.head_dim ** -0.5)
        x = x + dense("proj", ctx, *a.out_proj.int8_params())
        h = dense("mlp_fc1", self.ln_2(x), *m.c_fc.int8_params())
        return x + dense("mlp_fc2", primitives.quick_gelu(h), *m.c_proj.int8_params())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        kw = dict(heads=cfg.num_heads, eps=cfg.layer_norm_eps, scale=cfg.head_dim ** -0.5,
                  quick=True)
        if cfg.quant is None:
            fn = primitives.kernel_or_reference(fused_vit_block, fused_vit_block_plain)
            return fn(x, *self.kernel_params(), **kw)
        if cfg.quant != "int8_static":
            return self._forward_dynamic_int8(x)
        sc = dict(cfg.act_scales or ())
        fn = primitives.kernel_or_reference(fused_vit_block_i8, fused_vit_block_i8_plain)
        return fn(x, *self.kernel_params_i8(), **kw, acts=tuple(sc[n] for n in DENSE_NAMES))


class Transformer(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.resblocks = nn.ModuleList(ViTBlock(cfg) for _ in range(cfg.depth))


def _require_scales(cfg: ViTConfig) -> None:
    if cfg.quant == "int8_static":
        missing = set(DENSE_NAMES) - set(dict(cfg.act_scales or ()))
        if missing:
            raise ValueError(
                f"quant='int8_static' needs calibrated act_scales (missing {sorted(missing)}); "
                "run calibrate_act_scales with quant='int8_calib' first")


class ClipViT(nn.Module):
    """CLIP ViT-L tower: NHWC images -> the full token sequence [B, S, W]
    in ``config.dtype`` (conv without bias, ln_pre before the blocks)."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        _require_scales(cfg)
        self.cfg = cfg
        W, p = cfg.width, cfg.patch_size
        self.conv1 = nn.Conv2d(3, W, kernel_size=p, stride=p, bias=False, dtype=cfg.dtype)
        self.class_embedding = nn.Parameter(torch.empty(W))
        self.positional_embedding = nn.Parameter(torch.empty(cfg.seq_len, W))
        self.ln_pre = LayerNormFP32(W, cfg.layer_norm_eps)
        self.transformer = Transformer(cfg)

    def set_quant(self, quant: str, act_scales=None) -> None:
        """Switch an int8 tower to another int8 mode over the same weights
        and codes (calibrate in ``"int8_calib"``, then serve in
        ``"int8_static"`` with the scales). A tower built with ``quant=None``
        has no codes: they are derived when the weights are loaded."""
        if self.cfg.quant is None or quant is None:
            raise ValueError("set_quant switches between the int8 modes; the codes are derived "
                             "at load time, so build the tower in an int8 mode")
        cfg = dataclasses.replace(self.cfg, quant=quant, act_scales=act_scales)
        _require_scales(cfg)
        self.cfg = cfg
        for block in self.transformer.resblocks:
            block.cfg = cfg

    def patch_embed(self, images: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] -> [B, N, width] (row-major patch order)."""
        x = self.conv1(images.to(self.conv1.weight.dtype).permute(0, 3, 1, 2))
        return x.flatten(2).transpose(1, 2)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed(images)
        B, _, W = x.shape
        cls = self.class_embedding.to(x.dtype).expand(B, 1, W)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(x.dtype)
        x = self.ln_pre(x)
        for block in self.transformer.resblocks:
            x = block(x)
        return x


def calibrate_act_scales(tower: ClipViT, run) -> Tuple[Tuple[str, float], ...]:
    """Static activation scales from a tower built with
    ``quant="int8_calib"``: ``run()`` sends the calibration images through it
    (any entry point of the model that owns the tower, once or batch by
    batch); the result is ``(("mlp_fc1", s), ..., ("qkv", s))`` with
    ``s = amax / 127`` of each dense op's input, maxed over blocks and
    batches: the ``act_scales`` of a ``quant="int8_static"`` tower."""
    if tower.cfg.quant != "int8_calib":
        raise ValueError("calibrate_act_scales needs a tower built with quant='int8_calib'")
    blocks = tower.transformer.resblocks
    for block in blocks:
        block.calib_amax.clear()
    run()
    best: Dict[str, float] = {}
    for block in blocks:
        for name, amax in block.calib_amax.items():
            best[name] = max(best.get(name, 0.0), float(amax))
    if set(best) != set(DENSE_NAMES):
        raise RuntimeError(f"calibration saw {sorted(best)}; run() must drive the tower")
    return tuple(sorted((k, v / 127.0) for k, v in best.items()))
