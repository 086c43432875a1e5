"""The vision towers: EVA ViT-g, CLIP ViT-L and BLIP-1's timm ViT
(counterpart of ``sprc_tpu/models/vit.py``).

- EVA ViT-g (reference eva_vit.py:428-455): patch 14, width 1408, 39 blocks,
  16 heads of 88, MLP 6144, exact GELU, LN eps 1e-6, a patch conv with bias,
  no ``ln_pre``, fused qkv with separate q and v biases and no k bias.
- CLIP ViT-L/14 as BLIP-2 uses it (reference clip_vit.py:242-263): width
  1024, 23 blocks (the 24th dropped), 16 heads of 64, MLP 4096, QuickGELU,
  ``ln_pre``, packed qkv with bias, a patch conv without bias.

- BLIP-1's timm ViT (reference lavis/models/vit.py; :func:`blip_vit_b_config`,
  and the ViT-L/16 at 384 px of the large ITM and caption YAMLs: width 1024,
  24 blocks, 16 heads of 64, S = 577): exact GELU, LN eps 1e-6, a patch conv
  with bias, no ``ln_pre``, packed qkv with its full bias, and a final
  LayerNorm (``final_norm``), under the EVA tower's names plus ``norm``.

EVA and CLIP have no final LayerNorm: the raw 257-token sequence feeds
``ln_vision``.
Module and parameter names follow the reference torch modules, so the
state-dict keys are the ones ``sprc_tpu/interop/torch_export.py`` emits
(:class:`EvaViT`: ``cls_token``, ``blocks.{i}.attn.qkv.weight``, ``q_bias``;
:class:`ClipViT`: ``class_embedding``,
``transformer.resblocks.{i}.attn.in_proj_weight``, ...), the released
checkpoints'. The two classes differ in those names only; the blocks share
:class:`_Block`.

Images enter NHWC, as in the JAX package; the patchify conv transposes them
internally. The tower runs in ``config.dtype`` (bf16 on the card): its
matmul weights are held in that dtype, LayerNorms and biases in fp32.

A block takes one of three routes, chosen by two ``ViTConfig`` fields that
stand for the JAX package's ``SPRC_PALLAS_BLOCK`` and ``SPRC_PALLAS_MLP``
environment variables (the port reads no environment variable); the
parameters and state-dict keys are the same on every route:

- ``fused_block="block"`` (the default): the whole block through kernel K2's
  wrapper (:func:`sprc_tpu_torch.ops.fused_block.fused_vit_block`);
- ``fused_block="attn"``: the attention half through
  :func:`~sprc_tpu_torch.ops.fused_block.fused_attn_block`, then the MLP half
  unfused or, with ``fused_mlp=True``, through
  :func:`~sprc_tpu_torch.ops.fused_block.fused_mlp_block`;
- ``fused_block="none"``: the unfused block, op by op (LayerNorm, dense, q/v
  bias, attention, dense + residual, ...), whose attention is
  :func:`sprc_tpu_torch.ops.attention.dot_product_attention` and so, on the
  card, the ``flash_attention`` kernel; ``fused_mlp`` applies here too.

Every wrapper launches its kernel on CUDA tensors; the op-by-op pieces run
the kernels of :mod:`sprc_tpu_torch.ops.primitives` on the card; only
inside :func:`sprc_tpu_torch.ops.primitives.plain_reference` does a block
run plain PyTorch there. A trainable tower (``freeze_vit=False``) keeps
its routes: where autograd records, each wrapper is called through its
autograd Function (``FusedViTBlock``, ``FusedAttnBlock``, ``FusedMlpBlock``,
``FlashAttention``: the kernel forward, the plain version recomputed in the
backward, as the JAX custom VJPs), and the op-by-op pieces compute their
dense ops and LayerNorms with the plain set (``torch.matmul``, as XLA
computes them in the JAX package), their attention through
``FlashAttention``. ``ViTConfig.remat`` (the JAX ``remat``, the YAML's
``use_grad_checkpoint``) keeps only each block's input for the backward
where a block would keep its intermediates: on the unfused pieces, and on
every route inside ``plain_reference``; the Functions keep only their
inputs anyway.

``ViTConfig.quant`` switches the four dense ops of every block to int8
(serving only: ``CirConfig`` refuses it with ``freeze_vit=False``), as in
the JAX package:

- ``"int8_static"``: calibrated per-tensor activation scales from
  ``ViTConfig.act_scales``; every block calls kernel K5's wrapper
  (:func:`sprc_tpu_torch.ops.fused_block.fused_vit_block_i8`); the whole-block
  route only;
- ``"int8"``: dynamic per-token activation scales, the unfused block with its
  dense ops in plain PyTorch over :mod:`sprc_tpu_torch.ops.quant` (XLA ops in
  the JAX package) and its attention through ``dot_product_attention``
  (``flash_attention`` on the card, as in the JAX package); always the
  unfused route, whatever ``fused_block`` says;
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
from sprc_tpu_torch.ops.attention import dot_product_attention
from sprc_tpu_torch.ops.fused_block import (FusedAttnBlock, FusedMlpBlock, FusedViTBlock,
                                            fused_vit_block_i8, fused_vit_block_i8_plain)
from sprc_tpu_torch.ops.layers import LayerNormFP32, Linear, recompute

QUANT_MODES = (None, "int8", "int8_calib", "int8_static")
FUSED_BLOCK_ROUTES = ("block", "attn", "none")  # SPRC_PALLAS_BLOCK = 1 / attn / 0
DENSE_NAMES = ("qkv", "proj", "mlp_fc1", "mlp_fc2")  # the JAX package's names


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 14
    width: int = 1408
    depth: int = 39
    num_heads: int = 16
    mlp_hidden: int = 6144
    layer_norm_eps: float = 1e-6
    use_ln_pre: bool = False  # CLIP-style pre-transformer LN
    qkv_fused_no_kbias: bool = False  # EVA-style q/v bias, no k bias
    quick_gelu: bool = False
    final_norm: bool = False  # BLIP-1's timm tower ends in a LayerNorm
    patch_bias: bool = True  # CLIP's conv1 has no bias
    dtype: torch.dtype = torch.bfloat16
    fused_block: str = "block"  # one of FUSED_BLOCK_ROUTES
    fused_mlp: bool = False  # the MLP half through fused_mlp_block
    quant: Optional[str] = None  # one of QUANT_MODES
    # (("mlp_fc1", s), ("mlp_fc2", s), ("proj", s), ("qkv", s)), shared by all
    # blocks: what calibrate_act_scales returns
    act_scales: Optional[Tuple[Tuple[str, float], ...]] = None
    remat: bool = False  # keep only each block's input for the backward (training)

    def __post_init__(self):
        if self.quant not in QUANT_MODES:
            raise ValueError(f"quant {self.quant!r}: expected one of {QUANT_MODES}")
        if self.fused_block not in FUSED_BLOCK_ROUTES:
            raise ValueError(f"fused_block {self.fused_block!r}: expected one of "
                             f"{FUSED_BLOCK_ROUTES}")
        if self.fused_mlp and self.fused_block == "block":
            raise ValueError("fused_mlp=True needs fused_block='attn' or 'none': the whole-block "
                             "kernel already holds the MLP half")
        if self.quant is not None and self.fused_mlp:
            raise ValueError("fused_mlp=True is a bf16/fp32 route; the int8 modes have none")
        if self.quant == "int8_static" and self.fused_block != "block":
            raise ValueError("quant='int8_static' runs the whole-block int8 kernel: "
                             "fused_block='block' only")

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def seq_len(self) -> int:
        return self.num_patches + 1

    @property
    def head_dim(self) -> int:
        return self.width // self.num_heads

    @property
    def act(self) -> str:
        return "quick_gelu" if self.quick_gelu else "gelu"


def eva_vit_g_config(image_size: int = 224, dtype: torch.dtype = torch.bfloat16) -> ViTConfig:
    # depth/width/heads/mlp per create_eva_vit_g (eva_vit.py:428-441);
    # mlp hidden = int(1408 * 4.3637) = 6144
    return ViTConfig(image_size=image_size, patch_size=14, width=1408, depth=39,
                     num_heads=1408 // 88, mlp_hidden=int(1408 * 4.3637), layer_norm_eps=1e-6,
                     qkv_fused_no_kbias=True, dtype=dtype)


def clip_vit_l_config(image_size: int = 224, dtype: torch.dtype = torch.bfloat16) -> ViTConfig:
    # width/layers/heads per create_clip_vit_L (clip_vit.py:242-250)
    return ViTConfig(image_size=image_size, patch_size=14, width=1024, depth=23, num_heads=16,
                     mlp_hidden=4096, layer_norm_eps=1e-5, use_ln_pre=True, quick_gelu=True,
                     patch_bias=False, dtype=dtype)


def blip_vit_b_config(image_size: int = 224, dtype: torch.dtype = torch.bfloat16) -> ViTConfig:
    # BLIP-1's ViT-B/16 (reference vit.py:476-487): timm's ViT with a final
    # LayerNorm, packed qkv with bias, exact GELU, no ln_pre
    return ViTConfig(image_size=image_size, patch_size=16, width=768, depth=12, num_heads=12,
                     mlp_hidden=3072, layer_norm_eps=1e-6, final_norm=True, dtype=dtype)


class _Block(nn.Module):
    """Pre-LN block: ``x + attn(LN1 x)``, then ``y + mlp(LN2 y)``. The
    subclasses create the parameters under their checkpoint's names and say
    where they are (:meth:`_parts`); the routes are written once here."""

    cfg: ViTConfig

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        self.calib_amax: Dict[str, torch.Tensor] = {}  # filled under quant="int8_calib"

    def _parts(self):
        """(LN1, proj Linear, LN2, fc1 Linear, fc2 Linear)."""
        raise NotImplementedError

    def _qkv_weight(self) -> torch.Tensor:
        raise NotImplementedError

    def _qkv_int8(self) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def _qkv_dense_bias(self) -> Optional[torch.Tensor]:
        """The bias of the unfused qkv dense op (EVA's has none)."""
        raise NotImplementedError

    def _qv_bias(self) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        """EVA's separate q and v biases, added after the unfused dense op."""
        return None

    def _qkv_bias_packed(self) -> torch.Tensor:
        """The fused kernels' [3W] fp32 bias; EVA's is ``[q_bias | 0 | v_bias]``."""
        qv = self._qv_bias()
        if qv is None:
            return self._qkv_dense_bias()
        return torch.cat([qv[0], torch.zeros_like(qv[0]), qv[1]])

    def kernel_params(self):
        ln1, proj, ln2, fc1, fc2 = self._parts()
        return (ln1.weight, ln1.bias, self._qkv_weight(), self._qkv_bias_packed(),
                proj.weight, proj.bias, ln2.weight, ln2.bias,
                fc1.weight, fc1.bias, fc2.weight, fc2.bias)

    def kernel_params_i8(self):
        """K5's parameters: each dense weight as (codes, scale, bias)."""
        ln1, proj, ln2, fc1, fc2 = self._parts()
        return (ln1.weight, ln1.bias, *self._qkv_int8(), self._qkv_bias_packed(),
                *proj.int8_params(), ln2.weight, ln2.bias,
                *fc1.int8_params(), *fc2.int8_params())

    # ---------------------------------------------------- the unfused pieces

    def _attend(self, qkv: torch.Tensor) -> torch.Tensor:
        """Packed qkv [B, S, 3W] (EVA: before its q and v biases) -> ctx
        [B, S, W] through ``dot_product_attention`` on BSHD views."""
        cfg = self.cfg
        B, S, _ = qkv.shape
        W, H, D = cfg.width, cfg.num_heads, cfg.head_dim
        q, k, v = qkv[..., :W], qkv[..., W:2 * W], qkv[..., 2 * W:]
        qv = self._qv_bias()
        if qv is not None:
            q, v = q + qv[0].to(q.dtype), v + qv[1].to(v.dtype)
        ctx = dot_product_attention(q.view(B, S, H, D), k.view(B, S, H, D), v.view(B, S, H, D))
        return ctx.reshape(B, S, W)

    def _attn_unfused(self, x: torch.Tensor) -> torch.Tensor:
        ln1, proj, _, _, _ = self._parts()
        ops = primitives.ops_for(x, ln1.weight, proj.weight)
        h = ops.layer_norm(x, ln1.weight, ln1.bias, self.cfg.layer_norm_eps)
        ctx = self._attend(ops.gemm(h, self._qkv_weight(), self._qkv_dense_bias()))
        return ops.gemm(ctx, proj.weight, proj.bias, residual=x)

    def _mlp_unfused(self, x: torch.Tensor) -> torch.Tensor:
        _, _, ln2, fc1, fc2 = self._parts()
        ops = primitives.ops_for(x, ln2.weight, fc1.weight)
        h = ops.layer_norm(x, ln2.weight, ln2.bias, self.cfg.layer_norm_eps)
        h = primitives.ACT_FNS[self.cfg.act](ops.gemm(h, fc1.weight, fc1.bias))
        return ops.gemm(h, fc2.weight, fc2.bias, residual=x)

    def _forward_dynamic_int8(self, x: torch.Tensor) -> torch.Tensor:
        """The unfused block with dynamic per-token int8 dense ops (the JAX
        package's ``_block_dense`` route for ``"int8"`` / ``"int8_calib"``):
        the dense ops in plain PyTorch on any device, the attention through
        ``dot_product_attention``. Under ``"int8_calib"`` the amax of each
        dense op's input is kept in ``self.calib_amax``."""
        cfg = self.cfg
        ln1, proj, ln2, fc1, fc2 = self._parts()

        def dense(name, h, w8, ws, b):
            if cfg.quant == "int8_calib":
                amax = h.float().abs().max()
                prev = self.calib_amax.get(name)
                self.calib_amax[name] = amax if prev is None else torch.maximum(prev, amax)
            return quant.int8_matmul(h, w8, ws, b, out_dtype=cfg.dtype)

        qkv = dense("qkv", ln1(x), *self._qkv_int8(), self._qkv_dense_bias())
        x = x + dense("proj", self._attend(qkv), *proj.int8_params())
        h = dense("mlp_fc1", ln2(x), *fc1.int8_params())
        return x + dense("mlp_fc2", primitives.ACT_FNS[cfg.act](h), *fc2.int8_params())

    # ------------------------------------------------------------ the routes

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        # remat where the route keeps more than its input: an op-by-op piece,
        # or any route inside plain_reference (the Functions keep x alone)
        unfused = cfg.fused_block == "none" or (cfg.fused_block == "attn" and not cfg.fused_mlp)
        if (cfg.remat and (unfused or primitives.in_plain_reference())
                and primitives.records(x, *self.parameters())):
            return recompute(self._route, x, always=True)
        return self._route(x)

    def _route(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        attn_kw = dict(heads=cfg.num_heads, eps=cfg.layer_norm_eps, scale=cfg.head_dim ** -0.5)
        kw = dict(attn_kw, quick=cfg.quick_gelu)
        if cfg.quant == "int8_static":
            sc = dict(cfg.act_scales or ())
            fn = primitives.kernel_or_reference(fused_vit_block_i8, fused_vit_block_i8_plain)
            return fn(x, *self.kernel_params_i8(), **kw, acts=tuple(sc[n] for n in DENSE_NAMES))
        if cfg.quant is not None:
            return self._forward_dynamic_int8(x)
        params = self.kernel_params()
        if cfg.fused_block == "block":
            return primitives.dispatch(FusedViTBlock, x, *params, **kw)
        if cfg.fused_block == "attn":
            x = primitives.dispatch(FusedAttnBlock, x, *params[:6], **attn_kw)
        else:
            x = self._attn_unfused(x)
        if cfg.fused_mlp:
            return primitives.dispatch(FusedMlpBlock, x, *params[6:], eps=cfg.layer_norm_eps,
                                       quick=cfg.quick_gelu)
        return self._mlp_unfused(x)


# ------------------------------------------------------------ CLIP's names


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


class ViTBlock(_Block):
    """A block under CLIP's names (``ln_1``, ``attn.in_proj_weight``,
    ``attn.out_proj``, ``ln_2``, ``mlp.c_fc``, ``mlp.c_proj``)."""

    def __init__(self, cfg: ViTConfig):
        super().__init__(cfg)
        self.ln_1 = LayerNormFP32(cfg.width, cfg.layer_norm_eps)
        self.attn = ViTAttention(cfg)
        self.ln_2 = LayerNormFP32(cfg.width, cfg.layer_norm_eps)
        self.mlp = Mlp(cfg)

    def _parts(self):
        return self.ln_1, self.attn.out_proj, self.ln_2, self.mlp.c_fc, self.mlp.c_proj

    def _qkv_weight(self):
        return self.attn.in_proj_weight

    def _qkv_int8(self):
        return quant.int8_weight(self.attn, "in_proj")

    def _qkv_dense_bias(self):
        return self.attn.in_proj_bias


class Transformer(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.resblocks = nn.ModuleList(ViTBlock(cfg) for _ in range(cfg.depth))


# ------------------------------------------------------------- EVA's names


class EvaAttention(nn.Module):
    """Parameters of EVA's attention: a fused ``qkv`` without bias, separate
    ``q_bias`` and ``v_bias`` (the k third has none), and ``proj``; timm's
    (BLIP-1, ``qkv_fused_no_kbias=False``): a fused ``qkv`` with its full
    bias, and ``proj``."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        W, int8 = cfg.width, cfg.quant is not None
        eva = cfg.qkv_fused_no_kbias
        self.qkv = Linear(W, 3 * W, dtype=cfg.dtype, int8=int8, bias=not eva)
        if eva:
            self.q_bias = nn.Parameter(torch.empty(W))
            self.v_bias = nn.Parameter(torch.empty(W))
        self.proj = Linear(W, W, dtype=cfg.dtype, int8=int8)


class EvaMlp(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        int8 = cfg.quant is not None
        self.fc1 = Linear(cfg.width, cfg.mlp_hidden, dtype=cfg.dtype, int8=int8)
        self.fc2 = Linear(cfg.mlp_hidden, cfg.width, dtype=cfg.dtype, int8=int8)


class EvaBlock(_Block):
    """A block under EVA's and timm's names (``norm1``, ``attn.qkv``,
    ``attn.q_bias``, ``attn.v_bias`` (EVA), ``attn.proj``, ``norm2``,
    ``mlp.fc1``, ``mlp.fc2``)."""

    def __init__(self, cfg: ViTConfig):
        super().__init__(cfg)
        self.norm1 = LayerNormFP32(cfg.width, cfg.layer_norm_eps)
        self.attn = EvaAttention(cfg)
        self.norm2 = LayerNormFP32(cfg.width, cfg.layer_norm_eps)
        self.mlp = EvaMlp(cfg)

    def _parts(self):
        return self.norm1, self.attn.proj, self.norm2, self.mlp.fc1, self.mlp.fc2

    def _qkv_weight(self):
        return self.attn.qkv.weight

    def _qkv_int8(self):
        return quant.int8_weight(self.attn.qkv, "weight")

    def _qkv_dense_bias(self):
        return self.attn.qkv.bias

    def _qv_bias(self):
        if self.attn.qkv.bias is not None:
            return None
        return self.attn.q_bias, self.attn.v_bias


class PatchEmbed(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        p = cfg.patch_size
        self.proj = nn.Conv2d(3, cfg.width, kernel_size=p, stride=p, bias=True, dtype=cfg.dtype)


# ------------------------------------------------------------- the towers


def _require_scales(cfg: ViTConfig) -> None:
    if cfg.quant == "int8_static":
        missing = set(DENSE_NAMES) - set(dict(cfg.act_scales or ()))
        if missing:
            raise ValueError(
                f"quant='int8_static' needs calibrated act_scales (missing {sorted(missing)}); "
                "run calibrate_act_scales with quant='int8_calib' first")


class _Tower(nn.Module):
    """NHWC images -> the full token sequence [B, S, W] in ``config.dtype``.
    The subclasses hold the parameters under their checkpoint's names."""

    cfg: ViTConfig

    def vit_blocks(self) -> nn.ModuleList:
        raise NotImplementedError

    def _conv(self) -> nn.Conv2d:
        raise NotImplementedError

    def _embeddings(self) -> Tuple[torch.Tensor, torch.Tensor, Optional[LayerNormFP32]]:
        """(cls token [W] or [1, 1, W], positions [S, W] or [1, S, W], ln_pre or None)."""
        raise NotImplementedError

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
        for block in self.vit_blocks():
            block.cfg = cfg

    def patch_embed_tokens(self, images: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] -> [B, N, width] (row-major patch order)."""
        conv = self._conv()
        x = conv(images.to(conv.weight.dtype).permute(0, 3, 1, 2))
        return x.flatten(2).transpose(1, 2)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed_tokens(images)
        B, _, W = x.shape
        cls, pos, ln_pre = self._embeddings()
        x = torch.cat([cls.to(x.dtype).reshape(1, 1, W).expand(B, 1, W), x], dim=1)
        x = x + pos.to(x.dtype)
        if ln_pre is not None:
            x = ln_pre(x)
        for block in self.vit_blocks():
            x = block(x)
        if self.cfg.final_norm:
            x = self.final_norm(x)
        return x

    def final_norm(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(x)


class ClipViT(_Tower):
    """CLIP ViT tower under the CLIP checkpoint's names: a conv without
    bias, ``ln_pre`` before the blocks, packed qkv with bias. BLIP-2's CLIP
    ViT-L ends at its last block; the CLIP models' towers
    (:mod:`sprc_tpu_torch.models.clip`, ``final_norm=True``) end in OpenAI's
    ``ln_post``."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        if not cfg.use_ln_pre or cfg.patch_bias or cfg.qkv_fused_no_kbias:
            raise ValueError("ClipViT holds the CLIP layout: use_ln_pre=True, patch_bias=False, "
                             "qkv_fused_no_kbias=False (EvaViT holds EVA's and BLIP-1's)")
        _require_scales(cfg)
        self.cfg = cfg
        W, p = cfg.width, cfg.patch_size
        self.conv1 = nn.Conv2d(3, W, kernel_size=p, stride=p, bias=False, dtype=cfg.dtype)
        self.class_embedding = nn.Parameter(torch.empty(W))
        self.positional_embedding = nn.Parameter(torch.empty(cfg.seq_len, W))
        self.ln_pre = LayerNormFP32(W, cfg.layer_norm_eps)
        self.transformer = Transformer(cfg)
        if cfg.final_norm:
            self.ln_post = LayerNormFP32(W, cfg.layer_norm_eps)

    def final_norm(self, x: torch.Tensor) -> torch.Tensor:
        return self.ln_post(x)

    def vit_blocks(self):
        return self.transformer.resblocks

    def _conv(self):
        return self.conv1

    def _embeddings(self):
        return self.class_embedding, self.positional_embedding, self.ln_pre


class EvaViT(_Tower):
    """EVA ViT-g tower under the EVA checkpoint's names: a conv with bias, no
    ``ln_pre``, fused qkv with q and v biases only. With
    ``qkv_fused_no_kbias=False`` and ``final_norm=True`` it is BLIP-1's timm
    tower under LAVIS's names (reference lavis/models/vit.py): the same keys
    but the packed qkv's full bias (``blocks.{i}.attn.qkv.bias``) and the
    final LayerNorm ``norm``."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        if cfg.use_ln_pre or not cfg.patch_bias or cfg.qkv_fused_no_kbias == cfg.final_norm:
            raise ValueError("EvaViT holds the EVA layout (use_ln_pre=False, patch_bias=True, "
                             "qkv_fused_no_kbias=True) or BLIP-1's (the same with "
                             "qkv_fused_no_kbias=False, final_norm=True); ClipViT holds CLIP's")
        _require_scales(cfg)
        self.cfg = cfg
        W = cfg.width
        self.cls_token = nn.Parameter(torch.empty(1, 1, W))
        self.pos_embed = nn.Parameter(torch.empty(1, cfg.seq_len, W))
        self.patch_embed = PatchEmbed(cfg)
        self.blocks = nn.ModuleList(EvaBlock(cfg) for _ in range(cfg.depth))
        if cfg.final_norm:
            self.norm = LayerNormFP32(W, cfg.layer_norm_eps)

    def vit_blocks(self):
        return self.blocks

    def _conv(self):
        return self.patch_embed.proj

    def _embeddings(self):
        return self.cls_token, self.pos_embed, None


def build_tower(cfg: ViTConfig) -> _Tower:
    """The tower class whose checkpoint layout ``cfg`` describes."""
    return ClipViT(cfg) if cfg.use_ln_pre else EvaViT(cfg)


def calibrate_act_scales(tower: _Tower, run) -> Tuple[Tuple[str, float], ...]:
    """Static activation scales from a tower built with
    ``quant="int8_calib"``: ``run()`` sends the calibration images through it
    (any entry point of the model that owns the tower, once or batch by
    batch); the result is ``(("mlp_fc1", s), ..., ("qkv", s))`` with
    ``s = amax / 127`` of each dense op's input, maxed over blocks and
    batches: the ``act_scales`` of a ``quant="int8_static"`` tower."""
    if tower.cfg.quant != "int8_calib":
        raise ValueError("calibrate_act_scales needs a tower built with quant='int8_calib'")
    blocks = tower.vit_blocks()
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
