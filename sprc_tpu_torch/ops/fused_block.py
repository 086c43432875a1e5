"""Kernels K2, K5, K6 and K7: one pre-LN ViT block, ``x + proj(MHA(LN1 x))``
then ``y + fc2(act(fc1(LN2 y)))``, in bf16/fp32 (K2), with the four dense ops
in int8 (K5), and its two halves on their own (K6 ``fused_attn_block``, K7
``fused_mlp_block``, at the end of this file).

Replaces ``sprc_tpu/ops/pallas_block.py::fused_vit_block`` (``_full_kernel``),
which runs a whole block as one Pallas program with the block's weights
resident in VMEM. A ViT-L block's weights (about 25 MB in bf16) do not fit
an SM's shared memory, so on Hopper the block is a chain of seven launches
of the kernels in ``csrc/`` (see :mod:`.primitives`):

    LN1 -> qkv GEMM (+bias) -> attention on the packed qkv, read in place
        -> proj GEMM (+bias, +x residual) -> LN2 -> fc1 GEMM (+bias, act)
        -> fc2 GEMM (+bias, +y residual)

What bounds it on the card: the four GEMMs (about 24 W^2 S flops per image,
tensor-core bound in bf16) and the attention (4 S^2 W flops on the CUDA
cores in fp32). The design keeps the residual adds, biases and the
activation in the GEMM epilogues and reads q/k/v straight out of the qkv
output, so the only activations that reach device memory between launches
are the ones the chain needs (h, qkv, ctx, y, u, hid).

Numerics (the JAX kernel's): fp32 LayerNorm, matmuls with fp32
accumulation, bias and activation in fp32, residuals in the model dtype.
Weights are ``[out, in]``.

The wrappers serve (they raise under grad); a trainable tower calls K2, K6
and K7 through :class:`FusedViTBlock`, :class:`FusedAttnBlock` and
:class:`FusedMlpBlock` (the kernel forward, autograd over the plain version
recomputed in the backward, as the JAX custom VJPs; at the end of this
file).
"""

from __future__ import annotations

from typing import Optional

import torch

from sprc_tpu_torch.ops import primitives

Tensor = torch.Tensor


def _block(ops, x, l1s, l1b, wqkv, bqkv, wproj, bproj, l2s, l2b, w1, b1, w2, b2,
           *, heads: int, eps: float, scale: float, quick: bool) -> Tensor:
    W = x.shape[-1]
    h = ops.layer_norm(x, l1s, l1b, eps)
    qkv = ops.gemm(h, wqkv, bqkv)
    ctx = ops.attention(qkv[..., :W], qkv[..., W:2 * W], qkv[..., 2 * W:], heads, scale)
    y = ops.gemm(ctx, wproj, bproj, residual=x)
    u = ops.layer_norm(y, l2s, l2b, eps)
    hid = ops.gemm(u, w1, b1, act="quick_gelu" if quick else "gelu")
    return ops.gemm(hid, w2, b2, residual=y)


def fused_vit_block_plain(x: Tensor, *params: Optional[Tensor], heads: int, eps: float,
                          scale: float, quick: bool) -> Tensor:
    """The same block in plain PyTorch, on any device (the reference)."""
    return _block(primitives.PLAIN, x, *params, heads=heads, eps=eps, scale=scale, quick=quick)


def fused_vit_block(x: Tensor, *params: Optional[Tensor], heads: int, eps: float,
                    scale: float, quick: bool) -> Tensor:
    """x [B, S, W] -> [B, S, W]. ``params`` = (l1s, l1b, wqkv [3W, W], bqkv,
    wproj [W, W], bproj, l2s, l2b, w1 [M, W], b1, w2 [W, M], b2). On a CUDA
    tensor it launches the kernel chain (and raises on what it does not
    take); on a CPU tensor it runs the plain version. ``launches`` counts
    the chains launched in full (seven kernel launches each)."""
    primitives.check_no_grad("fused_vit_block", x, *params)
    ops = primitives.for_device(x)
    y = _block(ops, x, *params, heads=heads, eps=eps, scale=scale, quick=quick)
    if ops is primitives.CUDA:
        fused_vit_block.launches += 1
    return y


fused_vit_block.launches = 0


# ------------------------------------------------------------------- K5
#
# Replaces ``sprc_tpu/ops/pallas_block.py::fused_vit_block_i8``
# (``_full_kernel_i8``): the same block with the four dense ops as
# s8 x s8 -> s32 products. Weights arrive as int8 codes ``[out, in]`` with
# per-out-channel scales (``quant.quantize_weight`` of the fp32 weight);
# activations are quantised with the calibrated static per-tensor scales
# ``acts = (a_qkv, a_proj, a_fc1, a_fc2)``; each product is rescaled in fp32
# by ``w_scale * a`` and gets its bias there. The chain, eight launches:
#
#     LN1 -> s8 | qkv GEMM (-> model dtype) | attention | ctx -> s8
#         | proj GEMM (+bias, +x) | LN2 -> s8 | fc1 GEMM (+bias, act, -> s8)
#         | fc2 GEMM (+bias, +y)
#
# Both LayerNorms and the fc1 epilogue write int8 straight from their fp32
# values, as the TPU kernel's ``_q8`` takes them: no rounding to the model
# dtype in between, and a quarter (LN) or half (hid) of the bytes of the bf16
# chain. The attention is K2's kernel, unchanged. What bounds it: the four
# products, 24 W^2 S integer operations per image against the s8 tensor-core
# rate. The rescale vectors ``w_scale * a`` are not materialised: the GEMM's
# epilogue forms each product from ``w_scale[n]`` and ``col_alpha = a``.


def _block_i8(ops, x, l1s, l1b, wqkv8, sqkv, bqkv, wproj8, sproj, bproj, l2s, l2b,
              w18, s1, b1, w28, s2, b2, *, heads: int, eps: float, scale: float, quick: bool,
              acts) -> Tensor:
    W = x.shape[-1]
    a_qkv, a_proj, a_fc1, a_fc2 = map(float, acts)
    h8 = ops.layer_norm(x, l1s, l1b, eps, out_scale=a_qkv)
    qkv = ops.gemm_i8(h8, wqkv8, sqkv, bqkv, col_alpha=a_qkv, out_dtype=x.dtype)
    ctx = ops.attention(qkv[..., :W], qkv[..., W:2 * W], qkv[..., 2 * W:], heads, scale)
    c8 = ops.quantize_static(ctx, a_proj)
    y = ops.gemm_i8(c8, wproj8, sproj, bproj, col_alpha=a_proj, out_dtype=x.dtype, residual=x)
    u8 = ops.layer_norm(y, l2s, l2b, eps, out_scale=a_fc1)
    hid8 = ops.gemm_i8(u8, w18, s1, b1, col_alpha=a_fc1,
                       act="quick_gelu" if quick else "gelu", out_scale=a_fc2)
    return ops.gemm_i8(hid8, w28, s2, b2, col_alpha=a_fc2, out_dtype=x.dtype, residual=y)


def fused_vit_block_i8_plain(x: Tensor, *params: Tensor, heads: int, eps: float, scale: float,
                             quick: bool, acts) -> Tensor:
    """The same int8 block in plain PyTorch, on any device (the reference)."""
    return _block_i8(primitives.PLAIN, x, *params, heads=heads, eps=eps, scale=scale,
                     quick=quick, acts=acts)


def fused_vit_block_i8(x: Tensor, *params: Tensor, heads: int, eps: float, scale: float,
                       quick: bool, acts) -> Tensor:
    """x [B, S, W] -> [B, S, W]. ``params`` = (l1s, l1b, wqkv8 [3W, W] int8,
    sqkv [3W], bqkv, wproj8, sproj, bproj, l2s, l2b, w18, s1, b1, w28, s2,
    b2), the JAX kernel's order; ``acts`` the static activation scales
    (qkv, proj, fc1, fc2). On a CUDA tensor it launches the kernel chain (and
    raises on what it does not take); on a CPU tensor it runs the plain
    version. ``launches`` counts the chains launched in full."""
    primitives.check_no_grad("fused_vit_block_i8", x, *params)
    ops = primitives.for_device(x)
    y = _block_i8(ops, x, *params, heads=heads, eps=eps, scale=scale, quick=quick, acts=acts)
    if ops is primitives.CUDA:
        fused_vit_block_i8.launches += 1
    return y


fused_vit_block_i8.launches = 0


# ------------------------------------------------------------------- K6
#
# Replaces ``sprc_tpu/ops/pallas_block.py::fused_attn_block`` (``_kernel``):
# the attention half, ``x + bf16(proj(MHA(bf16(LN_f32 x) Wqkv + bqkv)))``. On
# the TPU its point is that Wqkv and Wproj (8 MB in bf16 at W = 1024, 15.9 MB
# at 1408) stay in VMEM across the grid; an SM has 227 KB, so on Hopper it is
# the first four launches of K2's chain:
#
#     LN (fp32, rounds to the model dtype) -> qkv GEMM (+bias, rounds)
#         -> attention on the packed qkv, read in place
#         -> proj GEMM (+bias, rounds; + x in the model dtype)
#
# The Pallas body scales q by ``scale * log2(e)`` before the product, takes
# exp2 without a max subtraction (clamped at 120) and divides after ``P V``;
# the attention kernel here keeps its max-subtracted online softmax, which is
# equal in exact arithmetic and decides what a fully masked row gives. The
# plain version is the unfused composition (``pallas_block._xla_ref``).


def _attn_half(ops, x, ln_s, ln_b, wqkv, bqkv, wproj, bproj, *, heads: int, eps: float,
               scale: float) -> Tensor:
    W = x.shape[-1]
    h = ops.layer_norm(x, ln_s, ln_b, eps)
    qkv = ops.gemm(h, wqkv, bqkv)
    ctx = ops.attention(qkv[..., :W], qkv[..., W:2 * W], qkv[..., 2 * W:], heads, scale)
    return ops.gemm(ctx, wproj, bproj, residual=x)


def fused_attn_block_plain(x: Tensor, *params: Tensor, heads: int, eps: float,
                           scale: float) -> Tensor:
    """The same half block in plain PyTorch, on any device (the reference)."""
    return _attn_half(primitives.PLAIN, x, *params, heads=heads, eps=eps, scale=scale)


def fused_attn_block(x: Tensor, *params: Tensor, heads: int, eps: float, scale: float) -> Tensor:
    """x [B, S, W] -> [B, S, W]. ``params`` = (ln_s, ln_b, wqkv [3W, W] packed
    q|k|v, bqkv [3W], wproj [W, W], bproj). On a CUDA tensor it launches the
    kernel chain (and raises on what it does not take); on a CPU tensor it
    runs the plain version. ``launches`` counts the chains launched in full
    (four kernel launches each)."""
    primitives.check_no_grad("fused_attn_block", x, *params)
    ops = primitives.for_device(x)
    y = _attn_half(ops, x, *params, heads=heads, eps=eps, scale=scale)
    if ops is primitives.CUDA:
        fused_attn_block.launches += 1
    return y


fused_attn_block.launches = 0


# ------------------------------------------------------------------- K7
#
# Replaces ``sprc_tpu/ops/pallas_mlp.py::fused_mlp_block`` (``_mlp_kernel``):
# the MLP half, ``x + fc2(act(fc1(LN x)))``. On the TPU the hidden activation
# [B S, M] never reaches HBM: the grid streams M in chunks of 512 against an
# fp32 accumulator of [512, W] in VMEM. The same design does not fit an SM:
# an fp32 accumulator of even [64, 1024] is 256 KB, the whole register file,
# and with row tiles that small the 16.8 MB of weights (34.6 MB for EVA
# ViT-g) would be read again for every tile, several GB per block at
# B = 64, against 2 x 16448 x 4096 x 2 bytes = 270 MB (0.08 ms at 3.35 TB/s)
# for writing the hidden activation in bf16 and reading it back, much of it
# from the 50 MB L2. So on Hopper it is three launches:
#
#     LN (fp32, rounds) -> fc1 GEMM (+bias, act in fp32, rounds to the model
#         dtype: the kernel's ``h.astype(w2.dtype)``)
#         -> fc2 GEMM (+bias, + x in fp32, then the one rounding)
#
# The last step is where this kernel differs from K2 and K6, which round the
# branch and add the residual in the model dtype: ``acc + b2 + f32(x)`` and
# one cast (the GEMM's ``residual_f32`` epilogue). The JAX kernel gives way
# to XLA when M is not a multiple of 512; the GEMM here has no such limit.
# Exact GELU is ``erff`` (the Pallas kernel's rational erf is the same
# function to 1.5e-7).


def _mlp_half(ops, x, ln_s, ln_b, w1, b1, w2, b2, *, eps: float, quick: bool) -> Tensor:
    u = ops.layer_norm(x, ln_s, ln_b, eps)
    hid = ops.gemm(u, w1, b1, act="quick_gelu" if quick else "gelu")
    return ops.gemm(hid, w2, b2, residual=x, residual_f32=True)


def fused_mlp_block_plain(x: Tensor, *params: Tensor, eps: float, quick: bool) -> Tensor:
    """The same half block in plain PyTorch, on any device (the reference)."""
    return _mlp_half(primitives.PLAIN, x, *params, eps=eps, quick=quick)


def fused_mlp_block(x: Tensor, *params: Tensor, eps: float, quick: bool) -> Tensor:
    """x [B, S, W] -> [B, S, W]. ``params`` = (ln_s, ln_b, w1 [M, W], b1,
    w2 [W, M], b2). On a CUDA tensor it launches the kernel chain (and raises
    on what it does not take); on a CPU tensor it runs the plain version.
    ``launches`` counts the chains launched in full (three kernel launches
    each)."""
    primitives.check_no_grad("fused_mlp_block", x, *params)
    ops = primitives.for_device(x)
    y = _mlp_half(ops, x, *params, eps=eps, quick=quick)
    if ops is primitives.CUDA:
        fused_mlp_block.launches += 1
    return y


fused_mlp_block.launches = 0


# ------------------------------------------------------- with a gradient
#
# The JAX package gives K2, K6 and K7 custom VJPs whose forward is the
# Pallas kernel and whose backward is ``jax.vjp`` over the XLA composition
# (``pallas_block.py:608-662``, ``pallas_mlp.py:128-148``); they save only
# the block's input and parameters. These Functions do the same over the
# wrappers and the plain versions: a trainable tower keeps one input a
# block (39 of [B, 677, 1408] fp32 for the COCO tower) and recomputes each
# block's intermediates in its backward. K5 (int8) serves only, in both
# packages, and has none.


class FusedViTBlock(primitives.RecomputedVJP):
    """:func:`fused_vit_block` with a gradient: ``FusedViTBlock.call(x,
    *params, heads=, eps=, scale=, quick=)``."""

    kernel = fused_vit_block
    plain = fused_vit_block_plain


class FusedAttnBlock(primitives.RecomputedVJP):
    """:func:`fused_attn_block` with a gradient."""

    kernel = fused_attn_block
    plain = fused_attn_block_plain


class FusedMlpBlock(primitives.RecomputedVJP):
    """:func:`fused_mlp_block` with a gradient."""

    kernel = fused_mlp_block
    plain = fused_mlp_block_plain
