"""Kernels K2 and K5: one pre-LN ViT block, ``x + proj(MHA(LN1 x))`` then
``y + fc2(act(fc1(LN2 y)))``, in bf16/fp32 (K2) and with the four dense ops
in int8 (K5, at the end of this file).

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
