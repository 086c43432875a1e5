"""Attention on BSHD tensors (counterpart of ``sprc_tpu/ops/attention.py``).

``dot_product_attention`` takes pre-projected q/k/v in ``[B, S, H, D]``
layout, the natural output of the qkv matmul, and an optional additive bias
broadcastable to ``[B, H, Sq, Sk]`` (the BERT-style ``(1 - mask) * -10000``
padding bias, added after the scale). Output is ``[B, Sq, H, D]``.

On CUDA tensors, unmasked and with ``Sq >= 128`` (the ViT towers), it
launches kernel K8, :func:`flash_attention`: the port of
``sprc_tpu/ops/pallas_attention.py::flash_attention``, which is the attention
kernel of ``csrc/attention.cu`` reading the BSHD tensors in place. The
Pallas variants of that function (v3, the default, and v4 to v11 behind
``SPRC_ATTN_V``) are TPU schedules of one function and become this one
kernel; its rounding order is that of v9 to v11 (the unnormalised
probabilities are rounded, the division comes after ``P V``), within one bf16
step of v3's (normalise, then round), which the plain version follows.

Otherwise (a bias, a short sequence, CPU tensors) it computes the einsum
path in plain PyTorch, which the JAX package also computes outside any
kernel. Nothing is caught around the kernel: on what the kernel does not
take (a head dim it is not built for) the call raises.

Where autograd records (a trainable tower's unfused route) the kernel goes
through :class:`FlashAttention`: the kernel forward, autograd over
:func:`~sprc_tpu_torch.ops.primitives.flash_attention_plain` recomputed in
the backward, as the JAX package's custom VJP
(``pallas_attention.py:427-448``).
"""

from __future__ import annotations

from typing import Optional

import torch

from sprc_tpu_torch.ops import primitives

Tensor = torch.Tensor

_KERNEL_MIN_SEQ = 128  # the JAX package's _PALLAS_MIN_SEQ


def flash_attention(q: Tensor, k: Tensor, v: Tensor, scale: float) -> Tensor:
    """Kernel K8: unmasked softmax attention, q [B, Sq, H, D], k/v
    [B, Sk, H, D] -> [B, Sq, H, D]. On CUDA tensors it launches the kernel
    (and raises on what the kernel does not take); on CPU tensors it runs
    :func:`sprc_tpu_torch.ops.primitives.flash_attention_plain`.
    ``launches`` counts the kernel's launches."""
    primitives.check_no_grad("flash_attention", q, k, v)
    ops = primitives.for_device(q)
    out = ops.flash_attention(q, k, v, scale)
    if ops is primitives.CUDA:
        flash_attention.launches += 1
    return out


flash_attention.launches = 0


class FlashAttention(primitives.RecomputedVJP):
    """:func:`flash_attention` with a gradient: ``FlashAttention.call(q, k, v,
    scale=)``; it keeps q, k and v for the backward."""

    kernel = flash_attention
    plain = primitives.flash_attention_plain


def dot_product_attention(q: Tensor, k: Tensor, v: Tensor, bias: Optional[Tensor] = None, *,
                          scale: Optional[float] = None) -> Tensor:
    """Multi-head attention over ``[B, S, H, D]`` tensors -> ``[B, Sq, H, D]``;
    ``scale`` defaults to ``D ** -0.5``."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.is_cuda and bias is None and q.shape[1] >= _KERNEL_MIN_SEQ:
        return primitives.dispatch(FlashAttention, q, k, v, scale=scale)
    return primitives.einsum_attention(q, k, v, bias, scale)
