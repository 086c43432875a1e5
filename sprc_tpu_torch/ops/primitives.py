"""The building blocks that the fused ViT block and Q-Former layer chain.

A TPU "fused block" keeps a whole block's weights resident in VMEM and runs
it as one Pallas program. On Hopper the same function is a short chain of
kernels, all in ``csrc/``:

- ``gemm``: ``Y = epi(X . W^T + b)`` with the epilogues none / QuickGELU /
  exact GELU / ``+ residual`` (added in the model dtype after the rounding,
  or with ``residual_f32`` in fp32 before it) (``csrc/gemm.cu``; the bf16
  path is cut as :func:`schedules.gemm_bf16_plan` says, the fp32 path as
  :func:`schedules.gemm_f32_plan`);
- ``attention``: ``softmax(q k^T scale + col_bias) v`` per item and head,
  head dim one of :data:`HEAD_DIMS`, ``Sq != Sk`` allowed
  (``csrc/attention.cu``; :func:`schedules.attention_emulated` and
  :func:`schedules.attention_f32_emulated` walk the bf16 and fp32 paths'
  schedules in plain PyTorch); ``flash_attention`` is the same kernel
  without a bias on BSHD tensors, read in place;
- ``layer_norm``: fp32 LayerNorm of ``x (+ r)`` (``csrc/layernorm.cu``, one
  warp a row; :func:`schedules.layer_norm_emulated` walks its sums), in the
  model dtype or, with ``out_scale``, as int8 codes of the fp32 result;
- ``gemm_i8``: ``Y = epi(s32(A8 . W8^T))``, the int8 dense layer on the
  tensor cores with its rescale, bias, activation, residual and
  re-quantising epilogues (``csrc/gemm_i8.cu``, cut as
  :func:`schedules.gemm_i8_plan` says);
- ``quantize_static`` / ``quantize_rows``: activations to int8 codes with one
  calibrated scale, or with a scale per row (``csrc/quantize.cu``: a 16-byte
  stream, and a warp a row; cut as :func:`schedules.quantize_static_plan` and
  :func:`schedules.quantize_rows_plan` say).

Each comes in two forms with one signature: ``CUDA`` launches the kernel
(and only takes CUDA tensors), ``PLAIN`` is the same math in plain PyTorch
(explicit matmul and softmax) and runs on any device. The chains in
:mod:`.fused_block` and :mod:`.fused_qformer` are written once over either
set, so the plain chain is the kernel chain's reference operation by
operation.

The CUDA set writes into buffers of its own through ``ctypes``, so
autograd records nothing through it: every CUDA primitive, like every
kernel wrapper, raises on a tensor that autograd records through
(:func:`check_no_grad`) rather than return an output without a
``grad_fn``. Training goes through a kernel's :class:`RecomputedVJP`
(the kernel forward, autograd over the plain version recomputed in the
backward), and a model's op-by-op pieces take the plain set there
(:func:`ops_for`).

Numerics follow the JAX kernels: matmuls accumulate in fp32, the bias and
the activation apply in fp32, the result rounds to the model dtype, and a
residual adds in the model dtype (the MLP kernel's fc2 alone adds it in fp32,
before its one rounding). Weights are ``[out, in]`` (torch Linear);
biases and LayerNorm parameters are fp32.
"""

from __future__ import annotations

import contextlib
import contextvars
import ctypes
import types
from typing import Callable, Iterator, Optional

import torch

from sprc_tpu_torch.ops import _ext, quant, schedules

Tensor = torch.Tensor


def quick_gelu(x: Tensor) -> Tensor:
    return x * torch.sigmoid(1.702 * x)


def gelu(x: Tensor) -> Tensor:
    return 0.5 * x * (1.0 + torch.erf(x * 0.7071067811865476))


ACT_FNS = {None: lambda x: x, "quick_gelu": quick_gelu, "gelu": gelu}


# ------------------------------------------------------------------ plain


def gemm_plain(x: Tensor, w: Tensor, b: Optional[Tensor] = None, act: Optional[str] = None,
               residual: Optional[Tensor] = None, residual_f32: bool = False) -> Tensor:
    """``residual_f32``: the residual joins the fp32 sum before the one
    rounding (``acc + b + f32(x)``, the JAX MLP kernel); else it is added in
    the model dtype to the rounded branch (the JAX block kernels)."""
    y = torch.matmul(x, w.t()).float()
    if b is not None:
        y = y + b.float()
    y = ACT_FNS[act](y)
    if residual is not None and residual_f32:
        return (y + residual.float()).to(x.dtype)
    y = y.to(x.dtype)
    if residual is not None:
        y = residual + y
    return y


def attention_plain(q: Tensor, k: Tensor, v: Tensor, heads: int, scale: float,
                    col_bias: Optional[Tensor] = None) -> Tensor:
    """q [B, Sq, H*D], k/v [B, Sk, H*D], col_bias [B, Sk] fp32 -> [B, Sq, H*D]
    (the unfused JAX attention: :func:`einsum_attention` on the BSHD views)."""
    B, Sq, W = q.shape
    D = W // heads
    bias = None if col_bias is None else col_bias.float()[:, None, None, :]
    out = einsum_attention(q.reshape(B, Sq, heads, D), k.reshape(B, -1, heads, D),
                           v.reshape(B, -1, heads, D), bias, scale)
    return out.reshape(B, Sq, W)


def einsum_attention(q: Tensor, k: Tensor, v: Tensor, bias: Optional[Tensor],
                     scale: float) -> Tensor:
    """q [B, Sq, H, D], k/v [B, Sk, H, D], bias broadcastable to
    [B, H, Sq, Sk] -> [B, Sq, H, D]: the JAX package's ``_xla_attention``
    (fp32 scores, the scale after the product, the bias after the scale, the
    probabilities normalised in fp32 and then rounded to v's dtype)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias.to(s.dtype)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)


def flash_attention_plain(q: Tensor, k: Tensor, v: Tensor, scale: float) -> Tensor:
    """The plain version of the ``flash_attention`` kernel: unmasked
    attention on BSHD, numerics of ``pallas_attention._attn_kernel``
    (normalise, then round)."""
    return einsum_attention(q, k, v, None, scale)


def layer_norm_plain(x: Tensor, w: Tensor, b: Tensor, eps: float,
                     residual: Optional[Tensor] = None,
                     out_scale: Optional[float] = None) -> Tensor:
    """LayerNorm in fp32, rounded to ``x.dtype``; with ``out_scale`` the fp32
    result is quantised instead (int8 codes, no rounding in between)."""
    v = x.float()
    if residual is not None:
        v = v + residual.float()
    mean = v.mean(-1, keepdim=True)
    var = (v - mean).square().mean(-1, keepdim=True)
    y = (v - mean) * torch.rsqrt(var + eps) * w.float() + b.float()
    return y.to(x.dtype) if out_scale is None else quant.quantize_static(y, out_scale)


def gemm_i8_plain(a8: Tensor, w8: Tensor, col_scale: Optional[Tensor] = None,
                  bias: Optional[Tensor] = None, *, row_scale: Optional[Tensor] = None,
                  col_alpha: float = 1.0, act: Optional[str] = None,
                  residual: Optional[Tensor] = None,
                  out_dtype: torch.dtype = torch.float32,
                  out_scale: Optional[float] = None) -> Tensor:
    """a8 [.., K] int8 x w8 [N, K] int8 -> [.., N]. Without ``col_scale`` the
    raw int32 product. Else, in fp32 and every step rounded on its own:
    ``v = act(acc (* row_scale[m]) * (col_scale[n] * col_alpha) (+ bias[n]))``
    (``col_alpha``: a static activation scale, folded here so that the vector
    ``w_scale * a`` needs no launch of its own), returned as
    ``out_dtype`` (a ``residual`` of that dtype added after the rounding) or,
    with ``out_scale``, as the int8 codes ``clip(rint(v * (1 / out_scale)))``."""
    acc = quant.int_matmul_exact(a8, w8)
    if col_scale is None:
        return acc
    v = acc.float()
    if row_scale is not None:
        v = v * row_scale[..., None]
    v = v * (col_scale if col_alpha == 1.0 else col_scale * col_alpha)
    if bias is not None:
        v = v + bias
    v = ACT_FNS[act](v)
    if out_scale is not None:
        return quant.quantize_static(v, out_scale)
    y = v.to(out_dtype)
    return y if residual is None else residual + y


# ------------------------------------------------------------------- CUDA


def _dtype_code(t: Tensor) -> int:
    if t.dtype == torch.float32:
        return _ext.F32
    if t.dtype == torch.bfloat16:
        return _ext.BF16
    raise TypeError(f"kernels take float32 or bfloat16, got {t.dtype}")


def _check(name: str, x: Tensor, *others: Optional[Tensor]) -> int:
    for t in (x,) + others:
        if t is None:
            continue
        if not t.is_cuda:
            raise ValueError(f"{name}: expected a CUDA tensor, got one on {t.device}")
        if t.device != x.device:
            raise ValueError(f"{name}: tensors on {x.device} and {t.device}")
    return _dtype_code(x)


def _fp32_vec(name: str, t: Optional[Tensor], n: int) -> None:
    if t is not None and (t.dtype != torch.float32 or t.shape != (n,) or not t.is_contiguous()):
        raise ValueError(f"{name}: expected a contiguous fp32 vector of {n}, got "
                         f"{t.dtype} {tuple(t.shape)}")


def _ptr(t: Optional[Tensor]):
    return None if t is None else t.data_ptr()


def _stream():
    return torch.cuda.current_stream().cuda_stream


def gemm_cuda(x: Tensor, w: Tensor, b: Optional[Tensor] = None, act: Optional[str] = None,
              residual: Optional[Tensor] = None, residual_f32: bool = False) -> Tensor:
    """:func:`gemm_plain` as a kernel (``csrc/gemm.cu``: bf16 through wgmma
    and TMA, cut as :func:`schedules.gemm_bf16_plan` says; true fp32 on the
    CUDA cores, cut as :func:`schedules.gemm_f32_plan` says). The fp32 path
    forms its offsets in 64 bits and takes products of 2^31 elements or more;
    the bf16 path refuses them.
    ``gemm_cuda.launches_bf16`` and ``gemm_cuda.launches_f32`` count the
    launches of the two kernels."""
    check_no_grad("gemm", x, w, b, residual)
    dt = _check("gemm", x, w, b, residual)
    K = x.shape[-1]
    N = w.shape[0]
    M = x.numel() // K
    if w.dtype != x.dtype or w.shape != (N, K) or not w.is_contiguous() or not x.is_contiguous():
        raise ValueError(f"gemm: x {x.dtype} {tuple(x.shape)} and w {w.dtype} "
                         f"{tuple(w.shape)} must be contiguous, same dtype, [..., K] x [N, K]")
    if K % (8 if dt == _ext.BF16 else 4) or x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("gemm: the kernel reads 16-byte rows: K % 8 == 0 (bf16) or "
                         "K % 4 == 0 (fp32), and aligned data")
    _fp32_vec("gemm bias", b, N)
    out_shape = x.shape[:-1] + (N,)
    if residual is not None and (residual.dtype != x.dtype or residual.shape != out_shape
                                 or not residual.is_contiguous()):
        raise ValueError("gemm: residual must match the output's shape and dtype")
    if any(t is not None and t.data_ptr() % 16 for t in (b, residual)):
        raise ValueError("gemm: the epilogue reads bias and residual as vectors: aligned data")
    plan = (schedules.gemm_bf16_plan(M, N, K, act) if dt == _ext.BF16
            else schedules.gemm_f32_plan(M, N, K))
    y = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    lib = _ext.library()
    _ext.check(lib.sprc_gemm(x.data_ptr(), w.data_ptr(), _ptr(b), _ptr(residual), y.data_ptr(),
                             M, N, K, dt, _ext.ACT[act], int(residual_f32), plan["tile_m"],
                             plan["tile_n"], _stream()), "gemm")
    if dt == _ext.BF16:
        gemm_cuda.launches_bf16 += 1
    else:
        gemm_cuda.launches_f32 += 1
    return y


gemm_cuda.launches_bf16 = 0
gemm_cuda.launches_f32 = 0


HEAD_DIMS = (64, 88)  # the head dims csrc/attention.cu is built for


def attention_cuda(q: Tensor, k: Tensor, v: Tensor, heads: int, scale: float,
                   col_bias: Optional[Tensor] = None) -> Tensor:
    """:func:`attention_plain` as a kernel (``csrc/attention.cu``), for a head
    dim in :data:`HEAD_DIMS`; q, k and v may be strided views (the thirds of
    a packed qkv, a BSHD tensor flattened to ``[B, S, H*D]``) whose rows are
    16-byte aligned. The bf16 path is walked by
    :func:`schedules.attention_emulated`, the fp32 path (cut as
    :func:`schedules.attention_f32_plan` says) by
    :func:`schedules.attention_f32_emulated`. ``attention_cuda.launches_bf16``
    and ``attention_cuda.launches_f32`` count the launches of the two paths
    (``flash_attention_cuda``'s included)."""
    check_no_grad("attention", q, k, v, col_bias)
    dt = _check("attention", q, k, v, col_bias)
    B, Sq, W = q.shape
    Sk = k.shape[1]
    if W % heads or W // heads not in HEAD_DIMS:
        raise ValueError(f"attention: the kernel is built for head dims {HEAD_DIMS}, got "
                         f"{W} / {heads}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype or t.shape != (B, Sk, W):
            raise ValueError(f"attention: {name} {t.dtype} {tuple(t.shape)} vs q {q.dtype} "
                             f"{tuple(q.shape)}")
    for t in (q, k, v):
        if t.stride(-1) != 1:
            raise ValueError("attention: the feature dim must be contiguous")
        per16 = 8 if dt == _ext.BF16 else 4  # elements in 16 bytes
        if t.stride(0) % per16 or t.stride(1) % per16 or t.data_ptr() % 16:
            raise ValueError(f"attention: the kernel reads 16-byte rows: strides % {per16} == 0 "
                             "and aligned data")
    if Sk < 1:
        raise ValueError("attention: needs at least one key")
    schedules.check_attention_grid(B, heads)
    if col_bias is not None and (col_bias.dtype != torch.float32 or col_bias.shape != (B, Sk)
                                 or not col_bias.is_contiguous()):
        raise ValueError("attention: col_bias must be contiguous fp32 [B, Sk]")
    out = torch.empty((B, Sq, W), dtype=q.dtype, device=q.device)
    lib = _ext.library()
    _ext.check(lib.sprc_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(col_bias), out.data_ptr(),
        B, heads, W // heads, Sq, Sk, q.stride(1), q.stride(0), k.stride(1), k.stride(0),
        v.stride(1), v.stride(0), out.stride(1), out.stride(0), ctypes.c_float(scale),
        dt, _stream()), "attention")
    if dt == _ext.BF16:
        attention_cuda.launches_bf16 += 1
    else:
        attention_cuda.launches_f32 += 1
    return out


attention_cuda.launches_bf16 = 0
attention_cuda.launches_f32 = 0


def flash_attention_cuda(q: Tensor, k: Tensor, v: Tensor, scale: float) -> Tensor:
    """:func:`flash_attention_plain` as a kernel: the attention kernel of
    ``csrc/attention.cu`` reads each BSHD tensor in place as its
    ``[B, S, H*D]`` view (heads contiguous within a row), so no transpose is
    made. q [B, Sq, H, D], k/v [B, Sk, H, D] -> [B, Sq, H, D]."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash_attention: BSHD tensors, got {tuple(q.shape)}")
    B, Sq, H, D = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 or t.stride(2) != D:
            raise ValueError(f"flash_attention: {name} must hold its heads contiguously within "
                             f"a row (strides {t.stride()})")
    flat = [t.as_strided((t.shape[0], t.shape[1], H * D), (t.stride(0), t.stride(1), 1))
            for t in (q, k, v)]
    return attention_cuda(*flat, H, scale).view(B, Sq, H, D)


def layer_norm_cuda(x: Tensor, w: Tensor, b: Tensor, eps: float,
                    residual: Optional[Tensor] = None,
                    out_scale: Optional[float] = None) -> Tensor:
    """:func:`layer_norm_plain` as a kernel (``csrc/layernorm.cu``, read as
    :func:`schedules.layer_norm_plan` says). ``layer_norm_cuda.launches`` and
    ``layer_norm_cuda.launches_q8`` count the launches of the model-dtype and
    the int8 outputs."""
    check_no_grad("layer_norm", x, w, b, residual)
    dt = _check("layer_norm", x, w, b, residual)
    W = x.shape[-1]
    if W > 4096 or not x.is_contiguous():
        raise ValueError("layer_norm: contiguous rows of at most 4096")
    _fp32_vec("layer_norm weight", w, W)
    _fp32_vec("layer_norm bias", b, W)
    if residual is not None and (residual.dtype != x.dtype or residual.shape != x.shape
                                 or not residual.is_contiguous()):
        raise ValueError("layer_norm: residual must match x")
    lib = _ext.library()
    if out_scale is not None:
        y = torch.empty(x.shape, dtype=torch.int8, device=x.device)
        _ext.check(lib.sprc_layernorm_q8(
            x.data_ptr(), _ptr(residual), w.data_ptr(), b.data_ptr(), y.data_ptr(),
            x.numel() // W, W, ctypes.c_float(eps), ctypes.c_float(1.0 / out_scale), dt,
            _stream()), "layer_norm")
        layer_norm_cuda.launches_q8 += 1
        return y
    y = torch.empty_like(x)
    _ext.check(lib.sprc_layernorm(x.data_ptr(), _ptr(residual), w.data_ptr(), b.data_ptr(),
                                  y.data_ptr(), x.numel() // W, W, ctypes.c_float(eps), dt,
                                  _stream()), "layer_norm")
    layer_norm_cuda.launches += 1
    return y


layer_norm_cuda.launches = 0
layer_norm_cuda.launches_q8 = 0


_GEMM_I8_OUT = {torch.float32: _ext.OUT_F32, torch.bfloat16: _ext.OUT_BF16}


def _check_i8(name: str, t: Tensor) -> None:
    if not t.is_cuda or t.dtype != torch.int8 or not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name}: expected a contiguous, 16-byte aligned int8 CUDA tensor, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def gemm_i8_cuda(a8: Tensor, w8: Tensor, col_scale: Optional[Tensor] = None,
                 bias: Optional[Tensor] = None, *, row_scale: Optional[Tensor] = None,
                 col_alpha: float = 1.0, act: Optional[str] = None,
                 residual: Optional[Tensor] = None,
                 out_dtype: torch.dtype = torch.float32,
                 out_scale: Optional[float] = None) -> Tensor:
    """:func:`gemm_i8_plain` on the tensor cores (``csrc/gemm_i8.cu``, cut as
    :func:`schedules.gemm_i8_plan` says). ``gemm_i8_cuda.launches`` counts the
    kernel's launches."""
    check_no_grad("gemm_i8", col_scale, bias, row_scale, residual)
    _check_i8("gemm_i8 a8", a8)
    _check_i8("gemm_i8 w8", w8)
    for t in (w8, col_scale, bias, row_scale, residual):
        if t is not None and t.device != a8.device:
            raise ValueError(f"gemm_i8: tensors on {a8.device} and {t.device}")
    K = a8.shape[-1]
    N = w8.shape[0]
    M = a8.numel() // K
    if w8.shape != (N, K) or K % 16 or N % 2:
        raise ValueError(f"gemm_i8: a8 {tuple(a8.shape)} x w8 {tuple(w8.shape)}: the kernel takes "
                         "[.., K] x [N, K] with K % 16 == 0 (16-byte rows) and N % 2 == 0")
    out_shape = a8.shape[:-1] + (N,)
    if col_scale is None:
        if any(t is not None for t in (bias, row_scale, residual, act, out_scale)):
            raise ValueError("gemm_i8: the raw int32 output takes no epilogue")
        out, y_dtype = _ext.OUT_S32, torch.int32
    elif out_scale is not None:
        if residual is not None:
            raise ValueError("gemm_i8: the int8 output takes no residual")
        out, y_dtype = _ext.OUT_S8, torch.int8
    elif out_dtype in _GEMM_I8_OUT:
        out, y_dtype = _GEMM_I8_OUT[out_dtype], out_dtype
    else:
        raise TypeError(f"gemm_i8: out_dtype float32 or bfloat16, got {out_dtype}")
    _fp32_vec("gemm_i8 col_scale", col_scale, N)
    _fp32_vec("gemm_i8 bias", bias, N)
    if row_scale is not None and (row_scale.dtype != torch.float32 or row_scale.numel() != M
                                  or not row_scale.is_contiguous()):
        raise ValueError(f"gemm_i8: row_scale must be contiguous fp32 with one value per row "
                         f"({M}), got {row_scale.dtype} {tuple(row_scale.shape)}")
    if residual is not None and (residual.dtype != y_dtype or residual.shape != out_shape
                                 or not residual.is_contiguous() or residual.data_ptr() % 8):
        raise ValueError("gemm_i8: residual must match the output's shape and dtype")
    plan = schedules.gemm_i8_plan(M, N, K, schedules.GEMM_I8_OUTS[out], act)
    y = torch.empty(out_shape, dtype=y_dtype, device=a8.device)
    lib = _ext.library()
    _ext.check(lib.sprc_gemm_i8(
        a8.data_ptr(), w8.data_ptr(), _ptr(row_scale), _ptr(col_scale), _ptr(bias),
        _ptr(residual), y.data_ptr(), M, N, K, out, _ext.ACT[act],
        ctypes.c_float(1.0 / out_scale if out_scale is not None else 0.0),
        ctypes.c_float(col_alpha), plan["tile_n"], _stream()), "gemm_i8")
    gemm_i8_cuda.launches += 1
    return y


gemm_i8_cuda.launches = 0


def quantize_static_cuda(x: Tensor, act_scale: float) -> Tensor:
    """:func:`quant.quantize_static` as a kernel (``csrc/quantize.cu``, cut as
    :func:`schedules.quantize_static_plan` says). ``quantize_static_cuda.
    launches`` counts the kernel's launches."""
    check_no_grad("quantize_static", x)
    dt = _check("quantize_static", x)
    if not x.is_contiguous():
        raise ValueError("quantize_static: contiguous input")
    y = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    _ext.check(_ext.library().sprc_quantize_static(
        x.data_ptr(), y.data_ptr(), x.numel(), ctypes.c_float(1.0 / act_scale), dt, _stream()),
        "quantize_static")
    quantize_static_cuda.launches += 1
    return y


quantize_static_cuda.launches = 0


def quantize_rows_cuda(x: Tensor):
    """:func:`quant.quantize_rows` as a kernel (``csrc/quantize.cu``, a warp a
    row, read as :func:`schedules.quantize_rows_plan` says): (codes like x,
    scales x.shape[:-1]). ``quantize_rows_cuda.launches`` counts the kernel's
    launches."""
    check_no_grad("quantize_rows", x)
    dt = _check("quantize_rows", x)
    W = x.shape[-1]
    if not x.is_contiguous() or not 1 <= W <= schedules.QUANT_MAX_W:
        raise ValueError(f"quantize_rows: contiguous rows of 1 to {schedules.QUANT_MAX_W}")
    y = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scales = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
    _ext.check(_ext.library().sprc_quantize_rows(
        x.data_ptr(), y.data_ptr(), scales.data_ptr(), x.numel() // W, W, dt, _stream()),
        "quantize_rows")
    quantize_rows_cuda.launches += 1
    return y, scales


quantize_rows_cuda.launches = 0


PLAIN = types.SimpleNamespace(gemm=gemm_plain, attention=attention_plain,
                              flash_attention=flash_attention_plain,
                              layer_norm=layer_norm_plain, gemm_i8=gemm_i8_plain,
                              quantize_static=quant.quantize_static,
                              quantize_rows=quant.quantize_rows)
CUDA = types.SimpleNamespace(gemm=gemm_cuda, attention=attention_cuda,
                             flash_attention=flash_attention_cuda,
                             layer_norm=layer_norm_cuda, gemm_i8=gemm_i8_cuda,
                             quantize_static=quantize_static_cuda,
                             quantize_rows=quantize_rows_cuda)


_STAGE_CHECK = contextvars.ContextVar("sprc_stage_check", default=None)


@contextlib.contextmanager
def stage_check(record: Callable[[str, object, object], None]) -> Iterator[None]:
    """Inside this context every stage of a kernel chain on the card is held
    against its plain version on the inputs that the kernel run gave it: each
    primitive launches its kernel, runs the plain version on the same
    tensors, calls ``record(name, kernel_out, plain_out)`` and passes the
    kernel's result on. The two runs cannot drift apart, so each stage can
    be held as tightly as the primitive alone. It exists for the checks on
    the card; the serving path never enters it, and a chain run inside it
    does not count as a launch of its wrapper."""
    token = _STAGE_CHECK.set(record)
    try:
        yield
    finally:
        _STAGE_CHECK.reset(token)


def _stage_name(name: str, args, kwargs) -> str:
    """The kind of stage a call is recorded under: the primitive, told apart
    where its kernel takes another path (the fp32 residual of the GEMM's
    epilogue, a head dim other than 64)."""
    if name == "gemm" and kwargs.get("residual_f32"):
        return "gemm, fp32 residual"
    if name == "attention" and args[0].shape[-1] // args[3] != 64:
        return f"attention D={args[0].shape[-1] // args[3]}"
    if name == "flash_attention" and args[0].shape[-1] != 64:
        return f"flash_attention D={args[0].shape[-1]}"
    return name


def _checked(record) -> types.SimpleNamespace:
    def both(name):
        kernel, plain = getattr(CUDA, name), getattr(PLAIN, name)

        def run(*args, **kwargs):
            got = kernel(*args, **kwargs)
            record(_stage_name(name, args, kwargs), got, plain(*args, **kwargs))
            return got

        return run

    return types.SimpleNamespace(**{name: both(name) for name in vars(CUDA)})


def for_device(x: Tensor):
    """The primitive set a wrapper runs on ``x``: the plain one only because
    ``x`` lies on the CPU; on CUDA the kernels (which raise on what they do
    not take; inside :func:`stage_check`, each with its plain version beside
    it); any other device is refused."""
    if x.device.type == "cpu":
        return PLAIN
    if x.device.type == "cuda":
        record = _STAGE_CHECK.get()
        return CUDA if record is None else _checked(record)
    raise ValueError(f"no kernels for device {x.device}")


_PLAIN_REFERENCE = contextvars.ContextVar("sprc_plain_reference", default=False)


@contextlib.contextmanager
def plain_reference() -> Iterator[None]:
    """Inside this context the model's kernel-holding modules call the plain
    PyTorch version of their kernel instead of its wrapper, on any device.
    It exists to compute, on the card, the reference that a kernel run is
    held against; the serving path never enters it."""
    token = _PLAIN_REFERENCE.set(True)
    try:
        yield
    finally:
        _PLAIN_REFERENCE.reset(token)


def in_plain_reference() -> bool:
    return _PLAIN_REFERENCE.get()


def records(*tensors: Optional[Tensor]) -> bool:
    """Whether autograd records through any of ``tensors``: grad is on and
    one of them requires it."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def ops_for(x: Tensor, *grad_inputs: Optional[Tensor]):
    """The primitive set for a model's op-by-op pieces: :func:`for_device`,
    or the plain set inside :func:`plain_reference` and where autograd
    records through ``x`` or ``grad_inputs`` (the CUDA set refuses those: it
    writes into buffers of its own through ``ctypes``, which autograd does
    not see)."""
    return PLAIN if in_plain_reference() or records(x, *grad_inputs) else for_device(x)


def kernel_or_reference(kernel: Callable, plain: Callable) -> Callable:
    """What a model module calls: the kernel wrapper (which routes by device
    alone), or the plain version inside :func:`plain_reference`."""
    return plain if in_plain_reference() else kernel


def dispatch(function, *tensors: Optional[Tensor], **kw):
    """What a model module calls for a kernel that has a gradient: its
    :class:`RecomputedVJP` ``function`` (which, where autograd does not
    record, only runs the wrapper), or its plain version inside
    :func:`plain_reference`."""
    if in_plain_reference():
        return function.plain(*tensors, **kw)
    return function.call(*tensors, **kw)


def check_no_grad(name: str, *tensors: Optional[Tensor]) -> None:
    """Every kernel wrapper and CUDA primitive refuses a tensor that autograd
    records through: its output would have no ``grad_fn``, and a model
    trained through it would train nothing. A kernel with a gradient is
    called through its :class:`RecomputedVJP`, whose forward runs with grad
    off."""
    if records(*tensors):
        raise RuntimeError(f"{name} is inference-only; call it under torch.no_grad() or "
                           "through its autograd Function")


class RecomputedVJP(torch.autograd.Function):
    """The base of the kernels' autograd Functions: ``Sub.call(*tensors,
    **kw)`` takes the wrapper's arguments. The forward is the wrapper
    (``Sub.kernel``: the kernel on the card, its plain version on the CPU)
    and keeps only its input tensors for the backward; the backward runs
    ``Sub.plain`` on them again under autograd, as the JAX package's custom
    VJPs run ``jax.vjp`` over their XLA composition. It returns a gradient
    for every tensor that needs one and None for the rest (a None bias). No
    backward kernel exists in either package; the recompute's products are
    the library's (``torch.matmul``)."""

    kernel: Callable
    plain: Callable

    @classmethod
    def call(cls, *tensors: Optional[Tensor], **kw) -> Tensor:
        return cls.apply(cls, kw, *tensors)

    @staticmethod
    def forward(ctx, cls, kw, *tensors):
        ctx.plain, ctx.kw = cls.plain, kw
        ctx.save_for_backward(*tensors)
        return cls.kernel(*tensors, **kw)

    @staticmethod
    def backward(ctx, grad):
        needs = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            ins = [t if t is None else t.detach().requires_grad_(need)
                   for t, need in zip(ctx.saved_tensors, needs)]
            out = ctx.plain(*ins, **ctx.kw)
        wrt = [t for t in ins if t is not None and t.requires_grad]
        grads = iter(torch.autograd.grad(out, wrt, grad) if wrt else ())
        return (None, None, *(next(grads) if t is not None and t.requires_grad else None
                              for t in ins))
