"""Kernels K3 and K4: one post-LN Q-Former (BERT) layer of the SPRC fork,
in fp32 (K3) and with its ten dense projections in int8 (K4, ``int8=True``).

Replaces ``sprc_tpu/ops/pallas_qformer.py::fused_qformer_layer``
(``_qf_layer_kernel`` and ``_qf_layer_kernel_i8``, ``_attend_bias``):

1. self-attention over all S rows with an additive column bias (0 / -10000),
   then ``LN(out + x)``;
2. with an image, the first Q rows cross-attend into the image rows, then
   ``LN(out + rows)``;
3. the dual FFN: the query FFN on rows < Q and the text FFN on the rest, or
   the text FFN on every row when there is no image (``text_ffn_all``, the
   fork's rule at ``sprc_tpu/models/qformer.py:372-392``). Exact GELU.

The Pallas kernel batches G items' rows into VMEM and runs the layer as one
program. On Hopper the layer is a chain of the kernels in ``csrc/`` (see
:mod:`.primitives`): per attention branch three projection GEMMs, one
attention launch and one output GEMM, then the fused ``LN(a + b)``; per FFN
two GEMMs (bias + GELU in the first epilogue) and one LN. The Q-Former runs
in fp32 (``qformer_precision: fp32``), so every GEMM is the true-fp32 CUDA
core path; that FMA rate bounds the layer, with the image's key/value
projections (257 rows per item, 1024 wide) the largest share on cross
layers. Slices of the first Q rows and of the text rows are copied to
contiguous buffers between stages.

Parameters arrive as dicts of ``(weight [out, in], bias)`` pairs:
``{"query", "key", "value", "out", "ln"}`` for an attention branch and
``{"fc1", "fc2", "ln"}`` for an FFN.

With ``int8=True`` (K4) every dense entry is a triple ``(codes [out, in]
int8, scale [out], bias)`` (:func:`quantize_layer_params` makes them from the
pairs) and each projection is the TPU kernel's ``_mm_i8``: the input rows
are quantised with one dynamic scale per row, the product is s8 x s8 -> s32
on the tensor cores, and the epilogue computes ``(acc * row_scale) *
w_scale + bias`` in fp32. Attention, LayerNorms and the GELU stay fp32. Rows
are quantised once per distinct input: the self-attention's q, k and v share
one set of codes, and so do the image's key and value projections (the TPU
kernel quantises those rows twice, to the same codes). The image rows are
the same in every cross layer of a pass, so the int8 Q-Former
(``models/qformer.py``) quantises them once and hands each cross layer the
pair ``(codes, scales)`` in place of ``img`` (the TPU kernel fuses one layer
per call and quantises them in each). Between fc1 and fc2
the GELU output goes through ``quantize_rows`` as a launch of its own: a
row's scale over all 3072 columns is not known inside one column tile's
epilogue. What bounds the int8 layer at serving sizes is launch count and
memory traffic more than the products (M is 512 to 4112 rows).
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch

from sprc_tpu_torch.ops import primitives, quant

Tensor = torch.Tensor


def _attend(ops, rows, kv, p, heads, eps, col_bias):
    W = rows.shape[-1]
    q = ops.gemm(rows, *p["query"])
    k = ops.gemm(kv, *p["key"])
    v = ops.gemm(kv, *p["value"])
    ctx = ops.attention(q, k, v, heads, (W // heads) ** -0.5, col_bias)
    out = ops.gemm(ctx, *p["out"])
    return ops.layer_norm(out, *p["ln"], eps, residual=rows)


def _ffn(ops, rows, p, eps):
    h = ops.gemm(rows, *p["fc1"], act="gelu")
    out = ops.gemm(h, *p["fc2"])
    return ops.layer_norm(out, *p["ln"], eps, residual=rows)


def _dense_i8(ops, codes, row_scale, p, act=None):
    w8, ws, b = p
    return ops.gemm_i8(codes, w8, ws, b, row_scale=row_scale, act=act)


def _attend_i8(ops, rows, kv, p, heads, eps, col_bias):
    """``kv``: rows, or the pair (codes, scales) of rows already quantised."""
    W = rows.shape[-1]
    r8, rs = ops.quantize_rows(rows)
    if kv is rows:
        k8, ks = r8, rs
    else:
        k8, ks = kv if isinstance(kv, tuple) else ops.quantize_rows(kv)
    q = _dense_i8(ops, r8, rs, p["query"])
    k = _dense_i8(ops, k8, ks, p["key"])
    v = _dense_i8(ops, k8, ks, p["value"])
    ctx = ops.attention(q, k, v, heads, (W // heads) ** -0.5, col_bias)
    out = _dense_i8(ops, *ops.quantize_rows(ctx), p["out"])
    return ops.layer_norm(out, *p["ln"], eps, residual=rows)


def _ffn_i8(ops, rows, p, eps):
    h = _dense_i8(ops, *ops.quantize_rows(rows), p["fc1"], act="gelu")
    out = _dense_i8(ops, *ops.quantize_rows(h), p["fc2"])
    return ops.layer_norm(out, *p["ln"], eps, residual=rows)


def _layer(ops, x, col_bias, self_p, img, cross_p, ffn_q_p, ffn_t_p, *, heads, eps, Q,
           text_ffn_all, int8=False):
    if isinstance(img, tuple) and not int8:
        raise ValueError("fused_qformer_layer: quantised image rows need int8=True")
    attend, ffn = (_attend_i8, _ffn_i8) if int8 else (_attend, _ffn)
    S = x.shape[1]
    attn = attend(ops, x, x, self_p, heads, eps, col_bias)
    if text_ffn_all:
        return ffn(ops, attn, ffn_t_p, eps)
    q_rows = attn[:, :Q].contiguous() if S > Q else attn
    if img is not None and cross_p is not None:
        q_rows = attend(ops, q_rows, img, cross_p, heads, eps, None)
    q_out = ffn(ops, q_rows, ffn_q_p, eps)
    if S == Q:
        return q_out
    t_out = ffn(ops, attn[:, Q:].contiguous(), ffn_t_p, eps)
    return torch.cat([q_out, t_out], dim=1)


def quantize_layer_params(p: Optional[Mapping]) -> Optional[dict]:
    """One branch's ``(weight, bias)`` pairs -> the int8 form: ``(codes,
    scale, bias)`` triples, the ``ln`` pair as it is."""
    if p is None:
        return None
    return {k: v if k == "ln" else (*quant.quantize_weight(v[0]), v[1]) for k, v in p.items()}


def fused_qformer_layer_plain(x: Tensor, col_bias: Optional[Tensor], self_p: Mapping,
                              img: Optional[Tensor], cross_p: Optional[Mapping],
                              ffn_q_p: Optional[Mapping], ffn_t_p: Optional[Mapping], *,
                              heads: int, eps: float, Q: int, text_ffn_all: bool,
                              int8: bool = False) -> Tensor:
    """The same layer in plain PyTorch, on any device (the reference, and
    the Q-Former's unfused path)."""
    return _layer(primitives.PLAIN, x, col_bias, self_p, img, cross_p, ffn_q_p, ffn_t_p,
                  heads=heads, eps=eps, Q=Q, text_ffn_all=text_ffn_all, int8=int8)


def _tensors(*groups):
    for g in groups:
        for pair in (g or {}).values():
            yield from pair


def fused_qformer_layer(x: Tensor, col_bias: Optional[Tensor], self_p: Mapping,
                        img: Optional[Tensor], cross_p: Optional[Mapping],
                        ffn_q_p: Optional[Mapping], ffn_t_p: Optional[Mapping], *,
                        heads: int, eps: float, Q: int, text_ffn_all: bool,
                        int8: bool = False) -> Tensor:
    """x [B, S, W]; col_bias [B, S] fp32 additive or None; img [B, Si, Wi] or
    None (cross-attention runs when both img and cross_p are given), or with
    ``int8`` the image rows already quantised, the pair ``quantize_rows``
    returns (codes [B, Si, Wi] int8, scales [B, Si] fp32). On a
    CUDA tensor it launches the kernel chain (and raises on what it does not
    take); on a CPU tensor it runs the plain version. ``launches`` counts
    the fp32 chains launched in full, ``launches_int8`` the int8 ones."""
    imgs = img if isinstance(img, tuple) else (img,)
    primitives.check_no_grad("fused_qformer_layer", x, col_bias, *imgs,
                             *_tensors(self_p, cross_p, ffn_q_p, ffn_t_p))
    ops = primitives.for_device(x)
    y = _layer(ops, x, col_bias, self_p, img, cross_p, ffn_q_p, ffn_t_p,
               heads=heads, eps=eps, Q=Q, text_ffn_all=text_ffn_all, int8=int8)
    if ops is primitives.CUDA:
        if int8:
            fused_qformer_layer.launches_int8 += 1
        else:
            fused_qformer_layer.launches += 1
    return y


fused_qformer_layer.launches = 0
fused_qformer_layer.launches_int8 = 0
