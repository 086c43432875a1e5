"""The s8 GEMM kernel's tiling, tensor-map and epilogue arithmetic
(sprc_tpu_torch/ops/schedules.py::gemm_i8_plan), which the wrapper consults
before every launch of csrc/gemm_i8.cu.

The kernel runs only on a card. What can be wrong outside the CUDA source is
held here: which tile width a product gets (and that it is one the kernel is
built with), the persistent grid, the boxes of the tensor maps, the last
partial tile along each axis, what the plan and the wrapper refuse, the
int8 staging tile's swizzle, and, by walking the plan tile by tile in plain
PyTorch (zero-filled 128-deep boxes, exact integer sums, then the epilogue in
the kernel's rounding order with its neutral row scale 1 and bias -0), that
the cut computes ``gemm_i8_plain`` bit for bit. Every product the plan is
given goes to the one wgmma mainloop: there is no other. Inputs come from
numpy generators seeded per test.
"""

import numpy as np
import pytest
import torch

from sprc_tpu_torch.ops import primitives, schedules
from test_torch_threads import one_torch_thread  # noqa: E402,F401  (one thread a module)

VIT_M, Q_M = 64 * 257, 32 * 64
# the main path's products: name -> (M, N, K, output, activation, tile width)
PRODUCTS = {
    "ablate 4096^3": (4096, 4096, 4096, "s32", None, 256),
    "vit qkv": (VIT_M, 3072, 1024, "bf16", None, 256),
    "vit proj": (VIT_M, 1024, 1024, "bf16", None, 256),
    "vit fc1": (VIT_M, 4096, 1024, "s8", "quick_gelu", 128),
    "vit fc2": (VIT_M, 1024, 4096, "bf16", None, 256),
    "eva qkv": (VIT_M, 4224, 1408, "bf16", None, 256),   # 16.5 x 256: pads 3 %
    "eva proj": (VIT_M, 1408, 1408, "bf16", None, 128),  # 5.5 x 256 would pad 9 %
    "eva fc1": (VIT_M, 6144, 1408, "s8", "gelu", 128),
    "eva fc2": (VIT_M, 1408, 6144, "bf16", None, 128),
    "qformer self": (Q_M, 768, 768, "f32", None, 128),
    "qformer self, query rows": (Q_M // 2, 768, 768, "f32", None, 128),
    "qformer cross kv": (VIT_M, 768, 1024, "f32", None, 128),
    "qformer fc1": (Q_M, 3072, 768, "f32", "gelu", 128),
    "qformer fc2": (Q_M, 768, 3072, "f32", None, 128),
}
RAGGED = [(M, N, K) for M in (1, 63, 65, 257, 4112) for N, K in ((18, 16), (130, 48), (266, 144),
                                                                  (1000, 48), (384, 1040))]
# what csrc/gemm_i8.cu::launch_act instantiates: (tile width, output) -> activations
BUILT = {(256, "s32"): {None}, (256, "bf16"): {None}, (256, "s8"): {None},
         (128, "s32"): {None}, **{(128, o): {None, "gelu", "quick_gelu"}
                                  for o in ("f32", "bf16", "s8")}}


def test_plan_of_the_main_path_products():
    for name, (M, N, K, out, act, tile_n) in PRODUCTS.items():
        p = schedules.gemm_i8_plan(M, N, K, out, act)
        assert p["tile_n"] == tile_n, name
        assert act in BUILT[(tile_n, out)], name
        assert p["tile_m"] == 128 and p["tile_k"] == 128 and K % 128 == 0, name
        assert p["last_depth"] == 128 and p["k_steps"] == K // 128, name
        assert p["grid"] == min(p["tiles"], schedules.H100_SMS), name
        assert p["smem_bytes"] <= 232448, name
        assert p["stages"] * p["stage_bytes"] + p["staging_bytes"] + 1024 == p["smem_bytes"]
        assert p["a_map"] == {"dims": (K, M), "pitch": K, "box": (128, 128)}, name
        assert p["w_map"] == {"dims": (K, N), "pitch": K, "box": (128, tile_n)}, name
        # bf16 and int8 rows of these widths leave through TMA, in 64-row boxes of 128 bytes
        assert p["y_tma"] == (out in ("bf16", "s8")), name
        if p["y_tma"]:
            elt = 2 if out == "bf16" else 1
            assert p["y_map"] == {"dims": (N, M), "pitch": elt * N, "box": (128 // elt, 64)}
    # the Q-Former's products fill at most one wave of the narrow tile's blocks
    assert schedules.gemm_i8_plan(Q_M // 2, 768, 768, "f32")["tiles"] == 48
    assert schedules.gemm_i8_plan(Q_M, 768, 768, "f32")["tiles"] == 96
    # the wide tile needs a full wave of its own: a small raw product takes 128
    assert schedules.gemm_i8_plan(Q_M, 768, 768, "s32")["tile_n"] == 128
    assert schedules.gemm_i8_plan(4096, 4096, 4096)["grid"] == schedules.H100_SMS


def test_plan_of_ragged_shapes_covers_the_output_once():
    for M, N, K in RAGGED:
        for out in schedules.GEMM_I8_OUTS:
            p = schedules.gemm_i8_plan(M, N, K, out)
            assert p["a_map"]["pitch"] % 16 == 0 and p["w_map"]["pitch"] % 16 == 0
            assert p["y_tma"] == ((out == "bf16" and N % 8 == 0) or (out == "s8" and N % 16 == 0))
            assert 1 <= p["last_rows"] <= 128 and 1 <= p["last_cols"] <= p["tile_n"]
            assert (p["tiles_m"] - 1) * 128 + p["last_rows"] == M
            assert (p["tiles_n"] - 1) * p["tile_n"] + p["last_cols"] == N
            assert (p["k_steps"] - 1) * 128 + p["last_depth"] == K
            assert None in BUILT[(p["tile_n"], out)]
            seen = np.zeros((M, N), np.int32)
            for block in range(p["grid"]):
                for m0, n0 in schedules.gemm_tiles_of_block(p, block):
                    seen[m0:m0 + 128, n0:n0 + p["tile_n"]] += 1
            assert (seen == 1).all(), (M, N, K, out)


def test_every_plan_is_a_built_specialisation():
    """The kernel is built only for the (tile width, output, activation)
    combinations in BUILT and refuses the others; the plan never asks for
    another, whatever the shape."""
    for M in (1, 1024, 2048, 4112, 16448):
        for N in (2, 768, 1408, 3072, 4224):
            for out in schedules.GEMM_I8_OUTS:
                for act in ((None,) if out == "s32" else (None, "gelu", "quick_gelu")):
                    p = schedules.gemm_i8_plan(M, N, 64, out, act)
                    assert act in BUILT[(p["tile_n"], out)], (M, N, out, act)


def _walk(plan, a8, w8, cs, bias, rs, alpha, act, residual, out, out_scale):
    """The product computed as the kernel cuts it: per tile, boxes that hang
    over an edge filled with zeros, exact sums over 128-deep steps, then the
    epilogue in the kernel's order: float(acc) * (row scale or 1) * (col
    scale * alpha) + (bias or -0), the activation, then the output mode."""
    M, K = a8.shape
    N = w8.shape[0]
    tm, tn, tk = plan["tile_m"], plan["tile_n"], plan["tile_k"]
    dt = {"s32": torch.int32, "f32": torch.float32, "bf16": torch.bfloat16, "s8": torch.int8}[out]
    y = torch.zeros((M, N), dtype=dt)
    quick = lambda v: v / (1.0 + torch.exp(-1.702 * v))  # noqa: E731 (the kernel's QuickGELU)
    act_fn = quick if act == "quick_gelu" else primitives.ACT_FNS[act]
    for block in range(plan["grid"]):
        for m0, n0 in schedules.gemm_tiles_of_block(plan, block):
            acc = torch.zeros(tm, tn, dtype=torch.int64)
            for k0 in range(0, plan["k_steps"] * tk, tk):
                ab, wb = torch.zeros(tm, tk, dtype=torch.int64), torch.zeros(tn, tk, dtype=torch.int64)
                xs, ws = a8[m0:m0 + tm, k0:k0 + tk], w8[n0:n0 + tn, k0:k0 + tk]
                ab[:xs.shape[0], :xs.shape[1]] = xs
                wb[:ws.shape[0], :ws.shape[1]] = ws
                acc += ab @ wb.t()
            rows, cols = min(tm, M - m0), min(tn, N - n0)
            acc = acc[:rows, :cols].to(torch.int32)
            if out == "s32":
                y[m0:m0 + rows, n0:n0 + cols] = acc
                continue
            r = torch.ones(rows) if rs is None else rs[m0:m0 + rows]
            b = torch.full((cols,), -0.0) if bias is None else bias[n0:n0 + cols]
            v = (acc.float() * r[:, None]) * (cs[n0:n0 + cols] * torch.tensor(alpha))
            v = act_fn(v + b)
            if out == "s8":
                y[m0:m0 + rows, n0:n0 + cols] = torch.clamp(
                    torch.round(v * torch.tensor(1.0 / out_scale)), -127, 127).to(torch.int8)
            elif out == "f32":
                res = 0.0 if residual is None else residual[m0:m0 + rows, n0:n0 + cols]
                y[m0:m0 + rows, n0:n0 + cols] = v if residual is None else res + v
            else:
                o = v.to(torch.bfloat16)
                if residual is not None:
                    o = (residual[m0:m0 + rows, n0:n0 + cols].float() + o.float()).to(torch.bfloat16)
                y[m0:m0 + rows, n0:n0 + cols] = o
    return y


def _bits(t):
    return t.view({torch.float32: torch.int32, torch.bfloat16: torch.int16}.get(t.dtype, t.dtype))


def test_the_cut_computes_gemm_i8_plain_bit_for_bit():
    """s32, fp32 and bf16 outputs equal bit for bit (the row scale 1 and the
    bias -0 that stand in for absent ones are exact); int8 codes within one
    (the kernel's QuickGELU divides by 1 + exp where plain multiplies by the
    sigmoid)."""
    rng = np.random.default_rng(43)
    cases = [("s32", None, False, False, None), ("f32", None, True, True, None),
             ("f32", "gelu", True, True, None), ("f32", None, False, False, "f32"),
             ("bf16", None, False, True, None), ("bf16", None, False, False, "bf16"),
             ("bf16", "gelu", False, True, None), ("s8", "gelu", False, True, None),
             ("s8", "quick_gelu", False, True, None), ("s8", None, True, False, None)]
    for M, N, K in ((65, 130, 48), (257, 34, 144), (129, 264, 16), (1, 18, 272)):
        a8 = torch.from_numpy(rng.integers(-127, 128, (M, K), dtype=np.int8))
        w8 = torch.from_numpy(rng.integers(-127, 128, (N, K), dtype=np.int8))
        unit = 2.0 / (5400.0 * K ** 0.5)
        cs = torch.from_numpy((rng.random(N, dtype=np.float32) + 0.5) * np.float32(unit))
        bias = torch.from_numpy(rng.standard_normal(N, dtype=np.float32) * np.float32(0.5))
        rs = torch.from_numpy(rng.random(M, dtype=np.float32) + np.float32(0.5))
        for out, act, rows, with_bias, residual in cases:
            alpha = 1.0 if rows else 0.037
            kw = dict(row_scale=rs if rows else None, col_alpha=alpha, act=act)
            res = None
            if residual is not None:
                res = torch.from_numpy(rng.standard_normal((M, N), dtype=np.float32)).to(
                    torch.float32 if residual == "f32" else torch.bfloat16)
            plan = schedules.gemm_i8_plan(M, N, K, out, act)
            if out == "s32":
                want = primitives.gemm_i8_plain(a8, w8)
            elif out == "s8":
                want = primitives.gemm_i8_plain(a8, w8, cs, bias if with_bias else None,
                                                out_scale=0.05, **kw)
            else:
                want = primitives.gemm_i8_plain(
                    a8, w8, cs, bias if with_bias else None, residual=res,
                    out_dtype=torch.float32 if out == "f32" else torch.bfloat16, **kw)
            got = _walk(plan, a8, w8, cs, bias if with_bias else None, kw["row_scale"], alpha,
                        act, res, out, 0.05)
            assert got.dtype == want.dtype and got.shape == want.shape
            if out == "s8":
                assert (got.int() - want.int()).abs().max().item() <= 1, (M, N, K, out, act)
            else:
                assert torch.equal(_bits(got), _bits(want)), (M, N, K, out, act, rows, with_bias)


def test_plan_and_wrapper_refuse_what_the_kernel_cannot_take():
    bad = [dict(M=4, N=8, K=24), dict(M=4, N=7, K=32), dict(M=0, N=8, K=16),
           dict(M=8, N=0, K=16), dict(M=2 ** 31, N=8, K=16),
           dict(M=4, N=8, K=16, out="s16"), dict(M=4, N=8, K=16, out="s32", act="gelu")]
    for kw in bad:
        with pytest.raises(ValueError):
            schedules.gemm_i8_plan(**kw)
    a8, w8 = torch.zeros(4, 16, dtype=torch.int8), torch.zeros(8, 16, dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA tensor"):  # no fallback inside the kernel wrapper
        primitives.gemm_i8_cuda(a8, w8)
    assert primitives.gemm_i8_cuda.launches == 0
    assert torch.equal(primitives.for_device(a8).gemm_i8(a8, w8), torch.zeros(4, 8, dtype=torch.int32))


def test_int8_staging_tile_swizzle():
    """The int8 codes of one warp instruction (8 rows x 4 pairs of bytes at
    tile column 8 j) fall in 16 different words on 16 different banks, two
    lanes to a word; offsets are unique, and a box of 64 rows holds 128
    columns in 8 KB."""
    for j in range(32):
        words = {(schedules.gemm_staging_offset(16 + g, 8 * j + 2 * t, elt=1) // 4)
                 for g in range(8) for t in range(4)}
        assert len(words) == 16 and len({w % 32 for w in words}) == 16, j
    offs = {schedules.gemm_staging_offset(r, c, elt=1) for r in range(64) for c in range(256)}
    assert len(offs) == 64 * 256 and max(offs) == 2 * 8192 - 1
    for r in range(64):
        for c in range(0, 128, 16):  # a 16-byte chunk stays whole, at chunk ^ (row % 8)
            o = schedules.gemm_staging_offset(r, c, elt=1)
            assert o == r * 128 + (((c // 16) ^ (r % 8)) * 16)
            assert schedules.gemm_staging_offset(r, c + 15, elt=1) == o + 15
