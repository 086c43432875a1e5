"""The bf16 GEMM kernel's tiling and tensor-map arithmetic
(sprc_tpu_torch/ops/schedules.py::gemm_bf16_plan), which the wrapper consults
before every launch of csrc/gemm.cu.

The kernel itself runs only on a card. What can be wrong outside the CUDA
source is held here: which tile width a product gets, the persistent grid,
the boxes of the three tensor maps, the last partial tile along each axis,
what the wrapper refuses, the staging tile's swizzle, and, by walking the
plan tile by tile in plain PyTorch (zero-filled boxes, 64-deep steps, the
epilogue's fp32 order in both residual modes), that the cut computes
``gemm_plain``. Inputs come from numpy generators seeded per test.
"""

import numpy as np
import pytest
import torch

from sprc_tpu_torch.ops import primitives, schedules
from test_torch_threads import one_torch_thread  # noqa: E402,F401  (one thread a module)

VIT_M = 64 * 257  # one encode batch
TOWER_PRODUCTS = {  # name -> (M, N, K, activation, tile width the plan must choose)
    "vit qkv": (VIT_M, 3072, 1024, None, 256), "vit proj": (VIT_M, 1024, 1024, None, 256),
    "vit fc1": (VIT_M, 4096, 1024, "quick_gelu", 128), "vit fc2": (VIT_M, 1024, 4096, None, 256),
    "eva qkv": (VIT_M, 4224, 1408, None, 256), "eva proj": (VIT_M, 1408, 1408, None, 128),
    "eva fc1": (VIT_M, 6144, 1408, "gelu", 128), "eva fc2": (VIT_M, 1408, 6144, None, 128),
    "calibration qkv": (16 * 257, 3072, 1024, None, 256),
}
RAGGED = [(M, N, K) for M in (1, 63, 65, 257, 16448) for N, K in ((8, 8), (130, 72), (1000, 72),
                                                                  (37, 64), (384, 1032))]


def test_plan_of_the_towers_products():
    for name, (M, N, K, act, tile_n) in TOWER_PRODUCTS.items():
        p = schedules.gemm_bf16_plan(M, N, K, act)
        assert p["tile_n"] == tile_n, name
        assert K % p["tile_k"] == 0 and p["last_depth"] == p["tile_k"], name  # whole depth boxes
        assert p["grid"] == schedules.H100_SMS and p["tiles"] >= p["grid"], name
        assert p["tiles_m"] == -(-M // 128) and p["last_rows"] == M - (p["tiles_m"] - 1) * 128
        assert p["y_tma"] and p["y_map"]["box"] == (64, 64), name
        assert p["smem_bytes"] <= 232448, name
        assert p["stages"] * p["stage_bytes"] + p["staging_bytes"] + 1024 == p["smem_bytes"]
        assert p["padding"] <= 0.035, (name, p["padding"])  # 16448 = 128.5 tiles: 0.4 % at least
    # 1408 = 5.5 x 256: the wide tile would pad 9 %, 4224 = 16.5 x 256 pads 3 % and keeps it
    assert schedules.gemm_bf16_plan(VIT_M, 1408, 1408)["padding"] < 0.005
    assert 0.03 < schedules.gemm_bf16_plan(VIT_M, 4224, 1408)["padding"] < 0.035


def test_plan_of_ragged_shapes_covers_the_output_once():
    for M, N, K in RAGGED:
        p = schedules.gemm_bf16_plan(M, N, K)
        assert p["x_map"] == {"dims": (K, M), "pitch": 2 * K, "box": (64, 128)}
        assert p["w_map"] == {"dims": (K, N), "pitch": 2 * K, "box": (64, p["tile_n"])}
        assert p["x_map"]["pitch"] % 16 == 0  # what TMA asks of a row pitch
        assert (p["y_map"] is None) == (N % 8 != 0) == (not p["y_tma"])
        assert 1 <= p["last_rows"] <= 128 and 1 <= p["last_cols"] <= p["tile_n"]
        assert (p["tiles_m"] - 1) * 128 + p["last_rows"] == M
        assert (p["tiles_n"] - 1) * p["tile_n"] + p["last_cols"] == N
        assert (p["k_steps"] - 1) * 64 + p["last_depth"] == K
        assert p["grid"] == min(p["tiles"], schedules.H100_SMS)
        seen = np.zeros((M, N), np.int32)
        for block in range(p["grid"]):
            for m0, n0 in schedules.gemm_tiles_of_block(p, block):
                seen[m0:m0 + 128, n0:n0 + p["tile_n"]] += 1
        assert (seen == 1).all(), (M, N, K)


def test_blocks_in_flight_share_row_bands():
    p = schedules.gemm_bf16_plan(VIT_M, 4224, 1408)
    first = [schedules.gemm_tiles_of_block(p, b)[0] for b in range(p["grid"])]
    assert len({m0 for m0, _ in first}) == -(-p["grid"] // p["tiles_n"])  # 132 tiles: 8 bands of 17
    walk = schedules.gemm_tiles_of_block(p, 5)
    assert len(walk) in (p["tiles"] // p["grid"], p["tiles"] // p["grid"] + 1)
    assert walk[0] == (0, 5 * 256) and walk[1] == (((5 + 132) // 17) * 128, ((5 + 132) % 17) * 256)


def test_plan_and_wrapper_refuse_what_the_kernel_cannot_take():
    for bad in ((4, 4, 12), (4, 4, 4), (0, 8, 8), (8, 0, 8), (1 << 16, 8, 1 << 15)):
        with pytest.raises(ValueError):
            schedules.gemm_bf16_plan(*bad)
    x, w = torch.zeros(4, 8, dtype=torch.bfloat16), torch.zeros(4, 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensor"):  # no fallback inside the kernel wrapper
        primitives.gemm_cuda(x, w)
    assert primitives.gemm_cuda.launches_bf16 == 0 and primitives.gemm_cuda.launches_f32 == 0
    torch.testing.assert_close(primitives.for_device(x).gemm(x, w), torch.zeros(4, 4).bfloat16())


def test_staging_tile_swizzle():
    """The fragment stores of one warp instruction (8 rows x 4 pairs at tile
    column 8 j) fall on 32 different banks, offsets are unique, and a box
    holds its 64 x 64 elements in 8 KB."""
    for j in range(32):
        banks = {(schedules.gemm_staging_offset(16 + g + 8 * h, 8 * j + 2 * t) // 4) % 32
                 for g in range(8) for t in range(4) for h in (0,)}
        assert len(banks) == 32, j
    offs = {schedules.gemm_staging_offset(r, c) for r in range(64) for c in range(256)}
    assert len(offs) == 64 * 256 and max(offs) == 4 * 8192 - 2
    for r in range(64):
        for c in range(0, 64, 8):  # a 16-byte chunk stays whole, at chunk ^ (row % 8)
            o = schedules.gemm_staging_offset(r, c)
            assert o % 16 == 0 and o == r * 128 + (((c // 8) ^ (r % 8)) * 16)
            assert schedules.gemm_staging_offset(r, c + 7) == o + 14


def _walk(plan, x, w, b, act, residual, residual_f32):
    """The product computed as the kernel cuts it: per tile, boxes that hang
    over an edge filled with zeros, fp32 sums over 64-deep steps, then the
    epilogue in the kernel's order."""
    M, K = x.shape
    N = w.shape[0]
    tm, tn, tk = plan["tile_m"], plan["tile_n"], plan["tile_k"]
    y = torch.full((M, N), float("nan"), dtype=x.dtype)
    for block in range(plan["grid"]):
        for m0, n0 in schedules.gemm_tiles_of_block(plan, block):
            acc = torch.zeros(tm, tn)
            for k0 in range(0, plan["k_steps"] * tk, tk):
                xa, wb = torch.zeros(tm, tk), torch.zeros(tn, tk)
                xs, ws = x[m0:m0 + tm, k0:k0 + tk].float(), w[n0:n0 + tn, k0:k0 + tk].float()
                xa[:xs.shape[0], :xs.shape[1]] = xs
                wb[:ws.shape[0], :ws.shape[1]] = ws
                acc += xa @ wb.t()
            rows, cols = min(tm, M - m0), min(tn, N - n0)
            v = acc[:rows, :cols]
            if b is not None:
                v = v + b[n0:n0 + cols]
            v = primitives.ACT_FNS[act](v)
            if residual is not None:
                r = residual[m0:m0 + rows, n0:n0 + cols]
                v = v + r.float() if residual_f32 else (r + v.to(x.dtype)).float()
            y[m0:m0 + rows, n0:n0 + cols] = v.to(x.dtype)
    return y


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_cut_computes_gemm_plain(dtype):
    """fp32 inputs: another summation order, atol 2e-5 at |y| ~ 1. bf16: the
    same fp32 sums rounded once, so at most one bf16 step where a sum sits on
    a rounding edge (2^-7 of the largest |y|)."""
    rng = np.random.default_rng(41)
    for M, N, K in ((65, 130, 72), (257, 37, 64), (129, 264, 136), (1, 8, 8)):
        x = torch.from_numpy(rng.standard_normal((M, K), dtype=np.float32)).to(dtype)
        w = torch.from_numpy(rng.standard_normal((N, K), dtype=np.float32) * 0.1).to(dtype)
        b = torch.from_numpy(rng.standard_normal(N, dtype=np.float32) * 0.1)
        res = torch.from_numpy(rng.standard_normal((M, N), dtype=np.float32)).to(dtype)
        for act, residual, f32 in ((None, None, False), ("gelu", None, False),
                                   ("quick_gelu", None, False), (None, res, False),
                                   (None, res, True)):
            plan = schedules.gemm_bf16_plan(M, N, K, act)
            got = _walk(plan, x, w, b, act, residual, f32).float()
            want = primitives.gemm_plain(x, w, b, act, residual, f32).float()
            assert bool(torch.isfinite(got).all())
            tol = 2e-5 if dtype == torch.float32 else want.abs().max().item() * 2.0 ** -7
            assert (got - want).abs().max().item() <= tol, (M, N, K, act, f32)
