"""The true-fp32 GEMM kernel's tiling and shared-memory arithmetic
(sprc_tpu_torch/ops/schedules.py::gemm_f32_plan), which the wrapper consults
before every fp32 launch of csrc/gemm.cu.

The kernel runs only on a card. What can be wrong outside the CUDA source is
held here: which block tile each Q-Former product gets and how many waves of
132 SMs it takes, that the tiles and the threads' outputs cover every output
element once, that a warp's float4 reads of the shared-memory stages are
free of bank conflicts, what the plan and the wrapper refuse, and, by walking
the plan tile by tile in plain PyTorch (zero-filled 32-deep stages, the
epilogue's order; no split of K, so no reduction across blocks), that the
cut computes ``gemm_plain`` within the bound of its stage. Inputs come from
numpy generators seeded per test.
"""

import numpy as np
import pytest
import torch

from sprc_tpu_torch.ops import primitives, schedules
from test_torch_threads import one_torch_thread  # noqa: E402,F401  (one thread a module)

# the Q-Former's fp32 products (K3) and an fp32 tower's fc2: (M, N, K) ->
# (block tile, waves of 132 SMs)
PRODUCTS = {
    (1024, 768, 768): ((64, 96), 1),      # cross q / out on a query batch's query rows
    (2048, 768, 768): ((64, 96), 2),      # self q / k / v / out
    (2048, 768, 3072): ((64, 96), 2),     # fc2
    (1024, 768, 3072): ((64, 96), 1),     # fc2 on half the rows
    (2048, 3072, 768): ((128, 128), 3),   # fc1
    (1024, 3072, 768): ((64, 96), 4),     # fc1 on half the rows
    (16448, 768, 1024): ((128, 128), 6),  # the image's k / v, queries pass
    (8224, 768, 1408): ((128, 128), 3),   # the image's k / v, fusion pass, EVA
    (2056, 1024, 4096): ((64, 96), 3),    # an fp32 tower's fc2
}
RAGGED = [(M, N, K) for M in (1, 63, 65, 257, 2048) for N, K in ((8, 4), (130, 36), (1000, 72),
                                                                 (37, 132), (384, 1028))]


def test_plan_of_the_qformer_products():
    for (M, N, K), (tile, waves) in PRODUCTS.items():
        p = schedules.gemm_f32_plan(M, N, K)
        assert (p["tile_m"], p["tile_n"]) == tile and p["waves"] == waves, (M, N, K, p)
        assert p["thread_tile"] == (tile[0] // 16, tile[1] // 16)
        assert p["grid"] == (p["tiles_n"], p["tiles_m"])
        assert p["smem_bytes"] == 4 * 4 * 36 * (tile[0] + tile[1]) <= 232448
        assert p["k_steps"] == -(-K // 32)
    # the one-wave product fills 97 % of the card
    assert schedules.gemm_f32_plan(1024, 768, 768)["tiles"] == 128
    # the cost model: fewer waves of a tile beat more waves of a faster one
    assert schedules.gemm_f32_cost(1024, 768, (64, 96)) < schedules.gemm_f32_cost(
        1024, 768, (128, 128))


def test_tiles_and_threads_cover_the_output_once():
    for M, N, K in RAGGED:
        p = schedules.gemm_f32_plan(M, N, K)
        assert 1 <= p["last_rows"] <= p["tile_m"] and 1 <= p["last_cols"] <= p["tile_n"]
        assert (p["tiles_m"] - 1) * p["tile_m"] + p["last_rows"] == M
        assert (p["tiles_n"] - 1) * p["tile_n"] + p["last_cols"] == N
        assert (p["k_steps"] - 1) * 32 + p["last_depth"] == K
        seen = np.zeros((M, N), np.int32)
        for m0, n0 in schedules.gemm_f32_tiles(p):
            seen[m0:m0 + p["tile_m"], n0:n0 + p["tile_n"]] += 1
        assert (seen == 1).all(), (M, N, K)
    for (bm, bn) in schedules.GEMM_F32_TILES:  # each thread's outputs, within one tile
        seen = np.zeros((bm, bn), np.int32)
        for tid in range(256):
            ty, tx = schedules.gemm_f32_thread(tid)
            for i in range(bm // 16):
                for j in range(bn // 16):
                    seen[ty + 16 * i, tx + 16 * j] += 1
        assert (seen == 1).all(), (bm, bn)


def test_shared_memory_reads_are_conflict_free():
    """A float4 read is served a quarter warp (8 lanes) at a time: within one,
    the distinct 16-byte chunks the lanes ask for must lie on distinct
    groups of 4 banks. The stage rows are 36 floats apart (144 bytes, a
    multiple of the 16 bytes a cp.async copy writes)."""
    pitch = schedules.GEMM_F32_PITCH
    assert (pitch * 4) % 16 == 0
    for tm, tn in ((8, 8), (4, 6)):
        for warp in range(8):
            for q in range(4):
                lanes = [schedules.gemm_f32_thread(warp * 32 + 8 * q + k) for k in range(8)]
                for kk in range(0, 32, 4):
                    for i in range(tm):  # X rows ty + 16 i
                        rows = {ty + 16 * i for ty, _ in lanes}
                        assert len({((r * pitch + kk) % 32) // 4 for r in rows}) == len(rows)
                    for j in range(tn):  # W rows tx + 16 j
                        rows = {tx + 16 * j for _, tx in lanes}
                        assert len(rows) == 8
                        assert len({((r * pitch + kk) % 32) // 4 for r in rows}) == 8


def _walk(plan, x, w, b, act, residual):
    """The product as the kernel cuts it: per block tile, zero-filled stages
    of 32 along K summed in order, then bias, activation, residual."""
    M, K = x.shape
    N = w.shape[0]
    tm, tn, tk = plan["tile_m"], plan["tile_n"], plan["tile_k"]
    y = torch.full((M, N), float("nan"))
    for m0, n0 in schedules.gemm_f32_tiles(plan):
        acc = torch.zeros(tm, tn)
        for k0 in range(0, plan["k_steps"] * tk, tk):
            xa, wb = torch.zeros(tm, tk), torch.zeros(tn, tk)
            xs, ws = x[m0:m0 + tm, k0:k0 + tk], w[n0:n0 + tn, k0:k0 + tk]
            xa[:xs.shape[0], :xs.shape[1]] = xs
            wb[:ws.shape[0], :ws.shape[1]] = ws
            acc += xa @ wb.t()
        rows, cols = min(tm, M - m0), min(tn, N - n0)
        v = acc[:rows, :cols]
        if b is not None:
            v = v + b[n0:n0 + cols]
        v = primitives.ACT_FNS[act](v)
        if residual is not None:
            v = v + residual[m0:m0 + rows, n0:n0 + cols]
        y[m0:m0 + rows, n0:n0 + cols] = v
    return y


def test_the_cut_computes_gemm_plain():
    """Another summation order than plain's: within the bound of the stage
    "gemm -> f32" (1.5e-5 of the largest |y|), every element written."""
    rng = np.random.default_rng(47)
    for M, N, K in ((65, 130, 36), (257, 37, 132), (129, 264, 4), (1, 8, 100), (70, 200, 68)):
        x = torch.from_numpy(rng.standard_normal((M, K), dtype=np.float32))
        w = torch.from_numpy(rng.standard_normal((N, K), dtype=np.float32) * np.float32(0.1))
        b = torch.from_numpy(rng.standard_normal(N, dtype=np.float32) * np.float32(0.1))
        res = torch.from_numpy(rng.standard_normal((M, N), dtype=np.float32))
        plan = schedules.gemm_f32_plan(M, N, K)
        for act, with_bias, residual in ((None, False, None), (None, True, None),
                                         ("gelu", True, None), ("quick_gelu", True, None),
                                         (None, True, res)):
            bias = b if with_bias else None
            got = _walk(plan, x, w, bias, act, residual)
            for f32 in (False, True):  # in fp32 the two residual modes are one sum
                want = primitives.gemm_plain(x, w, bias, act, residual, f32)
                assert bool(torch.isfinite(got).all())
                err = (got - want).abs().max().item() / want.abs().max().item()
                assert err <= 1.5e-5, (M, N, K, act, with_bias, f32, err)


def test_plan_and_wrapper_refuse_what_the_kernel_cannot_take():
    # K % 4, an empty product, M past the C entry's int, row tiles past gridDim.y
    for bad in ((4, 4, 6), (4, 4, 2 + 4 * 3 + 1), (0, 8, 8), (8, 0, 8), (2 ** 31, 8, 8),
                (128 * 65536, 8, 8)):
        with pytest.raises(ValueError):
            schedules.gemm_f32_plan(*bad)
    x, w = torch.zeros(4, 8), torch.zeros(4, 8)
    with pytest.raises(ValueError, match="CUDA tensor"):  # no fallback inside the kernel wrapper
        primitives.gemm_cuda(x, w)
    assert primitives.gemm_cuda.launches_f32 == 0 and primitives.gemm_cuda.launches_bf16 == 0
    torch.testing.assert_close(primitives.for_device(x).gemm(x, w), torch.zeros(4, 4))


# the rerank's cross key / value product on EVA ViT-g at a CIRR validation
# tile: 3000 candidates x 514 memory rows, K = 1408 (2,171,136,000 elements)
RERANK_KV_EVA = (3000 * 514, 768, 1408)


def test_plans_and_wrappers_take_products_past_2_31_elements(monkeypatch):
    """The fp32 and s8 GEMMs form every offset in 64 bits: their plans take
    M K >= 2^31 (one launch, no slicing), and so do their wrappers, driven on
    ``meta`` tensors through the CUDA branch with the C entry faked: each is
    called once with the whole M and counted once. The bf16 plan still
    refuses it."""
    M, N, K = RERANK_KV_EVA
    assert M * K >= 2 ** 31
    f32 = schedules.gemm_f32_plan(M, N, K)
    assert f32["tile_m"] * f32["tiles_m"] >= M and f32["tiles_m"] <= schedules.GRID_YZ_MAX
    i8 = schedules.gemm_i8_plan(M, N, K, "f32")
    assert i8["a_map"]["dims"] == (K, M) and i8["tiles"] == i8["tiles_m"] * i8["tiles_n"]
    with pytest.raises(ValueError, match="32-bit"):
        schedules.gemm_bf16_plan(M, N, K)
    # the tile's attention: B = 3000 items fit gridDim.z, 65,536 do not
    assert schedules.attention_f32_plan(32, 514, 64, B=3000, H=12)["grid"] == (1, 12, 3000)
    with pytest.raises(ValueError, match="gridDim.z"):
        schedules.attention_f32_plan(32, 514, 64, B=schedules.GRID_YZ_MAX + 1, H=12)

    calls = []

    class FakeLib:
        def sprc_gemm(self, *args):
            calls.append(("gemm", args[5:8]))
            return 0

        def sprc_gemm_i8(self, *args):
            calls.append(("gemm_i8", args[7:10]))
            return 0

    monkeypatch.setattr(primitives._ext, "library", lambda: FakeLib())
    monkeypatch.setattr(primitives, "_check", lambda name, x, *o: primitives._ext.F32)
    monkeypatch.setattr(primitives, "_check_i8", lambda name, t: None)
    monkeypatch.setattr(primitives, "_stream", lambda: None)
    monkeypatch.setattr(primitives.gemm_cuda, "launches_f32", 0)
    monkeypatch.setattr(primitives.gemm_i8_cuda, "launches", 0)
    x = torch.empty(3000, 514, K, device="meta")
    y = primitives.gemm_cuda(x, torch.empty(N, K, device="meta"), torch.empty(N, device="meta"))
    x8 = torch.empty(3000, 514, K, dtype=torch.int8, device="meta")
    y8 = primitives.gemm_i8_cuda(x8, torch.empty(N, K, dtype=torch.int8, device="meta"),
                                 torch.empty(N, device="meta"), torch.empty(N, device="meta"),
                                 row_scale=torch.empty(3000, 514, device="meta"))
    assert y.shape == y8.shape == (3000, 514, N) and y8.dtype == torch.float32
    assert calls == [("gemm", (M, N, K)), ("gemm_i8", (M, N, K))]
    assert primitives.gemm_cuda.launches_f32 == 1 and primitives.gemm_i8_cuda.launches == 1
