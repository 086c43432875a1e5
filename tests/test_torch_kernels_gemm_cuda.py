"""The s8 GEMM of csrc/gemm_i8.cu (wgmma s8, TMA, mbarrier ring) and the
true-fp32 GEMM of csrc/gemm.cu (cp.async ring, CUDA-core FMA) against their
plain PyTorch versions on the card: ragged shapes with every output mode and
epilogue (chip_smoke.py's edge phase), every tile each kernel is built with
whatever its plan would choose, the main paths' products, the refusals, and
the host side of a call (the tolerances are stated in
sprc_tpu_torch/kernel_checks.py).

Marked ``cuda``: each test skips where no CUDA device is present, deciding
inside the fixture, never at import. On a GPU machine:

    python -m pytest tests/test_torch_kernels_gemm_cuda.py -m cuda
"""

import pytest
import torch

from sprc_tpu_torch import kernel_checks
from sprc_tpu_torch.ops import _ext, primitives, schedules

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return "cuda"


def _assert_ok(row):
    assert row["ok"], row


def test_gemm_i8_tile_edges_output_modes_and_epilogues(cuda):
    _assert_ok(kernel_checks.check_gemm_i8_edges(cuda))


def test_gemm_f32_tile_edges_and_epilogues(cuda):
    _assert_ok(kernel_checks.check_gemm_edges(cuda, dtype=torch.float32))


@pytest.mark.parametrize("tile_n", [128, 256])
def test_gemm_i8_both_tile_widths_raw(tile_n, cuda):
    """Either tile width on any shape, whatever the plan would choose: the raw
    product equal to plain; a specialisation that is not built is refused."""
    lib = _ext.library()
    gen = torch.Generator(device=cuda).manual_seed(tile_n)
    for M, N, K in kernel_checks.GEMM_I8_EDGE_SHAPES:
        a8 = torch.randint(-127, 128, (M, K), generator=gen, device=cuda).to(torch.int8)
        w8 = torch.randint(-127, 128, (N, K), generator=gen, device=cuda).to(torch.int8)
        y = torch.empty(M, N, device=cuda, dtype=torch.int32)
        _ext.check(lib.sprc_gemm_i8(a8.data_ptr(), w8.data_ptr(), None, None, None, None,
                                    y.data_ptr(), M, N, K, _ext.OUT_S32, 0, 0.0, 1.0, tile_n,
                                    primitives._stream()), "gemm_i8")
        torch.cuda.synchronize()
        assert torch.equal(y.long(), primitives.gemm_i8_plain(a8, w8).long()), (M, N, K)
    y = torch.empty(16, 16, device=cuda, dtype=torch.float32)
    a8 = torch.zeros(16, 16, device=cuda, dtype=torch.int8)
    for tile, out, act in ((tile_n, _ext.OUT_S32, _ext.ACT["gelu"]), (256, _ext.OUT_F32, 0),
                           (64, _ext.OUT_BF16, 0)):
        code = lib.sprc_gemm_i8(a8.data_ptr(), a8.data_ptr(), None, y.data_ptr(), None, None,
                                y.data_ptr(), 16, 16, 16, out, act, 0.0, 1.0, tile,
                                primitives._stream())
        assert code != 0, (tile, out, act)


def test_gemm_f32_every_block_tile(cuda):
    """Each of the fp32 kernel's block tiles on the ragged shapes, with exact
    GELU and a residual, within the bound of its stage; a tile that is not
    built is refused."""
    lib = _ext.library()
    gen = torch.Generator(device=cuda).manual_seed(5)
    for tm, tn in schedules.GEMM_F32_TILES:
        for M, N, K in kernel_checks.GEMM_F32_EDGE_SHAPES:
            x = torch.empty(M, K, device=cuda).normal_(generator=gen)
            w = torch.empty(N, K, device=cuda).normal_(0, 0.05, generator=gen)
            b = torch.empty(N, device=cuda).normal_(0, 0.05, generator=gen)
            res = torch.empty(M, N, device=cuda).normal_(generator=gen)
            y = torch.empty(M, N, device=cuda)
            _ext.check(lib.sprc_gemm(x.data_ptr(), w.data_ptr(), b.data_ptr(), res.data_ptr(),
                                     y.data_ptr(), M, N, K, _ext.F32, _ext.ACT["gelu"], 1, tm, tn,
                                     primitives._stream()), "gemm")
            torch.cuda.synchronize()
            stage = kernel_checks._held("gemm, fp32 residual", y,
                                        primitives.gemm_plain(x, w, b, "gelu", res, True))
            assert stage["ok"] and bool(torch.isfinite(y).all()), (tm, tn, M, N, K, stage)
    y = torch.empty(8, 8, device=cuda)
    code = lib.sprc_gemm(y.data_ptr(), y.data_ptr(), None, None, y.data_ptr(), 8, 8, 8, _ext.F32,
                         0, 0, 64, 64, primitives._stream())
    assert code != 0


def test_gemm_i8_at_the_main_paths_products(cuda):
    for name in kernel_checks.GEMM_I8_PRODUCTS:
        row = kernel_checks.check_gemm_i8(name, cuda)
        _assert_ok(row)
        assert row["tops"] > 0 and row["library_ms"] > 0


def test_qformer_fp32_gemm_and_attention_at_the_main_paths_shapes(cuda):
    for row in kernel_checks.run_qformer_fp32(cuda):
        _assert_ok(row)
        assert row["library_ms"] > 0


def test_gemm_host_cost_of_each_kernel_is_reported(cuda):
    row = kernel_checks.check_gemm_host_cost(cuda, calls=50)
    assert all(row[f"host_us_{k}"] > 0 for k in ("bf16", "f32", "s8", "s8_rows"))
