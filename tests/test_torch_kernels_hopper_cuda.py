"""The two tensor-core kernels written for Hopper (the bf16 GEMM of
csrc/gemm.cu: wgmma, TMA, mbarrier ring; the bf16 attention of
csrc/attention.cu: mma.sync with scores in registers) against their plain
PyTorch versions on the card, over ragged shapes: tile edges, every epilogue
and both residual modes, strided packed-qkv views, BSHD tensors, a fully
masked row (the checks of chip_smoke.py's edge phase; the tolerances are
stated in sprc_tpu_torch/kernel_checks.py).

Marked ``cuda``: each test skips where no CUDA device is present, deciding
inside the fixture, never at import. On a GPU machine:

    python -m pytest tests/test_torch_kernels_hopper_cuda.py -m cuda
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


def test_gemm_bf16_tile_edges_and_epilogues(cuda):
    _assert_ok(kernel_checks.check_gemm_edges(cuda))


def test_attention_bf16_tile_edges_and_layouts(cuda):
    _assert_ok(kernel_checks.check_attention_edges(cuda))


@pytest.mark.parametrize("tile_n", [128, 256])
def test_gemm_bf16_both_tile_widths(tile_n, cuda):
    """Either tile width on any shape, whatever the plan would choose."""
    lib = _ext.library()
    gen = torch.Generator(device=cuda).manual_seed(tile_n)
    for M, N, K in kernel_checks.GEMM_EDGE_SHAPES:
        x = torch.empty(M, K, device=cuda).normal_(generator=gen).bfloat16()
        w = torch.empty(N, K, device=cuda).normal_(0, 0.05, generator=gen).bfloat16()
        b = torch.empty(N, device=cuda).normal_(0, 0.05, generator=gen)
        res = torch.empty(M, N, device=cuda).normal_(generator=gen).bfloat16()
        y = torch.empty(M, N, device=cuda, dtype=torch.bfloat16)
        _ext.check(lib.sprc_gemm(x.data_ptr(), w.data_ptr(), b.data_ptr(), res.data_ptr(),
                                 y.data_ptr(), M, N, K, _ext.BF16, _ext.ACT["gelu"], 1, 128,
                                 tile_n, primitives._stream()), "gemm")
        torch.cuda.synchronize()
        want = primitives.gemm_plain(x, w, b, "gelu", res, True)
        stage = kernel_checks._held("gemm, fp32 residual", y, want)
        assert stage["ok"] and bool(torch.isfinite(y).all()), (M, N, K, stage)
    y = torch.empty(8, 8, device=cuda, dtype=torch.bfloat16)
    code = lib.sprc_gemm(y.data_ptr(), y.data_ptr(), None, None, y.data_ptr(), 8, 8, 8, _ext.BF16,
                         0, 0, 128, 64, primitives._stream())
    assert code != 0  # a tile width that is not built is refused, not replaced


def test_gemm_bf16_at_the_ablation_shape_and_the_towers_products(cuda):
    _assert_ok(kernel_checks.check_gemm_bf16_ablate(cuda))
    for name, spec in kernel_checks.GEMM_PRODUCTS.items():
        if spec[3] == torch.bfloat16:
            _assert_ok(kernel_checks.check_gemm(name, cuda))


def test_gemm_counts_its_two_kernels_apart_and_raises_on_what_it_does_not_take(cuda):
    x = torch.zeros(4, 16, device=cuda, dtype=torch.bfloat16)
    before = (primitives.gemm_cuda.launches_bf16, primitives.gemm_cuda.launches_f32)
    primitives.gemm_cuda(x, x)
    primitives.gemm_cuda(x.float(), x.float())
    primitives.gemm_cuda(x.float(), x.float())
    assert (primitives.gemm_cuda.launches_bf16, primitives.gemm_cuda.launches_f32) == (
        before[0] + 1, before[1] + 2)
    with pytest.raises(ValueError, match="K % 8"):
        primitives.gemm_cuda(x[:, :12].contiguous(), x[:, :12].contiguous())
    with pytest.raises(ValueError, match="aligned"):
        primitives.gemm_cuda(x, x, torch.zeros(5, device=cuda)[1:])
    assert schedules.gemm_bf16_plan(4, 4, 16)["tile_n"] == 128


def test_attention_at_the_towers_shapes(cuda):
    for D in primitives.HEAD_DIMS:
        _assert_ok(kernel_checks.check_flash_attention(D, device=cuda))
        _assert_ok(kernel_checks.check_attention(D, device=cuda))


def test_gemm_host_cost_is_reported(cuda):
    row = kernel_checks.check_gemm_host_cost(cuda, calls=50)
    assert row["host_us_bf16"] > 0 and row["host_us_f32"] > 0
