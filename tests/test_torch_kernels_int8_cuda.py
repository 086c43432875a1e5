"""The int8 serving path's Hopper kernels against their plain PyTorch versions
on the card (the int8 rows of chip_smoke.py's kernel phase; the tolerances
are stated in sprc_tpu_torch/kernel_checks.py).

Marked ``cuda``: each test skips where no CUDA device is present, deciding
inside the fixture, never at import. On a GPU machine:

    python -m pytest tests/test_torch_kernels_int8_cuda.py -m cuda
"""

import pytest
import torch

from sprc_tpu_torch import kernel_checks

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


def test_gemm_i8_raw_is_exact(cuda):
    """The s32 product equals the plain one at the 4096^3 ablation shape."""
    _assert_ok(kernel_checks.check_gemm_i8("ablate 4096^3", cuda))


def test_gemm_i8_epilogues(cuda):
    """Every product of the int8 main path, at its shape: the raw product
    and the epilogue the path runs on it equal the plain version."""
    for name in kernel_checks.GEMM_I8_PRODUCTS:
        _assert_ok(kernel_checks.check_gemm_i8(name, cuda))


def test_quantizer_kernels(cuda):
    _assert_ok(kernel_checks.check_quantizers(cuda))


def test_vit_block_i8_kernel(cuda):
    """One int8 block within its bounds, then the 23-block chain stage by stage."""
    _assert_ok(kernel_checks.check_vit_block_i8(cuda))
    _assert_ok(kernel_checks.check_vit_tower_i8(cuda))


@pytest.mark.parametrize("shape", sorted(kernel_checks.SERVING_SHAPES))
def test_qformer_layer_int8_kernel(shape, cuda):
    """One int8 layer within its bounds, then the 12-layer chain stage by stage."""
    _assert_ok(kernel_checks.check_qformer_layer(shape, cuda, int8=True))
    _assert_ok(kernel_checks.check_qformer_trunk(shape, cuda, int8=True))
