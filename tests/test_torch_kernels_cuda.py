"""The Hopper kernels against their plain PyTorch versions on the card, at the
serving path's shapes (the checks of chip_smoke.py's kernel phase; the
tolerances are stated in sprc_tpu_torch/kernel_checks.py).

Marked ``cuda``: each test skips where no CUDA device is present, deciding
inside the fixture, never at import. On a GPU machine:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda
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


def test_token_max_sim_kernel(cuda):
    _assert_ok(kernel_checks.check_token_max_sim(cuda))


def test_vit_block_kernel(cuda):
    """One block within its bounds, the 23-block chain stage by stage, and
    the bf16 GEMM at the 4096^3 ablation shape."""
    _assert_ok(kernel_checks.check_vit_block(cuda))
    _assert_ok(kernel_checks.check_vit_tower(cuda))
    _assert_ok(kernel_checks.check_gemm_bf16_ablate(cuda))


# the main paths' shapes; the rerank's is held by test_torch_kernels_rerank_cuda.py
MAIN_SHAPES = ("fusion", "prompt", "queries")


@pytest.mark.parametrize("shape", MAIN_SHAPES)
def test_qformer_layer_kernel(shape, cuda):
    _assert_ok(kernel_checks.check_qformer_layer(shape, cuda))


@pytest.mark.parametrize("shape", MAIN_SHAPES)
def test_qformer_trunk_kernel_chain(shape, cuda):
    _assert_ok(kernel_checks.check_qformer_trunk(shape, cuda))
