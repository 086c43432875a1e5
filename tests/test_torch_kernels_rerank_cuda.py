"""The kernels of the ITM rerank against their plain PyTorch versions on the
card, at the rerank's shapes: K3 and K4 at ``SERVING_SHAPES["rerank"]`` (750
pairs into the 514-row [reference; candidate] memory), the fp32 and s8 GEMMs
at the memory's key / value product of a CIRR tile on EVA ViT-g (M =
3000 x 514, K = 1408: more than 2^31 elements, one launch each), the fp32
attention at a CIRR tile's calls (B = 3000 in gridDim.z), and the refusal of
a tile past the grid's limit (the tolerances are stated in
sprc_tpu_torch/kernel_checks.py).

Marked ``cuda``: each test skips where no CUDA device is present, deciding
inside the fixture, never at import. On a GPU machine:

    python -m pytest tests/test_torch_kernels_rerank_cuda.py -m cuda
"""

import pytest
import torch

from sprc_tpu_torch import kernel_checks
from sprc_tpu_torch.ops import primitives, schedules

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


def test_qformer_layer_and_chain_at_the_rerank_shape(cuda):
    _assert_ok(kernel_checks.check_qformer_layer("rerank", cuda))
    _assert_ok(kernel_checks.check_qformer_trunk("rerank", cuda))


def test_gemms_take_products_past_2_31_elements(cuda):
    """F5: the fp32 and the s8 GEMM at M K = 2,171,136,000, each launched
    once (no slicing) and held against its plain version."""
    name = "qformer cross kv, rerank, EVA"
    M, N, K, _ = kernel_checks.GEMM_F32_PRODUCTS[name]
    assert M * K >= 2 ** 31
    before = primitives.gemm_cuda.launches_f32
    _assert_ok(kernel_checks.check_gemm(name, cuda))
    assert primitives.gemm_cuda.launches_f32 > before
    _assert_ok(kernel_checks.check_gemm_i8(name, cuda))


def test_attention_at_the_rerank_calls_and_the_grid_limit(cuda):
    for name in ("rerank cross", "rerank self"):
        _assert_ok(kernel_checks.check_qformer_attention(name, cuda))
    B = schedules.GRID_YZ_MAX + 1
    q = torch.zeros(B, 1, 64, device=cuda)
    before = primitives.attention_cuda.launches_f32
    with pytest.raises(ValueError, match="gridDim.z"):
        primitives.attention_cuda(q, q, q, 1, 0.125)
    assert primitives.attention_cuda.launches_f32 == before
