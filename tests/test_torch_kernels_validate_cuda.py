"""The validate path's Hopper kernels against their plain PyTorch versions on
the card: K6 ``fused_attn_block``, K7 ``fused_mlp_block``, K8
``flash_attention``, the attention kernel at head dim 88, and K2 / K5 and the
dense products at EVA ViT-g's shapes (the checks of chip_smoke.py's kernel
phase; the tolerances are stated in sprc_tpu_torch/kernel_checks.py).

Marked ``cuda``: each test skips where no CUDA device is present, deciding
inside the fixture, never at import. On a GPU machine:

    python -m pytest tests/test_torch_kernels_validate_cuda.py -m cuda
"""

import pytest
import torch

from sprc_tpu_torch import kernel_checks
from sprc_tpu_torch.ops import primitives

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


@pytest.mark.parametrize("D", [64, 88])
def test_flash_attention_kernel(D, cuda):
    _assert_ok(kernel_checks.check_flash_attention(D, device=cuda))
    _assert_ok(kernel_checks.check_flash_attention(D, torch.float32, cuda, B=8, Sq=32))


def test_attention_kernel_head_dim_88(cuda):
    _assert_ok(kernel_checks.check_attention(88, device=cuda))
    _assert_ok(kernel_checks.check_attention(88, torch.float32, cuda, B=8))
    q = torch.zeros(2, 130, 4 * 80, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dims"):  # no fallback on a CUDA tensor
        primitives.attention_cuda(q, q, q, 4, 0.1)


@pytest.mark.parametrize("tower", sorted(kernel_checks.TOWERS))
def test_half_block_kernels(tower, cuda):
    W, M, heads, quick, eps = kernel_checks.TOWERS[tower]
    _assert_ok(kernel_checks.check_attn_block(cuda, W=W, heads=heads, eps=eps))
    _assert_ok(kernel_checks.check_mlp_block(cuda, W=W, M=M, quick=quick, eps=eps))


def test_block_kernels_at_eva_shapes(cuda):
    W, M, heads, quick, eps = kernel_checks.TOWERS["eva_g"]
    kw = dict(W=W, M=M, heads=heads, quick=quick, eps=eps)
    _assert_ok(kernel_checks.check_vit_block(cuda, **kw))
    _assert_ok(kernel_checks.check_vit_block_i8(cuda, **kw))


def test_eva_dense_products(cuda):
    for name in kernel_checks.GEMM_PRODUCTS:
        _assert_ok(kernel_checks.check_gemm(name, cuda))
    for name in kernel_checks.GEMM_I8_PRODUCTS:
        if "eva" in name.lower():
            _assert_ok(kernel_checks.check_gemm_i8(name, cuda))
