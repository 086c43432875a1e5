"""The fp32 attention of csrc/attention.cu (register tiles on the CUDA cores,
a cp.async ring of 32-key chunks) and the LayerNorm of csrc/layernorm.cu
(one warp a row, the row in registers) against their plain PyTorch versions
on the card: ragged shapes (chip_smoke.py's edge phase), every call of the
main paths, the kernels' own launch counts, and the refusals (the tolerances
are stated in sprc_tpu_torch/kernel_checks.py).

Marked ``cuda``: each test skips where no CUDA device is present, deciding
inside the fixture, never at import. On a GPU machine:

    python -m pytest tests/test_torch_kernels_norm_attn_cuda.py -m cuda
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


def test_attention_f32_edges(cuda):
    _assert_ok(kernel_checks.check_attention_f32_edges(cuda))


def test_layer_norm_edges(cuda):
    _assert_ok(kernel_checks.check_layer_norm_edges(cuda))


@pytest.mark.parametrize("name", sorted(n for n in kernel_checks.QF_ATTENTION
                                         if not n.startswith("rerank")))
def test_attention_f32_at_the_qformer_calls(name, cuda):
    _assert_ok(kernel_checks.check_qformer_attention(name, cuda))


@pytest.mark.parametrize("name", sorted(kernel_checks.LN_CALLS))
def test_layer_norm_at_the_main_path_calls(name, cuda):
    _assert_ok(kernel_checks.check_layer_norm(name, cuda))


def test_each_wrapper_counts_its_launches(cuda):
    q = torch.randn(2, 40, 2 * 64, device=cuda)
    x = torch.randn(9, 1024, device=cuda, dtype=torch.bfloat16)
    w, b = torch.ones(1024, device=cuda), torch.zeros(1024, device=cuda)
    before = (primitives.attention_cuda.launches_f32, primitives.attention_cuda.launches_bf16,
              primitives.layer_norm_cuda.launches, primitives.layer_norm_cuda.launches_q8)
    with torch.inference_mode():
        primitives.attention_cuda(q, q, q, 2, 0.125)
        primitives.layer_norm_cuda(x, w, b, 1e-5)
        primitives.layer_norm_cuda(x, w, b, 1e-5, out_scale=0.05)
    torch.cuda.synchronize()
    after = (primitives.attention_cuda.launches_f32, primitives.attention_cuda.launches_bf16,
             primitives.layer_norm_cuda.launches, primitives.layer_norm_cuda.launches_q8)
    assert [a - c for a, c in zip(after, before)] == [1, 0, 1, 1]


def test_refusals_before_any_launch(cuda):
    """A row the fp32 path cannot read in 16-byte units, and a row past 4096,
    are refused by the wrappers; nothing is counted."""
    before = (primitives.attention_cuda.launches_f32, primitives.layer_norm_cuda.launches)
    q = torch.randn(2, 40, 2 * 64 + 1, device=cuda)[..., 1:]  # rows 4 bytes off
    with pytest.raises(ValueError, match="16-byte"):
        primitives.attention_cuda(q, q, q, 2, 0.125)
    x = torch.randn(3, 4100, device=cuda)
    with pytest.raises(ValueError, match="4096"):
        primitives.layer_norm_cuda(x, torch.ones(4100, device=cuda), torch.zeros(4100, device=cuda),
                                   1e-5)
    assert (primitives.attention_cuda.launches_f32, primitives.layer_norm_cuda.launches) == before
    assert schedules.attention_f32_warps(257) == 6
