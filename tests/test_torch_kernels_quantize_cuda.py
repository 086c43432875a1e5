"""The two activation quantisers of csrc/quantize.cu (a 16-byte stream for
``quantize_static``, a warp a row for ``quantize_rows``) against their plain
PyTorch versions on the card: codes and scales bit-equal over ragged rows and
widths, unaligned views, zero rows, clipped values and exact ties
(chip_smoke.py's edge phase), at every call of the main paths, the wrappers'
launch counts, and the refusals.

Marked ``cuda``: each test skips where no CUDA device is present, deciding
inside the fixture, never at import. On a GPU machine:

    python -m pytest tests/test_torch_kernels_quantize_cuda.py -m cuda
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
    return "cuda"


def test_quantizer_edges(cuda):
    row = kernel_checks.check_quantizer_edges(cuda)
    assert row["ok"], row["shape"]


def test_quantizers_at_the_main_path_calls(cuda):
    for name in kernel_checks.QUANT_CALLS:
        row = kernel_checks.check_quantize(name, cuda)
        assert row["ok"], (name, row["shape"])


def test_each_wrapper_counts_its_launches(cuda):
    x = torch.randn(9, 1024, device=cuda, dtype=torch.bfloat16)
    before = (primitives.quantize_static_cuda.launches, primitives.quantize_rows_cuda.launches)
    with torch.inference_mode():
        primitives.quantize_static_cuda(x, 0.05)
        primitives.quantize_rows_cuda(x)
        primitives.quantize_rows_cuda(x.float())
    torch.cuda.synchronize()
    after = (primitives.quantize_static_cuda.launches, primitives.quantize_rows_cuda.launches)
    assert [a - b for a, b in zip(after, before)] == [1, 2]


def test_refusals_before_any_launch(cuda):
    """Rows past 4096, a strided view and a CPU tensor are refused by the
    wrappers; nothing is counted."""
    before = (primitives.quantize_static_cuda.launches, primitives.quantize_rows_cuda.launches)
    with pytest.raises(ValueError, match="4096"):
        primitives.quantize_rows_cuda(torch.randn(3, 4100, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        primitives.quantize_static_cuda(torch.randn(8, 64, device=cuda).t(), 0.05)
    with pytest.raises(ValueError, match="CUDA"):
        primitives.quantize_rows_cuda(torch.randn(3, 64))
    assert (primitives.quantize_static_cuda.launches,
            primitives.quantize_rows_cuda.launches) == before
