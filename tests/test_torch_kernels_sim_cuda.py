"""Kernel K1 of csrc/token_max_sim.cu (a persistent 3xTF32 product whose
epilogue takes the max over each item's tokens) against its plain PyTorch
version on the card: ragged batches, galleries, token counts and depths
within 1e-5, copied items tied bit for bit, NaN and infinities where the
plain version gives them, a gallery past 2^31 elements (chip_smoke.py's
edge phase); the serving shape; the C entry's plan against ``schedules.token_max_sim_plan`` and the card's
resident blocks; the launch count and the refusals.

Marked ``cuda``: each test skips where no CUDA device is present, deciding
inside the fixture, never at import. On a GPU machine:

    python -m pytest tests/test_torch_kernels_sim_cuda.py -m cuda
"""

import pytest
import torch

from sprc_tpu_torch import kernel_checks
from sprc_tpu_torch.ops.sim_kernels import token_max_sim

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return "cuda"


def test_token_max_sim_edges(cuda):
    row = kernel_checks.check_token_max_sim_edges(cuda)
    assert row["ok"], row["shape"]


def test_token_max_sim_at_the_serving_shape(cuda):
    row = kernel_checks.check_token_max_sim(cuda)
    assert row["ok"] and row["within_1e-5"], row


def test_plan_agrees_with_the_launch(cuda):
    row = kernel_checks.check_token_max_sim_plan(cuda)
    assert row["ok"], row


def test_launch_count_and_refusals(cuda):
    f = torch.randn(3, 256, device=cuda)
    t = torch.randn(5, 32, 256, device=cuda)
    before = token_max_sim.launches
    with torch.inference_mode():
        token_max_sim(f, t)
        with pytest.raises(ValueError, match="Q <= 32"):
            token_max_sim(f, torch.randn(5, 33, 256, device=cuda))
        with pytest.raises(ValueError, match="contiguous"):
            token_max_sim(f, t.transpose(0, 1))
        with pytest.raises(ValueError, match="CUDA"):
            token_max_sim(f, t.cpu())
    torch.cuda.synchronize()
    assert token_max_sim.launches == before + 1
