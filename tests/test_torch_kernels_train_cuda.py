"""The fine-tune path's kernels on the card: K1 with a gradient
(``TokenMaxSim``: kernel forward, autograd over the plain version
recomputed) at the training shape and at ragged shapes, random and with
exact ties, against autograd over the plain version (forward within 1e-5,
gradients within 1e-5, ties split evenly); and one tiny live step (an fp32
EVA-style tower of 2 blocks, Q-Former hidden 128, batch 4) through the
kernels against the same step under ``primitives.plain_reference()`` from
one dropout seed: losses within 1e-5 relative, every trainable gradient
within 1e-4 of its tensor's largest (floored at 1e-4 of the step's
largest), as on the CPU against JAX; the tower's chain and K1 launched.

Marked ``cuda``: each test skips where no CUDA device is present, deciding
inside the fixture, never at import. On a GPU machine:

    python -m pytest tests/test_torch_kernels_train_cuda.py -m cuda
"""

import pytest
import torch

from sprc_tpu_torch import kernel_checks
from sprc_tpu_torch.loader import load_model
from sprc_tpu_torch.ops import primitives
from sprc_tpu_torch.ops.fused_block import fused_vit_block
from sprc_tpu_torch.ops.sim_kernels import token_max_sim
from sprc_tpu_torch.train.loop import TrainConfig, Trainer

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return "cuda"


@pytest.mark.parametrize("shape", [(128, 128, 32, 256), (17, 129, 8, 128), (1, 7, 2, 4)])
def test_token_max_sim_function_against_autograd_over_plain(shape, cuda):
    B, N, Q, E = shape
    row = kernel_checks.check_token_max_sim_grad(cuda, B=B, N=N, Q=Q, E=E)
    assert row["ok"], row


def test_tiny_live_step_through_the_kernels_against_plain(cuda):
    model = load_model(
        "blip2_cir_align_prompt", "pretrain", device=cuda, seed=2, image_size=28,
        num_query_token=4, max_txt_len=8, embed_dim=64, vit_dtype="fp32",
        vit_config_override=dict(image_size=28, patch_size=14, width=128, depth=2, num_heads=2,
                                 mlp_hidden=256, qkv_fused_no_kbias=True, dtype="fp32"),
        qformer_config_override=dict(vocab_size=60, hidden_size=128, num_layers=2, num_heads=2,
                                     intermediate_size=256, encoder_width=128, query_length=4,
                                     dropout_rate=0.1))
    g = torch.Generator(device=cuda).manual_seed(3)
    batch = {"reference": torch.rand((4, 28, 28, 3), generator=g, device=cuda),
             "target": torch.rand((4, 28, 28, 3), generator=g, device=cuda),
             "input_ids": torch.randint(1, 60, (4, 8), generator=g, device=cuda),
             "text_mask": torch.ones((4, 8), dtype=torch.long, device=cuda)}
    batch["text_mask"][0, -3:] = 0
    before = (token_max_sim.launches, fused_vit_block.launches)
    _, losses, grads = Trainer(model, TrainConfig(), seed=7).loss_and_grads(batch)
    torch.cuda.synchronize()
    assert (token_max_sim.launches - before[0], fused_vit_block.launches - before[1]) == (2, 2)
    with primitives.plain_reference():
        _, p_losses, p_grads = Trainer(model, TrainConfig(), seed=7).loss_and_grads(batch)
    for key, value in p_losses.items():
        assert abs(losses[key].item() - value.item()) <= 1e-5 * abs(value.item()), key
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    gap = kernel_checks.grad_gap(grads, p_grads, names)
    assert gap["gap"] <= 1e-4, gap
