"""BLIP-2 stage 1's kernels on the card, at the shapes of its two paths
(``kernel_checks.run_stage1``): K1 at COCO's retrieval call (25,000
captions against 5,000 images of 32 query tokens, E = 256) within 1e-4 of
its plain version; K2 in fp32 at 364 px (S = 677, EVA ViT-g's block) within
``kernel_checks.VIT_F32_REL`` of the output's scale, and in bf16 at
pretraining's batch of 100; K3 against 677 memory rows (the gallery's
queries pass, the captions' CLS pass, the ITM rescoring) within 1e-4; K1
with a gradient at B = N = 100; and a tiny ``blip2`` training step through
the kernels against the same step under ``primitives.plain_reference()``
(losses within 1e-5 relative, gradients within 1e-4 of their tensor's
largest, the kernel step's hard negatives handed over).

Marked ``cuda``: each test skips where no CUDA device is present, deciding
inside the fixture, never at import. On a GPU machine:

    python -m pytest tests/test_torch_kernels_stage1_cuda.py -m cuda
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


def test_token_max_sim_at_coco_retrieval(cuda):
    row = kernel_checks.check_token_max_sim_retrieval(cuda)
    assert row["ok"], row


@pytest.mark.parametrize("dtype,batch", [(torch.float32, kernel_checks.ENCODE_BATCH),
                                         (torch.bfloat16, kernel_checks.STAGE1_BATCH)])
def test_vit_block_of_the_stage1_paths(dtype, batch, cuda):
    W, M, heads, quick, eps = kernel_checks.TOWERS["eva_g"]
    S = kernel_checks.RETRIEVAL_MEMORY if dtype == torch.float32 else 257
    row = kernel_checks.check_vit_block(cuda, B=batch, S=S, W=W, M=M, heads=heads, quick=quick,
                                        eps=eps, dtype=dtype)
    assert row["ok"], row


@pytest.mark.parametrize("shape", list(kernel_checks.RETRIEVAL_SHAPES))
def test_qformer_layer_against_677_memory_rows(shape, cuda):
    row = kernel_checks.check_qformer_layer(shape, cuda)
    assert row["ok"], row


def test_token_max_sim_gradient_at_the_stage1_batch(cuda):
    row = kernel_checks.check_token_max_sim_grad(cuda, B=100, N=100)
    assert row["ok"], row


def test_tiny_stage1_step_through_the_kernels_against_plain(cuda):
    from sprc_tpu_torch.loader import load_model
    from sprc_tpu_torch.models.qformer import QFormerConfig
    from sprc_tpu_torch.models.vit import ViTConfig
    from sprc_tpu_torch.ops.sim_kernels import token_max_sim
    from sprc_tpu_torch.train.generic import GenericTrainer
    from sprc_tpu_torch.train.loop import TrainConfig

    model = load_model("blip2", "pretrain", device=cuda, seed=2, image_size=28,
                       num_query_token=4, max_txt_len=8, embed_dim=64, vit_dtype=torch.float32,
                       vit_config_override=ViTConfig(image_size=28, patch_size=14, width=128,
                                                     depth=2, num_heads=2, mlp_hidden=256,
                                                     qkv_fused_no_kbias=True,
                                                     dtype=torch.float32),
                       qformer_config_override=QFormerConfig(
                           hidden_size=128, num_layers=2, num_heads=2, intermediate_size=256,
                           encoder_width=128, query_length=4, dropout_rate=0.0))
    gen = torch.Generator(device=cuda).manual_seed(3)
    batch = {"images": torch.rand((8, 28, 28, 3), generator=gen, device=cuda),
             "input_ids": torch.randint(4, 1000, (8, 8), generator=gen, device=cuda),
             "text_mask": torch.ones((8, 8), dtype=torch.int64, device=cuda)}
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    picks = []
    own = model._neg_indices
    model._neg_indices = lambda *a: picks.append(own(*a)) or picks[-1]
    before = token_max_sim.launches
    _, k_losses, k_grads = GenericTrainer(model, TrainConfig()).loss_and_grads(batch)
    assert token_max_sim.launches == before + 1
    model._neg_indices = lambda *a: picks[0]
    with primitives.plain_reference():
        _, p_losses, p_grads = GenericTrainer(model, TrainConfig()).loss_and_grads(batch)
    for key in p_losses:
        assert abs(k_losses[key].item() - p_losses[key].item()) <= 1e-5 * abs(p_losses[key].item())
    gap = kernel_checks.grad_gap(k_grads, p_grads, names)
    assert gap["gap"] <= 1e-4, gap
