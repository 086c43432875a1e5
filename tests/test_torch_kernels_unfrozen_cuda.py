"""A tower that trains, on the card: the autograd Functions of K2, K6, K7 and
K8 (``kernel_checks.run_unfrozen``: EVA ViT-g fp32 at 364 px, S = 677, a
batch of 4, and K2 in bf16 at ViT-L's shapes) against autograd over their
plain versions, within ``kernel_checks.GRAD_REL``; every CUDA primitive and
kernel wrapper refuses a tensor that autograd records through; and each
tower route of a tiny ``blip2`` / ``coco`` step launches its kernels once a
block and gets the all-plain step's tower gradients.

Marked ``cuda``: each test skips where no CUDA device is present, deciding
inside the fixture, never at import. On a GPU machine:

    python -m pytest tests/test_torch_kernels_unfrozen_cuda.py -m cuda
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


@pytest.mark.parametrize("name", list(kernel_checks.FUNCTIONS))
def test_function_gradient_at_the_coco_tower(name, cuda):
    row = kernel_checks.check_function_grad(name, cuda)
    assert row["ok"], row
    if name == "FusedViTBlock":  # and K2's in bf16 at ViT-L's shapes
        row = kernel_checks.check_function_grad(name, cuda, "vit_l", torch.bfloat16, S=257)
        assert row["ok"], row


def test_cuda_primitives_refuse_a_recorded_tensor(cuda):
    x = torch.randn(2, 8, 128, device=cuda, requires_grad=True)
    w = torch.randn(128, 128, device=cuda)
    v = torch.ones(128, device=cuda)
    calls = {"gemm": (x, w), "attention": (x, x, x, 2, 0.1),
             "flash_attention": (x.view(2, 8, 2, 64),) * 3 + (0.1,),
             "layer_norm": (x, v, v, 1e-6), "quantize_static": (x, 0.05), "quantize_rows": (x,),
             "gemm_i8": (torch.zeros(16, 128, dtype=torch.int8, device=cuda),
                         torch.zeros(128, 128, dtype=torch.int8, device=cuda),
                         v.requires_grad_())}
    assert set(calls) == set(vars(primitives.CUDA))
    for name, args in calls.items():
        with pytest.raises(RuntimeError, match="inference-only"):
            getattr(primitives.CUDA, name)(*args)
        with torch.no_grad():  # the same call without a graph is taken
            getattr(primitives.CUDA, name)(*args)


@pytest.mark.parametrize("route", ["block", "attn+mlp", "none"])
def test_tiny_unfrozen_step_on_each_route(route, cuda):
    """A tiny ``blip2`` / ``coco`` training step (tower fp32, D 64) through the
    kernels on each tower route: the route's kernels launch once a block in
    the forward, and every gradient, each tower tensor's included, is within
    1e-4 of the all-plain step's (``kernel_checks.grad_gap``)."""
    from sprc_tpu_torch.loader import load_model
    from sprc_tpu_torch.models.qformer import QFormerConfig
    from sprc_tpu_torch.models.vit import ViTConfig
    from sprc_tpu_torch.ops.attention import flash_attention
    from sprc_tpu_torch.ops.fused_block import fused_attn_block, fused_mlp_block, fused_vit_block
    from sprc_tpu_torch.train.generic import GenericTrainer
    from sprc_tpu_torch.train.loop import TrainConfig

    overrides = {"block": {}, "attn+mlp": {"vit_fused_block": "attn", "vit_fused_mlp": True},
                 "none": {"vit_fused_block": "none"}}[route]
    kernels = {"block": (fused_vit_block,), "attn+mlp": (fused_attn_block, fused_mlp_block),
               "none": (flash_attention,)}[route]
    model = load_model("blip2", "coco", device=cuda, seed=2, image_size=224,
                       num_query_token=4, max_txt_len=8, embed_dim=64,
                       vit_config_override=ViTConfig(image_size=224, patch_size=14, width=128,
                                                     depth=2, num_heads=2, mlp_hidden=256,
                                                     qkv_fused_no_kbias=True,
                                                     dtype=torch.float32),
                       qformer_config_override=QFormerConfig(
                           hidden_size=128, num_layers=2, num_heads=2, intermediate_size=256,
                           encoder_width=128, query_length=4, dropout_rate=0.0), **overrides)
    gen = torch.Generator(device=cuda).manual_seed(3)
    batch = {"images": torch.rand((8, 224, 224, 3), generator=gen, device=cuda),
             "input_ids": torch.randint(4, 1000, (8, 8), generator=gen, device=cuda),
             "text_mask": torch.ones((8, 8), dtype=torch.int64, device=cuda)}
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    assert any(n.startswith("visual_encoder") for n in names)
    picks = []
    own = model._neg_indices
    model._neg_indices = lambda *a: picks.append(own(*a)) or picks[-1]
    before = [k.launches for k in kernels]
    _, k_losses, k_grads = GenericTrainer(model, TrainConfig()).loss_and_grads(batch)
    assert [k.launches - b for k, b in zip(kernels, before)] == [2] * len(kernels)
    model._neg_indices = lambda *a: picks[0]
    with primitives.plain_reference():
        _, p_losses, p_grads = GenericTrainer(model, TrainConfig()).loss_and_grads(batch)
    for key in p_losses:
        assert abs(k_losses[key].item() - p_losses[key].item()) <= 1e-5 * abs(p_losses[key].item())
    gap = kernel_checks.grad_gap(k_grads, p_grads, names)
    assert gap["gap"] <= 1e-4, gap
