"""The variant zoo's kernels on the card: K3 at the shapes of the variants'
no-grad passes (``kernel_checks.VARIANT_SHAPES``: ``blip2_cir_cls``'s 640
candidate items, the plain text pass at batch 128, ``blip2_cir_slt``'s
4-query second pass) against its plain version within 1e-4; and one tiny
live step of the hard-negative variants (an fp32 EVA-style tower of 2
blocks, Q-Former hidden 128, batch 8) through the kernels against the same
step under ``primitives.plain_reference()`` from one dropout seed, the
kernel step's hard negatives handed to the plain step: losses within 1e-5
relative, every trainable gradient within 1e-4 of its tensor's largest, as
on the CPU against JAX; K1 and, where the step has no-grad passes, K3
launched.

Marked ``cuda``: each test skips where no CUDA device is present, deciding
inside the fixture, never at import. On a GPU machine:

    python -m pytest tests/test_torch_kernels_variants_cuda.py -m cuda
"""

import pytest
import torch

from sprc_tpu_torch import kernel_checks
from sprc_tpu_torch.loader import load_model
from sprc_tpu_torch.ops import primitives
from sprc_tpu_torch.ops.fused_qformer import fused_qformer_layer
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


@pytest.mark.parametrize("shape", list(kernel_checks.VARIANT_SHAPES))
def test_qformer_layer_at_the_variants_shapes(shape, cuda):
    row = kernel_checks.check_qformer_layer(shape, cuda)
    assert row["ok"], row


@pytest.mark.parametrize("name", ["blip2_cir_neg", "blip2_cir_rerank", "blip2_cir_cls"])
def test_tiny_variant_step_through_the_kernels_against_plain(name, cuda):
    model = load_model(
        name, "pretrain", device=cuda, seed=2, image_size=28, num_query_token=4,
        max_txt_len=8, embed_dim=64, vit_dtype="fp32",
        vit_config_override=dict(image_size=28, patch_size=14, width=128, depth=2, num_heads=2,
                                 mlp_hidden=256, qkv_fused_no_kbias=True, dtype="fp32"),
        qformer_config_override=dict(vocab_size=60, hidden_size=128, num_layers=2, num_heads=2,
                                     intermediate_size=256, encoder_width=128, query_length=4,
                                     dropout_rate=0.1))
    g = torch.Generator(device=cuda).manual_seed(3)
    B = 8
    batch = {"reference": torch.rand((B, 28, 28, 3), generator=g, device=cuda),
             "target": torch.rand((B, 28, 28, 3), generator=g, device=cuda),
             "input_ids": torch.randint(1, 60, (B, 8), generator=g, device=cuda),
             "text_mask": torch.ones((B, 8), dtype=torch.long, device=cuda)}
    picks = {}
    attrs = [a for a in ("_neg_indices", "_candidates") if hasattr(model, a)]

    def patch(inject):
        for attr in attrs:
            own, calls = getattr(model, attr), []

            def fn(*a, _own=own, _attr=attr, _calls=calls, **kw):
                out = _own(*a, **kw)
                if inject:
                    out = picks[_attr][len(_calls)]
                    _calls.append(1)
                else:
                    picks.setdefault(_attr, []).append(out)
                return out

            setattr(model, attr, fn)

    k1, k3 = token_max_sim.launches, fused_qformer_layer.launches
    patch(inject=False)
    _, k_losses, k_grads = Trainer(model, TrainConfig(), seed=4).loss_and_grads(batch)
    launched = (token_max_sim.launches - k1, fused_qformer_layer.launches - k3)
    patch(inject=True)
    with primitives.plain_reference():
        _, p_losses, p_grads = Trainer(model, TrainConfig(), seed=4).loss_and_grads(batch)
    for key in p_losses:
        assert abs(k_losses[key].item() - p_losses[key].item()) <= 1e-5 * abs(
            p_losses[key].item()), key
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    gap = kernel_checks.grad_gap(k_grads, p_grads, names)
    assert gap["gap"] <= 1e-4, gap
    assert launched[0] >= 1
    assert (launched[1] > 0) == (name != "blip2_cir_neg"), launched
