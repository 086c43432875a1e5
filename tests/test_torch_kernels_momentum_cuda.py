"""The momentum-queue families on the card: K2 at BLIP-1's ViT-B/16 shapes
(``kernel_checks.run_momentum``: without a graph, and through
``FusedViTBlock`` forward and backward against autograd over the plain
block, at the retrieval fine-tune's B = 32, S = 577 and the pretrainers' B =
64, S = 197; its bf16 attention and the block's four bf16 products), and one
step of a tiny ``blip_retrieval`` whose live tower launches K2 through the
Function once a block and whose momentum tower launches the wrapper once a
block, the step's losses and aux state against the all-plain step.

Marked ``cuda``: each test skips where no CUDA device is present, deciding
inside the fixture, never at import. On a GPU machine:

    python -m pytest tests/test_torch_kernels_momentum_cuda.py -m cuda
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


def test_k2_at_the_vit_b_shapes(cuda):
    rows = kernel_checks.run_momentum(cuda)
    assert {r["check"] for r in rows} >= {"FusedViTBlock blip_b bf16 S=577 B=32",
                                          "FusedViTBlock blip_b bf16 S=197 B=64",
                                          "K2 vit_block blip_b S=577 B=16"}
    bad = [r for r in rows if not r["ok"]]
    assert not bad, bad


def test_tiny_momentum_step_launches_k2_and_equals_plain(cuda):
    """A 2-block ViT-B-wide tower at 64 px (bf16, S = 17) with a 2-layer
    med-BERT: one ``blip_retrieval`` step launches K2 four times (two blocks
    live, two momentum), and its losses and queues agree with the all-plain
    step on the same hard negatives."""
    from sprc_tpu_torch import loader
    from sprc_tpu_torch.models import albef
    from sprc_tpu_torch.ops import primitives
    from sprc_tpu_torch.ops.fused_block import fused_vit_block
    from sprc_tpu_torch.train import generic
    from sprc_tpu_torch.train.loop import TrainConfig

    kw = dict(image_size=64, queue_size=16, embed_dim=32,
              vit_config_override=dict(image_size=64, patch_size=16, width=768, depth=2,
                                       num_heads=12, mlp_hidden=3072, layer_norm_eps=1e-6,
                                       final_norm=True, dtype="bf16"),
              text_config_override=dict(vocab_size=64, hidden_size=128, num_layers=2,
                                        num_heads=2, intermediate_size=256, encoder_width=768))
    gen = torch.Generator(device=cuda).manual_seed(3)
    batch = {"images": torch.rand(4, 64, 64, 3, device=cuda, generator=gen),
             "input_ids": torch.randint(5, 64, (4, 9), device=cuda, generator=gen),
             "text_mask": torch.ones(4, 9, dtype=torch.int32, device=cuda),
             "image_ids": torch.tensor([1, 2, 1, 3], device=cuda), "alpha": torch.tensor(0.2)}
    batch["enc_input_ids"] = batch["input_ids"].clone()
    runs, picks = {}, []
    real = albef.sample_negatives
    for kind in ("kernel", "plain"):
        model = loader.load_model("blip_retrieval", "coco", device=cuda, seed=0, **kw)
        adapter = generic.RetrievalAdapter(None)
        trainer = generic.GenericTrainer(model, TrainConfig(total_steps=1), adapter=adapter)
        trainer.aux = adapter.init_aux(model, trainer.param_values())
        if kind == "plain":
            replay = list(picks)
            albef.sample_negatives = lambda w, g: replay.pop(0)
        else:
            albef.sample_negatives = lambda w, g: picks.append(real(w, g)) or picks[-1]
        before = fused_vit_block.launches
        try:
            if kind == "plain":
                with primitives.plain_reference():
                    losses = trainer.train_step(batch)
            else:
                losses = trainer.train_step(batch)
        finally:
            albef.sample_negatives = real
        runs[kind] = (losses, trainer.aux, fused_vit_block.launches - before)
    (k_losses, k_aux, k_launches), (p_losses, p_aux, p_launches) = runs["kernel"], runs["plain"]
    assert k_launches == 4 and p_launches == 0
    for key, value in p_losses.items():
        assert abs(k_losses[key] - value) <= 2e-2 * max(1.0, abs(value)), key
    assert torch.equal(k_aux["idx_queue"], p_aux["idx_queue"]) and int(k_aux["ptr"]) == 4
    assert (k_aux["image_queue"] - p_aux["image_queue"]).abs().max() <= 3e-2
    assert k_aux["params_m"]["visual_encoder.blocks.0.attn.qkv.weight"].dtype == torch.float32
