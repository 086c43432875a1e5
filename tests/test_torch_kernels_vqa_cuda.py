"""BLIP-1 / ALBEF's VQA, SNLI-VE and NLVR2 heads on the card: K2 at BLIP's
VQA tower at 480 px (``kernel_checks.run_vqa``: B = 16, S = 901, a length
that is no multiple of any tile; without a graph, and through
``FusedViTBlock`` forward and backward against autograd over the plain
block; its bf16 attention and the block's four bf16 products), and a tiny
distilled ``albef_vqa`` step whose live tower launches K2 through the
Function once a block and whose momentum tower launches the wrapper once a
block, its loss and momentum copies against the all-plain step, and the
ranked answers of a tiny ``blip_vqa`` against all-plain from the same tower
rows.

Marked ``cuda``: each test skips where no CUDA device is present, deciding
inside the fixture, never at import. On a GPU machine:

    python -m pytest tests/test_torch_kernels_vqa_cuda.py -m cuda
"""

import pytest
import torch

from sprc_tpu_torch import kernel_checks

pytestmark = pytest.mark.cuda

TOWER = dict(image_size=80, patch_size=16, width=768, depth=2, num_heads=12, mlp_hidden=3072,
             layer_norm_eps=1e-6, final_norm=True, dtype="bf16")
TEXT = dict(vocab_size=64, hidden_size=128, num_layers=2, num_heads=2, intermediate_size=256,
            encoder_width=768, dropout_rate=0.0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return "cuda"


def test_k2_at_the_vqa_tower_shape(cuda):
    rows = kernel_checks.run_vqa(cuda)
    assert {r["check"] for r in rows} >= {"K2 vit_block blip_b S=901 B=16",
                                          "FusedViTBlock blip_b bf16 S=901 B=16",
                                          "attention D=64 bf16 blip_b S=901 B=16"}
    bad = [r for r in rows if not r["ok"]]
    assert not bad, bad


def test_tiny_vqa_step_and_ranking_launch_k2_and_equal_plain(cuda):
    """A 2-block ViT-B-wide tower at 80 px (bf16, S = 26): one distilled
    ``albef_vqa`` step launches K2 four times (two blocks live, two
    momentum), its loss within 2e-2 and its momentum copies within 1e-4 of
    the all-plain step's; ``blip_vqa``'s ranking from the kernel tower's rows
    equals all-plain's from the same rows."""
    from sprc_tpu_torch import loader
    from sprc_tpu_torch.models.vqa import VQAModel
    from sprc_tpu_torch.ops import primitives
    from sprc_tpu_torch.ops.fused_block import fused_vit_block
    from sprc_tpu_torch.train import generic
    from sprc_tpu_torch.train.loop import TrainConfig

    gen = torch.Generator(device=cuda).manual_seed(5)
    ids = torch.randint(5, 64, (4, 9), device=cuda, generator=gen)
    batch = {"images": torch.rand(4, 80, 80, 3, device=cuda, generator=gen),
             "question_ids": ids, "question_mask": torch.ones_like(ids),
             "answer_ids": torch.randint(5, 64, (6, 5), device=cuda, generator=gen),
             "answer_mask": torch.ones(6, 5, dtype=torch.long, device=cuda),
             "ans_to_question": torch.tensor([0, 0, 1, 2, 3, 3], device=cuda),
             "weights": torch.rand(6, device=cuda, generator=gen), "alpha": torch.tensor(0.2)}
    runs = {}
    for kind in ("kernel", "plain"):
        model = loader.load_model("albef_vqa", "vqav2", device=cuda, seed=0, image_size=80,
                                  fusion_layer=1, vit_config_override=TOWER,
                                  text_config_override=TEXT)
        adapter = generic.VQAAdapter(None).specialize(model)
        trainer = generic.GenericTrainer(model, TrainConfig(total_steps=1), adapter=adapter)
        trainer.aux = adapter.init_aux(model, trainer.param_values())
        before = fused_vit_block.launches
        if kind == "plain":
            with primitives.plain_reference():
                losses = trainer.train_step(batch)
        else:
            losses = trainer.train_step(batch)
        runs[kind] = (losses, trainer.aux, fused_vit_block.launches - before)
    (k_losses, k_aux, k_launches), (p_losses, p_aux, p_launches) = runs["kernel"], runs["plain"]
    assert k_launches == 4 and p_launches == 0
    assert abs(k_losses["loss"] - p_losses["loss"]) <= 2e-2 * max(1.0, abs(p_losses["loss"]))
    gap = max((k_aux["params_m"][n] - p_aux["params_m"][n]).abs().max().item()
              for n in p_aux["params_m"])
    assert gap <= 1e-4

    model = loader.load_model("blip_vqa", "vqav2", device=cuda, seed=1, image_size=80,
                              vit_config_override=TOWER, text_config_override=TEXT)
    answers = torch.randint(5, 64, (40, 4), device=cuda, generator=gen)
    answers[:, 0] = 2
    args = (batch["images"], ids, batch["question_mask"], answers, torch.ones_like(answers))
    rows = []
    real = VQAModel.encode_image
    try:
        VQAModel.encode_image = lambda self, images: rows.append(real(self, images)) or rows[-1]
        best, top = model.rank_answers(*args, num_ans_candidates=8)
        VQAModel.encode_image = lambda self, images: rows[0]
        with primitives.plain_reference():
            p_best, p_top = model.rank_answers(*args, num_ans_candidates=8)
    finally:
        VQAModel.encode_image = real
    assert torch.equal(best, p_best) and torch.equal(top.sort(1)[0], p_top.sort(1)[0])
