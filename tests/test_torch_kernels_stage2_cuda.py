"""BLIP-2 stage 2's training and zero-shot VQA paths on the card
(``kernel_checks.run_stage2``): K2 in bf16 at 224 px (EVA ViT-g's block)
and its bf16 attention call at pretrain_stage2.yaml's batch of 32 and the
VQA batch of 16, and K3's queries-only pass into 257 rows, each against its
plain version within its bound; then on cli/instruct.py's tiny heads (the
LLM's matrices scaled by 4, as test_torch_kernels_caption_cuda.py does):

- one training step of each head through ``GenericTrainer`` with the
  kernels against the same step under ``primitives.plain_reference()``:
  the loss within 1e-5 of its value, every trainable gradient within 1e-4 of
  its tensor's scale (``kernel_checks.grad_gap``), the frozen tower's K2
  launched once a block and no K3 (the Q-Former trains unfused), and after
  the update every tower and LLM tensor bit for bit unchanged;
- one VQA batch through ``make_blip2_vqa_predict_fn``: K3 launches once a
  layer, and the answers equal the all-plain run's.

Marked ``cuda``: each test skips where no CUDA device is present, deciding
inside the fixture, never at import. On a GPU machine:

    python -m pytest tests/test_torch_kernels_stage2_cuda.py -m cuda
"""

import numpy as np
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


def test_stage2_path_kernels_against_plain(cuda):
    rows = kernel_checks.run_stage2(cuda)
    assert [r["check"] for r in rows] == [
        "K2 vit_block eva_g B=32", "attention D=88 bf16 B=32", "K2 vit_block eva_g B=16",
        "attention D=88 bf16 B=16", "K3 qformer_layer vqa queries"]
    assert all(r["ok"] for r in rows), rows


def _head(arch, device):
    from sprc_tpu_torch.cli import instruct

    model, tok = instruct.build_synthetic(arch, device, seed=6)
    with torch.no_grad():
        for p in getattr(model, "opt_model" if arch == "blip2_opt" else "t5_model").parameters():
            if p.dim() == 2:
                p.mul_(4.0)
    return model, tok


@pytest.mark.parametrize("arch", ["blip2_opt", "blip2_t5"])
def test_training_step_against_all_plain(arch, cuda):
    from sprc_tpu_torch.cli import instruct
    from sprc_tpu_torch.ops import primitives
    from sprc_tpu_torch.ops.fused_block import fused_vit_block
    from sprc_tpu_torch.ops.fused_qformer import fused_qformer_layer
    from sprc_tpu_torch.train import generic
    from sprc_tpu_torch.train.loop import TrainConfig

    model, tok = _head(arch, cuda)
    adapter = generic.CaptionAdapter(tok, max_txt_len=instruct.TXT).specialize(model)
    rng = np.random.RandomState(7)
    items = [{"image": rng.rand(instruct.IMG, instruct.IMG, 3).astype(np.float32),
              "text_input": t} for t in ("a photo of two dogs", "red car", "a cat", "sky")]
    batch = {k: torch.as_tensor(v).to(cuda) for k, v in adapter.collate(items).items()}
    before = {n: t.clone() for n, t in model.state_dict().items()}
    k2, k3 = fused_vit_block.launches, fused_qformer_layer.launches
    trainer = generic.GenericTrainer(model, TrainConfig(learning_rate=1e-3), adapter=adapter)
    total, _, grads = trainer.loss_and_grads(batch)
    assert fused_vit_block.launches - k2 == model.visual_encoder.cfg.depth
    assert fused_qformer_layer.launches == k3
    with primitives.plain_reference():
        p_total, _, p_grads = generic.GenericTrainer(
            model, TrainConfig(), adapter=adapter).loss_and_grads(batch)
    assert abs(total.item() - p_total.item()) <= 1e-5 * abs(p_total.item())
    gap = kernel_checks.grad_gap(grads, p_grads, trainer.names)
    assert gap["gap"] <= 1e-4, gap
    trainer.apply_gradients(grads)
    after = model.state_dict()
    moved = [n for n in trainer.names if not torch.equal(after[n], before[n])]
    assert moved
    for name, value in after.items():
        if name.startswith(model.FROZEN_PREFIXES):
            assert torch.equal(value, before[name]), name


@pytest.mark.parametrize("arch", ["blip2_opt", "blip2_t5"])
def test_vqa_batch_against_all_plain(arch, cuda):
    from sprc_tpu_torch.cli import instruct
    from sprc_tpu_torch.ops import primitives
    from sprc_tpu_torch.ops.fused_qformer import fused_qformer_layer
    from sprc_tpu_torch.train.eval_glue import make_blip2_vqa_predict_fn

    model, tok = _head(arch, cuda)
    rng = np.random.RandomState(8)
    samples = {"image": rng.rand(4, instruct.IMG, instruct.IMG, 3).astype(np.float32),
               "text_input": ["what is red", "how many dogs", "is it a cat", "where"]}
    predict = make_blip2_vqa_predict_fn(model, tok)
    k3 = fused_qformer_layer.launches
    got = predict(samples, max_len=6, prompt="Question: {} Short answer:")
    assert fused_qformer_layer.launches - k3 == model.qformer.cfg.num_layers
    with primitives.plain_reference():
        want = predict(samples, max_len=6, prompt="Question: {} Short answer:")
    assert got == want and any(got)
