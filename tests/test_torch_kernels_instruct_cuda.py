"""The LLaMA heads' paths on the card (``kernel_checks.run_instruct``): K3 at
the InstructBLIP-style fusion passes (32 queries and 128 or 32 BERT tokens
into 257 rows of EVA ViT-g's width), against its plain version within its
bound; then on cli/instruct.py's tiny LLaMA heads (the LLaMA's matrices
scaled by 4, as test_torch_kernels_stage2_cuda.py does):

- one retrieval batch of ``blip2_vicuna_instruct`` (``extract_target_features``
  and ``inference``): K2 once a block an image batch, K3 once a layer a
  Q-Former pass, the gallery features within 1e-5 of the all-plain run's
  and the scores, through the scaled LLaMA, within 1e-4;
- one generate batch of ``blip2_instruct_cir`` (``instruct_generate``,
  KV-cached): K2 and K3 as above, the ids equal to the all-plain run's;
- one training step of each model through ``GenericTrainer`` and
  ``InstructAdapter`` against the same step under
  ``primitives.plain_reference()``: the loss within 1e-5 of its value, every
  trainable gradient within 1e-4 of its tensor's scale
  (``kernel_checks.grad_gap``), K2 once a block and no K3 (the Q-Former
  trains unfused), and after the update every tower and LLaMA tensor bit for
  bit unchanged.

Marked ``cuda``: each test skips where no CUDA device is present, deciding
inside the fixture, never at import. On a GPU machine:

    python -m pytest tests/test_torch_kernels_instruct_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from sprc_tpu_torch import kernel_checks

pytestmark = pytest.mark.cuda
NAMES = ("blip2_vicuna_instruct", "blip2_instruct_cir")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return "cuda"


def test_instruct_path_kernels_against_plain(cuda):
    rows = kernel_checks.run_instruct(cuda)
    assert [r["check"] for r in rows] == ["K3 qformer_layer instruct fusion L=128",
                                          "K3 qformer_layer instruct fusion L=32"]
    assert all(r["ok"] for r in rows), rows


def _head(name, device):
    from sprc_tpu_torch.cli import instruct

    model, tok = instruct.build_synthetic(name, device, seed=6)
    with torch.no_grad():
        for p in model.llm_model.parameters():
            if p.dim() == 2:
                p.mul_(4.0)
    return model, tok


def _inputs(tok, device, texts, rng):
    from sprc_tpu_torch.cli import instruct

    images = torch.from_numpy(rng.rand(len(texts), instruct.IMG, instruct.IMG, 3)
                              .astype(np.float32)).to(device)
    out = [images]
    for t, n in ((instruct.bert_tokenizer(), instruct.TXT), (tok, 8)):
        enc = t(texts, max_length=n)
        out += [torch.from_numpy(enc[k]).to(device) for k in ("input_ids", "attention_mask")]
    return out


def _launches():
    from sprc_tpu_torch.ops.fused_block import fused_vit_block
    from sprc_tpu_torch.ops.fused_qformer import fused_qformer_layer

    return fused_vit_block.launches, fused_qformer_layer.launches


TEXTS = ["make it red", "longer sleeves with dots", "a dog", "two cats on a blue car"]


def test_retrieval_batch_against_all_plain(cuda):
    from sprc_tpu_torch.ops import primitives

    model, tok = _head(NAMES[0], cuda)
    images, ids, mask, llm_ids, llm_mask = _inputs(tok, cuda, TEXTS, np.random.RandomState(9))
    gallery = torch.flip(images, dims=[0])

    def run():
        with torch.inference_mode():
            feats, _ = model.extract_target_features(gallery)
            return feats, model.inference(model.encode_image(images), feats, ids, mask, llm_ids,
                                          llm_mask)

    k2, k3 = _launches()
    feats, scores = run()
    depth, layers = model.visual_encoder.cfg.depth, model.qformer.cfg.num_layers
    assert _launches() == (k2 + 2 * depth, k3 + 2 * layers)
    with primitives.plain_reference():
        p_feats, p_scores = run()
    assert scores.shape == (4, 4) and bool(torch.isfinite(scores).all())
    torch.testing.assert_close(feats, p_feats, rtol=0, atol=1e-5)
    torch.testing.assert_close(scores, p_scores, rtol=0, atol=1e-4)  # through the scaled LLaMA


def test_generate_batch_against_all_plain(cuda):
    from sprc_tpu_torch.models.instruct_cir import instruct_generate
    from sprc_tpu_torch.ops import primitives

    model, tok = _head(NAMES[1], cuda)
    args = _inputs(tok, cuda, TEXTS, np.random.RandomState(10))
    kw = dict(eos_token_id=tok.eos_id, pad_token_id=tok.pad_id, max_new_tokens=6)
    k2, k3 = _launches()
    with torch.inference_mode():
        got = instruct_generate(model, *args, **kw)
    assert _launches() == (k2 + model.visual_encoder.cfg.depth,
                           k3 + model.qformer.cfg.num_layers)
    with torch.inference_mode(), primitives.plain_reference():
        want = instruct_generate(model, *args, **kw)
    assert torch.equal(got, want) and got.shape == (4, 6)


@pytest.mark.parametrize("name", NAMES)
def test_training_step_against_all_plain(name, cuda):
    from sprc_tpu_torch.models.instruct_cir import InstructAdapter
    from sprc_tpu_torch.ops import primitives
    from sprc_tpu_torch.train.generic import GenericTrainer
    from sprc_tpu_torch.train.loop import TrainConfig

    model, tok = _head(name, cuda)
    rng = np.random.RandomState(11)
    images, ids, mask, llm_ids, llm_mask = _inputs(tok, cuda, TEXTS, rng)
    batch = {"input_ids": ids, "text_mask": mask, "llm_input_ids": llm_ids, "llm_mask": llm_mask}
    if name == NAMES[0]:
        batch.update(reference=images, target=torch.flip(images, dims=[0]))
    else:
        target = torch.zeros_like(llm_mask)
        target[:, 2:] = llm_mask[:, 2:]  # the tokens after the first word: the output span
        batch.update(images=images, target_mask=target)
    before = {n: t.clone() for n, t in model.state_dict().items()}
    k2, k3 = _launches()
    trainer = GenericTrainer(model, TrainConfig(learning_rate=1e-3), adapter=InstructAdapter())
    total, _, grads = trainer.loss_and_grads(batch)
    assert _launches() == (k2 + model.visual_encoder.cfg.depth, k3)
    with primitives.plain_reference():
        p_total, _, p_grads = GenericTrainer(model, TrainConfig(),
                                             adapter=InstructAdapter()).loss_and_grads(batch)
    assert abs(total.item() - p_total.item()) <= 1e-5 * abs(p_total.item())
    gap = kernel_checks.grad_gap(grads, p_grads, trainer.names)
    assert gap["gap"] <= 1e-4, gap
    trainer.apply_gradients(grads)
    after = model.state_dict()
    assert not torch.equal(after["llm_proj.weight"], before["llm_proj.weight"])
    for n, value in after.items():
        if n.startswith(model.FROZEN_PREFIXES):
            assert torch.equal(value, before[n]), n
