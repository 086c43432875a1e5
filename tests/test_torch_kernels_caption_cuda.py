"""BLIP-2 stage 2's caption path on the card (``kernel_checks.run_caption``):
K2 in fp32 at 364 px (S = 677, EVA ViT-g's block) at the caption batch of
16 within ``kernel_checks.VIT_F32_REL`` of the output's scale, its fp32
attention call within its stage bound, and K3's queries-only pass into the
677 rows within 1e-4; then a tiny ``blip2_opt`` and ``blip2_t5``
(cli/instruct.py's synthetic configuration, the LLM's matrices scaled by 4
so that its layers pick the tokens) decode on the card through the kernels
equal to the same weights' run on the CPU, up to a near tie (the CPU run's
top-2 gap at the first step that differs under 1e-4).

Marked ``cuda``: each test skips where no CUDA device is present, deciding
inside the fixture, never at import. On a GPU machine:

    python -m pytest tests/test_torch_kernels_caption_cuda.py -m cuda
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


@pytest.mark.parametrize("check", ["K2 vit_block eva_g fp32 S=677 B=16",
                                   "attention D=88 fp32 S=677 B=16",
                                   "K3 qformer_layer caption queries"])
def test_caption_path_kernels_against_plain(check, cuda):
    W, M, heads, quick, eps = kernel_checks.TOWERS["eva_g"]
    B, S = kernel_checks.CAPTION_BATCH, kernel_checks.RETRIEVAL_MEMORY
    if check.startswith("K2"):
        row = kernel_checks.check_vit_block(cuda, B=B, S=S, W=W, M=M, heads=heads, quick=quick,
                                            eps=eps, dtype=torch.float32)
    elif check.startswith("attention"):
        row = kernel_checks.check_attention(88, torch.float32, cuda, B=B, S=S)
    else:
        row = kernel_checks.check_qformer_layer("caption queries", cuda)
    assert row["ok"], row


def _decode(model, images, ids, mask, gaps):
    """Cached greedy ids, each step's top-2 logit gap appended to ``gaps``."""
    from sprc_tpu_torch.models import generation

    real = generation.cached_greedy_loop

    def loop(logits0, cache, pos0, step_fn, **kw):
        def top2(logits):
            v = torch.topk(logits.float(), 2, dim=-1).values
            return (v[:, 0] - v[:, 1]).cpu()

        gaps.append(top2(logits0))

        def step(tok, pos, c):
            logits, c = step_fn(tok, pos, c)
            gaps.append(top2(logits))
            return logits, c

        return real(logits0, cache, pos0, step, **kw)

    generation.cached_greedy_loop = loop
    try:
        with torch.inference_mode():
            return model.generate_ids(images, ids, mask, eos_token_id=1, pad_token_id=0,
                                      max_new_tokens=10).cpu()
    finally:
        generation.cached_greedy_loop = real


@pytest.mark.parametrize("arch", ["blip2_opt", "blip2_t5"])
def test_tiny_head_decodes_on_the_card_as_on_the_cpu(arch, cuda):
    from sprc_tpu_torch.cli import instruct
    from sprc_tpu_torch.ops.fused_qformer import fused_qformer_layer

    host, tok = instruct.build_synthetic(arch, "cpu", seed=4)
    with torch.no_grad():
        for p in getattr(host, "opt_model" if arch == "blip2_opt" else "t5_model").parameters():
            if p.dim() == 2:
                p.mul_(4.0)
    card = instruct.build_synthetic(arch, cuda)[0]
    card.load_state_dict(host.state_dict())
    rng = np.random.RandomState(5)
    images = torch.from_numpy(rng.rand(4, instruct.IMG, instruct.IMG, 3).astype(np.float32))
    enc = tok(["a photo of", "two dogs", "a red car on the street", "x"], max_length=instruct.TXT)
    ids, mask = (torch.from_numpy(enc[k]) for k in ("input_ids", "attention_mask"))
    host_gaps, card_gaps = [], []
    want = _decode(host, images, ids, mask, host_gaps)
    before = fused_qformer_layer.launches
    got = _decode(card, images.to(cuda), ids.to(cuda), mask.to(cuda), card_gaps)
    assert fused_qformer_layer.launches == before + 2  # the kernel route on the card
    gaps = torch.stack(host_gaps, dim=1)
    assert len(set(want[0].tolist())) > 1, want
    for b in range(len(want)):
        diff = torch.nonzero(got[b] != want[b]).flatten()
        if len(diff):
            assert gaps[b, diff[0]] < 1e-4, (b, diff[0], gaps[b], got[b], want[b])
