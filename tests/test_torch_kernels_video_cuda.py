"""The video families on the card: K8 at TimeSformer's spatial call (fp32, D
64, S = 197, strided views of the packed qkv; through ``FlashAttention`` at
the training batch, without a graph at the evaluation's:
``kernel_checks.run_video``), and a tiny ALPRO retrieval model whose tower
launches K8 once a block (S = 1 + 144 at 192 px, head dim 64): its rows and
one step's gradients against all-plain.

Marked ``cuda``: each test skips where no CUDA device is present, deciding
inside the fixture, never at import. On a GPU machine:

    python -m pytest tests/test_torch_kernels_video_cuda.py -m cuda
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


def test_k8_at_the_timesformer_call(cuda):
    rows = kernel_checks.run_video(cuda)
    assert len(rows) == 2
    bad = [r for r in rows if not r["ok"]]
    assert not bad, bad


def test_tiny_alpro_tower_launches_k8_a_block(cuda):
    """A 2-block TimeSformer (width 128, 2 heads of 64) at 192 px over 2
    frames: 2 K8 launches a tower call; the rows within 1e-5 of their scale
    of all-plain; one training step's gradients through ``FlashAttention``
    within 1e-4 of their scale (the backward recomputes the plain version)."""
    from sprc_tpu_torch import loader
    from sprc_tpu_torch.ops import primitives
    from sprc_tpu_torch.ops.attention import flash_attention

    model = loader.load_model(
        "alpro_retrieval", "pretrain", device=cuda, seed=0, image_size=192, num_frames=2,
        embed_dim=16, fusion_layer=1,
        video_config_override=dict(image_size=192, patch_size=16, width=128, depth=2,
                                   num_heads=2, mlp_hidden=256, num_frames=2),
        text_config_override=dict(vocab_size=64, hidden_size=128, num_layers=2, num_heads=2,
                                  intermediate_size=256, encoder_width=128, dropout_rate=0.0))
    gen = torch.Generator(device=cuda).manual_seed(3)
    video = torch.rand(3, 2, 192, 192, 3, device=cuda, generator=gen)
    ids = torch.randint(1, 64, (3, 7), device=cuda, generator=gen)
    mask = torch.ones(3, 7, dtype=torch.int64, device=cuda)
    with torch.inference_mode():
        before = flash_attention.launches
        got = model.encode_video(video)
        launched = flash_attention.launches - before
        with primitives.plain_reference():
            want = model.encode_video(video)
    assert launched == 2
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    grads = {}
    for kind in ("kernel", "plain"):
        model.zero_grad(set_to_none=True)
        with primitives.plain_reference() if kind == "plain" else torch.enable_grad():
            model(video, ids, mask)["loss"].backward()
        grads[kind] = {n: p.grad.clone() for n, p in model.named_parameters()
                       if p.grad is not None}
    gap = kernel_checks.grad_gap(list(grads["kernel"].values()), list(grads["plain"].values()),
                                 list(grads["kernel"]))
    assert gap["gap"] <= 1e-4, gap
