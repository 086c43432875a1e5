"""The engine's feed on the card: the pinned upload ring on a side stream
and the doubling pinned buffer of the frozen embeds
(``retrieval/engine.py``), against the same engine on the CPU.

Marked ``cuda``: each test skips where no CUDA device is present, deciding
inside the fixture, never at import. On a GPU machine:

    python -m pytest tests/test_torch_kernels_feed_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from sprc_tpu_torch.loader import load_model
from sprc_tpu_torch.retrieval.engine import RetrievalEngine
from sprc_tpu_torch.utils.artifacts import synthetic_raw_batches

pytestmark = pytest.mark.cuda

IMG, N, BATCH, BUFFER = 28, 11, 4, 48


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return "cuda"


def _tiny(device):
    """A CLIP-style fp32 tower of 2 blocks (head dim 64) and a 2-layer
    Q-Former, seeded."""
    return load_model(
        "blip2_cir_align_prompt", "pretrain_vitL", device=device, seed=2, image_size=IMG,
        num_query_token=4, max_txt_len=8, embed_dim=64, vit_dtype="fp32",
        vit_config_override=dict(image_size=IMG, patch_size=14, width=128, depth=2, num_heads=2,
                                 mlp_hidden=256, use_ln_pre=True, quick_gelu=True,
                                 patch_bias=False, dtype="fp32"),
        qformer_config_override=dict(vocab_size=60, hidden_size=128, num_layers=2, num_heads=2,
                                     intermediate_size=256, encoder_width=128, query_length=4,
                                     dropout_rate=0.0))


def test_pinned_ring_and_buffer_against_the_cpu_engine(cuda):
    """Both paths equal the CPU engine over 17 batches, more than five times
    the upload ring's slots (a slot refilled too early would corrupt a batch); the ring
    is made once and reused by a second build; the frozen embeds come back
    into one pinned buffer, which grows once on the way (51 rows of this
    model's 2560 bytes first, 66 in all)."""
    cpu_model = _tiny("cpu")
    gpu_model = _tiny(cuda)
    gpu_model.load_state_dict(cpu_model.state_dict())
    cpu = RetrievalEngine(cpu_model, device="cpu", encode_batch=BATCH)
    gpu = RetrievalEngine(gpu_model, device=cuda, encode_batch=BATCH)
    rng = np.random.default_rng(0)
    batches = []
    for s in range(0, 6 * N, BATCH):
        b = min(BATCH, 6 * N - s)
        batches.append(([f"p{i}" for i in range(s, s + b)],
                        rng.standard_normal((b, IMG, IMG, 3), dtype=np.float32)))
    want = cpu.build_index(iter(batches))
    got = gpu.build_index(iter(batches))
    ring = {id(slot) for r in gpu._rings.values() for slot in r}  # the ring rotates
    again = gpu.build_index(iter(batches))
    assert {id(slot) for r in gpu._rings.values() for slot in r} == ring and len(ring) == 3
    assert got.frozen_embeds.is_pinned() and got.n == want.n == 6 * N
    assert got.names == want.names
    for index in (got, again):
        torch.testing.assert_close(index.target_feats.cpu(), want.target_feats, atol=1e-3, rtol=0)
        torch.testing.assert_close(index.frozen_embeds, want.frozen_embeds, atol=1e-3, rtol=0)
    raw = list(synthetic_raw_batches(1, 6 * N, BATCH, BUFFER))
    torch.testing.assert_close(gpu.build_index_raw(iter(raw)).target_feats.cpu(),
                               cpu.build_index_raw(iter(raw)).target_feats, atol=1e-3, rtol=0)
