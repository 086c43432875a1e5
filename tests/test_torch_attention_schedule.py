"""The bf16 attention kernel's schedule (csrc/attention.cu), walked tile by
tile in plain PyTorch (sprc_tpu_torch/ops/schedules.py::attention_emulated),
against the port's plain attention and against sprc_tpu.

The kernel runs only on a card; what can be wrong outside the CUDA source is
its schedule: warp tiles of 16 query rows (a last tile of one row), key
chunks of 64 in which only the 8-key score tiles and 16-key P V steps with a
valid key are computed, the head padded to a multiple of 16, ``s = (q . k) *
scale + bias`` with keys past Sk at -inf, ``exp2((s - m) * log2 e)``, the
probabilities rounded unnormalised and the division after P V. The emulation
runs it in any float dtype. fp32: within 2e-6 of ``attention_plain``
(another summation order in the row sum and in P V; outputs are O(1)), 2e-5
of the Pallas kernels in interpret mode (the JAX tests' own atol). bf16: one
bf16 step of the output (2^-8 of the largest |value|; held to 2^-7), because
the emulation rounds the unnormalised probabilities and the plain version
the normalised ones. Inputs come from numpy generators seeded per test.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sprc_tpu.ops import pallas_block  # noqa: E402
from sprc_tpu.ops.pallas_attention import flash_attention as jax_flash_attention  # noqa: E402

from sprc_tpu_torch.ops import primitives, schedules  # noqa: E402
from test_torch_threads import one_torch_thread  # noqa: E402,F401  (one thread a module)

SHAPES = [(1, 1), (1, 257), (257, 1), (31, 32), (32, 31), (32, 257), (257, 32), (257, 31)]
B, H = 2, 2


def _inputs(seed, Sq, Sk, D, masked=True):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, H * D), dtype=np.float32)
    k = rng.standard_normal((B, Sk, H * D), dtype=np.float32)
    v = rng.standard_normal((B, Sk, H * D), dtype=np.float32)
    bias = np.where(rng.random((B, Sk)) < 0.7, 0.0, -10000.0).astype(np.float32)
    if masked:
        bias[0] = -10000.0  # a fully masked item
    return q, k, v, bias


def _t(*arrays, dtype=torch.float32):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dtype) for a in arrays]


@pytest.mark.parametrize("D", [64, 88])
def test_emulated_schedule_matches_plain_fp32(D):
    for i, (Sq, Sk) in enumerate(SHAPES):
        q, k, v, bias = _inputs(100 + i, Sq, Sk, D)
        tq, tk, tv, tb = _t(q, k, v, bias)
        for col_bias in (None, tb):
            got = schedules.attention_emulated(tq, tk, tv, H, D ** -0.5, col_bias)
            want = primitives.attention_plain(tq, tk, tv, H, D ** -0.5, col_bias)
            assert got.shape == want.shape == (B, Sq, H * D)
            assert (got - want).abs().max().item() <= 2e-6, (Sq, Sk, col_bias is not None)


@pytest.mark.parametrize("D", [64, 88])
def test_emulated_schedule_within_one_bf16_step_of_plain(D):
    for i, (Sq, Sk) in enumerate(SHAPES):
        q, k, v, bias = _inputs(200 + i, Sq, Sk, D)
        tq, tk, tv = _t(q, k, v, dtype=torch.bfloat16)
        tb, = _t(bias)
        for col_bias in (None, tb):
            got = schedules.attention_emulated(tq, tk, tv, H, D ** -0.5, col_bias)
            want = primitives.attention_plain(tq, tk, tv, H, D ** -0.5, col_bias).float()
            assert got.dtype == torch.bfloat16
            d = (got.float() - want).abs().max().item()
            assert d <= want.abs().max().item() * 2.0 ** -7, (Sq, Sk, d)


def test_emulated_schedule_matches_jax_flash_attention():
    """The Pallas ``flash_attention`` in interpret mode on BSHD tensors, at
    both head dims, with Sq != Sk."""
    for seed, (Sq, Sk, D) in enumerate([(257, 257, 64), (32, 257, 88), (31, 32, 88)]):
        q, k, v, _ = _inputs(300 + seed, Sq, Sk, D)
        jq, jk, jv = (jnp.asarray(a.reshape(B, -1, H, D)) for a in (q, k, v))
        want = np.asarray(jax_flash_attention(jq, jk, jv, D ** -0.5)).reshape(B, Sq, H * D)
        got = schedules.attention_emulated(*_t(q, k, v), H, D ** -0.5)
        np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
        want16 = np.asarray(jax_flash_attention(
            *(a.astype(jnp.bfloat16) for a in (jq, jk, jv)), D ** -0.5).astype(jnp.float32))
        got16 = schedules.attention_emulated(*_t(q, k, v, dtype=torch.bfloat16), H, D ** -0.5)
        d = np.abs(got16.float().numpy() - want16.reshape(B, Sq, H * D)).max()
        assert d <= np.abs(want16).max() * 2.0 ** -7, (Sq, Sk, D, d)


def test_emulated_schedule_matches_pallas_block_attend():
    """``pallas_block._attend`` (the attention inside the fused ViT block
    kernels, called directly on a packed [S, 3W] qkv) has the kernel's order:
    unnormalised probabilities rounded, division after P V: fp32 within 2e-5.
    In bf16 it also rounds q * scale * log2(e) to bf16 before the product,
    which the kernel does not (it scales the fp32 scores): that moves a score
    of size 3 by up to 2^-9 of itself and a probability by 0.6 %, a second
    bf16 step of the output, so 2^-6 of the largest |value|."""
    for seed, (S, D) in enumerate([(257, 64), (257, 88), (31, 88)]):
        q, k, v, _ = _inputs(400 + seed, S, S, D)
        W = H * D
        for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
            got = schedules.attention_emulated(*_t(q, k, v, dtype=dtype), H, D ** -0.5).float()
            for mode in ("batched", "perhead_loop"):  # the max-subtracting forms
                pallas_block_env = {"SPRC_FBLK_ATTN": mode}
                want = []
                for b in range(B):
                    qkv = jnp.asarray(np.concatenate([q[b], k[b], v[b]], axis=-1), jdtype)
                    with _env(pallas_block_env):
                        want.append(np.asarray(pallas_block._attend(
                            qkv, W, D, H, D ** -0.5, jdtype, perhead=False).astype(jnp.float32)))
                want = np.stack(want)
                d = np.abs(got.numpy() - want).max()
                tol = 2e-5 if dtype == torch.float32 else np.abs(want).max() * 2.0 ** -6
                assert d <= tol, (S, D, dtype, mode, d)


class _env:
    def __init__(self, values):
        self.values = values

    def __enter__(self):
        import os
        self.old = {k: os.environ.get(k) for k in self.values}
        os.environ.update(self.values)

    def __exit__(self, *exc):
        import os
        for k, v in self.old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def test_fully_masked_row_is_spread_evenly():
    """A bias of -10000 on every key leaves the scores' differences intact
    under a max-subtracted softmax; with equal scores (q = 0) every key gets
    the same weight, as ``jax.nn.softmax`` gives."""
    _, k, v, _ = _inputs(500, 5, 70, 64)
    q = np.zeros((B, 5, H * 64), np.float32)
    bias = np.full((B, 70), -10000.0, np.float32)
    got = schedules.attention_emulated(*_t(q, k, v), H, 0.125, _t(bias)[0])
    want = np.broadcast_to(v.mean(axis=1, keepdims=True), got.shape)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6)
    jw = jax.nn.softmax(jnp.asarray(bias)[:, None, :] + jnp.zeros((B, 5, 70)), axis=-1)
    np.testing.assert_allclose(np.asarray(jw), 1.0 / 70, rtol=1e-6)


def test_attention_tiles_for_the_towers_sequence():
    t = schedules.attention_tiles(257, 257)
    assert (t["blocks"], t["warp_tiles"], len(t["chunks"])) == (3, 17, 5)
    assert [c["valid"] for c in t["chunks"]] == [64, 64, 64, 64, 1]
    assert t["chunks"][-1] == {"first_key": 256, "valid": 1, "score_tiles": 2,
                               "softmax_tiles": 1, "pv_steps": 1}
    # 272 rows x 272 key columns computed for 257 x 257
    assert abs(t["padding_qk"] - (272 * 272 / 257 ** 2 - 1)) < 1e-12
    assert abs(t["padding_pv"] - (272 * 272 / 257 ** 2 - 1)) < 1e-12
    assert t["padding_qk"] < 0.125  # the 64 x 64 tiling it replaces computed 320 x 320: 0.55
    one = schedules.attention_tiles(1, 1)
    assert (one["blocks"], one["warp_tiles"], one["chunks"][0]["pv_steps"]) == (1, 1, 1)
    cross = schedules.attention_tiles(32, 257)
    assert (cross["blocks"], cross["warp_tiles"]) == (1, 2)
    for bad in ((0, 4), (4, 0)):
        with pytest.raises(ValueError):
            schedules.attention_tiles(*bad)
