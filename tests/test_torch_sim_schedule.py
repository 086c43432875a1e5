"""Kernel K1 (csrc/token_max_sim.cu) as it walks its data, in plain PyTorch
(sprc_tpu_torch/ops/schedules.py), against the JAX package.

What can be wrong outside the CUDA source: which items and query rows each
block of the persistent grid takes (every item once per query tile, every
SM busy at the serving gallery), the ring's shared memory and the blocks an
SM, and the arithmetic's order: the depth zero-padded to k-steps of 8, each
warp's k-steps in 3xTF32 in order, the warps' partial sums in warp order,
the max over the item's tokens with NaN propagated, and a score that comes
out NaN taken again in plain fp32 (an infinity's 3xTF32 products are NaN),
so that infinities come out as the JAX functions give them. The walk is
held against
``_xla_token_max_sim`` and the Pallas ``token_max_sim_pallas`` in interpret
mode within 1e-5 on L2-normalised inputs (what the model scores: each
product loses about 2^-20 of itself in 3xTF32 with the gallery's values
split by truncation, and the sums run in another order), and a copied item's
scores tie bit for bit.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sprc_tpu.ops.pallas_sim import token_max_sim_pallas  # noqa: E402
from sprc_tpu.ops.sim_kernels import _xla_token_max_sim  # noqa: E402

from sprc_tpu_torch.ops import schedules  # noqa: E402


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _inputs(b, n, q, e, seed):
    rng = np.random.default_rng(seed)
    return (_unit(rng.standard_normal((b, e), dtype=np.float32)),
            _unit(rng.standard_normal((n, q, e), dtype=np.float32)))


def test_plan_covers_every_item_once_and_fills_the_card():
    """Every (query tile, item) pair exactly once; all blocks resident at
    once; at the serving shape (B 32, N 512, Q 32, E 256) 264 blocks of 8
    warps, two an SM, each with an item, three 33,792-byte slots; what the
    kernel cannot take is refused."""
    for B, N, Q, E in [(32, 512, 32, 256), (1, 512, 32, 256), (128, 512, 32, 256),
                       (33, 7, 31, 4), (17, 129, 8, 512), (32, 123403, 32, 256), (1000, 3, 1, 128)]:
        plan = schedules.token_max_sim_plan(B, N, Q, E)
        pairs = [(tile, n) for tile, items in schedules.token_max_sim_blocks(plan, N)
                 for n in items]
        assert sorted(pairs) == [(tile, n) for tile in range(plan["tiles"]) for n in range(N)]
        assert plan["tiles"] * schedules.SIM_TILE_B >= B
        assert plan["smem_bytes"] + schedules.SMEM_RESERVED <= (
            schedules.SMEM_SM // plan["blocks_per_sm"])
        assert plan["stages"] >= 2 and plan["pitch"] % 16 == 8
        assert plan["pitch"] - E >= (4 if E % 8 else 0)  # a ragged last k-step reads zeros
        if plan["tiles"] <= schedules.H100_SMS * plan["blocks_per_sm"]:
            assert plan["grid"] <= schedules.H100_SMS * plan["blocks_per_sm"]
        # a half-warp's float2 reads of a k-step (rows g = 0..3 or 4..7 of an
        # n8 tile, depths 2t, 2t + 1): 32 words on 32 banks, no conflict
        for half in (0, 1):
            words = [(g * plan["pitch"] + 2 * t + w) % 32
                     for g in range(4 * half, 4 * half + 4) for t in range(4) for w in (0, 1)]
            assert sorted(words) == list(range(32))
    plan = schedules.token_max_sim_plan(32, 512, 32, 256)
    busy = [items for _, items in schedules.token_max_sim_blocks(plan, 512) if len(items)]
    assert (plan["warps"], plan["blocks_per_sm"], plan["grid"], len(busy)) == (8, 2, 264, 264)
    assert (plan["stages"], plan["stage_bytes"], plan["smem_bytes"]) == (3, 33792, 101440)
    assert max(map(len, busy)) == 2
    assert schedules.token_max_sim_plan(32, 512, 32, 512)["blocks_per_sm"] == 1
    for bad in [(32, 512, 33, 256), (32, 512, 32, 516), (32, 512, 32, 254), (0, 5, 32, 256)]:
        with pytest.raises(ValueError):
            schedules.token_max_sim_plan(*bad)


@pytest.mark.parametrize("b,n,q,e", [(33, 130, 31, 132), (5, 7, 8, 256)])
def test_walk_matches_jax(b, n, q, e):
    """Ragged B, N, Q and E (a last k-step of 4, tokens past a whole n8
    tile, query rows past a tile of 32): within 1e-5 of the XLA path and of
    the Pallas kernel in interpret mode."""
    feats, targets = _inputs(b, n, q, e, seed=b * n)
    got = schedules.token_max_sim_emulated(torch.from_numpy(feats),
                                           torch.from_numpy(targets)).numpy()
    assert got.shape == (b, n) and got.dtype == np.float32
    want_xla = np.asarray(_xla_token_max_sim(jnp.asarray(feats), jnp.asarray(targets)))
    want_pallas = np.asarray(token_max_sim_pallas(jnp.asarray(feats), jnp.asarray(targets)))
    np.testing.assert_allclose(got, want_xla, atol=1e-5)
    np.testing.assert_allclose(got, want_pallas, atol=1e-5)


def test_copied_items_tie_exactly():
    """Items 2, 5 and 9 are one image: their scores are the same bits, so a
    stable sort keeps them in gallery order, as the JAX scores do."""
    feats, targets = _inputs(4, 11, 32, 256, seed=9)
    targets[5] = targets[2]
    targets[9] = targets[2]
    got = schedules.token_max_sim_emulated(torch.from_numpy(feats), torch.from_numpy(targets))
    assert torch.equal(got[:, 2], got[:, 5]) and torch.equal(got[:, 2], got[:, 9])
    want = np.asarray(_xla_token_max_sim(jnp.asarray(feats), jnp.asarray(targets)))
    order = torch.sort(got, dim=-1, descending=True, stable=True).indices.numpy()
    for row, ref in zip(order, want):
        ranks = [list(row).index(i) for i in (2, 5, 9)]
        assert ranks == sorted(ranks)
        np.testing.assert_array_equal(np.sort(row[ranks]), [2, 5, 9])
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_walk_propagates_nan():
    """A NaN in a query row or in one token of an item: NaN in that row and
    that item's column, as amax and jnp.max give it."""
    feats, targets = _inputs(3, 5, 8, 64, seed=2)
    feats[2, 63] = np.nan
    targets[1, 7, 3] = np.nan
    got = schedules.token_max_sim_emulated(torch.from_numpy(feats),
                                           torch.from_numpy(targets)).numpy()
    want = np.asarray(_xla_token_max_sim(jnp.asarray(feats), jnp.asarray(targets)))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[2]).all() and np.isnan(got[:, 1]).all() and np.isnan(got).sum() == 7
    np.testing.assert_allclose(got[~np.isnan(want)], want[~np.isnan(want)], atol=1e-5)


def test_walk_keeps_infinities():
    """-inf in one token of item 1 and +inf in one of item 3, at depths
    every query row holds positive (item 1's score is its other tokens' max,
    item 3's +inf), -inf in query row 2: their 3xTF32 products are NaN,
    the walk takes those scores again in plain fp32 and gets the XLA path's
    and the Pallas kernel's infinities and NaN; the other scores within
    1e-5."""
    feats, targets = _inputs(4, 6, 8, 64, seed=4)
    feats[:, [0, 63]] = np.abs(feats[:, [0, 63]])
    targets[1, 0, 0] = -np.inf
    targets[3, 7, 63] = np.inf
    feats[2, 32] = -np.inf
    got = schedules.token_max_sim_emulated(torch.from_numpy(feats),
                                           torch.from_numpy(targets)).numpy()
    for ref in (_xla_token_max_sim, token_max_sim_pallas):
        want = np.asarray(ref(jnp.asarray(feats), jnp.asarray(targets)))
        np.testing.assert_allclose(got, want, atol=1e-5)  # equal_nan, infinities equal
    finite = np.ones((4, 6), bool)
    finite[2, :] = finite[:, 3] = False
    np.testing.assert_array_equal(np.isfinite(got), finite)
