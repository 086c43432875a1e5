"""Kernel K1's module (sprc_tpu_torch/ops/sim_kernels.py) against sprc_tpu.

On the CPU the port's token_max_sim runs its plain version; it is held
against the JAX XLA path and the Pallas kernel in interpret mode on the
same numpy inputs, atol 1e-5 (fp32 dot products of length 128 summed in
another order). A NaN in a query row or a gallery item gives NaN scores
where the JAX functions give them, infinities give the same infinities (or
NaN) as there, and the CUDA branch of the wrapper takes a
gallery of N Q E >= 2^31 elements (its launch monkeypatched: the CPU has no
kernel).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sprc_tpu.ops.pallas_sim import token_max_sim_pallas  # noqa: E402
from sprc_tpu.ops.sim_kernels import _xla_token_max_sim  # noqa: E402

from sprc_tpu_torch.ops import primitives, schedules, sim_kernels  # noqa: E402
from sprc_tpu_torch.ops.sim_kernels import token_max_sim, token_max_sim_plain  # noqa: E402
from sprc_tpu_torch.retrieval.engine import GalleryIndex, RetrievalEngine  # noqa: E402

E, Q = 128, 4


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _inputs(b, n, seed):
    """L2-normalised features, as the model's projections emit them."""
    rng = np.random.RandomState(seed)
    return _unit(rng.randn(b, E)), _unit(rng.randn(n, Q, E))


@pytest.mark.parametrize("b,n", [(3, 7), (5, 130)])  # N not a multiple of 128
def test_token_max_sim_matches_jax(b, n):
    feats, targets = _inputs(b, n, seed=n)
    got = token_max_sim(torch.from_numpy(feats), torch.from_numpy(targets)).numpy()
    assert got.shape == (b, n) and got.dtype == np.float32
    want_xla = np.asarray(_xla_token_max_sim(jnp.asarray(feats), jnp.asarray(targets)))
    want_pallas = np.asarray(token_max_sim_pallas(jnp.asarray(feats), jnp.asarray(targets)))
    np.testing.assert_allclose(got, want_xla, atol=1e-5)
    np.testing.assert_allclose(got, want_pallas, atol=1e-5)


def test_tied_scores_keep_stable_order():
    """Items 1, 3 and 4 are the same image: their scores tie exactly, and the
    ranking keeps gallery order among them, as np.argsort(kind='stable')."""
    feats, targets = _inputs(2, 6, seed=3)
    targets[3] = targets[1]
    targets[4] = targets[1]
    sims = token_max_sim(torch.from_numpy(feats), torch.from_numpy(targets))
    assert sims[0, 1] == sims[0, 3] == sims[0, 4]
    index = GalleryIndex(names=list("abcdef"), target_feats=torch.from_numpy(targets),
                         frozen_embeds=torch.zeros(6, 1, 1), n=6)
    engine = RetrievalEngine(torch.nn.Linear(1, 1), device="cpu")
    _, idx = engine.topk(index, sims, k=6)
    want = np.asarray(_xla_token_max_sim(jnp.asarray(feats), jnp.asarray(targets)))
    for row, ref in zip(idx, want):
        np.testing.assert_array_equal(row, np.argsort(-ref, kind="stable"))


def test_wrapper_is_inference_only():
    feats, targets = _inputs(2, 3, seed=4)
    f = torch.from_numpy(feats).requires_grad_()
    with pytest.raises(RuntimeError, match="inference-only"):
        token_max_sim(f, torch.from_numpy(targets))
    with torch.no_grad():
        np.testing.assert_array_equal(
            token_max_sim(f, torch.from_numpy(targets)).numpy(),
            token_max_sim_plain(f, torch.from_numpy(targets)).numpy())


def test_wrapper_refuses_devices_without_kernels():
    with pytest.raises(ValueError, match="no kernels"):
        token_max_sim(torch.zeros(2, E, device="meta"), torch.zeros(3, Q, E, device="meta"))


def test_nan_propagates_as_in_jax():
    """A NaN in query row 1 and in one token of item 4: NaN in that row and
    that column, as jnp.max and amax give it, the other scores unchanged."""
    feats, targets = _inputs(3, 6, seed=5)
    feats[1, 7] = np.nan
    targets[4, Q - 1, 0] = np.nan
    got = token_max_sim(torch.from_numpy(feats), torch.from_numpy(targets)).numpy()
    want = np.asarray(_xla_token_max_sim(jnp.asarray(feats), jnp.asarray(targets)))
    want_pallas = np.asarray(token_max_sim_pallas(jnp.asarray(feats), jnp.asarray(targets)))
    nan = np.zeros((3, 6), bool)
    nan[1, :] = nan[:, 4] = True
    np.testing.assert_array_equal(np.isnan(want), nan)
    np.testing.assert_array_equal(np.isnan(want_pallas), nan)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_allclose(got[~nan], want[~nan], atol=1e-5)
    # -inf in one token of item 2 and +inf in one of item 5, at depths every
    # query row holds positive (item 2's score is its other tokens' max, item
    # 5's +inf), -inf in query row 0: the same infinities and NaN as the JAX
    # functions
    feats, targets = _inputs(3, 6, seed=6)
    feats[:, [0, E - 1]] = np.abs(feats[:, [0, E - 1]])
    targets[2, 0, 0] = -np.inf
    targets[5, Q - 1, E - 1] = np.inf
    feats[0, E // 2] = -np.inf
    got = token_max_sim(torch.from_numpy(feats), torch.from_numpy(targets)).numpy()
    for ref in (_xla_token_max_sim, token_max_sim_pallas):
        want = np.asarray(ref(jnp.asarray(feats), jnp.asarray(targets)))
        np.testing.assert_allclose(got, want, atol=1e-5)  # equal_nan, infinities equal
    assert np.isfinite(got[1:, 2]).all() and (got[1:, 5] == np.inf).all()
    assert not np.isfinite(got[0]).any()


def test_wrapper_takes_galleries_past_2_31_elements(monkeypatch):
    """N = 262,145 items of 32 x 256 (2^31 + 8192 elements, 8.6 GB) on
    ``meta`` tensors through the CUDA branch, the launch and the device checks
    monkeypatched: planned, launched once and counted; only B or N past the C
    entry's 32-bit ints is refused."""
    N = 262145
    launched = []
    monkeypatch.setattr(primitives, "for_device", lambda x: primitives.CUDA)
    monkeypatch.setattr(sim_kernels, "_check_tensors", lambda f, t: None)
    monkeypatch.setattr(sim_kernels, "_launch", lambda f, t, out: launched.append(out.shape))
    before = token_max_sim.launches
    out = token_max_sim(torch.empty(32, 256, device="meta"),
                        torch.empty(N, 32, 256, device="meta"))
    assert N * 32 * 256 >= 2 ** 31
    assert out.shape == (32, N) and launched == [(32, N)]
    assert token_max_sim.launches == before + 1
    with pytest.raises(ValueError, match="32-bit ints"):
        schedules.token_max_sim_plan(32, 2 ** 31, 32, 256)
    with pytest.raises(ValueError, match="Q <= 32"):
        token_max_sim(torch.empty(2, 256, device="meta"), torch.empty(3, 33, 256, device="meta"))
    assert launched == [(32, N)]
