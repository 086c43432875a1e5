"""The port's copy of the retrieval metrics
(sprc_tpu_torch/retrieval/metrics.py) equals ``sprc_tpu.retrieval.metrics``
on seeded sims with ties: the same numbers, keys and key order, for CIRR,
FashionIQ and CIRCO, including a case where a recall is zero (the means
forced to 0.0). Exact equality: both are numpy on the host.
"""

import numpy as np
import pytest

from sprc_tpu.retrieval import metrics as jm

from sprc_tpu_torch.retrieval import metrics as pm
from test_torch_threads import one_torch_thread  # noqa: E402,F401  (one thread a module)

N, B = 60, 24
NAMES = [f"img{i:03d}" for i in range(N)]


def _sims(seed, ties=True):
    """[B, N] scores on a coarse grid, so that many are tied."""
    rng = np.random.RandomState(seed)
    sims = rng.rand(B, N).astype(np.float32)
    return np.round(sims * 8) / 8 if ties else sims


def _cirr_case(seed):
    rng = np.random.RandomState(seed)
    refs, targets, groups = [], [], []
    for _ in range(B):
        members = rng.choice(N, 6, replace=False)
        refs.append(NAMES[members[0]])
        targets.append(NAMES[members[1]])
        groups.append([NAMES[m] for m in members])
    return refs, targets, groups


def test_sort_gallery_keeps_gallery_order_on_ties():
    sims = np.array([[0.5, 0.9, 0.5, 0.9, 0.1]], np.float32)
    names = ["a", "b", "c", "d", "e"]
    assert pm.sort_gallery(sims, names).tolist() == [["b", "d", "a", "c", "e"]]
    np.testing.assert_array_equal(pm.sort_gallery(_sims(0), NAMES), jm.sort_gallery(_sims(0), NAMES))
    # fp32 distances: two float64 scores that round to one float32 are a tie
    sims64 = np.array([[0.3, 0.3 + 1e-12]], np.float64)
    assert pm.sort_gallery(sims64, ["x", "y"]).tolist() == [["x", "y"]]


@pytest.mark.parametrize("seed", [1, 2])
def test_cirr_metrics_equal(seed):
    refs, targets, groups = _cirr_case(seed)
    got = pm.compute_cirr_metrics(_sims(seed), NAMES, refs, targets, groups)
    want = jm.compute_cirr_metrics(_sims(seed), NAMES, refs, targets, groups)
    assert list(got) == list(want) and got == want
    assert pm.cirr_topk_lists(_sims(seed), NAMES, refs, groups) == jm.cirr_topk_lists(
        _sims(seed), NAMES, refs, groups)


def test_cirr_zero_recall_forces_the_means_to_zero():
    refs, targets, groups = _cirr_case(3)
    sims = _sims(3, ties=False)
    for row, target in enumerate(targets):  # every target ranks last: recall@1 is 0
        sims[row, NAMES.index(target)] = -1.0
    got = pm.compute_cirr_metrics(sims, NAMES, refs, targets, groups)
    want = jm.compute_cirr_metrics(sims, NAMES, refs, targets, groups)
    assert got == want and got["recall_at1"] == 0.0
    assert got["harmonic_mean"] == 0.0 and got["geometric_mean"] == 0.0
    with pytest.raises(AssertionError, match="exactly one target"):
        pm.compute_cirr_metrics(sims, NAMES, refs, ["missing"] * B, groups)


def test_fiq_metrics_equal():
    targets = [NAMES[i] for i in np.random.RandomState(4).randint(0, N, B)]
    assert pm.compute_fiq_metrics(_sims(4), NAMES, targets) == jm.compute_fiq_metrics(
        _sims(4), NAMES, targets)


def test_circo_metrics_equal():
    rng = np.random.RandomState(5)
    gts = []
    for _ in range(B):
        n = rng.randint(1, 6)
        gts.append([NAMES[i] for i in rng.choice(N, n, replace=False)] + [""] * (23 - n))
    got = pm.compute_circo_metrics(_sims(5), NAMES, gts)
    assert list(got) == ["map_at5", "map_at10", "map_at25", "map_at50"]
    assert got == jm.compute_circo_metrics(_sims(5), NAMES, gts)
    assert pm.compute_circo_metrics(_sims(5), NAMES, [[""] * 23] * B) == {
        k: 0.0 for k in got}
