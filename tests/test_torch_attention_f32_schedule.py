"""The fp32 attention kernel's schedule (csrc/attention.cu, fp32 path: 3xTF32
on mma.sync.m16n8k8), walked in plain PyTorch (sprc_tpu_torch/ops/
schedules.py::attention_f32_emulated), against the port's plain attention
and against sprc_tpu.

The kernel runs only on a card; what can be wrong outside the CUDA source is
its walk: the warps of a block (a block owns all of a Q-Former head's query
rows; 96 rows at S = 257), 32-key chunks in which only the 8-key score tiles
and P V k-steps with a valid key are computed, every product split into TF32
parts (rounded by masking the fp32 mantissa, as cvt.rna does) and taken as
small . big + big . small + big . big, the plain version's two roundings of
the score, the running max, the row sum as a quad of lanes takes it, ``l = l
* corr + rowsum``, the unnormalised P V and the division last; and the
fragment layouts that let the score tile be P's A fragment. Each emulated
output is held to its kernel's stage bound,
``kernel_checks.STAGE_BOUNDS["attention -> f32"]`` (relative to the largest
|plain value|), against ``attention_plain`` and the JAX functions.

A fully masked item (every key at -10000) is held with inputs whose scores
are exact in fp32 in any summation order (multiples of 1/8 of size at most
2): at -10000 the fp32 grid is 2^-10, so two right sums that differ in their
last bit can round a score to neighbouring grid points, and with random
inputs that alone moves such a row's output by 1e-5 of its range. With exact
scores the check sees what it is for: a max-subtracted softmax that spreads
the row's weight as ``jax.nn.softmax`` does.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sprc_tpu.ops.attention import dot_product_attention  # noqa: E402
from sprc_tpu.ops.pallas_qformer import _attend_bias  # noqa: E402

from sprc_tpu_torch import kernel_checks  # noqa: E402
from sprc_tpu_torch.ops import primitives, schedules  # noqa: E402
from test_torch_threads import one_torch_thread  # noqa: E402,F401  (one thread a module)

B, H = 2, 2
# ragged (Sq, Sk): one row and one key, a last chunk of 1, 31 and 32 keys, a
# P V step of 1 key, a last warp tile of 1 row, 64 rows (4 warps, one block),
# 65 rows (5 warps), the Q-Former's 32 into 257, the towers' 257 x 257
SHAPES = [(1, 1), (1, 257), (257, 1), (31, 32), (32, 33), (32, 257), (64, 64), (65, 63),
          (17, 97), (257, 257)]


def _inputs(seed, Sq, Sk, D):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, H * D), dtype=np.float32)
    k = rng.standard_normal((B, Sk, H * D), dtype=np.float32)
    v = rng.standard_normal((B, Sk, H * D), dtype=np.float32)
    bias = np.where(rng.random((B, Sk)) < 0.7, 0.0, -10000.0).astype(np.float32)
    bias[:, 0] = 0.0  # every row keeps a key here; the fully masked item is its own test
    return q, k, v, bias


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _relative(got, want):
    return (got.float() - want.float()).abs().max().item() / want.float().abs().max().item()


def _bound(D):
    kind = "attention -> f32" if D == 64 else f"attention D={D} -> f32"
    return kernel_checks.STAGE_BOUNDS[kind][1]


@pytest.mark.parametrize("D", [64, 88])
def test_emulated_walk_within_the_stage_bound_of_plain(D):
    for i, (Sq, Sk) in enumerate(SHAPES):
        q, k, v, bias = _inputs(600 + i, Sq, Sk, D)
        tq, tk, tv, tb = _t(q, k, v, bias)
        for col_bias in (None, tb):
            got = schedules.attention_f32_emulated(tq, tk, tv, H, D ** -0.5, col_bias)
            want = primitives.attention_plain(tq, tk, tv, H, D ** -0.5, col_bias)
            assert got.shape == want.shape == (B, Sq, H * D) and got.dtype == torch.float32
            assert _relative(got, want) <= _bound(D), (Sq, Sk, col_bias is not None)


@pytest.mark.parametrize("D", [64, 88])
def test_fully_masked_item_is_spread_evenly(D):
    rng = np.random.default_rng(700 + D)
    Sq, Sk = 40, 70
    q, k = ((rng.integers(-16, 17, (B, S, H * D)) / 8).astype(np.float32) for S in (Sq, Sk))
    v = rng.standard_normal((B, Sk, H * D), dtype=np.float32)
    bias = np.where(rng.random((B, Sk)) < 0.7, 0.0, -10000.0).astype(np.float32)
    bias[0] = -10000.0
    tq, tk, tv, tb = _t(q, k, v, bias)
    got = schedules.attention_f32_emulated(tq, tk, tv, H, D ** -0.5, tb)
    want = primitives.attention_plain(tq, tk, tv, H, D ** -0.5, tb)
    assert _relative(got, want) <= _bound(D)
    # with equal scores (q = 0) every key of the masked item weighs the same
    zero = torch.zeros_like(tq)
    even = schedules.attention_f32_emulated(zero, tk, tv, H, D ** -0.5, tb)[0]
    np.testing.assert_allclose(even.numpy(), np.broadcast_to(v[0].mean(0), even.shape), atol=2e-6)


def test_emulated_walk_matches_jax_attend_bias():
    """``pallas_qformer._attend_bias`` (the Q-Former kernel's attention,
    called directly on one item's q, k, v) in fp32 with its column bias, at
    the Q-Former's head dim and its three kinds of call; its softmax folds
    ``scale * log2 e`` into q and skips the max, which moves the result by
    rounding only."""
    D = 64
    for seed, (Sq, Sk) in enumerate([(32, 32), (32, 257), (64, 64), (9, 40)]):
        q, k, v, bias = _inputs(800 + seed, Sq, Sk, D)
        got = schedules.attention_f32_emulated(*_t(q, k, v, bias)[:3], H, D ** -0.5,
                                               _t(bias)[0])
        want = np.stack([np.asarray(_attend_bias(
            (jnp.asarray(q[b]), jnp.asarray(k[b]), jnp.asarray(v[b])), Sq, Sk, H * D, H,
            D ** -0.5, jnp.float32, jnp.asarray(bias[b]))) for b in range(B)])
        assert _relative(got, torch.from_numpy(want)) <= _bound(64), (Sq, Sk)


@pytest.mark.parametrize("D", [64, 88])
def test_emulated_walk_matches_jax_dot_product_attention(D):
    """``sprc_tpu.ops.attention.dot_product_attention`` (XLA, fp32) on BSHD
    tensors with the BERT-style additive bias, Sq != Sk."""
    for seed, (Sq, Sk) in enumerate([(257, 257), (32, 257), (31, 32)]):
        q, k, v, bias = _inputs(900 + seed, Sq, Sk, D)
        jq, jk, jv = (jnp.asarray(a.reshape(B, -1, H, D)) for a in (q, k, v))
        want = np.array(dot_product_attention(jq, jk, jv, jnp.asarray(bias)[:, None, None, :],
                                              scale=D ** -0.5, use_pallas=False))
        got = schedules.attention_f32_emulated(*_t(q, k, v, bias)[:3], H, D ** -0.5,
                                               _t(bias)[0])
        assert _relative(got, torch.from_numpy(want.reshape(B, Sq, H * D))) <= _bound(D)


def test_plan_at_the_main_path_calls():
    """The seven fp32 calls of the main paths: a Q-Former head is one block
    (K and V read once), 257 rows are 3 blocks of 96; every block fits two
    to a few on an SM; the grid is at least two blocks per SM."""
    calls = {  # (B, heads, Sq, Sk, D) -> (warps, blocks a head, stages)
        "queries self": ((64, 12, 32, 32, 64), (2, 1, 1)),
        "queries cross": ((64, 12, 32, 257, 64), (2, 1, 2)),
        "fusion self": ((32, 12, 64, 64, 64), (4, 1, 2)),
        "fusion cross": ((32, 12, 32, 257, 64), (2, 1, 2)),
        "prompt self": ((32, 12, 64, 64, 64), (4, 1, 2)),
        "fp32 tower": ((8, 16, 257, 257, 88), (6, 3, 2)),
        "flash fp32": ((8, 16, 257, 257, 64), (6, 3, 2)),
    }
    for name, ((b, h, Sq, Sk, D), want) in calls.items():
        plan = schedules.attention_f32_plan(Sq, Sk, D, B=b, H=h)
        assert (plan["warps"], plan["blocks"], plan["stages"]) == want, name
        assert plan["grid"] == (want[1], h, b)
        assert plan["block_rows"] >= min(Sq, 64), name
        assert 2 <= plan["blocks_per_sm"] and plan["smem_bytes"] <= 227 * 1024, name
        assert b * h * plan["blocks"] >= 2 * schedules.H100_SMS, name
    cross = schedules.attention_f32_plan(32, 257, 64)
    assert [c["valid"] for c in cross["chunks"]] == [32] * 8 + [1]
    assert cross["chunks"][-1] == {"first_key": 256, "valid": 1, "tiles": 1}
    tower = schedules.attention_f32_plan(257, 257, 88)
    assert tower["smem_bytes"] == 4 * (96 * 92 + 2 * (2 * 32 * 92 + 32))  # 83 KB: two a SM
    assert abs(tower["padding"] - (272 * 264 / 257 ** 2 - 1)) < 1e-12
    assert [schedules.attention_f32_warps(s) for s in (1, 16, 17, 64, 65, 128, 129, 257)] == [
        1, 1, 2, 4, 5, 8, 5, 6]
    for bad in ((0, 4, 64), (4, 0, 64), (4, 4, 68)):
        with pytest.raises(ValueError):
            schedules.attention_f32_plan(*bad)


def _mma_1688(a_frags, b_frags):
    """mma.m16n8k8 from its per-lane fragments as the PTX ISA lays them out
    (g = lane / 4, t = lane % 4): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
    a3 (g + 8, t + 4); b0 (t, g), b1 (t + 4, g). Returns the C fragments
    c0 c1 (g, 2t..), c2 c3 (g + 8, 2t..) per lane."""
    A, Bm = torch.zeros(16, 8, dtype=torch.float64), torch.zeros(8, 8, dtype=torch.float64)
    for lane in range(32):
        g, t = divmod(lane, 4)
        A[g, t], A[g + 8, t], A[g, t + 4], A[g + 8, t + 4] = a_frags[lane]
        Bm[t, g], Bm[t + 4, g] = b_frags[lane]
    C = A @ Bm
    return [(C[g, 2 * t], C[g, 2 * t + 1], C[g + 8, 2 * t], C[g + 8, 2 * t + 1])
            for g, t in (divmod(lane, 4) for lane in range(32))]


@pytest.mark.parametrize("D", [64, 88])
def test_fragments_score_tile_is_p_and_banks(D):
    """The kernel's fragment reads give Q K^T for a score tile, and the score
    tile's C fragment taken as (c0, c2, c1, c3) with V's rows 2t and 2t + 1
    gives P V; the fragments' shared-memory reads (rows pitched D + 4) fall
    in 32 distinct banks."""
    rng = np.random.default_rng(D)
    LD = D + 4
    Q, K = rng.standard_normal((16, D)), rng.standard_normal((8, D))
    S = np.zeros((16, 8))
    for kk in range(0, D, 8):  # the QK loop: a = Q rows g, g + 8; b0 = K[g][kk + t], b1 = [+4]
        a = [(Q[g, kk + t], Q[g + 8, kk + t], Q[g, kk + t + 4], Q[g + 8, kk + t + 4])
             for g, t in (divmod(lane, 4) for lane in range(32))]
        b = [(K[g, kk + t], K[g, kk + t + 4]) for g, t in (divmod(lane, 4) for lane in range(32))]
        c = _mma_1688(a, b)
        for lane, (c0, c1, c2, c3) in enumerate(c):
            g, t = divmod(lane, 4)
            S[g, 2 * t] += c0
            S[g, 2 * t + 1] += c1
            S[g + 8, 2 * t] += c2
            S[g + 8, 2 * t + 1] += c3
    np.testing.assert_allclose(S, Q @ K.T, atol=1e-12)
    V = rng.standard_normal((8, 8))
    frags = [(S[g, 2 * t], S[g, 2 * t + 1], S[g + 8, 2 * t], S[g + 8, 2 * t + 1])
             for g, t in (divmod(lane, 4) for lane in range(32))]
    a = [(c0, c2, c1, c3) for c0, c1, c2, c3 in frags]
    b = [(V[2 * t, g], V[2 * t + 1, g]) for g, t in (divmod(lane, 4) for lane in range(32))]
    out = _mma_1688(a, b)
    want = S @ V
    for lane, (o0, o1, o2, o3) in enumerate(out):
        g, t = divmod(lane, 4)
        np.testing.assert_allclose([o0, o1, o2, o3], [want[g, 2 * t], want[g, 2 * t + 1],
                                                      want[g + 8, 2 * t], want[g + 8, 2 * t + 1]])
    lanes = [divmod(lane, 4) for lane in range(32)]
    for offsets in ([g * LD + t for g, t in lanes],                 # Q a0, K b0 (rows g)
                    [(g + 8) * LD + t + 4 for g, t in lanes],       # Q a3
                    [2 * t * LD + g for g, t in lanes],             # V b0 (rows 2t)
                    [(2 * t + 1) * LD + g for g, t in lanes]):      # V b1
        assert len({o % 32 for o in offsets}) == 32


def test_tf32_split_as_cvt_rna():
    x = torch.tensor([1.0, 1 + 2 ** -11, 1 + 2 ** -10 + 2 ** -11, -(1 + 2 ** -11), 3.0000002,
                      0.0, -2.5e-8])
    big = schedules.tf32_round(x)
    want = torch.tensor([1.0, 1 + 2 ** -10, 1 + 2 ** -9, -(1 + 2 ** -10), 3.0, 0.0,
                         float(schedules.tf32_round(torch.tensor([-2.5e-8]))[0])])
    assert torch.equal(big, want)  # ties away from zero
    assert torch.equal(big.view(torch.int32) & 0x1FFF, torch.zeros(7, dtype=torch.int32))
    y = torch.from_numpy(np.random.default_rng(1).standard_normal(10000).astype(np.float32))
    b, s = schedules.split_tf32(y)
    rest = (y.double() - b.double() - s.double()).abs()
    assert (rest <= y.double().abs() * 2.0 ** -21).all()  # big + small is y to ~2^-22
    assert ((y - b).abs() <= y.abs() * 2.0 ** -11).all()
