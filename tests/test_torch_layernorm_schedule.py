"""The LayerNorm kernel's walk (csrc/layernorm.cu: one warp a row, the row in
registers), in plain PyTorch (sprc_tpu_torch/ops/schedules.py::
layer_norm_emulated), against the port's plain LayerNorm and against the
JAX kernels' ``_ln_f32`` and ``_q8``.

What can be wrong outside the CUDA source: which elements a lane loads
(16-byte vectors of 8 bf16 or 4 fp32, the ragged tail of EVA's 1408 bf16, a
width that is not a whole number of vectors), and the order of the row sums
(each lane in load order, then the xor butterfly). The emulation is held to
the kernel's stage bounds, ``kernel_checks.STAGE_BOUNDS`` for ``layer_norm
-> bf16 / f32 / s8``, through ``kernel_checks.StageRecorder``: the share of
elements that differ and the worst difference relative to the largest
|reference value| (int8: in codes). An int8 code flips where the fp32 value
lies within an ulp of a half step, a few in a million, so the s8 checks
count over half a million elements or more.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sprc_tpu.ops import pallas_block, pallas_qformer  # noqa: E402

from sprc_tpu_torch import kernel_checks  # noqa: E402
from sprc_tpu_torch.ops import primitives, schedules  # noqa: E402
from test_torch_threads import one_torch_thread  # noqa: E402,F401  (one thread a module)

WIDTHS = [768, 1000, 1024, 1408, 77]  # the main path's widths, a generic one, a ragged one


def _inputs(seed, rows, W, dtype, std=2.0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, W), dtype=np.float32) * std + 0.3
    r = rng.standard_normal((rows, W), dtype=np.float32)
    w = (rng.standard_normal(W, dtype=np.float32) * 0.1 + 1.0)
    b = rng.standard_normal(W, dtype=np.float32) * 0.02
    t = lambda a: torch.from_numpy(a).to(dtype)  # noqa: E731
    return t(x), t(r), torch.from_numpy(w), torch.from_numpy(b)


def _held(kind, got, want):
    rec = kernel_checks.StageRecorder()
    rec.add(kind, got, want)
    (row,) = rec.rows()
    assert row["ok"], (kind, row)
    return row


@pytest.mark.parametrize("W", WIDTHS)
def test_emulated_walk_within_the_stage_bounds_of_plain(W):
    for dtype, kind in ((torch.bfloat16, "layer_norm -> bf16"),
                        (torch.float32, "layer_norm -> f32")):
        x, r, w, b = _inputs(W, 64, W, dtype)
        for residual in (None, r):
            got = schedules.layer_norm_emulated(x, w, b, 1e-5, residual)
            want = primitives.layer_norm_plain(x, w, b, 1e-5, residual)
            assert got.dtype == want.dtype == dtype and got.shape == want.shape
            _held(kind, got, want)
        x3 = x[:60].reshape(3, 20, W)  # leading dims are rows
        assert torch.equal(schedules.layer_norm_emulated(x3, w, b, 1e-6).reshape(60, W),
                           schedules.layer_norm_emulated(x[:60], w, b, 1e-6))


@pytest.mark.parametrize("W", [768, 1024, 1408])
def test_emulated_walk_matches_jax_ln_f32(W):
    """Both JAX kernels' ``_ln_f32`` (the Q-Former's post-LN in fp32 with
    the residual added first, and the ViT block's pre-LN rounded to bf16)."""
    x, r, w, b = _inputs(10 + W, 64, W, torch.float32)
    jw, jb = jnp.asarray(w.numpy()), jnp.asarray(b.numpy())
    want = np.array(pallas_qformer._ln_f32(jnp.asarray((x + r).numpy()), jw, jb, 1e-12))
    _held("layer_norm -> f32", schedules.layer_norm_emulated(x, w, b, 1e-12, r),
          torch.from_numpy(want))
    xb = x.to(torch.bfloat16)
    want = pallas_block._ln_f32(jnp.asarray(xb.float().numpy()), jw, jb, 1e-6).astype(jnp.bfloat16)
    _held("layer_norm -> bf16", schedules.layer_norm_emulated(xb, w, b, 1e-6),
          torch.from_numpy(np.asarray(want.astype(jnp.float32))).to(torch.bfloat16))


@pytest.mark.parametrize("W", [1024, 1408])
def test_s8_codes_match_jax_q8(W):
    """LN -> int8 with a static scale, against ``_q8(_ln_f32(x), 1 / a)`` of
    ``_full_kernel_i8`` and against the plain version: a few codes in a
    million differ, by one."""
    x, _, w, b = _inputs(20 + W, 512, W, torch.bfloat16, std=1.0)
    a = 0.04
    got = schedules.layer_norm_emulated(x, w, b, 1e-5, out_scale=a)
    assert got.dtype == torch.int8
    ln = pallas_block._ln_f32(jnp.asarray(x.float().numpy()), jnp.asarray(w.numpy()),
                              jnp.asarray(b.numpy()), 1e-5)
    want = torch.from_numpy(np.asarray(pallas_block._q8(ln, 1.0 / a)))
    _held("layer_norm -> s8", got, want)
    _held("layer_norm -> s8", got, primitives.layer_norm_plain(x, w, b, 1e-5, out_scale=a))


def test_plan_at_the_main_path_widths():
    plans = {(W, elt): schedules.layer_norm_plan(W, elt)
             for W, elt in ((1024, 2), (1408, 2), (768, 4), (1024, 4), (1408, 4))}
    # 32 values a lane at 1024 bf16, 44 at 1408 (48 registers: the sixth load
    # is taken by lanes 0 to 15 only), 24 at 768 fp32
    assert [(p["vec"], p["loads"], p["registers"], p["tail_lanes"], p["values_per_lane"])
            for p in plans.values()] == [(8, 4, 32, 32, 32.0), (8, 6, 48, 16, 44.0),
                                         (4, 6, 24, 32, 24.0), (4, 8, 32, 32, 32.0),
                                         (4, 11, 44, 32, 44.0)]
    assert all(p["width"] == W for (W, _), p in plans.items())
    generic = schedules.layer_norm_plan(1000, 2)
    assert (generic["width"], generic["vec"], generic["loads"], generic["registers"]) == (
        "generic", 8, 4, 128)
    ragged = schedules.layer_norm_plan(77, 2)
    assert (ragged["vec"], ragged["loads"], ragged["tail_lanes"]) == (1, 3, 13)
    assert schedules.layer_norm_plan(1024, 2, aligned=False)["vec"] == 1
    for bad in ((0, 2), (4097, 4), (64, 1)):
        with pytest.raises(ValueError):
            schedules.layer_norm_plan(*bad)


@pytest.mark.parametrize("W,elt", [(1408, 2), (768, 4), (77, 2), (4096, 4)])
def test_every_element_has_one_lane_in_load_order(W, elt):
    idx = schedules.layer_norm_lanes(W, elt)
    flat = idx[idx >= 0]
    assert sorted(flat.tolist()) == list(range(W))
    for lane in idx:
        own = lane[lane >= 0]
        assert torch.equal(own, torch.sort(own).values)  # a lane sums in load order
    vec = schedules.layer_norm_plan(W, elt)["vec"]
    # the first load: lane l takes elements l * vec .. l * vec + vec - 1 (16 bytes)
    assert torch.equal(idx[:, :vec], torch.arange(32)[:, None] * vec + torch.arange(vec))
