"""Kernel K5's module (fused_vit_block_i8 in sprc_tpu_torch/ops/fused_block.py)
and the CLIP tower's int8 modes (sprc_tpu_torch/models/vit.py) against
sprc_tpu, on test_torch_vit.py's tiny sizes (width 128, 2 heads of 64, MLP
256, 2 blocks, fp32 activations, CPU).

The JAX side runs ``fused_vit_block_i8`` as a Pallas kernel in interpret mode
(directly, and inside the tower with SPRC_PALLAS_BLOCK=force and
quant="int8_static"); quant="int8" / "int8_calib" run its unfused XLA block.

Tolerance. Both sides quantise fp32 values that differ by about 1e-6
(another summation order in LayerNorm, attention and the GELU), so a code
flips wherever a value sits that close to a half step, and one flip moves
its row of outputs by about scale x |w|, and through attention every row
of its image a little. Readings on these seeds: about 1e-5 where no code
flips (the block alone, "int8_static"), and max-abs 1.6e-3 / mean-abs 1.7e-4
in the "int8" tower, where one code of image 0 flips in the first block. The
bounds are 3x that: max-abs 5e-3 and mean-abs 5e-4 at output scale ~4, forty
times tighter than the ``rel < 0.05`` the JAX tests allow int8 against fp.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sprc_tpu.models.vit import ClipViT as JClipViT  # noqa: E402
from sprc_tpu.models.vit import ViTConfig as JViTConfig  # noqa: E402
from sprc_tpu.models.vit import calibrate_act_scales as jcalibrate  # noqa: E402
from sprc_tpu.ops.pallas_block import fused_vit_block_i8 as jax_fused_vit_block_i8  # noqa: E402
from sprc_tpu.ops.quant import quantize_weight as jquantize_weight  # noqa: E402

from sprc_tpu_torch.interop.jax_params import clip_vit_from_jax, to_torch  # noqa: E402
from sprc_tpu_torch.models.vit import ClipViT, ViTConfig, calibrate_act_scales  # noqa: E402
from sprc_tpu_torch.ops import quant  # noqa: E402
from sprc_tpu_torch.ops.fused_block import fused_vit_block_i8  # noqa: E402

from test_torch_vit import B, H, M, S, W, _block_params  # noqa: E402
from test_torch_threads import one_torch_thread  # noqa: E402,F401  (one thread a module)

MAX_ABS, MEAN_ABS = 5e-3, 5e-4
ACTS = (0.05, 0.01, 0.05, 0.03)  # qkv, proj, fc1, fc2
KW = dict(image_size=28, patch_size=14, width=W, depth=2, num_heads=H, mlp_hidden=M,
          layer_norm_eps=1e-5, use_ln_pre=True, quick_gelu=True, patch_bias=False)


def _close(got, want):
    d = np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32))
    assert d.max() <= MAX_ABS and d.mean() <= MEAN_ABS, (d.max(), d.mean())


@pytest.mark.parametrize("quick", [True, False], ids=["quick_gelu", "exact_gelu"])
def test_vit_block_i8_matches_jax_pallas(quick):
    rng = np.random.RandomState(10)
    x = rng.randn(B, S, W).astype(np.float32)
    l1s, l1b, wqkv, bqkv, wproj, bproj, l2s, l2b, w1, b1, w2, b2 = _block_params(rng)
    kw = dict(heads=H, eps=1e-5, scale=(W // H) ** -0.5, quick=quick, acts=ACTS)
    j = jnp.asarray
    jq = [jquantize_weight(j(w)) for w in (wqkv, wproj, w1, w2)]
    want = jax_fused_vit_block_i8(j(x), j(l1s), j(l1b), *jq[0], j(bqkv), *jq[1], j(bproj),
                                  j(l2s), j(l2b), *jq[2], j(b1), *jq[3], j(b2), **kw, G=2)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    pq = [quant.quantize_weight(t(w.T)) for w in (wqkv, wproj, w1, w2)]
    for (p8, ps), (j8, js) in zip(pq, jq):  # the same codes go into both kernels
        np.testing.assert_array_equal(p8.numpy(), np.asarray(j8).T)
        np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    with torch.no_grad():
        got = fused_vit_block_i8(t(x), t(l1s), t(l1b), *pq[0], t(bqkv), *pq[1], t(bproj),
                                 t(l2s), t(l2b), *pq[2], t(b1), *pq[3], t(b2), **kw)
    _close(got.numpy(), want)


@pytest.fixture(scope="module")
def towers():
    """JAX params of the tiny tower, its calibration images and the scales
    the JAX package calibrates from them."""
    rng = np.random.RandomState(11)
    images = rng.rand(B, 28, 28, 3).astype(np.float32)
    jcfg = JViTConfig(**KW, dtype=jnp.float32)
    params = jax.jit(JClipViT(jcfg).init)(jax.random.PRNGKey(0), jnp.asarray(images))["params"]
    jcal = JClipViT(JViTConfig(**{**jcfg.__dict__, "quant": "int8_calib"}))
    scales = jcalibrate(jcal, params, jnp.asarray(images))
    state = to_torch(clip_vit_from_jax(jax.tree_util.tree_map(np.asarray, params), prefix=""))
    return jcfg, params, images, scales, state


def _port_tower(state, **kw):
    tower = ClipViT(ViTConfig(**KW, dtype=torch.float32, **kw))
    tower.load_state_dict(state, strict=True)
    return tower.eval()


@pytest.mark.parametrize("mode", ["int8", "int8_calib", "int8_static"])
def test_clip_vit_int8_modes_match_jax(mode, towers, monkeypatch):
    jcfg, params, images, scales, state = towers
    monkeypatch.setenv("SPRC_PALLAS_BLOCK", "force")  # int8_static -> the Pallas K5, interpret
    extra = dict(quant=mode, act_scales=scales if mode == "int8_static" else None)
    jtower = JClipViT(JViTConfig(**{**jcfg.__dict__, **extra}))
    want = jax.jit(lambda p, x: jtower.apply({"params": p}, x,
                                             mutable=["intermediates"])[0])(params, images)
    with torch.inference_mode():
        got = _port_tower(state, **extra)(torch.from_numpy(images))
    assert got.shape == (B, S, W)
    _close(got.numpy(), want)


def test_calibrate_act_scales_matches_jax(towers):
    """The calibration pass is itself a dynamic-int8 forward, so a flipped
    code in block 0 moves block 1's amax by about 1e-3 relative (the
    fixture's images do that to ``mlp_fc2``). On these images no code flips
    and the scales agree to 1e-6 (reading 5e-7)."""
    jcfg, params, _, _, state = towers
    images = np.random.RandomState(13).rand(B, 28, 28, 3).astype(np.float32)
    jcal = JClipViT(JViTConfig(**{**jcfg.__dict__, "quant": "int8_calib"}))
    scales = jcalibrate(jcal, params, jnp.asarray(images))
    tower = _port_tower(state, quant="int8_calib")

    def run():  # two batches: the amax is taken over batches as over blocks
        with torch.inference_mode():
            tower(torch.from_numpy(images[:1]))
            tower(torch.from_numpy(images[1:]))

    got = calibrate_act_scales(tower, run)
    assert [k for k, _ in got] == [k for k, _ in scales] == ["mlp_fc1", "mlp_fc2", "proj", "qkv"]
    np.testing.assert_allclose([v for _, v in got], [v for _, v in scales], rtol=1e-6)
    with pytest.raises(ValueError, match="int8_calib"):
        calibrate_act_scales(_port_tower(state, quant="int8"), run)


def test_int8_static_without_scales_raises(towers):
    with pytest.raises(ValueError, match="missing .*'qkv'"):
        ClipViT(ViTConfig(**KW, quant="int8_static", act_scales=(("proj", 0.1),)))
    with pytest.raises(ValueError, match="calibrate_act_scales"):
        ClipViT(ViTConfig(**KW, quant="int8_static"))
    with pytest.raises(ValueError, match="quant"):
        ViTConfig(**KW, quant="int4")


def test_state_dict_keys_equal_across_modes(towers):
    """The int8 codes are derived state: every mode reads and writes the same
    reference-layout keys, and a tower whose weights did not come through
    load_state_dict (or the seeded init) refuses to run in int8."""
    *_, scales, state = towers
    plain = _port_tower(state)
    for mode in ("int8", "int8_calib", "int8_static"):
        tower = _port_tower(state, quant=mode, act_scales=scales)
        assert list(tower.state_dict()) == list(plain.state_dict()) == list(state)
    cold = ClipViT(ViTConfig(**KW, dtype=torch.float32, quant="int8"))
    with torch.no_grad():
        for p in cold.parameters():
            p.fill_(0.01)
    with pytest.raises(RuntimeError, match="int8 codes are derived"), torch.inference_mode():
        cold(torch.zeros(1, 28, 28, 3))
