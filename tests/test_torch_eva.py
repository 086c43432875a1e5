"""The EVA ViT-g tower of the port (``EvaViT`` in sprc_tpu_torch/models/vit.py)
against sprc_tpu, at a tiny size that keeps EVA's head dim: width 176, 2
heads of 88, MLP 256, 2 blocks, exact GELU, eps 1e-6, a patch conv with bias,
no ln_pre, and random q and v biases (so that a k third that is not zero
would show). Weights cross through ``eva_vit_from_jax`` and load with
``strict=True``. fp32 on the CPU; atol 5e-5 (fp32 sums in another order
through LayerNorm, attention and two residual branches per block).

The int8 modes have test_torch_vit_int8.py's stated bounds (max-abs 5e-3,
mean-abs 5e-4: a code that flips at a half step moves a row by about 1e-3;
on the seed used here none flips and the reading is 2e-6, while seed 2, with
these 0.05-noised weights, flips one in the first block and reads 2e-2);
the weights' codes are bit-equal.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sprc_tpu.interop.torch_export import eva_vit_to_torch  # noqa: E402
from sprc_tpu.models.vit import EvaViT as JEvaViT  # noqa: E402
from sprc_tpu.models.vit import ViTConfig as JViTConfig  # noqa: E402
from sprc_tpu.models.vit import calibrate_act_scales as jcalibrate  # noqa: E402
from sprc_tpu.ops.quant import quantize_weight as jquantize_weight  # noqa: E402

from sprc_tpu_torch.interop.jax_params import eva_vit_from_jax, to_torch  # noqa: E402
from sprc_tpu_torch.models.vit import ClipViT, EvaViT, ViTConfig, build_tower  # noqa: E402
from sprc_tpu_torch.ops import quant  # noqa: E402

from test_torch_vit_int8 import _close  # noqa: E402
from test_torch_threads import one_torch_thread  # noqa: E402,F401  (one thread a module)

B, S, W = 2, 5, 176
KW = dict(image_size=28, patch_size=14, width=W, depth=2, num_heads=2, mlp_hidden=256,
          layer_norm_eps=1e-6, qkv_fused_no_kbias=True)
ATOL = 5e-5


def _jax_tower(scan, seed=0, **extra):
    """(config, numpy params with every zero-initialised bias made random)."""
    jcfg = JViTConfig(**KW, dtype=jnp.float32, scan_blocks=scan, **extra)
    params = jax.jit(JEvaViT(jcfg).init)(jax.random.PRNGKey(seed),
                                         jnp.zeros((1, 28, 28, 3)))["params"]
    rng = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + (rng.standard_normal(a.shape) * 0.05).astype(np.float32), params)
    return jcfg, params


def _port_tower(params, dtype=torch.float32, **kw):
    tower = EvaViT(ViTConfig(**KW, dtype=dtype, **kw))
    tower.load_state_dict(to_torch(eva_vit_from_jax(params, prefix="")), strict=True)
    return tower.eval()


@pytest.mark.parametrize("scan", [False, True], ids=["unscanned", "scanned"])
def test_eva_vit_matches_jax(scan, monkeypatch):
    monkeypatch.setenv("SPRC_PALLAS_BLOCK", "0")
    jcfg, params = _jax_tower(scan)
    assert ("blocks" in params["trunk"]) == scan
    images = np.random.RandomState(1).rand(B, 28, 28, 3).astype(np.float32)
    want = np.asarray(jax.jit(JEvaViT(jcfg).apply)({"params": params}, jnp.asarray(images)))
    with torch.inference_mode():
        got = _port_tower(params)(torch.from_numpy(images)).numpy()
    assert got.shape == (B, S, W)
    np.testing.assert_allclose(got, want, atol=ATOL)
    # the k third of the packed bias is zero, the q and v thirds are the checkpoint's
    block = _port_tower(params).blocks[0]
    packed = block.kernel_params()[3]
    assert torch.equal(packed[:W], block.attn.q_bias) and torch.equal(packed[2 * W:],
                                                                      block.attn.v_bias)
    assert packed[W:2 * W].abs().max() == 0 and packed[:W].abs().max() > 0


def test_bridge_equals_torch_export_and_keeps_scanned_blocks():
    _, params = _jax_tower(scan=False)
    ours, theirs = eva_vit_from_jax(params), eva_vit_to_torch(params)
    assert sorted(ours) == sorted(theirs)
    for k, v in theirs.items():
        np.testing.assert_array_equal(ours[k], np.asarray(v), err_msg=k)
    _, scanned = _jax_tower(scan=True)
    assert not any(".blocks." in k for k in eva_vit_to_torch(scanned))  # the exporter's gap
    assert sum(k.endswith("attn.qkv.weight") for k in eva_vit_from_jax(scanned)) == 2


def test_strict_load_and_layout_checks():
    _, params = _jax_tower(scan=False)
    state = to_torch(eva_vit_from_jax(params, prefix=""))
    state.pop("blocks.1.attn.v_bias")
    with pytest.raises(RuntimeError, match="Missing key"):
        EvaViT(ViTConfig(**KW, dtype=torch.float32)).load_state_dict(state, strict=True)
    assert isinstance(build_tower(ViTConfig(**KW)), EvaViT)
    with pytest.raises(ValueError, match="EVA layout"):
        EvaViT(ViTConfig(**{**KW, "qkv_fused_no_kbias": False}))
    with pytest.raises(ValueError, match="CLIP layout"):
        ClipViT(ViTConfig(**KW))


@pytest.mark.parametrize("mode", ["int8", "int8_static"])
def test_eva_vit_int8_modes_match_jax(mode, monkeypatch):
    monkeypatch.setenv("SPRC_PALLAS_BLOCK", "force")  # int8_static -> the Pallas K5, interpret
    jcfg, params = _jax_tower(scan=False, seed=3)
    images = np.random.RandomState(3).rand(B, 28, 28, 3).astype(np.float32)
    jcal = JEvaViT(JViTConfig(**{**jcfg.__dict__, "quant": "int8_calib"}))
    scales = jcalibrate(jcal, params, jnp.asarray(images))
    extra = dict(quant=mode, act_scales=scales if mode == "int8_static" else None)
    jtower = JEvaViT(JViTConfig(**{**jcfg.__dict__, **extra}))
    want = jax.jit(lambda p, x: jtower.apply({"params": p}, x,
                                             mutable=["intermediates"])[0])(params, images)
    tower = _port_tower(params, **extra)
    with torch.inference_mode():
        got = tower(torch.from_numpy(images))
    _close(got.numpy(), want)
    # the weights' codes and scales are the JAX package's, bit for bit
    block, jblock = tower.blocks[0], params["trunk"]["block_0"]
    for (p8, ps), kernel in ((quant.int8_weight(block.attn.qkv, "weight"),
                              jblock["attn"]["qkv"]["kernel"]),
                             (block.mlp.fc2.int8_params()[:2], jblock["mlp_fc2"]["kernel"])):
        j8, js = jquantize_weight(jnp.asarray(kernel))
        np.testing.assert_array_equal(p8.numpy(), np.asarray(j8).T)
        np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
