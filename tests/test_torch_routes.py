"""The tower's three routes (``ViTConfig.fused_block`` / ``fused_mlp`` in
sprc_tpu_torch/models/vit.py, which stand for the JAX package's
SPRC_PALLAS_BLOCK and SPRC_PALLAS_MLP) against the JAX tower.

The JAX model reaches ``fused_attn_block`` and ``flash_attention`` only on a
TPU backend, so the JAX side runs the routes it can run on the CPU: unfused
(SPRC_PALLAS_BLOCK=0), the whole-block Pallas kernel in interpret mode
(``force``) and the Pallas MLP kernel in interpret mode
(SPRC_PALLAS_MLP=force), each set before the first trace. Every route of the
port is held against each of them: one function, fp32, atol 5e-5 (fp32 sums
in another order). Tiny EVA-style tower: width 176, 2 heads of 88, 2 blocks.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sprc_tpu.models.vit import EvaViT as JEvaViT  # noqa: E402

from sprc_tpu_torch.models.vit import ViTConfig  # noqa: E402
from sprc_tpu_torch.ops import primitives  # noqa: E402

from test_torch_eva import ATOL, B, KW, _jax_tower, _port_tower  # noqa: E402
from test_torch_threads import one_torch_thread  # noqa: E402,F401  (one thread a module)

ROUTES = {"block": dict(), "attn": dict(fused_block="attn"),
          "attn+mlp": dict(fused_block="attn", fused_mlp=True),
          "none": dict(fused_block="none"), "none+mlp": dict(fused_block="none", fused_mlp=True)}


@pytest.mark.parametrize("flags", [{"SPRC_PALLAS_BLOCK": "0"}, {"SPRC_PALLAS_BLOCK": "force"},
                                   {"SPRC_PALLAS_BLOCK": "0", "SPRC_PALLAS_MLP": "force"}],
                         ids=["jax-unfused", "jax-block-kernel", "jax-mlp-kernel"])
def test_every_route_matches_the_jax_tower(flags, monkeypatch):
    for key, value in flags.items():
        monkeypatch.setenv(key, value)
    jcfg, params = _jax_tower(scan=False, seed=4)
    images = np.random.RandomState(5).rand(B, 28, 28, 3).astype(np.float32)
    want = np.asarray(jax.jit(JEvaViT(jcfg).apply)({"params": params}, jnp.asarray(images)))
    for name, route in ROUTES.items():
        with torch.inference_mode():
            got = _port_tower(params, **route)(torch.from_numpy(images)).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL, err_msg=name)


def test_routes_share_parameters_and_agree():
    """One state dict loads into every route, and in fp32 the routes agree
    to rounding (1e-5: the unfused route adds EVA's q and v biases after the
    dense op, the fused ones inside it)."""
    _, params = _jax_tower(scan=False, seed=6)
    images = torch.from_numpy(np.random.RandomState(7).rand(B, 28, 28, 3).astype(np.float32))
    towers = {name: _port_tower(params, **route) for name, route in ROUTES.items()}
    keys = [list(t.state_dict()) for t in towers.values()]
    assert all(k == keys[0] for k in keys)
    with torch.inference_mode():
        outs = {name: t(images) for name, t in towers.items()}
        with primitives.plain_reference():
            plain = towers["none"](images)
    for name, out in outs.items():
        np.testing.assert_allclose(out.numpy(), outs["block"].numpy(), atol=1e-5, err_msg=name)
    np.testing.assert_array_equal(plain.numpy(), outs["none"].numpy())


def test_routes_run_bf16():
    """In bf16 the routes round at other places (the MLP kernel adds its
    residual in fp32; the unfused route rounds before EVA's biases and
    before the activation): within 2^-6 of the output's largest |value|
    after two blocks."""
    _, params = _jax_tower(scan=False, seed=8)
    images = torch.from_numpy(np.random.RandomState(9).rand(B, 28, 28, 3).astype(np.float32))
    outs = {}
    for name, route in ROUTES.items():
        with torch.inference_mode():
            outs[name] = _port_tower(params, dtype=torch.bfloat16, **route)(images).float()
        assert bool(torch.isfinite(outs[name]).all())
    top = outs["block"].abs().max().item()
    for name, out in outs.items():
        assert (out - outs["block"]).abs().max().item() <= top * 2.0 ** -6, name


def test_impossible_combinations_raise():
    scales = (("mlp_fc1", 0.1), ("mlp_fc2", 0.1), ("proj", 0.1), ("qkv", 0.1))
    with pytest.raises(ValueError, match="fused_block"):
        ViTConfig(**KW, fused_block="1")
    with pytest.raises(ValueError, match="whole-block"):
        ViTConfig(**KW, fused_mlp=True)
    for route in ("attn", "none"):
        with pytest.raises(ValueError, match="int8_static"):
            ViTConfig(**KW, fused_block=route, quant="int8_static", act_scales=scales)
    with pytest.raises(ValueError, match="int8 modes"):
        ViTConfig(**KW, fused_block="none", fused_mlp=True, quant="int8")
    # the dynamic modes take the unfused route whatever fused_block says, as in the JAX package
    assert ViTConfig(**KW, quant="int8_calib").fused_block == "block"
    assert ViTConfig().fused_block == "block" and not ViTConfig().fused_mlp  # the JAX defaults
