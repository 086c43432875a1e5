"""The port's TimeSformer (``sprc_tpu_torch/models/timesformer.py``) against
sprc_tpu's, at the JAX tests' tiny shapes (32 px, patch 16, width 24, depth
2, 2 frames; tests/test_alpro.py).

The port's trunk is drawn by ``loader.init_weights`` and every tensor then
moved by seeded noise (so that a zero ``temporal_fc`` or a misplaced bias
would show); the JAX trunk gets the same weights through the JAX package's
LAVIS reader (``timesformer_params_from_torch``), and the JAX tree comes
back through the port's bridge (``timesformer_from_jax``) into a strict
load. Inputs are seeded numpy clips [B, T, H, W, 3]. Features and tokens
are held within 1e-5 absolute (fp32 both sides). On the CPU the JAX
attention takes its XLA path and the port's its einsum path; the spatial
call at S >= 128 is also held through the K8 wrapper (``flash_attention``,
its plain version on the CPU) and against the JAX package's Pallas
``flash_attention`` in interpret mode.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sprc_tpu.models.timesformer import TimeSformer as JTimeSformer  # noqa: E402
from sprc_tpu.models.timesformer import TimeSformerConfig as JConfig  # noqa: E402
from sprc_tpu.models.timesformer import timesformer_params_from_torch  # noqa: E402

from sprc_tpu_torch import loader  # noqa: E402
from sprc_tpu_torch.interop.jax_params import timesformer_from_jax, to_torch  # noqa: E402
from sprc_tpu_torch.models.timesformer import TimeSformer, TimeSformerConfig  # noqa: E402
from sprc_tpu_torch.ops import attention  # noqa: E402
from test_torch_threads import one_torch_thread  # noqa: E402,F401  (one thread a module)

TOL = 1e-5
TINY = dict(image_size=32, patch_size=16, width=24, depth=2, num_heads=2, mlp_hidden=48,
            num_frames=2)


def port_trunk(seed=0, noise=0.05, **over):
    """A tiny port trunk from ``init_weights(seed)``, every tensor moved by
    seeded noise."""
    model = TimeSformer(TimeSformerConfig(**{**TINY, **over}))
    loader.init_weights(model, seed)
    gen = torch.Generator().manual_seed(seed + 100)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn(p.shape, generator=gen) * noise)
    return model.eval()


def jax_pair(model):
    """(the JAX module, its params read from the port's state dict)."""
    cfg = model.cfg
    jmodel = JTimeSformer(JConfig(**{f.name: getattr(cfg, f.name)
                                     for f in dataclasses.fields(cfg) if f.name != "dtype"}))
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    return jmodel, jax.tree_util.tree_map(jnp.asarray,
                                          timesformer_params_from_torch(sd, "", cfg.depth))


def japply(jmodel, params, video, method=None):
    """The JAX module applied under ``jit`` (eager Flax runs op by op, about
    seven times slower at these shapes)."""
    return np.asarray(jax.jit(lambda p, v: jmodel.apply({"params": p}, v, method=method))(
        params, jnp.asarray(video)))


def clips(B=3, T=2, size=32, seed=0):
    return np.random.RandomState(seed).randn(B, T, size, size, 3).astype(np.float32)


def test_trunk_features_and_tokens_equal_jax():
    """forward_features ([B, 1 + N, C]: the CLS and the frame-mean tokens) and
    forward_tokens ([B, 1 + N T, C] in the (h w t) order) equal JAX's; the
    JAX tree bridged back loads strictly and gives the same state."""
    model = port_trunk(1)
    jmodel, params = jax_pair(model)
    video = clips()
    with torch.no_grad():
        feats = model.forward_features(torch.from_numpy(video)).numpy()
        tokens = model.forward_tokens(torch.from_numpy(video)).numpy()
    want_f = japply(jmodel, params, video, jmodel.forward_features)
    want_t = japply(jmodel, params, video, jmodel.forward_tokens)
    assert feats.shape == (3, 1 + 4, 24) and tokens.shape == (3, 1 + 4 * 2, 24)
    np.testing.assert_allclose(feats, want_f, atol=TOL, rtol=0)
    np.testing.assert_allclose(tokens, want_t, atol=TOL, rtol=0)
    # the frame mean of the (h w t) tokens is the pooled part
    np.testing.assert_allclose(tokens[:, 1:].reshape(3, 4, 2, 24).mean(2), feats[:, 1:],
                               atol=TOL, rtol=0)
    back = to_torch(timesformer_from_jax(jax.tree_util.tree_map(np.asarray, params), prefix=""))
    fresh = TimeSformer(model.cfg)
    fresh.load_state_dict(back, strict=True)
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(fresh.state_dict()[k].numpy(), v.numpy(), err_msg=k)


def test_temporal_fc_zero_after_block_zero():
    """``temporal_fc`` is zero-initialised in the blocks after the first only
    (reference vit.py:373-383), in the port's init as in the JAX init; its
    bias is zero everywhere, and block 0's weight is drawn."""
    model = TimeSformer(TimeSformerConfig(**dict(TINY, depth=3)))
    loader.init_weights(model, 0)
    jparams = jax.jit(JTimeSformer(JConfig(**dict(TINY, depth=3))).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 2, 32, 32, 3)))["params"]
    for i, block in enumerate(model.blocks):
        w = block.temporal_fc.weight
        jw = np.asarray(jparams[f"block_{i}"]["temporal_fc"]["kernel"])
        assert bool((w == 0).all()) == (i > 0) == bool((jw == 0).all()), i
        assert bool((block.temporal_fc.bias == 0).all())
        assert bool((block.attn.qkv.weight != 0).any())


def test_time_embed_with_more_rows_than_frames():
    """The QA models build 16 ``time_embed`` rows and sample 8 frames: a clip
    of T frames takes the table's first T rows, as in JAX; a later row
    changes nothing."""
    model = port_trunk(2, num_frames=4)
    jmodel, params = jax_pair(model)
    video = clips(B=2, T=2, seed=3)
    with torch.no_grad():
        got = model(torch.from_numpy(video)).numpy()
        model.time_embed[:, 2:] += 1.0
        again = model(torch.from_numpy(video)).numpy()
    want = japply(jmodel, params, video)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    np.testing.assert_array_equal(got, again)
    assert model.time_embed.shape == (1, 4, 24)


def test_spatial_attention_dispatches_to_k8_plain_on_cpu(monkeypatch):
    """At 192 px (S = 1 + 144 >= 128 rows, head dim 64) every block's
    spatial call is unmasked and long enough for K8 (on CUDA tensors the
    kernel; here its wrapper runs the plain version, no launch), the
    temporal call (T rows) takes the einsum path; the wrapper's output
    equals the call's and the JAX Pallas ``flash_attention`` in interpret
    mode on the same q / k / v, and the trunk equals JAX's."""
    from sprc_tpu.ops.pallas_attention import flash_attention as jax_flash

    model = port_trunk(4, image_size=192, width=128, num_heads=2, mlp_hidden=256, depth=1)
    jmodel, params = jax_pair(model)
    calls = []
    real = attention.dot_product_attention

    def spy(q, k, v, bias=None, **kw):
        out = real(q, k, v, bias, **kw)
        calls.append((q, k, v, bias, out))
        return out

    monkeypatch.setattr(attention, "dot_product_attention", spy)
    video = clips(B=1, T=2, size=192, seed=5)
    with torch.no_grad():
        got = model(torch.from_numpy(video)).numpy()
    assert [(c[0].shape[1], c[3] is None) for c in calls] == [(2, True), (145, True)]
    assert calls[0][0].shape[1] < attention._KERNEL_MIN_SEQ <= calls[1][0].shape[1]
    q, k, v, _, out = calls[1]
    before = attention.flash_attention.launches
    with torch.no_grad():
        wrapped = attention.flash_attention(q, k, v, 64 ** -0.5)
    assert attention.flash_attention.launches == before
    np.testing.assert_array_equal(wrapped.numpy(), out.numpy())
    pallas = np.asarray(jax_flash(*(jnp.asarray(t.numpy()) for t in (q, k, v)), 64 ** -0.5))
    np.testing.assert_allclose(out.numpy(), pallas, atol=TOL, rtol=0)
    want = japply(jmodel, params, video)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
