"""Kernel K2's module (sprc_tpu_torch/ops/fused_block.py) and the CLIP
tower (sprc_tpu_torch/models/vit.py) against sprc_tpu.

One block (width 128, 2 heads of 64, MLP 256, QuickGELU, eps 1e-5) is held
against the JAX unfused reference ``_full_xla_ref`` and the Pallas
``fused_vit_block`` in interpret mode, and the whole 2-block ClipViT
against the JAX tower run unfused (SPRC_PALLAS_BLOCK=0) and with the Pallas
block forced (interpret). All fp32; atol 5e-5 (fp32 sums in another order
through LayerNorm, attention and two residual branches per block).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sprc_tpu.models.vit import ClipViT as JClipViT  # noqa: E402
from sprc_tpu.models.vit import ViTConfig as JViTConfig  # noqa: E402
from sprc_tpu.ops.pallas_block import _full_xla_ref  # noqa: E402
from sprc_tpu.ops.pallas_block import fused_vit_block as jax_fused_vit_block  # noqa: E402

from sprc_tpu_torch.interop.jax_params import clip_vit_from_jax, to_torch  # noqa: E402
from sprc_tpu_torch.models.vit import ClipViT, ViTConfig  # noqa: E402
from sprc_tpu_torch.ops import primitives  # noqa: E402
from sprc_tpu_torch.ops.fused_block import fused_vit_block  # noqa: E402
from test_torch_threads import one_torch_thread  # noqa: E402,F401  (one thread a module)

B, S, W, H, M = 2, 5, 128, 2, 256
ATOL = 5e-5


def _block_params(rng):
    """JAX-layout block params ([in, out] kernels) as numpy."""
    shapes = [(W,), (W,), (W, 3 * W), (3 * W,), (W, W), (W,), (W,), (W,), (W, M), (M,),
              (M, W), (W,)]
    p = [(rng.randn(*sh) * 0.05).astype(np.float32) for sh in shapes]
    p[0] += 1.0
    p[6] += 1.0
    return p


def test_vit_block_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(B, S, W).astype(np.float32)
    p = _block_params(rng)
    kw = dict(heads=H, eps=1e-5, scale=(W // H) ** -0.5, quick=True)
    want_ref = np.asarray(_full_xla_ref(jnp.asarray(x), *map(jnp.asarray, p), **kw))
    want_pallas = np.asarray(jax_fused_vit_block(jnp.asarray(x), *map(jnp.asarray, p),
                                                 H, 1e-5, (W // H) ** -0.5, True, 2))
    # the port takes torch Linear layouts: [out, in] weights
    tp = [torch.from_numpy(np.ascontiguousarray(a.T if a.ndim == 2 else a)) for a in p]
    with torch.no_grad():
        got = fused_vit_block(torch.from_numpy(x), *tp, **kw).numpy()
    np.testing.assert_allclose(got, want_ref, atol=ATOL)
    np.testing.assert_allclose(got, want_pallas, atol=ATOL)


@pytest.mark.parametrize("flag", ["0", "force"])
def test_clip_vit_matches_jax(flag, monkeypatch):
    rng = np.random.RandomState(1)
    jcfg = JViTConfig(image_size=28, patch_size=14, width=W, depth=2, num_heads=H,
                      mlp_hidden=M, layer_norm_eps=1e-5, use_ln_pre=True, quick_gelu=True,
                      patch_bias=False, dtype=jnp.float32)
    jtower = JClipViT(jcfg)
    images = rng.rand(B, 28, 28, 3).astype(np.float32)
    monkeypatch.setenv("SPRC_PALLAS_BLOCK", "0")
    params = jax.jit(jtower.init)(jax.random.PRNGKey(0), jnp.asarray(images))["params"]
    monkeypatch.setenv("SPRC_PALLAS_BLOCK", flag)
    want = np.asarray(jax.jit(jtower.apply)({"params": params}, jnp.asarray(images)))

    tower = ClipViT(ViTConfig(image_size=28, patch_size=14, width=W, depth=2, num_heads=H,
                              mlp_hidden=M, layer_norm_eps=1e-5, use_ln_pre=True,
                              quick_gelu=True, patch_bias=False, dtype=torch.float32))
    tower.load_state_dict(to_torch(clip_vit_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                                     prefix="")), strict=True)
    with torch.inference_mode():
        got = tower(torch.from_numpy(images)).numpy()
    assert got.shape == (B, S, W)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_blocks_call_the_wrapper_whatever_the_grad_mode():
    """A block routes by device alone: with grad on and parameters that
    require grad it calls K2's wrapper through its autograd Function
    (``FusedViTBlock``; the wrapper alone raises there, it serves only);
    only ``plain_reference`` picks the plain block, and both equal the
    wrapper's output without a graph exactly on the CPU."""
    tower = ClipViT(ViTConfig(image_size=28, patch_size=14, width=W, depth=2, num_heads=H,
                              mlp_hidden=M, layer_norm_eps=1e-5, use_ln_pre=True,
                              quick_gelu=True, patch_bias=False, dtype=torch.float32))
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in tower.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
    images = torch.from_numpy(np.random.RandomState(2).rand(B, 28, 28, 3).astype(np.float32))
    block = tower.vit_blocks()[0]
    x = torch.randn(B, 5, W, generator=gen)
    with pytest.raises(RuntimeError, match="inference-only"):
        fused_vit_block(x, *block.kernel_params(), heads=H, eps=1e-5, scale=(W // H) ** -0.5,
                        quick=True)
    trained = tower(images)
    assert type(trained.grad_fn).__name__ == "FusedViTBlockBackward"
    with primitives.plain_reference():
        plain = tower(images)
    assert plain.requires_grad and type(plain.grad_fn).__name__ != "FusedViTBlockBackward"
    with torch.inference_mode():
        got = tower(images)
    np.testing.assert_array_equal(got.numpy(), plain.detach().numpy())
    np.testing.assert_array_equal(got.numpy(), trained.detach().numpy())
