"""Kernels K6 and K7's modules (``fused_attn_block`` and ``fused_mlp_block``
in sprc_tpu_torch/ops/fused_block.py) against the Pallas kernels of
``sprc_tpu/ops/pallas_block.py`` and ``pallas_mlp.py`` in interpret mode,
called directly as tests/test_pallas_kernels.py calls them. On the CPU the
port runs its plain versions.

fp32: atol 3e-5 for the attention half (the JAX test's own; the Pallas body
works in the exp2 domain without a max subtraction, the port with a
max-subtracted softmax) and 2e-5 for the MLP half, QuickGELU and exact GELU
(the Pallas kernel's rational erf is good to 1.5e-7). bf16: one bf16 step of
the output (2^-7 of its largest |value|): the port's plain GEMM rounds the
product before the bias where the Pallas kernels keep fp32, and
``pallas_mlp._xla_ref`` rounds the branch before the residual.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sprc_tpu.ops.pallas_block import fused_attn_block as jax_fused_attn_block  # noqa: E402
from sprc_tpu.ops.pallas_mlp import _xla_ref as jax_mlp_ref  # noqa: E402
from sprc_tpu.ops.pallas_mlp import fused_mlp_block as jax_fused_mlp_block  # noqa: E402

from sprc_tpu_torch.ops import primitives  # noqa: E402
from sprc_tpu_torch.ops.fused_block import fused_attn_block, fused_mlp_block  # noqa: E402
from test_torch_threads import one_torch_thread  # noqa: E402,F401  (one thread a module)


def _port(arrays, dtype=torch.float32):
    """JAX-layout arrays -> torch: [in, out] kernels become [out, in] weights
    in ``dtype``; vectors stay fp32."""
    return [torch.from_numpy(np.ascontiguousarray(a.T)).to(dtype) if a.ndim == 2
            else torch.from_numpy(a) for a in arrays]


def _mlp_args(rng, D=128, C=256):
    return [1.0 + 0.1 * rng.randn(D).astype(np.float32), 0.1 * rng.randn(D).astype(np.float32),
            rng.randn(D, C).astype(np.float32) * 0.05, rng.randn(C).astype(np.float32) * 0.05,
            rng.randn(C, D).astype(np.float32) * 0.05, rng.randn(D).astype(np.float32) * 0.05]


@pytest.mark.parametrize("quick", [True, False], ids=["quick_gelu", "exact_gelu"])
def test_fused_mlp_block_matches_jax_pallas(quick):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 9, 128).astype(np.float32) * 0.3
    p = _mlp_args(rng)
    want = np.asarray(jax_fused_mlp_block(jnp.asarray(x), *map(jnp.asarray, p), 1e-6, quick))
    with torch.no_grad():
        got = fused_mlp_block(torch.from_numpy(x), *_port(p), eps=1e-6, quick=quick)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


def test_fused_mlp_block_bf16_within_one_step():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 9, 128).astype(np.float32)
    p = _mlp_args(rng)
    jp = [jnp.asarray(a, jnp.bfloat16) if a.ndim == 2 else jnp.asarray(a) for a in p]
    jx = jnp.asarray(x, jnp.bfloat16)
    kernel = np.asarray(jax_fused_mlp_block(jx, *jp, 1e-6, False).astype(jnp.float32))
    ref = np.asarray(jax_mlp_ref(jx, *jp, eps=1e-6, quick=False).astype(jnp.float32))
    with torch.no_grad():
        got = fused_mlp_block(torch.from_numpy(x).to(torch.bfloat16),
                              *_port(p, torch.bfloat16), eps=1e-6, quick=False)
    assert got.dtype == torch.bfloat16
    step = np.abs(kernel).max() * 2.0 ** -7
    for want in (kernel, ref):
        assert np.abs(got.float().numpy() - want).max() <= step


def test_gemm_fp32_residual_rounds_once():
    """The MLP kernel's last step: ``acc + b2 + f32(x)`` and one cast, where
    the block kernels round the branch and add in the model dtype."""
    rng = np.random.RandomState(2)
    x, w = (torch.from_numpy(rng.randn(*s).astype(np.float32)).to(torch.bfloat16)
            for s in ((64, 32), (48, 32)))
    b = torch.from_numpy(rng.randn(48).astype(np.float32))
    res = torch.from_numpy(rng.randn(64, 48).astype(np.float32) * 8).to(torch.bfloat16)
    acc = torch.matmul(x, w.t()).float() + b
    once = primitives.gemm_plain(x, w, b, residual=res, residual_f32=True)
    twice = primitives.gemm_plain(x, w, b, residual=res)
    assert torch.equal(once, (acc + res.float()).to(torch.bfloat16))
    assert torch.equal(twice, res + acc.to(torch.bfloat16))
    assert not torch.equal(once, twice)
    xf, wf, rf = x.float(), w.float(), res.float()  # in fp32 the two modes are one sum
    np.testing.assert_allclose(primitives.gemm_plain(xf, wf, b, residual=rf, residual_f32=True),
                               primitives.gemm_plain(xf, wf, b, residual=rf), atol=1e-5)


def _attn_args(rng, W):
    return [1 + 0.1 * rng.randn(W).astype(np.float32), 0.1 * rng.randn(W).astype(np.float32),
            0.05 * rng.randn(W, 3 * W).astype(np.float32), 0.05 * rng.randn(3 * W).astype(np.float32),
            0.05 * rng.randn(W, W).astype(np.float32), 0.05 * rng.randn(W).astype(np.float32)]


@pytest.mark.parametrize("B,S,W,H", [(4, 37, 128, 2), (3, 9, 176, 2)], ids=["D=64", "D=88"])
def test_fused_attn_block_matches_jax_pallas(B, S, W, H):
    rng = np.random.RandomState(3)
    x = rng.randn(B, S, W).astype(np.float32)
    p = _attn_args(rng, W)
    scale = (W // H) ** -0.5
    want = np.asarray(jax_fused_attn_block(jnp.asarray(x), *map(jnp.asarray, p), H, 1e-5, scale, 4))
    with torch.no_grad():
        got = fused_attn_block(torch.from_numpy(x), *_port(p), heads=H, eps=1e-5, scale=scale)
    np.testing.assert_allclose(got.numpy(), want, atol=3e-5)


def test_fused_attn_block_bf16_within_one_step():
    rng = np.random.RandomState(4)
    B, S, W, H = 2, 17, 176, 2
    x = rng.randn(B, S, W).astype(np.float32)
    p = _attn_args(rng, W)
    scale = (W // H) ** -0.5
    want = np.asarray(jax_fused_attn_block(jnp.asarray(x, jnp.bfloat16), *map(jnp.asarray, p),
                                           H, 1e-5, scale, 2).astype(jnp.float32))
    with torch.no_grad():
        got = fused_attn_block(torch.from_numpy(x).to(torch.bfloat16), *_port(p, torch.bfloat16),
                               heads=H, eps=1e-5, scale=scale)
    assert got.dtype == torch.bfloat16
    assert np.abs(got.float().numpy() - want).max() <= np.abs(want).max() * 2.0 ** -7


def test_stage_names_tell_the_new_kernel_paths_apart():
    """``stage_check`` records a call under its primitive's name, and under a
    name of its own where the kernel takes another path, so that each has its
    bound in ``kernel_checks.STAGE_BOUNDS``."""
    from sprc_tpu_torch import kernel_checks

    x = torch.zeros(2, 5, 176)
    q4 = torch.zeros(2, 5, 2, 88)
    names = [primitives._stage_name("gemm", (x, x), {"residual": x, "residual_f32": True}),
             primitives._stage_name("gemm", (x, x), {"residual": x}),
             primitives._stage_name("attention", (x, x, x, 2, 0.1), {}),
             primitives._stage_name("attention", (x[..., :128], x, x, 2, 0.1), {}),
             primitives._stage_name("flash_attention", (q4, q4, q4, 0.1), {}),
             primitives._stage_name("flash_attention", (q4[..., :64], q4, q4, 0.1), {})]
    assert names == ["gemm, fp32 residual", "gemm", "attention D=88", "attention",
                     "flash_attention D=88", "flash_attention"]
    for name in names:
        for suffix in (" -> bf16", " -> f32"):
            assert name + suffix in kernel_checks.STAGE_BOUNDS
    assert set(vars(primitives.CUDA)) == set(vars(primitives.PLAIN))
