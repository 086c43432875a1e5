"""Kernel K8's module (sprc_tpu_torch/ops/attention.py) against sprc_tpu.

``flash_attention`` is held against the Pallas ``flash_attention`` in
interpret mode, called directly at the shapes of tests/test_pallas_kernels.py
(a head dim of 88 and Sq != Sk among them), and ``dot_product_attention``
with a padding bias against the JAX einsum path. On the CPU the port runs
the plain version. fp32: atol 2e-5, the JAX tests' own (another summation
order in the softmax). bf16: the Pallas v3 kernel and the port's plain
version both normalise in fp32 and then round, so they agree to one bf16
step of the output (2^-8 relative to the largest |value|; held to 2^-7).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sprc_tpu.ops.attention import _xla_attention  # noqa: E402
from sprc_tpu.ops.pallas_attention import flash_attention as jax_flash_attention  # noqa: E402

from sprc_tpu_torch.ops import primitives  # noqa: E402
from sprc_tpu_torch.ops.attention import dot_product_attention, flash_attention  # noqa: E402
from test_torch_threads import one_torch_thread  # noqa: E402,F401  (one thread a module)

ATOL = 2e-5


def _qkv(seed, B, Sq, Sk, H, D):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, Sq, H, D).astype(np.float32), rng.randn(B, Sk, H, D).astype(np.float32),
            rng.randn(B, Sk, H, D).astype(np.float32))


def _t(*arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


@pytest.mark.parametrize("shape", [(2, 257, 2, 64), (1, 100, 3, 88), (2, 128, 1, 128)])
def test_flash_attention_matches_jax_pallas(shape):
    B, S, H, D = shape
    q, k, v = _qkv(0, B, S, S, H, D)
    want = np.asarray(jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), D ** -0.5))
    with torch.no_grad():
        got = flash_attention(*_t(q, k, v), D ** -0.5)
    assert got.shape == (B, S, H, D)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_flash_attention_cross_lengths_matches_jax_pallas():
    q, k, v = _qkv(1, 2, 32, 257, 2, 88)
    want = np.asarray(jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0.125))
    with torch.no_grad():
        got = flash_attention(*_t(q, k, v), 0.125)
    assert got.shape == (2, 32, 2, 88)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_flash_attention_bf16_within_one_step_of_jax_pallas():
    q, k, v = _qkv(2, 2, 130, 130, 2, 88)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = np.asarray(jax_flash_attention(jq, jk, jv, 88 ** -0.5).astype(jnp.float32))
    with torch.no_grad():
        got = flash_attention(*_t(q, k, v, dtype=torch.bfloat16), 88 ** -0.5)
    assert got.dtype == torch.bfloat16
    d = np.abs(got.float().numpy() - want)
    assert d.max() <= np.abs(want).max() * 2.0 ** -7, d.max()
    assert d.mean() <= 1e-3, d.mean()


def test_dot_product_attention_with_bias_matches_jax():
    """The masked path (the Q-Former's): bias after the scale, broadcast from
    [B, 1, 1, Sk]; and the default scale."""
    q, k, v = _qkv(3, 2, 9, 12, 2, 16)
    mask = np.ones((2, 12), np.float32)
    mask[0, -5:] = 0
    bias = ((1.0 - mask) * -10000.0)[:, None, None, :]
    want = np.asarray(_xla_attention(*map(jnp.asarray, (q, k, v, bias)), 16 ** -0.5))
    got = dot_product_attention(*_t(q, k, v), torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    want = np.asarray(_xla_attention(*map(jnp.asarray, (q, k, v)), None, 0.3))
    got = dot_product_attention(*_t(q, k, v), scale=0.3)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_flash_attention_is_inference_only_and_counts_no_cpu_run():
    q, k, v = _t(*_qkv(4, 1, 130, 130, 1, 64))
    before = flash_attention.launches
    with torch.no_grad():
        got = flash_attention(q, k, v, 0.125)
    assert flash_attention.launches == before  # the plain version is no launch
    np.testing.assert_array_equal(
        got.numpy(), primitives.flash_attention_plain(q, k, v, 0.125).numpy())
    q.requires_grad_(True)
    with pytest.raises(RuntimeError, match="inference-only"):
        flash_attention(q, k, v, 0.125)
    # the einsum path differentiates: a short or masked sequence never reaches the kernel
    dot_product_attention(q[:, :8], k, v).sum().backward()
    assert q.grad is not None
