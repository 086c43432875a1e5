"""Kernel K3's module (sprc_tpu_torch/ops/fused_qformer.py) and one
Q-Former layer (sprc_tpu_torch/models/qformer.py) against sprc_tpu; the
trunk is in test_torch_qformer_trunk.py.

Hidden 128, 2 heads of 64, intermediate 256, cross-attention on, Q=4
queries, text length 8, 5 image rows of width 128, fp32. The three serving
shapes: queries-only with the image (S=4), fusion with image, text and a
padded text mask (S=12), and the prompt pass without the image (S=12, text
FFN on every row). The JAX side runs each shape unfused (SPRC_PALLAS_QF=0)
and through the Pallas layer in interpret mode (SPRC_PALLAS_QF=force).
Tolerance: 2e-5 per layer (fp32 sums in another order; LayerNorm eps 1e-12
amplifies nothing here).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sprc_tpu.models.qformer import QFormerConfig as JQFormerConfig  # noqa: E402
from sprc_tpu.models.qformer import QFormerLayer as JQFormerLayer  # noqa: E402
from sprc_tpu.models.qformer import make_additive_mask as jmask  # noqa: E402

from sprc_tpu_torch.interop.jax_params import qformer_layer_from_jax, to_torch  # noqa: E402
from sprc_tpu_torch.models.qformer import (  # noqa: E402
    QFormerConfig, QFormerLayer, make_additive_mask)
from test_torch_threads import one_torch_thread  # noqa: E402,F401  (one thread a module)

B, Q, L, SI, W = 3, 4, 8, 5, 128
KW = dict(vocab_size=60, hidden_size=W, num_layers=2, num_heads=2, intermediate_size=256,
          encoder_width=W, query_length=Q)
JCFG = JQFormerConfig(**KW, dropout_rate=0.0, attention_dropout_rate=0.0)
CFG = QFormerConfig(**KW)
SHAPES = ["queries", "fusion", "prompt"]


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(7)
    ids = rng.randint(0, 60, (B, L)).astype(np.int32)
    queries = (rng.randn(B, Q, W) * 0.5).astype(np.float32)
    img = rng.randn(B, SI, W).astype(np.float32)
    mask = np.ones((B, Q + L), np.int32)
    mask[0, -3:] = 0
    mask[2, -1:] = 0
    return ids, queries, img, mask


def _jrun(flag, fn, monkeypatch):
    monkeypatch.setenv("SPRC_PALLAS_QF", flag)
    return np.asarray(jax.jit(fn)())


def _layer_case(shape, data):
    ids, queries, img, mask = data
    rng = np.random.RandomState(8)
    S = Q if shape == "queries" else Q + L
    hidden = rng.randn(B, S, W).astype(np.float32)
    m = None if shape == "queries" else mask
    image = None if shape == "prompt" else img
    return hidden, m, image


@pytest.fixture(scope="module")
def layer_params(data):
    ids, queries, img, mask = data
    layer = JQFormerLayer(JCFG, has_cross_attention=True)
    hidden = jnp.zeros((B, Q + L, W))
    params = jax.jit(lambda k: layer.init(k, hidden, jmask(jnp.asarray(mask)), jnp.asarray(img),
                                          None, Q))(jax.random.PRNGKey(0))["params"]
    return layer, jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("flag", ["0", "force"])
@pytest.mark.parametrize("shape", SHAPES)
def test_layer_matches_jax(shape, flag, data, layer_params, monkeypatch):
    layer, params = layer_params
    hidden, m, image = _layer_case(shape, data)
    bias = None if m is None else jmask(jnp.asarray(m))
    img = None if image is None else jnp.asarray(image)
    want = _jrun(flag, lambda: layer.apply({"params": params}, jnp.asarray(hidden), bias, img,
                                           None, Q), monkeypatch)

    port = QFormerLayer(CFG, has_cross_attention=True)
    port.load_state_dict(to_torch(qformer_layer_from_jax(params, "")), strict=True)
    with torch.inference_mode():
        got = port(torch.from_numpy(hidden),
                   None if m is None else make_additive_mask(torch.from_numpy(m)),
                   None if image is None else torch.from_numpy(image), Q).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)
