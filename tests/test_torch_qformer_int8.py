"""Kernel K4 (fused_qformer_layer with int8=True, sprc_tpu_torch/ops/
fused_qformer.py) and the int8 Q-Former (QFormerConfig.int8) against
sprc_tpu, on test_torch_qformer.py's tiny config and inputs (hidden 128, 2
heads, intermediate 256, Q=4, text 8, 5 image rows; fp32; CPU).

The JAX side runs its int8 Pallas layer in interpret mode: SPRC_QF_INT8=1
with SPRC_PALLAS_QF=force, set before the first trace. One layer and the
2-layer trunk, each in the three serving shapes.

Tolerance. Both sides quantise fp32 rows that differ by about 1e-6 (another
summation order; erf against the JAX kernel's rational erf, 1.5e-7), so a
code flips wherever a value sits that close to a half step; one flip moves
its row of outputs by about row scale x |w| ~ 1e-3 here. On these seeds no
code flips: the readings are max-abs 4.8e-7 for every layer and 4.8e-7 /
7.2e-7 / 9.5e-7 for the trunks (mean-abs under 7e-8). A bound of 3x that
would fail on the first flipped code on another CPU, so the bound leaves
room for a few flips instead: max-abs 2e-3 and mean-abs 5e-5 on unit-scale
outputs, against the int8-against-fp envelope of the JAX tests of median
0.02 and q99 0.15 relative.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sprc_tpu.models.qformer import QFormer as JQFormer  # noqa: E402
from sprc_tpu.models.qformer import make_additive_mask as jmask  # noqa: E402

from sprc_tpu_torch.interop.jax_params import (  # noqa: E402
    qformer_from_jax, qformer_layer_from_jax, to_torch)
from sprc_tpu_torch.models.qformer import (  # noqa: E402
    QFormer, QFormerLayer, make_additive_mask)

from test_torch_qformer import (  # noqa: E402,F401  (fixtures)
    CFG, JCFG, Q, SHAPES, _jrun, _layer_case, data, layer_params)
from test_torch_qformer_trunk import _trunk_kwargs  # noqa: E402
from test_torch_threads import one_torch_thread  # noqa: E402,F401  (one thread a module)

CFG8 = dataclasses.replace(CFG, int8=True)
BOUND = (2e-3, 5e-5)  # (max-abs, mean-abs)


def _close(got, want, bound=BOUND):
    d = np.abs(got - want)
    assert d.max() <= bound[0] and d.mean() <= bound[1], (d.max(), d.mean())


def _int8_jax(fn, monkeypatch):
    monkeypatch.setenv("SPRC_QF_INT8", "1")
    return _jrun("force", fn, monkeypatch)


@pytest.mark.parametrize("shape", SHAPES)
def test_int8_layer_matches_jax_pallas(shape, data, layer_params, monkeypatch):
    layer, params = layer_params
    hidden, m, image = _layer_case(shape, data)
    bias = None if m is None else jmask(jnp.asarray(m))
    img = None if image is None else jnp.asarray(image)
    want = _int8_jax(lambda: layer.apply({"params": params}, jnp.asarray(hidden), bias, img,
                                         None, Q), monkeypatch)
    port = QFormerLayer(CFG8, has_cross_attention=True)
    port.load_state_dict(to_torch(qformer_layer_from_jax(params, "")), strict=True)
    with torch.inference_mode():
        got = port(torch.from_numpy(hidden),
                   None if m is None else make_additive_mask(torch.from_numpy(m)),
                   None if image is None else torch.from_numpy(image), Q).numpy()
    _close(got, want)


@pytest.fixture(scope="module")
def trunk(data):
    ids, queries, img, mask = data
    model = JQFormer(JCFG)
    params = jax.jit(lambda k: model.init(
        k, input_ids=jnp.asarray(ids), query_embeds=jnp.asarray(queries),
        attention_mask=jnp.asarray(mask), image_embeds=jnp.asarray(img)))(
            jax.random.PRNGKey(1))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    state = to_torch(qformer_from_jax(params, prefix=""))
    ports = {}
    for cfg in (CFG, CFG8):
        ports[cfg.int8] = QFormer(cfg).eval()
        ports[cfg.int8].load_state_dict(state, strict=True)
    return model, params, ports


@pytest.mark.parametrize("shape", SHAPES)
def test_int8_trunk_matches_jax_pallas(shape, data, trunk, monkeypatch):
    model, params, ports = trunk
    kw = _trunk_kwargs(shape, data)
    want = _int8_jax(lambda: model.apply(
        {"params": params}, **{k: jnp.asarray(v) for k, v in kw.items()}), monkeypatch)
    with torch.inference_mode():
        got = ports[True](**{k: torch.from_numpy(v) for k, v in kw.items()}).numpy()
    _close(got, want)


def test_int8_is_a_switch_over_one_parameter_tree(data, trunk):
    """The same state dict loads into both; ``int8=False`` is the fp32 path
    as it was; ``int8=True`` moves the output, by about what the JAX tests
    allow int8 against fp (median relative error under 0.02)."""
    _, _, ports = trunk
    assert list(ports[True].state_dict()) == list(ports[False].state_dict())
    kw = {k: torch.from_numpy(v) for k, v in _trunk_kwargs("fusion", data).items()}
    plain = QFormer(CFG).eval()
    plain.load_state_dict(ports[False].state_dict(), strict=True)
    with torch.inference_mode():
        fp, fp_again, i8 = ports[False](**kw), plain(**kw), ports[True](**kw)
    np.testing.assert_array_equal(fp.numpy(), fp_again.numpy())
    rel = ((i8 - fp).abs() / (fp.abs() + 1e-3)).numpy()
    assert 0 < np.median(rel) < 0.02, np.median(rel)
