"""The Q-Former trunk (sprc_tpu_torch/models/qformer.py, every layer through
kernel K3's wrapper) against sprc_tpu, on test_torch_qformer.py's tiny
config and inputs: 2 layers (cross-attention on layer 0), in the three
serving shapes, with the JAX side unfused (SPRC_PALLAS_QF=0) and through
the Pallas layer in interpret mode (SPRC_PALLAS_QF=force). Tolerance: 1e-4
over the trunk, fp32.

A fully masked row (every column of an item masked): the port's plain path
follows the unfused JAX softmax, which spreads it evenly over the -10000
columns, not the JAX kernel's guarded ~zero output
(pallas_qformer.py:132-139). The serving path never builds one: queries are
never masked and padded query batches use an all-ones mask (engine.py:384).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sprc_tpu.models.qformer import QFormer as JQFormer  # noqa: E402

from sprc_tpu_torch.interop.jax_params import qformer_from_jax, to_torch  # noqa: E402
from sprc_tpu_torch.models.qformer import QFormer  # noqa: E402

from test_torch_qformer import CFG, JCFG, SHAPES, _jrun, data  # noqa: E402,F401  (fixture)
from test_torch_threads import one_torch_thread  # noqa: E402,F401  (one thread a module)


@pytest.fixture(scope="module")
def trunk(data):
    ids, queries, img, mask = data
    model = JQFormer(JCFG)
    params = jax.jit(lambda k: model.init(
        k, input_ids=jnp.asarray(ids), query_embeds=jnp.asarray(queries),
        attention_mask=jnp.asarray(mask), image_embeds=jnp.asarray(img)))(
            jax.random.PRNGKey(1))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    port = QFormer(CFG)
    port.load_state_dict(to_torch(qformer_from_jax(params, prefix="")), strict=True)
    return model, params, port.eval()


def _trunk_kwargs(shape, data):
    ids, queries, img, mask = data
    if shape == "queries":
        return dict(query_embeds=queries, image_embeds=img)
    kw = dict(input_ids=ids, query_embeds=queries, attention_mask=mask)
    if shape == "fusion":
        kw["image_embeds"] = img
    return kw


@pytest.mark.parametrize("flag", ["0", "force"])
@pytest.mark.parametrize("shape", SHAPES)
def test_trunk_matches_jax(shape, flag, data, trunk, monkeypatch):
    model, params, port = trunk
    kw = _trunk_kwargs(shape, data)
    want = _jrun(flag, lambda: model.apply(
        {"params": params}, **{k: jnp.asarray(v) for k, v in kw.items()}), monkeypatch)
    with torch.inference_mode():
        got = port(**{k: torch.from_numpy(v) for k, v in kw.items()}).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_fully_masked_row_follows_unfused_softmax(data, trunk, monkeypatch):
    model, params, port = trunk
    ids, queries, img, mask = data
    mask = mask.copy()
    mask[1] = 0  # item 1: every column masked
    kw = dict(input_ids=ids, query_embeds=queries, attention_mask=mask, image_embeds=img)
    want = _jrun("0", lambda: model.apply(
        {"params": params}, **{k: jnp.asarray(v) for k, v in kw.items()}), monkeypatch)
    with torch.inference_mode():
        got = port(**{k: torch.from_numpy(v) for k, v in kw.items()}).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
