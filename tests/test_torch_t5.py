"""The port's T5 encoder-decoder and ``blip2_t5`` head (models/t5.py,
models/blip2_t5.py) against sprc_tpu's.

``relative_bucket`` integer-equal to JAX's ``_relative_bucket`` over
relative positions -300..300, both directions; the encoder-decoder's logits
(FlanT5's gated GELU with its untied head, and v1.0's ReLU with the tied
head scaled by ``d_model ** -0.5``) over padded masks, the cached decode's
prefill and steps, and the head's loss within 1e-5; the greedy ids equal up
to a near tie. Tiny models as test_torch_opt.py builds them (the JAX
instruct CLI's T5 of width 32, 4 heads of 8, 2 + 2 layers, 80 tokens).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sprc_tpu_torch.interop.jax_params import t5_from_jax, to_torch  # noqa: E402
from test_torch_opt import (ATOL, assert_ids_equal_up_to_tie, heads, jnp_tree,  # noqa: E402
                            prompts, stir, top2_gap)
from test_torch_threads import one_torch_thread  # noqa: E402,F401  (one thread a module)


@pytest.mark.parametrize("bidirectional", [True, False])
def test_relative_bucket_is_integer_equal_to_jax(bidirectional):
    from sprc_tpu.models.t5 import _relative_bucket

    from sprc_tpu_torch.models.t5 import relative_bucket

    rel = np.arange(-300, 301, dtype=np.int32)[None, :] + np.zeros((2, 1), np.int32)
    for buckets, distance in ((32, 128), (16, 40)):
        want = np.asarray(_relative_bucket(jnp.asarray(rel), bidirectional=bidirectional,
                                           num_buckets=buckets, max_distance=distance))
        got = relative_bucket(torch.from_numpy(rel), bidirectional=bidirectional,
                              num_buckets=buckets, max_distance=distance)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        assert want.max() == buckets - 1


def _t5_pair(v1=False):
    from sprc_tpu.models.t5 import T5Config as JCfg, T5ForConditionalGeneration as JT5

    from sprc_tpu_torch.models.t5 import T5Config, T5ForConditionalGeneration

    kw = dict(vocab_size=70, d_model=32, d_kv=8, d_ff=48, num_heads=4, num_layers=2,
              num_decoder_layers=3, relative_buckets=8, relative_max_distance=20,
              gated_act=not v1, tie_word_embeddings=v1)
    jm = JT5(JCfg(**kw))
    ids = jnp.zeros((1, 5), jnp.int32)
    params = jnp_tree(jm.init(jax.random.PRNGKey(2), ids, ids)["params"])
    params = dict(params, **stir({k: v for k, v in params.items() if k != "shared"}, 2.0))
    model = T5ForConditionalGeneration(T5Config(**kw))
    model.load_state_dict(to_torch(t5_from_jax(params, prefix="")), strict=True)
    return jm, params, model


@pytest.mark.parametrize("v1", [False, True], ids=["flan_gated_untied", "v1_relu_tied"])
def test_encoder_decoder_logits_equal_jax(v1):
    jm, params, model = _t5_pair(v1)
    rng = np.random.RandomState(6)
    ids, mask = prompts(rng, 3, 7, 70, [7, 4, 2])
    dec, dmask = prompts(rng, 3, 5, 70, [5, 3, 1])
    want = jm.apply({"params": params}, *map(jnp.asarray, (ids, dec, mask, dmask)))
    with torch.no_grad():
        got = model(*(torch.from_numpy(a).long() for a in (ids, dec, mask, dmask)))
    assert got.shape == (3, 5, 70)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    with torch.no_grad():
        enc = model.encode_ids(torch.from_numpy(ids).long(), torch.from_numpy(mask).long())
    jenc = jm.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask), method=jm.encode_ids)
    np.testing.assert_allclose(enc.numpy(), np.asarray(jenc), atol=ATOL, rtol=0)


def test_decode_prefill_and_steps_equal_jax():
    """``decode_prefill`` (the encoder memory's K/V projected once) and four
    ``decode_step_logits``: logits and every block's buffers within 1e-5."""
    jm, params, model = _t5_pair()
    rng = np.random.RandomState(7)
    ids, mask = prompts(rng, 2, 6, 70, [6, 3])
    jenc = jm.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask), method=jm.encode_ids)
    enc = torch.from_numpy(np.array(jenc))
    start = np.zeros((2, 1), np.int32)
    s_max = 6
    jl, jcache = jm.apply({"params": params}, jnp.asarray(start), jenc, jnp.asarray(mask), s_max,
                          method=jm.decode_prefill)
    tmask = torch.from_numpy(mask).long()
    with torch.no_grad():
        gl, cache = model.decode_prefill(torch.from_numpy(start).long(), enc, tmask, s_max)
    np.testing.assert_allclose(gl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    for t in range(1, 5):
        tok = rng.randint(2, 70, 2).astype(np.int32)
        jl, jcache = jm.apply({"params": params}, jnp.asarray(tok), t, jcache, jnp.asarray(mask),
                              method=jm.decode_step_logits)
        with torch.no_grad():
            gl, cache = model.decode_step_logits(torch.from_numpy(tok).long(), torch.tensor([t]),
                                                 cache, tmask)
        np.testing.assert_allclose(gl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    for i, entry in enumerate(cache):
        for key in ("k", "v", "ck", "cv"):
            np.testing.assert_allclose(entry[key].numpy(),
                                       np.asarray(jcache[f"block_{i}"][key]), atol=ATOL)


@pytest.fixture(scope="module")
def t5_head():
    return heads("blip2_t5")


@pytest.fixture(scope="module")
def batch():
    rng = np.random.RandomState(8)
    images = rng.rand(3, 28, 28, 3).astype(np.float32)
    ids, mask = prompts(rng, 3, 6, 80, [6, 3, 1])
    out, omask = prompts(rng, 3, 5, 80, [5, 2, 4])
    return images, ids, mask, out, omask


def test_blip2_t5_loss_equals_jax(t5_head, batch):
    jm, params, model = t5_head
    want = jm.apply({"params": params}, *map(jnp.asarray, batch))["loss"]
    with torch.no_grad():
        got = model(*map(torch.from_numpy, batch))
    assert got["logits"].shape == (3, 5, 80)
    np.testing.assert_allclose(got["loss"].item(), float(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("use_cache", [True, False])
def test_generate_ids_equal_jax(t5_head, batch, use_cache):
    """Greedy ids from decoder start 0, cached and recompute, equal JAX's;
    eos is row 1's first token, so row 1 pads while the others run."""
    jm, params, model = t5_head
    images, ids, mask = batch[:3]
    args = (torch.from_numpy(images), torch.from_numpy(ids), torch.from_numpy(mask))
    with torch.no_grad():
        eos = int(model.generate_ids(*args, eos_token_id=1, max_new_tokens=1)[1, 0])
    kw = dict(eos_token_id=eos, pad_token_id=0, max_new_tokens=7, use_cache=use_cache)
    want = np.asarray(jm.generate_ids(params, *map(jnp.asarray, (images, ids, mask)), **kw))
    stats = {}
    with torch.no_grad():
        got = model.generate_ids(*args, stats=stats, **kw).numpy()
    assert got[1, 0] == eos and (got[1, 1:] == 0).all()
    assert len(set(got[0].tolist())) > 1, got

    def gap_at(b, t):
        enc, emask = jm.apply({"params": params}, *map(jnp.asarray, (images, ids, mask)), True,
                              method=jm._encode)
        dec = np.zeros((1, t + 1), np.int32)
        dec[0, 1:] = want[b, :t]
        logits = jm.apply({"params": params}, jnp.asarray(dec), enc[b:b + 1], emask[b:b + 1],
                          method=lambda mdl, d, e, m: mdl.t5.decode(d, e, m))
        return top2_gap(np.asarray(logits)[0, t])

    assert_ids_equal_up_to_tie(got, want, gap_at)
    assert {"image_encode_s", "qformer_s", "prefill_s"} <= set(stats)
