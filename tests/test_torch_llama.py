"""The port's LLaMA decoder (models/llama.py, interop/jax_params.py::
llama_from_jax) against sprc_tpu.models.llama.

A tiny LLaMA (hidden 48, 2 layers, 4 query heads, FFN 96, vocabulary 80),
its JAX init carried across with ``strict=True``, its dense kernels and
embeddings scaled by test_torch_opt.py's ``STIR`` so that the layers pick
the greedy tokens; with multi-head attention and with grouped-query heads
(2 K/V heads for 4 query heads). Held at fp32 within 1e-5: RoPE at
positions [S] and [B, S], the logits from ids and the hidden states from
``inputs_embeds`` over right-padded masks, ``prefill`` and every
``decode_step_logits`` of prompts of unequal lengths with each layer's K/V
buffers; and the KV-cached greedy decode equal to the recomputed one.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sprc_tpu_torch.interop.jax_params import llama_from_jax, to_torch  # noqa: E402
from test_torch_opt import jnp_tree, prompts, stir  # noqa: E402
from test_torch_threads import one_torch_thread  # noqa: E402,F401  (one thread a module)

ATOL = 1e-5
VOCAB = 80
HEADS = {"mha": None, "gqa": 2}  # num_kv_heads


def _pair(kv_heads):
    """(JAX LlamaForCausalLM, its stirred params, the port's model loaded
    from them with ``strict=True``)."""
    from sprc_tpu.models.llama import LlamaConfig as JCfg, LlamaForCausalLM as JLlama

    from sprc_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

    kw = dict(vocab_size=VOCAB, hidden_size=48, intermediate_size=96, num_layers=2, num_heads=4,
              num_kv_heads=kv_heads)
    jm = JLlama(JCfg(**kw))
    params = stir(jnp_tree(jm.init(jax.random.PRNGKey(2), jnp.zeros((1, 5), jnp.int32))["params"]))
    model = LlamaForCausalLM(LlamaConfig(**kw))
    model.load_state_dict(to_torch(llama_from_jax(params, prefix="")), strict=True)
    return jm, params, model.eval()


@pytest.fixture(scope="module", params=list(HEADS))
def pair(request):
    return _pair(HEADS[request.param])


def test_rotary_embed_equals_jax_at_shared_and_per_row_positions():
    from sprc_tpu.models.llama import rotary_embed as jrotary

    from sprc_tpu_torch.models.llama import rotary_embed

    rng = np.random.RandomState(0)
    x = rng.randn(3, 7, 4, 16).astype(np.float32)
    for pos in (np.arange(7, dtype=np.int32), rng.randint(0, 40, (3, 7)).astype(np.int32)):
        want = np.asarray(jrotary(jnp.asarray(x), jnp.asarray(pos), 10000.0))
        got = rotary_embed(torch.from_numpy(x), torch.from_numpy(pos).long(), 10000.0)
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_logits_and_hidden_states_over_padding_equal_jax(pair):
    """Logits from ids, and the hidden states from ``inputs_embeds`` with
    a right-padded mask (the instruct models' entry)."""
    jm, params, model = pair
    rng = np.random.RandomState(4)
    ids, mask = prompts(rng, 4, 9, VOCAB, [9, 5, 2, 7])
    want = jm.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask))
    embeds = rng.randn(4, 9, 48).astype(np.float32) * 0.5
    want_h = jm.apply({"params": params}, jnp.asarray(embeds), jnp.asarray(mask),
                      method=jm.hidden_states)
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long(), torch.from_numpy(mask).long())
        got_h = model.hidden_states(torch.from_numpy(embeds), torch.from_numpy(mask).long())
    assert got.dtype == torch.float32 and got.shape == (4, 9, VOCAB)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), atol=ATOL, rtol=0)


def test_prefill_and_decode_steps_equal_jax_cache_path(pair):
    """``prefill`` (positions arange(P) for every row, an ``s_max`` bias)
    and three ``decode_step_logits`` at each row's next slot after prompts
    of unequal lengths: the hidden rows, the logits and every layer's K/V
    buffers ([B, s_max, KV, D]) within 1e-5 of JAX's."""
    jm, params, model = pair
    rng = np.random.RandomState(5)
    ids, mask = prompts(rng, 3, 6, VOCAB, [6, 2, 4])
    s_max = 10
    embeds = np.array(jm.apply({"params": params}, jnp.asarray(ids), method=jm.embed))
    jh, jcache = jm.apply({"params": params}, jnp.asarray(embeds), jnp.asarray(mask), s_max,
                          method=jm.prefill)
    with torch.no_grad():
        h, cache = model.prefill(torch.from_numpy(embeds), torch.from_numpy(mask).long(), s_max)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=ATOL, rtol=0)
    pos = mask.sum(1).astype(np.int32)
    for _ in range(3):
        tok = rng.randint(3, VOCAB, 3).astype(np.int32)
        jl, jcache = jm.apply({"params": params}, jnp.asarray(tok), jnp.asarray(pos), jcache,
                              method=jm.decode_step_logits)
        with torch.no_grad():
            gl, cache = model.decode_step_logits(torch.from_numpy(tok).long(),
                                                 torch.from_numpy(pos).long(), cache)
        np.testing.assert_allclose(gl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
        pos = pos + 1
    kv = model.cfg.kv_heads
    for i, (k, v) in enumerate(cache):
        assert k.shape == (3, s_max, kv, 12)
        np.testing.assert_allclose(k.numpy(), np.asarray(jcache[f"layer_{i}"]["k"]), atol=ATOL)
        np.testing.assert_allclose(v.numpy(), np.asarray(jcache[f"layer_{i}"]["v"]), atol=ATOL)


def test_cached_greedy_decode_equals_the_recomputed_one(pair):
    """The KV-cached greedy decode (prefill, then ``cached_greedy_loop``)
    picks the tokens a full recompute of the growing sequence picks, each
    row from its own length, and its step logits agree within 1e-5."""
    from sprc_tpu_torch.models.generation import cached_greedy_loop

    _, _, model = pair
    ids, mask = prompts(np.random.RandomState(6), 3, 5, VOCAB, [5, 1, 3])
    ids, mask = torch.from_numpy(ids).long(), torch.from_numpy(mask).long()
    T, rows = 6, torch.arange(3)
    lengths = mask.sum(1)
    seen = []
    with torch.no_grad():
        hidden, cache = model.prefill(model.embed(ids), mask, ids.shape[1] + T)
        logits0 = model.logits(hidden[rows, lengths - 1])

        def step(tok, pos, c):
            out, c = model.decode_step_logits(tok, pos, c)
            seen.append(out)
            return out, c

        cached = cached_greedy_loop(logits0, cache, lengths, step, eos_token_id=VOCAB + 1,
                                    pad_token_id=0, max_new_tokens=T)
        seq = torch.zeros(3, ids.shape[1] + T, dtype=torch.long)
        seq[:, :ids.shape[1]] = ids
        full = mask.new_zeros(seq.shape)
        full[:, :ids.shape[1]] = mask
        for t in range(T):
            logits = model(seq, full)[rows, lengths + t - 1]
            if 0 < t:
                np.testing.assert_allclose(logits.numpy(), seen[t - 1].numpy(), atol=ATOL)
            seq[rows, lengths + t] = logits.argmax(-1)
            full[rows, lengths + t] = 1
    want = torch.stack([seq[b, lengths[b]:lengths[b] + T] for b in range(3)])
    assert torch.equal(cached, want)
    assert len(set(cached[0].tolist())) > 1, cached  # the layers pick, not an echo
