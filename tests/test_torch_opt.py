"""The port's OPT decoder and ``blip2_opt`` head (models/opt.py,
models/blip2_opt.py, interop/jax_params.py) against sprc_tpu's.

Tiny models: the JAX instruct CLI's synthetic configuration (28 px tower of
width 32, a 2-layer Q-Former with 4 queries, a 2-layer OPT of width 48 over
80 tokens), its JAX init carried across with ``strict=True``, the LLM's
dense kernels and embeddings scaled by ``STIR`` so that its layers, not the
tied head's echo of the last token, pick the tokens. The logits, the loss
and the cache path within 1e-5; the generated ids equal, up to a near tie
(JAX's top-2 gap at the first step that differs under the logits'
tolerance, printed where it happens).
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sprc_tpu_torch.interop.jax_params import opt_from_jax, state_dict_from_jax, to_torch  # noqa: E402
from test_torch_threads import one_torch_thread  # noqa: E402,F401  (one thread a module)

ATOL = 1e-5
STIR = 4.0


def jnp_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def stir(params, factor=STIR):
    """The LLM tower's dense kernels and embeddings times ``factor``."""
    def walk(node, key=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        return node * factor if key in ("kernel", "embedding") else node
    return walk(params)


def port_model(name, jm):
    """The port's model at the JAX model's tiny configuration, on the CPU,
    its weights not yet filled."""
    from sprc_tpu_torch import loader
    from sprc_tpu_torch.models.qformer import QFormerConfig
    from sprc_tpu_torch.models.vit import ViTConfig

    def fields(cfg, cls, drop=()):
        keep = {f.name for f in dataclasses.fields(cls)} - {"dtype", *drop}
        return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg) if f.name in keep}

    c = jm.cfg
    llm = ("opt_config", jm.opt_config) if name == "blip2_opt" else ("t5_config", jm.t5_config)
    return loader.build_model(
        name, "caption_coco_opt2.7b" if name == "blip2_opt" else "caption_coco_flant5xl",
        device="cpu", image_size=c.image_size, num_query_token=c.num_query_token,
        max_txt_len=c.max_txt_len, vocab_size=c.vocab_size, embed_dim=c.embed_dim,
        vit_dtype=torch.float32, vit_config_override=ViTConfig(
            **fields(c.vit_config_override, ViTConfig), dtype=torch.float32),
        qformer_config_override=QFormerConfig(**fields(c.qformer_config_override, QFormerConfig)),
        **{llm[0]: fields(llm[1], type(llm[1]))})


def heads(name):
    """(JAX model, its params with the LLM stirred, the port's model
    loaded from them with ``strict=True``): the JAX instruct CLI's tiny
    configuration."""
    from sprc_tpu.cli.instruct import build_synthetic, init_params_for

    jm, _, _, img, txt = build_synthetic(name)
    params = jnp_tree(init_params_for(jm, img, txt))
    llm = "opt" if name == "blip2_opt" else "t5"
    params[llm] = stir(params[llm])
    model = port_model(name, jm)
    model.load_state_dict(state_dict_from_jax(params, vit="eva_clip_g"), strict=True)
    return jm, params, model.eval()


def prompts(rng, B, L, vocab, lengths):
    """Right-padded prompts of the given lengths (ids from 3, pad 0)."""
    ids = np.zeros((B, L), np.int32)
    mask = np.zeros((B, L), np.int32)
    for b, n in enumerate(lengths):
        ids[b, :n] = rng.randint(3, vocab, n)
        mask[b, :n] = 1
    return ids, mask


def assert_ids_equal_up_to_tie(got, want, gap_at, tol=ATOL):
    """Every row equal; where one differs, JAX's top-2 gap at the first step
    that differs (``gap_at(row, step)``) must be under ``tol``."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    for b in range(len(want)):
        diff = np.nonzero(got[b] != want[b])[0]
        if len(diff):
            gap = gap_at(b, int(diff[0]))
            print(f"row {b} differs from step {diff[0]}: JAX top-2 gap {gap:.3e}")
            assert gap < tol, (b, diff[0], gap, got[b], want[b])


def top2_gap(logits):
    top = np.sort(np.asarray(logits, np.float64))[-2:]
    return float(top[1] - top[0])


@pytest.fixture(scope="module")
def opt_head():
    return heads("blip2_opt")


@pytest.fixture(scope="module")
def batch():
    rng = np.random.RandomState(3)
    images = rng.rand(3, 28, 28, 3).astype(np.float32)
    ids, mask = prompts(rng, 3, 6, 80, [6, 3, 1])
    return images, ids, mask


def _opt_pair():
    from sprc_tpu.models.opt import OPTConfig as JCfg, OPTForCausalLM as JOpt

    from sprc_tpu_torch.models.opt import OPTConfig, OPTForCausalLM

    kw = dict(vocab_size=90, hidden_size=32, ffn_dim=64, num_layers=3, num_heads=4,
              max_positions=64)
    jm = JOpt(JCfg(**kw))
    params = stir(jnp_tree(jm.init(jax.random.PRNGKey(1), jnp.zeros((1, 5), jnp.int32))["params"]))
    model = OPTForCausalLM(OPTConfig(**kw))
    model.load_state_dict(to_torch(opt_from_jax(params, prefix="")), strict=True)
    return jm, params, model


def test_opt_logits_over_right_padded_masks_equal_jax():
    jm, params, model = _opt_pair()
    ids, mask = prompts(np.random.RandomState(4), 4, 9, 90, [9, 5, 2, 7])
    want = jm.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask))
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long(), torch.from_numpy(mask).long())
    assert got.dtype == torch.float32 and got.shape == (4, 9, 90)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_prefill_and_decode_steps_equal_jax_cache_path():
    """``prefill`` (per-row positions, an ``s_max`` bias) and three
    ``decode_step_logits`` at each row's next slot: the hidden rows, the
    logits and every layer's K/V buffers within 1e-5 of JAX's."""
    jm, params, model = _opt_pair()
    rng = np.random.RandomState(5)
    ids, mask = prompts(rng, 3, 6, 90, [6, 2, 4])
    s_max = 10
    embeds = np.array(jm.apply({"params": params}, jnp.asarray(ids), method=jm.embed))
    jh, jcache = jm.apply({"params": params}, jnp.asarray(embeds), jnp.asarray(mask), s_max,
                          method=jm.prefill)
    with torch.no_grad():
        h, cache = model.prefill(torch.from_numpy(embeds), torch.from_numpy(mask).long(), s_max)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=ATOL, rtol=0)
    pos = mask.sum(1).astype(np.int32)
    for step in range(3):
        tok = rng.randint(3, 90, 3).astype(np.int32)
        jl, jcache = jm.apply({"params": params}, jnp.asarray(tok), jnp.asarray(pos), jcache,
                              method=jm.decode_step_logits)
        with torch.no_grad():
            gl, cache = model.decode_step_logits(torch.from_numpy(tok).long(),
                                                 torch.from_numpy(pos).long(), cache)
        np.testing.assert_allclose(gl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
        pos = pos + 1
    for i, (k, v) in enumerate(cache):
        np.testing.assert_allclose(k.numpy(), np.asarray(jcache[f"layer_{i}"]["k"]), atol=ATOL)
        np.testing.assert_allclose(v.numpy(), np.asarray(jcache[f"layer_{i}"]["v"]), atol=ATOL)


@pytest.mark.parametrize("prompt_length", [0, 2])
def test_blip2_opt_loss_equals_jax(opt_head, batch, prompt_length):
    jm, params, model = opt_head
    images, ids, mask = batch
    want = jm.apply({"params": params}, jnp.asarray(images), jnp.asarray(ids),
                    jnp.asarray(mask), pad_token_id=0, prompt_length=prompt_length)["loss"]
    with torch.no_grad():
        got = model(torch.from_numpy(images), torch.from_numpy(ids), torch.from_numpy(mask),
                    pad_token_id=0, prompt_length=prompt_length)
    assert got["logits"].shape == (3, 4 + 6, 80)
    np.testing.assert_allclose(got["loss"].item(), float(want), atol=ATOL, rtol=0)


def _jax_opt_gap(jm, params, images, ids, mask, want):
    """JAX's top-2 gap at (row, step) over the prompt and ``want``'s first
    tokens (the recompute path's logits)."""
    def logits(mdl, images, ids, mask):
        inputs = mdl._inputs_opt(images, True)
        tok = mdl.opt.embed(ids)
        full = jnp.concatenate([jnp.ones((ids.shape[0], inputs.shape[1]), mask.dtype), mask], 1)
        return mdl.opt.logits(mdl.opt.hidden_states(
            jnp.concatenate([inputs.astype(tok.dtype), tok], 1), full))

    def gap_at(b, t):
        n = int(mask[b].sum())
        row = np.zeros((1, n + t + 1), np.int32)
        row[0, :n] = ids[b, :n]
        row[0, n:n + t] = want[b, :t]
        out = jm.apply({"params": params}, jnp.asarray(images[b:b + 1]), jnp.asarray(row),
                       jnp.asarray(np.ones_like(row)), method=logits)
        return top2_gap(np.asarray(out)[0, 4 + n + t - 1])
    return gap_at


@pytest.mark.parametrize("use_cache", [True, False])
def test_generate_ids_equal_jax(opt_head, batch, use_cache):
    """Greedy ids, cached and recompute, equal JAX's; eos is the token row 1
    picks first, so row 1 finishes at once and pads while the others run."""
    jm, params, model = opt_head
    images, ids, mask = batch
    args = (torch.from_numpy(images), torch.from_numpy(ids), torch.from_numpy(mask))
    with torch.no_grad():
        first = model.generate_ids(*args, eos_token_id=0, pad_token_id=1, max_new_tokens=1)
    eos = int(first[1, 0])
    kw = dict(eos_token_id=eos, pad_token_id=1, max_new_tokens=7, use_cache=use_cache)
    want = np.asarray(jm.generate_ids(params, jnp.asarray(images), jnp.asarray(ids),
                                      jnp.asarray(mask), **kw))
    stats = {}
    with torch.no_grad():
        got = model.generate_ids(*args, stats=stats, **kw).numpy()
    assert got[1, 0] == eos and (got[1, 1:] == 1).all()
    assert len(set(got[0].tolist())) > 1, got  # the layers pick, not an echo
    assert_ids_equal_up_to_tie(got, want, _jax_opt_gap(jm, params, images, ids, mask, want))
    keys = {"image_encode_s", "qformer_s"} | ({"prefill_s", "decode_s", "decode_steps"}
                                              if use_cache else set())
    assert set(stats) == keys


def test_bridge_loads_strictly_without_the_qformer_text_side(opt_head):
    """The JAX init of the head holds no Q-Former word / position embeddings
    and no text FFN (Flax makes only what the queries pass reaches), no
    retrieval heads, but ``temp``: the port's state dict has exactly the
    bridged keys."""
    _, params, model = opt_head
    keys = set(model.state_dict())
    assert keys == set(state_dict_from_jax(params, vit="eva_clip_g"))
    assert "temp" in keys and "opt_proj.weight" in keys
    assert "opt_model.model.decoder.embed_positions.weight" in keys
    assert not [k for k in keys if "word_embeddings" in k or "position_ids" in k
                or ".intermediate." in k or ".output.dense" in k and "attention" not in k
                and "_query" not in k]
    assert not {"vision_proj.weight", "text_proj.weight", "itm_head.weight"} & keys
    with pytest.raises(ValueError, match="no text side"):
        model.qformer(input_ids=torch.zeros(1, 3, dtype=torch.long))
