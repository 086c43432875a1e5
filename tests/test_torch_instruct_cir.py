"""The InstructBLIP-style CIR models (models/instruct_cir.py over
models/llama.py; loader rows, presets, cli/instruct.py) against
sprc_tpu's.

The JAX test's tiny configuration (tests/test_instruct_cir.py: a 28 px
EVA-style tower of depth 2, a 2-layer Q-Former with 4 queries over 60
words, a 2-layer LLaMA of width 48 over 80 words) with the tower and the
Q-Former widened to 128, as cli/instruct.py builds them. Each model is
built by both loaders from the ``vicuna7b`` row with the same overrides;
its JAX init is carried across with ``strict=True``, the LLaMA stirred as
test_torch_opt.py does. Flax makes only what the init's method runs: the
retrieval model's tree has no ``lm_head``, which a real checkpoint holds,
so one is grafted from a fresh LLaMA init, as the JAX test does; the LM
model's has no ``l2q_proj``, which the port's does not build either.
Texts and LLaMA prompts are right-padded at unequal lengths; the
Q-Former's dropout is 0.

Held: ``loss_itc``, ``extract_target_features`` and ``inference`` within
1e-5; the LM loss and its label mask (zero targets: a loss of 0); one
step's gradients (``llm_proj``, ``l2q_proj``, the Q-Former's last layer)
within 1e-4 of ``jax.grad``; one AdamW step on those gradients: the frozen
tower and LLaMA bit for bit, the trained set the JAX partition's name for
name, its values within 1e-6 relative of optax's; the generated ids on both
paths equal to JAX's; the synthetic CLI for both names; the loader rows
equal to JAX's; the LLaMA tokenizer equal to JAX's.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("yaml")
import jax.numpy as jnp  # noqa: E402

from sprc_tpu_torch.interop.jax_params import state_dict_from_jax  # noqa: E402
from test_torch_opt import jnp_tree, prompts, stir  # noqa: E402
from test_torch_threads import one_torch_thread  # noqa: E402,F401  (one thread a module)

ATOL, GRAD_ATOL = 1e-5, 1e-4
IMG, Q, VOCAB, TXT, B, LLM_VOCAB, LLM_LEN = 28, 4, 60, 6, 3, 80, 8
W = 128
SECTION = dict(
    image_size=IMG, num_query_token=Q, max_txt_len=TXT, vocab_size=VOCAB, embed_dim=16,
    vit_dtype="fp32",
    vit_config_override=dict(image_size=IMG, patch_size=14, width=W, depth=2, num_heads=2,
                             mlp_hidden=2 * W, qkv_fused_no_kbias=True, dtype="fp32"),
    qformer_config_override=dict(vocab_size=VOCAB, hidden_size=W, num_layers=2, num_heads=2,
                                 intermediate_size=2 * W, encoder_width=W, query_length=Q,
                                 dropout_rate=0.0),
    llama_config=dict(vocab_size=LLM_VOCAB, hidden_size=48, intermediate_size=96, num_layers=2,
                      num_heads=4))
NAMES = ("blip2_vicuna_instruct", "blip2_instruct_cir")


@pytest.fixture(scope="module")
def batch():
    rng = np.random.RandomState(7)
    ids, mask = prompts(rng, B, TXT, VOCAB, [6, 3, 4])
    llm_ids, llm_mask = prompts(rng, B, LLM_LEN, LLM_VOCAB, [8, 3, 5])
    target = np.zeros_like(llm_mask)
    for b, n in enumerate([8, 3, 5]):
        target[b, n - 2:n] = 1  # the last two tokens of each row: the output span
    return {"reference": rng.rand(B, IMG, IMG, 3).astype(np.float32),
            "target": rng.rand(B, IMG, IMG, 3).astype(np.float32),
            "input_ids": ids, "text_mask": mask, "llm_input_ids": llm_ids, "llm_mask": llm_mask,
            "target_mask": target}


def _jax_model(name, b):
    """The JAX model of the row, its init (the LLaMA stirred, ``lm_head``
    grafted where the init makes none)."""
    from sprc_tpu.loader import build_model
    from sprc_tpu.models.llama import LlamaForCausalLM

    jm = build_model(name, "vicuna7b", **SECTION)
    j = {k: jnp.asarray(v) for k, v in b.items()}
    args = ((j["reference"], j["target"]) if name == NAMES[0] else (j["reference"],)) + (
        j["input_ids"], j["text_mask"], j["llm_input_ids"], j["llm_mask"]) + (
        () if name == NAMES[0] else (j["target_mask"],))
    params = jnp_tree(jax.jit(jm.init)(jax.random.PRNGKey(0), *args)["params"])
    if "lm_head" not in params["llm"]:
        head = LlamaForCausalLM(jm.llama_config).init(jax.random.PRNGKey(3),
                                                      jnp.zeros((1, 4), jnp.int32))["params"]
        params["llm"] = {**params["llm"], "lm_head": jnp_tree(head["lm_head"])}
    params["llm"] = stir(params["llm"])
    return jm, params


@pytest.fixture(scope="module")
def heads(batch):
    from sprc_tpu_torch import loader

    out = {}
    for name in NAMES:
        jm, params = _jax_model(name, batch)
        model = loader.build_model(name, "vicuna7b", device="cpu", **SECTION)
        model.load_state_dict(state_dict_from_jax(params, vit="eva_clip_g"), strict=True)
        out[name] = (jm, params, model.eval())
    return out


def _t(b, *keys):
    return [torch.from_numpy(b[k]) for k in keys]


def _j(b, *keys):
    return [jnp.asarray(b[k]) for k in keys]


TEXT = ("input_ids", "text_mask", "llm_input_ids", "llm_mask")


def _port_batch(name, b):
    keys = (("reference", "target") if name == NAMES[0] else ()) + TEXT + (
        () if name == NAMES[0] else ("target_mask",))
    out = {k: torch.from_numpy(b[k]) for k in keys}
    if name == NAMES[1]:
        out["images"] = torch.from_numpy(b["reference"])
    return out


def test_vicuna_loss_features_and_scores_equal_jax(heads, batch):
    jm, params, model = heads[NAMES[0]]
    def run(p, ref, tgt, *text):
        v = {"params": p}
        feats, frozen = jm.apply(v, tgt, method=jm.extract_target_features)
        sims = jm.apply(v, jm.apply(v, ref, method=jm.encode_image), feats, *text,
                        method=jm.inference)
        return jm.apply(v, ref, tgt, *text), feats, frozen, sims

    want, jfeats, jfrozen, jsims = jax.jit(run)(params, *_j(batch, "reference", "target", *TEXT))
    with torch.no_grad():
        got = model(*_t(batch, "reference", "target", *TEXT))
        feats, frozen = model.extract_target_features(torch.from_numpy(batch["target"]))
        sims = model.inference(model.encode_image(torch.from_numpy(batch["reference"])), feats,
                               *_t(batch, *TEXT))
    assert set(got) == {"loss_itc"} and feats.shape == (B, W)  # the Q-Former's width
    np.testing.assert_allclose(got["loss_itc"].item(), float(want["loss_itc"]), atol=ATOL)
    np.testing.assert_allclose(feats.numpy(), np.asarray(jfeats), atol=ATOL, rtol=0)
    np.testing.assert_allclose(frozen.numpy(), np.asarray(jfrozen), atol=ATOL, rtol=0)
    np.testing.assert_allclose(sims.numpy(), np.asarray(jsims), atol=ATOL, rtol=0)


def test_instruct_cir_lm_loss_and_its_label_mask_equal_jax(heads, batch):
    jm, params, model = heads[NAMES[1]]
    args = _t(batch, "reference", *TEXT)
    loss = jax.jit(lambda p, *a: jm.apply({"params": p}, *a)["loss"])
    for target in (batch["target_mask"], np.zeros_like(batch["target_mask"])):
        want = loss(params, *_j(batch, "reference", *TEXT), jnp.asarray(target))
        with torch.no_grad():
            got = model(*args, torch.from_numpy(target))
        np.testing.assert_allclose(got["loss"].item(), float(want), atol=ATOL)
    assert got["loss"].item() == 0.0 == float(want)  # no target: the guarded mean


@pytest.mark.parametrize("name", NAMES)
def test_step_gradients_and_one_adamw_step_equal_jax(name, heads, batch):
    """One step's loss and every trainable gradient against ``jax.grad``
    over the JAX partition (the tower and the LLaMA held out), through the
    frozen LLaMA into ``llm_proj``, ``l2q_proj`` and the Q-Former; then one
    AdamW step on JAX's gradients against the JAX optimizer
    (``frozen_prefixes`` the model's): the trained set is the JAX
    partition's name for name, every tensor within 1e-6 relative of JAX's,
    and every tower and LLaMA tensor bit for bit unchanged."""
    import optax
    from sprc_tpu.train.loop import TrainConfig as JConfig, make_optimizer

    from sprc_tpu_torch.models.instruct_cir import InstructAdapter
    from sprc_tpu_torch.train.generic import GenericTrainer
    from sprc_tpu_torch.train.loop import TrainConfig

    jm, params, model = heads[name]
    trainer = GenericTrainer(model, TrainConfig(), adapter=InstructAdapter())
    total, losses, grads = trainer.loss_and_grads(_port_batch(name, batch))
    model.eval()
    key = "loss_itc" if name == NAMES[0] else "loss"
    assert set(losses) == {key}
    frozen = set(type(jm).FROZEN_PREFIXES)
    train = {k: v for k, v in params.items() if k not in frozen}
    rest = {k: v for k, v in params.items() if k in frozen}
    j = _j(batch, "reference", "target", *TEXT) if name == NAMES[0] else \
        _j(batch, "reference", *TEXT, "target_mask")
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda t, *a: jm.apply({"params": {**t, **rest}}, *a)[key]))(train, *j)
    np.testing.assert_allclose(total.item(), float(jloss), atol=ATOL)
    full = {**jgrads, **jax.tree_util.tree_map(jnp.zeros_like, rest)}
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, full), vit="eva_clip_g")
    for n, g in zip(trainer.names, grads):
        np.testing.assert_allclose(g.numpy(), want[n].numpy(), atol=GRAD_ATOL, rtol=0, err_msg=n)
    own = dict(model.named_parameters())
    assert set(trainer.names) == {n for n in want if n in own and not n.startswith(
        ("visual_encoder.", "llm_model."))}
    projs = ("llm_proj.", "l2q_proj.") if name == NAMES[0] else ("llm_proj.",)
    for proj in projs:
        assert max(g.abs().max().item() for n, g in zip(trainer.names, grads)
                   if n.startswith(proj)) > 1e-4, proj
    assert any(n.startswith("Qformer.bert.encoder.layer.1.") for n in trainer.names)

    lr, steps = 1e-3, 10
    tx = make_optimizer(JConfig(learning_rate=lr, total_steps=steps,
                                frozen_prefixes=jm.FROZEN_PREFIXES), params)
    updates, _ = jax.jit(tx.update)(full, tx.init(params), params)
    after = state_dict_from_jax(jax.tree_util.tree_map(
        np.asarray, optax.apply_updates(params, updates)), vit="eva_clip_g")
    before = {n: p.detach().clone() for n, p in own.items()}
    step = GenericTrainer(model, TrainConfig(learning_rate=lr, total_steps=steps),
                          adapter=InstructAdapter())
    try:
        step.apply_gradients([want[n] for n in step.names])
        for n, p in own.items():
            torch.testing.assert_close(p.detach(), after[n], rtol=1e-6, atol=1e-7, msg=n)
            if n.startswith(("visual_encoder.", "llm_model.")):
                assert torch.equal(p, before[n]), n
    finally:
        with torch.no_grad():
            for n, p in own.items():
                p.copy_(before[n])


def test_instruct_generate_ids_equal_jax_on_both_paths(heads, batch):
    """Greedy ids, KV-cached and recomputed, equal JAX's and each other;
    eos is the token row 1 picks first, so row 1 finishes at once and pads
    while the others decode into their pad slots."""
    from sprc_tpu.models.instruct_cir import instruct_generate as jgenerate

    from sprc_tpu_torch.models.instruct_cir import instruct_generate

    jm, params, model = heads[NAMES[1]]
    args = _t(batch, "reference", *TEXT)
    with torch.no_grad():
        first = instruct_generate(model, *args, eos_token_id=LLM_VOCAB + 1, pad_token_id=0,
                                  max_new_tokens=1)
    kw = dict(eos_token_id=int(first[1, 0]), pad_token_id=0, max_new_tokens=6)
    got = {}
    for use_cache in (True, False):
        want = np.asarray(jgenerate(jm, params, *_j(batch, "reference", *TEXT),
                                    use_cache=use_cache, **kw))
        stats = {}
        with torch.no_grad():
            got[use_cache] = instruct_generate(model, *args, use_cache=use_cache, stats=stats,
                                               **kw).numpy()
        np.testing.assert_array_equal(got[use_cache], want)
        assert {"image_encode_s", "qformer_s"} <= set(stats)
    np.testing.assert_array_equal(got[True], got[False])
    assert got[True][1, 0] == kw["eos_token_id"] and (got[True][1, 1:] == 0).all()
    assert any(len(set(row.tolist())) > 1 for row in got[True]), got  # not one token repeated


def test_instruct_cli_runs_both_llama_names(capsys):
    import json

    from sprc_tpu_torch.cli import instruct

    instruct.main(["--model-name", NAMES[0], "--synthetic", "--device", "cpu", "--n-gallery",
                   "5"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["task"] == "retrieval" and out["sims_shape"] == [2, 5] and out["finite"]
    assert len(out["top1"]) == 2 and all(0 <= t < 5 for t in out["top1"])
    instruct.main(["--model-name", NAMES[1], "--synthetic", "--device", "cpu", "--batch", "3",
                   "--max-new-tokens", "4"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["model"] == NAMES[1] and out["task"] == "generate" and out["n_outputs"] == 3
    assert all(len(t.split()) <= 4 for t in out["outputs"])


def test_loader_rows_and_presets_equal_jax():
    """The InstructBLIP rows of MODEL_CONFIGS (``vicuna7b``, ``vicuna13b``,
    ``blip2_instruct_cir``'s ``vicuna7b``, ``blip2_t5_instruct``'s two)
    against what sprc_tpu.loader builds from their YAMLs (the LLaMA preset
    table is held in test_torch_caption_eval.py), a ``llama_config``
    override, and ``blip2_t5_instruct`` as ``blip2_t5``'s class."""
    import dataclasses

    from sprc_tpu.loader import build_model as jbuild

    from sprc_tpu_torch import loader
    from sprc_tpu_torch.models.blip2_t5 import Blip2T5
    from sprc_tpu_torch.registry import registry

    rows = [k for k in loader.MODEL_CONFIGS if k[0] in loader.INSTRUCT_MODELS
            or k[0] == "blip2_t5_instruct"]
    assert sorted(rows) == sorted([("blip2_vicuna_instruct", "vicuna7b"),
                                   ("blip2_vicuna_instruct", "vicuna13b"),
                                   ("blip2_instruct_cir", "vicuna7b"),
                                   ("blip2_t5_instruct", "flant5xl"),
                                   ("blip2_t5_instruct", "flant5xxl")])
    for name, model_type in rows:
        jm = jbuild(name, model_type)
        jcfg, cfg = jm.cfg, loader.model_config(name, model_type)
        for f in ("vit_model", "image_size", "num_query_token", "cross_attention_freq",
                  "embed_dim", "max_txt_len", "vocab_size", "freeze_vit"):
            assert getattr(cfg, f) == getattr(jcfg, f), (name, model_type, f)
        assert str(cfg.vit_dtype).split(".")[-1] == jnp.dtype(jcfg.vit_dtype).name
        (field, llm), = loader.llm_config(name, model_type).items()
        jllm = getattr(jm, field)
        for f in dataclasses.fields(jllm):
            want = getattr(jllm, f.name)
            got = getattr(llm, f.name)
            if f.name == "dtype":
                assert str(got).split(".")[-1] == jnp.dtype(want).name, (name, f.name)
            else:
                assert got == want, (name, model_type, f.name)
    assert loader.llm_config("blip2_vicuna_instruct", "vicuna7b")["llama_config"].dtype == \
        torch.float32
    assert registry.get_model_class("blip2_t5_instruct") is Blip2T5
    cfg = loader.llm_config("blip2_vicuna_instruct", "vicuna7b",
                            llama_config={"hidden_size": 64, "num_layers": 1, "num_kv_heads": 2,
                                          "dtype": "fp32"})["llama_config"]
    assert (cfg.hidden_size, cfg.num_layers, cfg.kv_heads, cfg.vocab_size) == (64, 1, 2, 32001)


def test_llama_tokenizer_equals_jax(tmp_path):
    """``llama_tokenizer`` (pad 0, eos 2, bos 1 first) over a WordLevel
    tokenizer.json equals JAX's: ids, mask and the decoded text."""
    tokenizers = pytest.importorskip("tokenizers")
    from sprc_tpu.text.llm_tokenizers import llama_tokenizer as jllama

    from sprc_tpu_torch.text.llm_tokenizers import llama_tokenizer

    words = ["make", "it", "red", "a", "dog", "with", "longer", "sleeves"]
    vocab = {"<unk>": 0, "<s>": 1, "</s>": 2, **{w: 3 + i for i, w in enumerate(words)}}
    tok = tokenizers.Tokenizer(tokenizers.models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = tokenizers.pre_tokenizers.Whitespace()
    path = str(tmp_path / "tokenizer.json")
    tok.save(path)
    port, ref = llama_tokenizer(path), jllama(path)
    assert (port.pad_id, port.eos_id, port.bos_id, port.add_bos) == (0, 2, 1, True)
    texts = ["make it red", "a dog with longer sleeves and more", ""]
    got, want = port(texts, max_length=6), ref(texts, max_length=6)
    for key in ("input_ids", "attention_mask"):
        np.testing.assert_array_equal(got[key], want[key])
    assert got["input_ids"][0, 0] == 1 and got["input_ids"][0, 4] == 2
    assert [port.decode(r) for r in got["input_ids"]] == [ref.decode(r) for r in want["input_ids"]]
