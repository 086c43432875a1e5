"""The port's GPT-2 video dialogue (models/gpt_dialogue.py,
data/gpt_processors.py, train/generic.DialogueAdapter) against sprc_tpu's.

A tiny GPT-2 (vocabulary 64, width 32, 2 layers, 2 heads, 64 positions) and
``len_video_ft`` 8; the JAX init goes to the port through
``interop.jax_params.gpt_dialogue_from_jax``, and one numpy-seeded batch runs
through both: the logits within 1e-5 of their largest magnitude, the loss
within 1e-6 relative, and the gradients of every parameter (the tied
``wte`` among them: the head's, the embedding's and the token-type
embedding's parts) within 1e-4 of their scale. HF's GPT-2 file reads into
the trunk as ``gpt2_params_from_hf`` reads it, and the processors and the
collate give JAX's arrays on the same items.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from sprc_tpu_torch.interop.jax_params import gpt_dialogue_from_jax  # noqa: E402
from sprc_tpu_torch.models.gpt_dialogue import (GPT2Config, GPTDialogue,  # noqa: E402
                                                GPTDialogueConfig, gpt2_state_from_hf)
from test_torch_threads import one_torch_thread  # noqa: E402,F401  (one thread a module)

VOCAB, WIDTH, LAYERS, HEADS, POSITIONS, FT = 64, 32, 2, 2, 64, 8
GPT = dict(vocab_size=VOCAB, n_embd=WIDTH, n_layer=LAYERS, n_head=HEADS, n_positions=POSITIONS)


class WordTokens:
    """A word-level tokenizer with the dialogue's special ids after 50 words."""

    def __init__(self):
        from sprc_tpu_torch.data.gpt_processors import SPECIAL_TOKEN_ADD_ORDER

        self.words = {}
        self.special = {t: 50 + i for i, t in enumerate(SPECIAL_TOKEN_ADD_ORDER)}

    def encode(self, text):
        return [self.words.setdefault(w, len(self.words) % 50) for w in str(text).split()]

    def special_token_id(self, name):
        return self.special[name]


def jax_model():
    from sprc_tpu.models.gpt_dialogue import GPT2Config as JGPT2Config
    from sprc_tpu.models.gpt_dialogue import GPTDialogue as JGPTDialogue
    from sprc_tpu.models.gpt_dialogue import GPTDialogueConfig as JGPTDialogueConfig

    return JGPTDialogue(JGPTDialogueConfig(gpt=JGPT2Config(**GPT), len_video_ft=FT))


def jax_params(model, seed=0):
    from sprc_tpu.train.generic import DialogueAdapter as JDialogueAdapter

    params = JDialogueAdapter().init_params(model, jax.random.PRNGKey(seed), 0)
    return jax.tree_util.tree_map(np.asarray, params)


def port_model(params):
    model = GPTDialogue(GPTDialogueConfig(gpt=GPT2Config(**GPT), len_video_ft=FT))
    model.load_state_dict(gpt_dialogue_from_jax(params), strict=True)
    return model


def batch(seed=0, B=3, T=5, L=9):
    """One padded [video | text] batch: rows with shorter videos and texts."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, VOCAB, (B, L)).astype(np.int32)
    fts = np.ones((B, T, FT), np.float32)
    attn = np.zeros((B, T + L), np.int32)
    labels = np.full((B, T + L), -1, np.int32)
    for i in range(B):
        t, n = T - i, L - 2 * i
        fts[i, :t] = rng.randn(t, FT)
        attn[i, :t] = 1
        attn[i, T:T + n] = 1
        labels[i, T + n - 3:T + n] = ids[i, n - 3:n]
    tt = rng.randint(50, 57, (B, T + L)).astype(np.int32)
    return {"input_ids": ids, "video_fts": fts, "attn_mask": attn, "token_type_ids": tt,
            "labels": labels}


def jax_apply(model, params, b):
    return model.apply({"params": params}, b["input_ids"], b["video_fts"], b["attn_mask"],
                       b["token_type_ids"], b["labels"])


def jax_apply_and_grads(model, params, b):
    """(the outputs, the loss's gradients) in one jitted program."""
    fn = jax.jit(jax.value_and_grad(lambda p: (jax_apply(model, p, b)["loss"],
                                               jax_apply(model, p, b)), has_aux=True))
    (_, out), grads = fn(params)
    return out, jax.tree_util.tree_map(np.asarray, grads)


def port_apply(model, b):
    t = {k: torch.from_numpy(v) for k, v in b.items()}
    return model(t["input_ids"], t["video_fts"], t["attn_mask"], t["token_type_ids"],
                 t["labels"])


def test_logits_loss_and_gradients_equal_jax():
    model = jax_model()
    params = jax_params(model)
    b = batch()
    want, grads = jax_apply_and_grads(model, params, b)
    port = port_model(params)
    got = port_apply(port, b)
    w_logits = np.asarray(want["logits"])
    assert got["logits"].shape == w_logits.shape
    gap = np.abs(got["logits"].detach().numpy() - w_logits).max()
    assert gap <= 1e-5 * np.abs(w_logits).max(), gap
    w_loss = float(want["loss"])
    assert abs(got["loss"].item() - w_loss) <= 1e-6 * abs(w_loss), (got["loss"].item(), w_loss)

    # one step's gradients: the JAX loss's against autograd through the port
    got["loss"].backward()
    want_g = gpt_dialogue_from_jax(grads)
    port_g = {n: p.grad for n, p in port.named_parameters()}
    assert set(port_g) == set(want_g) - {"lm_head.weight"}  # one tied wte, no head copy
    for name, g in port_g.items():
        w = want_g[name].numpy()
        scale = max(np.abs(w).max(), 1e-12)
        assert np.abs(g.numpy() - w).max() <= 1e-4 * scale, name
    # the head is the embedding table itself: one parameter, its gradient the sum
    assert port.transformer.wte.weight.grad is port_g["transformer.wte.weight"]


def test_model_refuses_a_width_and_a_length_jax_would_not_check():
    port = port_model(jax_params(jax_model()))
    b = {k: torch.from_numpy(v) for k, v in batch().items()}
    with pytest.raises(ValueError, match="9 wide: the model's len_video_ft is 8"):
        port(b["input_ids"], torch.ones(3, 5, FT + 1), b["attn_mask"], b["token_type_ids"])
    long_ids = torch.zeros(1, POSITIONS, dtype=torch.long)
    with pytest.raises(ValueError, match="GPT-2 has 64"):
        port(long_ids, torch.ones(1, 2, FT), torch.ones(1, POSITIONS + 2, dtype=torch.long),
             torch.zeros(1, POSITIONS + 2, dtype=torch.long))


def test_float64_copy_is_the_fp32_models_reference():
    """The model moved to float64 runs in float64 throughout (the chip's
    first-step check rests on it): its loss is the fp32 loss within fp32's
    rounding, and not bit-equal to it."""
    port = port_model(jax_params(jax_model(), seed=3))
    b = batch(seed=4)
    f32 = port_apply(port, b)["loss"]
    f64 = port_apply(port.double(), {k: v.astype(np.float64) if v.dtype == np.float32 else v
                                     for k, v in b.items()})["loss"]
    assert f64.dtype == torch.float64
    assert abs(f32.item() - f64.item()) <= 1e-5 * abs(f64.item())


def test_gpt2_state_from_hf_reads_what_gpt2_params_from_hf_reads():
    transformers = pytest.importorskip("transformers")
    from sprc_tpu.models.gpt_dialogue import gpt2_params_from_hf

    torch.manual_seed(0)
    hf = transformers.GPT2LMHeadModel(transformers.GPT2Config(
        vocab_size=VOCAB, n_embd=WIDTH, n_layer=LAYERS, n_head=HEADS, n_positions=POSITIONS)).eval()
    sd = hf.state_dict()
    port = port_model(jax_params(jax_model()))
    port.transformer.load_state_dict(gpt2_state_from_hf(sd), strict=True)
    jparams = gpt2_params_from_hf({k: v.numpy() for k, v in sd.items()}, n_layer=LAYERS)
    want = gpt_dialogue_from_jax({"transformer": jparams,
                                  "video_ff": {"kernel": np.zeros((FT, WIDTH)),
                                               "bias": np.zeros(WIDTH)},
                                  "video_ff_out": {"kernel": np.zeros((WIDTH, FT)),
                                                   "bias": np.zeros(FT)}})
    for name, value in port.transformer.state_dict().items():
        assert torch.equal(value, want[f"transformer.{name}"]), name
    # the trunk equals HF's own forward over the same embeddings
    ids = torch.arange(12)[None] % VOCAB
    with torch.no_grad():
        hidden = port.transformer(port.transformer.wte(ids))
        want_h = hf.transformer(input_ids=ids).last_hidden_state
    assert (hidden - want_h).abs().max() <= 1e-5 * want_h.abs().max()


def test_load_gpt2_trunk_reads_a_file_of_gpt2s_smaller_vocabulary(tmp_path):
    """An HF GPT-2 file has 7 rows fewer than the dialogue's vocabulary:
    its rows fill the model's first rows, the special tokens' rows and the
    video projections keep their init, and the rest of the trunk is the
    file's."""
    transformers = pytest.importorskip("transformers")
    from sprc_tpu_torch import loader

    torch.manual_seed(1)
    hf = transformers.GPT2LMHeadModel(transformers.GPT2Config(
        vocab_size=VOCAB - 7, n_embd=WIDTH, n_layer=LAYERS, n_head=HEADS, n_positions=POSITIONS))
    torch.save(hf.state_dict(), tmp_path / "gpt2.bin")
    port = port_model(jax_params(jax_model()))
    before = {k: v.clone() for k, v in port.state_dict().items()}
    loader.load_gpt2_trunk(port, str(tmp_path / "gpt2.bin"))
    got, want = port.state_dict(), hf.state_dict()
    assert torch.equal(got["transformer.wte.weight"][:VOCAB - 7], want["transformer.wte.weight"])
    assert torch.equal(got["transformer.wte.weight"][VOCAB - 7:],
                       before["transformer.wte.weight"][VOCAB - 7:])
    for name, value in got.items():
        if name.startswith("video_ff"):
            assert torch.equal(value, before[name]), name
        elif name != "transformer.wte.weight":
            assert torch.equal(value, want[name]), name
    big = transformers.GPT2LMHeadModel(transformers.GPT2Config(
        vocab_size=VOCAB + 1, n_embd=WIDTH, n_layer=LAYERS, n_head=HEADS, n_positions=POSITIONS))
    torch.save(big.state_dict(), tmp_path / "big.bin")
    with pytest.raises(ValueError, match="more than the model's vocab_size"):
        loader.load_gpt2_trunk(port, str(tmp_path / "big.bin"))


def test_processors_and_collate_equal_jax(tmp_path):
    from sprc_tpu.data import gpt_processors as jproc
    from sprc_tpu.train.generic import DialogueAdapter as JDialogueAdapter

    from sprc_tpu_torch.data import gpt_processors as proc
    from sprc_tpu_torch.registry import registry
    from sprc_tpu_torch.train.generic import DialogueAdapter

    assert proc.SPECIAL_TOKEN_ADD_ORDER == jproc.SPECIAL_TOKEN_ADD_ORDER
    assert registry.get("processor", "gpt_dialogue") is proc.GPTDialogueProcessor
    rng = np.random.RandomState(5)
    for stream, width in (("i3d_flow", 3), ("i3d_rgb", 3), ("vggish", 2)):
        (tmp_path / stream).mkdir()
        for v in range(3):
            np.save(tmp_path / stream / f"v{v}.npy",
                    rng.randn(4 + v + width, width).astype(np.float32))
    words = ["a", "man", "walks", "the", "dog", "in", "park", "yes", "no", "red"]

    def ann(v):
        say = lambda n: " ".join(rng.choice(words, n))  # noqa: E731
        return {"caption": say(4), "summary": say(3), "question": say(5), "answer": say(3),
                "dialog": [{"question": say(4), "answer": say(2)} for _ in range(4)],
                "image_id": f"v{v}"}

    anns = [ann(v) for v in range(3)]
    items = {}
    for name, mod in (("port", proc), ("jax", jproc)):
        tok = WordTokens()
        text = mod.GPTDialogueProcessor(tokenizer=tok, max_turns=3)
        vis = mod.GPTVideoFeatureProcessor(tokenizer=tok, visual_ft=["i3d_flow", "i3d_rgb"],
                                           audio_ft=["vggish"])
        items[name] = []
        for a in anns:
            item = dict(text(a))
            v = vis(str(tmp_path), a["image_id"])
            item["video_fts"], item["video_token_type_ids"] = v["video_fts"], v["token_type_ids"]
            items[name].append(item)
        assert text.padding([i["input_ids"] for i in items[name]]).shape == (3, max(
            len(i["input_ids"]) for i in items[name]))
    for got, want in zip(items["port"], items["jax"]):
        assert set(got) == set(want)
        for key in got:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert items["port"][0]["video_fts"].shape[1] == 8  # the three streams joined

    class DS:  # what attach reads: the text processor's tokenizer
        text_processor = proc.GPTDialogueProcessor(tokenizer=WordTokens())

    port_ad, jax_ad = DialogueAdapter(), JDialogueAdapter()
    port_ad.attach(DS)
    jax_ad.attach(DS)
    assert port_ad.pad_id == jax_ad.pad_id == 56
    got, want = port_ad.collate(items["port"]), jax_ad.collate(items["jax"])
    assert set(got) == set(want)
    for key in got:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    # the synthetic tokenizer: the specials after the base vocabulary, <video> before <cap>
    syn = proc.SyntheticGPT2Tokens(100)
    assert (syn.special_token_id("<video>"), syn.special_token_id("<cap>"),
            syn.vocab_size) == (104, 105, 107)
    with pytest.raises(FileNotFoundError, match="missing/tokenizer.json"):
        proc.GPT2SpecialTokens(str(tmp_path / "missing" / "tokenizer.json"))
    with pytest.raises(ValueError, match="synthetic_vocab"):
        proc.GPTDialogueProcessor()


def test_loader_rows_equal_jax():
    """The port's ``gpt_dialogue`` rows (the model type the run YAMLs leave
    out, and base.yaml's), with the YAMLs' ``gpt`` override, are the
    configurations sprc_tpu.loader builds, field by field (JAX's ``dtype``
    aside: the port is fp32 throughout), and build the registered class."""
    import dataclasses

    from sprc_tpu.loader import build_model as jbuild

    from sprc_tpu_torch import loader

    for model_type in ("pretrain", "base"):
        jcfg = jbuild("gpt_dialogue", model_type, gpt={"vocab_size": 50264}).cfg
        cfg = loader.family_config("gpt_dialogue", model_type, gpt={"vocab_size": 50264})
        assert cfg.len_video_ft == jcfg.len_video_ft == 4224
        for f in dataclasses.fields(cfg.gpt):
            assert getattr(cfg.gpt, f.name) == getattr(jcfg.gpt, f.name), (model_type, f.name)
        model = loader.build_model("gpt_dialogue", model_type, device="meta",
                                   gpt={"vocab_size": 50264})
        assert isinstance(model, GPTDialogue) and model.transformer.wte.weight.shape[0] == 50264
