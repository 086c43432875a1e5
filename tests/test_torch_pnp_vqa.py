"""PNP-VQA in the port (models/pnp_vqa.py, models/generation.py's sampling
and recomputing decoders, the FiD reader, cli/evaluate.py's ``pnp_vqa``
branch) against sprc_tpu's.

The framework-free parts equal the JAX functions on the same inputs: the
FiD contexts, the Gumbel top-k over JAX's own ``jax.random.gumbel`` draw,
the three logit filters, and the greedy and top-1 sampling decoders over
one logits function written in both frameworks. The random draws differ
(``torch.Generator`` against ``jax.random``), so sampled captions are not
compared. On tiny models built once a module in the port and read by the
JAX package's importers (ViT width 32 at 32 px, patch 16; med-BERT hidden
32, 2 layers; a T5 v1.0 of width 32 and a 512-word vocabulary, the
whitespace tokenizer's), fp32, within 1e-5 unless stated: the FiD reader's logits and its
cached and recomputing decodes, and the assembled pipelines' ``forward_itm``
(the GradCAM maps, within 1e-5 of their largest value) and ``forward_qa``
(the same answers from the same captions). Both evaluate CLIs run one tiny
pnp YAML shaped as configs/runs/eval/pnp_vqa_vqav2_eval.yaml: the port's
runs the pipeline, the JAX CLI's pipeline is handed the port's answers
(its own samples other captions), and they pass ``predict_answers`` the
same pixels, questions and settings and write the same result file and
metric JSON.
"""

import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
yaml = pytest.importorskip("yaml")
import jax.numpy as jnp  # noqa: E402

from sprc_tpu_torch import loader  # noqa: E402
from sprc_tpu_torch.interop.jax_params import fid_t5_from_jax  # noqa: E402
from test_torch_blip1 import numpy_state, port_model  # noqa: E402
from test_torch_threads import one_torch_thread  # noqa: E402,F401  (one thread a module)

IMG = 32
WORDS = ["a", "picture", "of", "red", "dress", "dog", "cat", "what", "color", "is", "the"]
VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[DEC]", "[ENC]"] + WORDS
VIT = dict(image_size=IMG, patch_size=16, width=32, depth=1, num_heads=2, mlp_hidden=64,
           final_norm=True, dtype="fp32")
TXT = dict(vocab_size=len(VOCAB), hidden_size=32, num_layers=2, num_heads=2,
           intermediate_size=64, encoder_width=32, dropout_rate=0.0)
T5 = dict(vocab_size=512, d_model=32, d_kv=8, d_ff=64, num_heads=4, num_layers=2,
          num_decoder_layers=2)
TOL = 1e-5


def t(a) -> torch.Tensor:
    a = np.asarray(a)
    return torch.from_numpy(a.astype(np.int64) if a.dtype.kind in "iu" else a.copy())


class IdTokenizer:
    """The reader's tokenizer of both pipelines: the port's whitespace
    tokenizer (the JAX one's equal), decoding every id to its number, so that
    answers compare as ids."""

    def __init__(self):
        from sprc_tpu_torch.text.llm_tokenizers import WhitespaceTokenizer

        self.words = WhitespaceTokenizer()
        self.pad_id, self.eos_id = self.words.pad_id, self.words.eos_id

    def __call__(self, texts, max_length=32):
        return self.words(texts, max_length=max_length)

    def decode(self, ids):
        return " ".join(str(int(i)) for i in ids if int(i) not in (0, 1, 2))


@pytest.fixture(scope="module")
def pipelines():
    """(the JAX PnpVqaPipeline, the port's) over the same tiny weights: the
    port's from ``init_weights`` (biases and norms moved by seeded noise;
    the reader's dense weights and embeddings scaled by 4 and its pad row
    shrunk, so that its greedy answers are neither an echo of the start
    token nor near ties), read by the JAX package's importers."""
    from sprc_tpu.interop.lavis_import import (blip_caption_params_from_torch,
                                               blip_retrieval_params_from_torch)
    from sprc_tpu.models.blip1 import BlipCaption, BlipCaptionConfig, BlipITM, BlipRetrievalConfig
    from sprc_tpu.models.pnp_vqa import FiDT5, PnpVqaPipeline as JPipe
    from sprc_tpu.models.qformer import QFormerConfig
    from sprc_tpu.models.t5 import T5Config, t5_params_from_hf
    from sprc_tpu.models.vit import ViTConfig
    from sprc_tpu.text.tokenizer import BertWordPieceTokenizer as JBert

    from sprc_tpu_torch.models.pnp_vqa import PnpVqaPipeline
    from sprc_tpu_torch.text.tokenizer import BertWordPieceTokenizer

    jv, jq = ViTConfig(**{**VIT, "dtype": jnp.float32}), QFormerConfig(**TXT)
    itm = BlipITM(BlipRetrievalConfig(image_size=IMG, embed_dim=8, vocab_size=len(VOCAB),
                                      vit_dtype=jnp.float32, vit_config_override=jv,
                                      text_config_override=jq))
    cap = BlipCaption(BlipCaptionConfig(image_size=IMG, vocab_size=len(VOCAB),
                                        vit_dtype=jnp.float32, vit_config_override=jv,
                                        text_config_override=jq))
    jcfg = T5Config(**T5, gated_act=False, tie_word_embeddings=True)
    blip = dict(vit_config_override=VIT, text_config_override=TXT)
    port = [port_model("blip_image_text_matching", "large", 0, embed_dim=8, **blip),
            port_model("blip_caption", "large_coco", 1, **blip),
            loader.load_model("pnp_unifiedqav2_fid", "base", device="cpu", seed=9, **T5)]
    with torch.no_grad():
        for name, p in port[2].named_parameters():
            if "layer_norm" not in name:
                p.mul_(4.0)
        port[2].shared.weight[0].mul_(0.05)
    sd = [numpy_state(m) for m in port]
    vocab = {w: i for i, w in enumerate(VOCAB)}
    jpipe = JPipe(itm_model=itm, itm_params=blip_retrieval_params_from_torch(sd[0], itm),
                  cap_model=cap, cap_params=blip_caption_params_from_torch(sd[1], cap),
                  qa_model=FiDT5(jcfg),
                  qa_params={"t5": t5_params_from_hf(
                      sd[2], num_layers=2, num_decoder_layers=2, gated_act=False,
                      tie_word_embeddings=True)},
                  tokenizer=JBert(vocab, extra_special_tokens=["[DEC]"]),
                  qa_tokenizer=IdTokenizer())
    assert all(torch.equal(fid_t5_from_jax(jpipe.qa_params)[k], v)
               for k, v in port[2].state_dict().items())
    pipe = PnpVqaPipeline(*port, tokenizer=BertWordPieceTokenizer(
        vocab, extra_special_tokens=["[DEC]"]), qa_tokenizer=IdTokenizer())
    return jpipe, pipe


def test_prepare_qa_input_equals_jax():
    """The FiD contexts on the JAX test's case and on chunks of 2 and 3
    captions, fewer captions than asked, none, and cut to num_captions."""
    from sprc_tpu.models.pnp_vqa import prepare_qa_input as jprepare

    from sprc_tpu_torch.models.pnp_vqa import prepare_qa_input

    questions = ["What color?", " Is it A DOG ", "where"]
    captions = [["a red dress", "a dog"], [" the Cat .", "x", "y y", "z", "w"], []]
    assert prepare_qa_input(questions[:1], captions[:1], num_captions=2, num_captions_fid=1) \
        == [["what color? \\n a red dress.", "what color? \\n a dog."]]
    for n, fid in ((2, 1), (5, 2), (5, 3), (9, 2), (3, 1)):
        assert prepare_qa_input(questions, captions, num_captions=n, num_captions_fid=fid) \
            == jprepare(questions, captions, num_captions=n, num_captions_fid=fid), (n, fid)


def test_top_k_patches_on_jax_gumbel_draw():
    """``top_k_patches`` over JAX's own Gumbel draw picks the patches of the
    JAX ``sample_patches`` (sorted, without replacement; a zero weight
    clamped as there); ``sample_patches`` from a seeded generator repeats
    itself and draws every patch set without replacement."""
    from sprc_tpu.models.pnp_vqa import sample_patches as jsample

    from sprc_tpu_torch.models.pnp_vqa import sample_patches, top_k_patches

    w = np.random.RandomState(0).rand(3, 24).astype(np.float32)
    w[1, :5] = 0.0
    key = jax.random.PRNGKey(7)
    want = np.asarray(jsample(key, jnp.asarray(w), 6, 5))
    g = np.asarray(jax.random.gumbel(key, (3, 5, 24)))
    got = top_k_patches(t(w), t(g), 6).numpy()
    np.testing.assert_array_equal(got, want)
    draws = [sample_patches(torch.Generator().manual_seed(3), t(w), 6, 40) for _ in range(2)]
    assert torch.equal(*draws) and draws[0].shape == (3, 40, 6)
    idx = draws[0].numpy()
    assert (np.diff(idx, axis=-1) > 0).all()
    assert not np.isin(idx[1], np.arange(5)).any()


def _logits_fns(table):
    """One recomputing logits function in both frameworks: position l of a
    row scores ``table[ids[l]] + 0.1 * l`` over the vocabulary."""
    jt = jnp.asarray(table)
    pos = np.arange(16, dtype=np.float32)[:, None] * 0.1

    def jfn(ids, memory=None):
        return jt[ids] + jnp.asarray(pos[:ids.shape[1]])[None]

    tt = t(table)

    def fn(ids, memory=None):
        return tt[ids] + t(pos[:ids.shape[1]])[None]

    return jfn, fn


def test_filters_and_decoders_equal_jax():
    """The repetition penalty, top-k and top-p filters on random logits
    equal the JAX functions'; ``sample_generate(top_k=1)`` equals
    ``greedy_generate_fn`` in both packages, and the port's ids equal JAX's,
    with and without the penalty and ``min_length``."""
    from sprc_tpu.models import generation as jgen

    from sprc_tpu_torch.models import generation as gen

    rs = np.random.RandomState(1)
    logits = rs.randn(4, 30).astype(np.float32) * 3
    ids = rs.randint(0, 30, (4, 9))
    for k in (0, 1, 5, 30):
        np.testing.assert_array_equal(gen._filter_top_k(t(logits), k).numpy(),
                                      np.asarray(jgen._filter_top_k(jnp.asarray(logits), k)))
    for p in (0.0, 0.3, 0.9, 1.0):
        np.testing.assert_array_equal(gen._filter_top_p(t(logits), p).numpy(),
                                      np.asarray(jgen._filter_top_p(jnp.asarray(logits), p)))
    for penalty, step in ((1.0, 4), (1.3, 4), (0.7, 9), (2.0, 1)):
        np.testing.assert_allclose(
            gen._apply_repetition_penalty(t(logits), t(ids), step, penalty).numpy(),
            np.asarray(jgen._apply_repetition_penalty(jnp.asarray(logits), jnp.asarray(ids),
                                                      step, penalty)), rtol=1e-7)
    table = rs.randn(30, 30).astype(np.float32)
    table[[7, 11, 19, 23], 3] = 8.0  # the eos after these tokens: rows end at different steps
    jfn, fn = _logits_fns(table)
    prompt = rs.randint(4, 30, (5, 2))
    for kw in (dict(), dict(min_length=4), dict(repetition_penalty=1.5, min_length=2)):
        greedy_kw = {k: v for k, v in kw.items() if k == "min_length"}
        common = dict(eos_token_id=3, pad_token_id=0, max_length=12)
        want = np.asarray(jgen.sample_generate(jfn, jnp.asarray(prompt, jnp.int32),
                                               rng=jax.random.PRNGKey(0), top_k=1,
                                               **common, **kw))
        got = gen.sample_generate(fn, t(prompt), generator=torch.Generator().manual_seed(0),
                                  top_k=1, **common, **kw).numpy()
        np.testing.assert_array_equal(got, want)
        if "repetition_penalty" not in kw:
            jgreedy = np.asarray(jgen.greedy_generate_fn(jfn, jnp.asarray(prompt, jnp.int32),
                                                         **common, **greedy_kw))
            greedy = gen.greedy_generate_fn(fn, t(prompt), **common, **greedy_kw).numpy()
            np.testing.assert_array_equal(greedy, jgreedy)
            np.testing.assert_array_equal(greedy, got)
    assert (got == 3).any(axis=1).any() and (got[:, 2:] != 0).any()


def test_fid_generate_equals_jax(pipelines):
    """FiDT5: the contexts encoded alone and fused, the decoder's logits over
    them within 1e-5, and ``fid_generate``'s ids cached and recomputing equal
    to each other and to the JAX reader's."""
    from sprc_tpu.models.pnp_vqa import fid_generate as jfid

    from sprc_tpu_torch.models.pnp_vqa import fid_generate

    jpipe, pipe = pipelines
    rs = np.random.RandomState(2)
    ids = rs.randint(3, 512, (2, 3, 7))
    mask = np.ones_like(ids)
    mask[1, 2, 4:] = 0
    dec = rs.randint(3, 512, (2, 5))
    jqa, p = jpipe.qa_model, jpipe.qa_params
    want = np.asarray(jqa.apply({"params": p}, *(jnp.asarray(a, jnp.int32)
                                                 for a in (ids, mask, dec))))
    with torch.no_grad():
        got = pipe.qa_model(t(ids), t(mask), t(dec)).numpy()
        rows, fused = pipe.qa_model.encode_contexts(t(ids), t(mask))
        alone = torch.cat([pipe.qa_model.encode_ids(t(ids[:, c]), t(mask[:, c]))
                           for c in range(3)], dim=1)
    assert rows.shape == (2, 21, 32) and fused.shape == (2, 21)
    np.testing.assert_allclose(rows.numpy(), alone.numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    kw = dict(pad_id=0, eos_id=1, max_length=7, min_length=2)
    cached = fid_generate(pipe.qa_model, t(ids), t(mask), **kw).numpy()
    again = fid_generate(pipe.qa_model, t(ids), t(mask), use_cache=False, **kw).numpy()
    jids = [jnp.asarray(a, jnp.int32) for a in (ids, mask)]
    for use_cache in (True, False):
        np.testing.assert_array_equal(
            cached, np.asarray(jfid(jqa, p, *jids, use_cache=use_cache, **kw)))
    np.testing.assert_array_equal(cached, again)
    assert cached.shape == (2, 7) and (cached[:, 0] == 0).all()


def test_pipeline_gradcam_and_answers_equal_jax(pipelines):
    """The assembled pipelines. ``forward_itm``: the JAX one is
    ``compute_gradcam`` over its tokenizer's ids of the questions stripped
    of '?' with [ENC] first (max_length 35); the port's maps equal them, and
    the port's ``compute_gradcam`` on those ids gives them with the full
    [B, L + 1, P] maps, within 1e-5 of their largest value (a random
    model's maps are about 1e-4); the tower without a graph. ``forward_qa``:
    the same greedy FiD answers from the same captions (two contexts a
    question; a question without captions answered from itself)."""
    from sprc_tpu.utils.gradcam import compute_gradcam as jgradcam

    from sprc_tpu_torch.utils.gradcam import compute_gradcam

    jpipe, pipe = pipelines
    imgs = np.random.RandomState(3).rand(3, IMG, IMG, 3).astype(np.float32)
    questions = ["what color is the dress?", "dog or cat", "what is red?"]
    enc = jpipe.tokenizer([q.strip("?") for q in questions], max_length=35, enc_token=True)
    want_avg, want = jgradcam(jpipe.itm_model, jpipe.itm_params, jnp.asarray(imgs),
                              jnp.asarray(enc["input_ids"]), jnp.asarray(enc["attention_mask"]),
                              block_num=1)
    scale = np.abs(want).max()
    got = pipe.forward_itm(t(imgs), questions, block_num=1)
    got_avg, got_full = compute_gradcam(pipe.itm_model, t(imgs), t(enc["input_ids"]),
                                        t(enc["attention_mask"]), block_num=1)
    assert got.shape == want_avg.shape == (3, 4) and got_full.shape == want.shape == (3, 36, 4)
    assert scale > 0 and (got >= 0).all()
    np.testing.assert_allclose(got, want_avg, atol=TOL * scale, rtol=0)
    np.testing.assert_allclose(got_full, want, atol=TOL * scale, rtol=0)
    np.testing.assert_array_equal(got_avg, got)
    assert all(p.grad is None for p in pipe.itm_model.parameters())
    from sprc_tpu.utils.gradcam import get_att_map as jmap

    from sprc_tpu_torch.utils.gradcam import get_att_map

    for kw in (dict(), dict(blur=False), dict(overlap=False)):  # the overlay, PIL only
        np.testing.assert_array_equal(get_att_map(imgs[0], got[0].reshape(2, 2), **kw),
                                      jmap(imgs[0], got[0].reshape(2, 2), **kw))
    captions = [["a red dress", "a dog of the cat", "red"], ["the cat", "a cat", "dog"], []]
    kw = dict(num_captions=3, num_captions_fid=2, max_len=6, min_len=1)
    answers = pipe.forward_qa(questions, captions, **kw)
    assert answers == jpipe.forward_qa(questions, captions, **kw)
    assert len(set(answers)) > 1 and all(answers)


def _pnp_config(ann, images):
    return {
        "run": {"task": "vqa", "evaluate": True, "batch_size_eval": 2, "num_captions": 3,
                "num_captions_fid": 1, "num_patches": 2, "block_num": 1, "max_len": 4,
                "min_len": 1, "test_splits": ["val"]},
        "model": {"arch": "pnp_vqa", "model_type": "base",
                  "image_question_matching_model": {
                      "arch": "blip_image_text_matching", "model_type": "large",
                      "image_size": IMG, "vit_dtype": "fp32", "vit_config_override": VIT,
                      "text_config_override": TXT},
                  "image_captioning_model": {
                      "arch": "blip_caption", "model_type": "large_coco", "image_size": IMG,
                      "vit_dtype": "fp32", "vit_config_override": VIT,
                      "text_config_override": TXT},
                  "question_answering_model": {"arch": "pnp_unifiedqav2_fid",
                                               "model_type": "base", **T5}},
        "datasets": {"coco_vqa": {
            "build_info": {"annotations": {"val": [ann]}, "images": images},
            "vis_processor": {"eval": {"name": "blip_image_eval", "image_size": IMG}},
            "text_processor": {"eval": {"name": "blip_question"}}}}}


def _write_split(root, n=5):
    from PIL import Image

    rng = np.random.RandomState(4)
    (root / "imgs").mkdir()
    ann = []
    for i in range(n):
        name = f"p{i}.png"
        Image.fromarray((rng.rand(30 + 3 * i, 40, 3) * 255).astype(np.uint8)).save(
            root / "imgs" / name)
        words = [str(w) for w in rng.choice(WORDS, 2)]
        ann.append({"image": name, "question": f"What is the {words[0]}?", "question_id": 70 + i,
                    "answers": [{"answer": str(rng.choice(words))} for _ in range(10)],
                    "question_type": "what is", "answer_type": "other"})
    (root / "vqa.json").write_text(json.dumps(ann))
    (root / "vocab.txt").write_text("\n".join(VOCAB))
    return str(root / "vqa.json"), str(root / "imgs")


def test_evaluate_cli_pnp_vqa_as_jax(tmp_path, monkeypatch, capsys):
    """The port's CLI runs the tiny pipeline over 5 questions (batches of 2,
    the last padded): answers from the captions it samples, the run's
    settings, seconds by stage. The JAX CLI on the same YAML, its pipeline
    handed the port's answers batch by batch: the same pixels, questions and
    ``predict_answers`` settings, the same result file and metric JSON."""
    from sprc_tpu.cli import evaluate as jevaluate
    from sprc_tpu.models import pnp_vqa as jpnp

    from sprc_tpu_torch.cli import evaluate
    from sprc_tpu_torch.models.pnp_vqa import PnpVqaPipeline

    ann, images = _write_split(tmp_path)
    cfg_path = tmp_path / "pnp.yaml"
    cfg_path.write_text(yaml.safe_dump(_pnp_config(ann, images)))
    argv = ["--cfg-path", str(cfg_path), "--vocab-path", str(tmp_path / "vocab.txt")]
    calls = {"port": [], "jax": []}
    real = PnpVqaPipeline.predict_answers

    def spy(self, images, questions, **kw):
        stats = kw.pop("stats") or {}
        out = real(self, images, questions, stats=stats, **kw)
        calls["port"].append((np.asarray(images), list(questions), kw, out, dict(stats)))
        return out

    monkeypatch.setattr(PnpVqaPipeline, "predict_answers", spy)
    evaluate.main(argv + ["--output-dir", str(tmp_path / "port"), "--device", "cpu"])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    answers = iter([c[3] for c in calls["port"]])

    def jax_answers(self, images, questions, **kw):
        calls["jax"].append((np.asarray(images), list(questions), kw))
        return next(answers)

    monkeypatch.setattr(jpnp.PnpVqaPipeline, "from_config",
                        classmethod(lambda cls, mcfg, **kw: object.__new__(cls)))
    monkeypatch.setattr(jpnp.PnpVqaPipeline, "predict_answers", jax_answers)
    jevaluate.main(argv + ["--output-dir", str(tmp_path / "jax")])
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got == want and "agg_metrics" in got
    assert len(calls["port"]) == len(calls["jax"]) == 3
    for (imgs, qs, kw, (ans, caps, cams), stats), (jimgs, jqs, jkw) in zip(calls["port"],
                                                                          calls["jax"]):
        np.testing.assert_array_equal(imgs, jimgs)
        assert qs == jqs and kw == jkw == dict(num_captions=3, num_captions_fid=1,
                                               num_patches=2, block_num=1, max_len=4,
                                               min_len=1)
        assert len(ans) == 2 and cams.shape == (2, 4)
        assert all(0 < len(c) <= 3 and len(set(c)) == len(c) for c in caps)
    assert {"tower_s", "gradcam_s", "caption_sample_s", "fid_encode_s", "fid_decode_s",
            "caption_steps", "fid_steps"} <= set(stats)
    name = "val_vqa_result.json"
    assert sorted(p.name for p in (tmp_path / "port" / "result").iterdir()) == [name]
    assert (tmp_path / "port" / "result" / name).read_text() == \
        (tmp_path / "jax" / "result" / name).read_text()


def test_load_model_assembles_the_pipeline(pipelines, tmp_path):
    """``loader.load_model("pnp_vqa", ...)`` builds the three models from
    their sub-sections: random from seed, seed + 1, seed + 2 (each equal to
    its own ``load_model``), or from a ``finetuned:`` file through
    ``read_checkpoint`` (strict); the prompt and the reader's tokenizer as
    the JAX ``from_config`` sets them."""
    from sprc_tpu_torch.models.pnp_vqa import PnpVqaPipeline
    from sprc_tpu_torch.text.llm_tokenizers import WhitespaceTokenizer

    _, pipe = pipelines
    (tmp_path / "vocab.txt").write_text("\n".join(VOCAB))
    sections = _pnp_config("", "")["model"]
    path = tmp_path / "itm.pth"
    torch.save({"model": pipe.itm_model.state_dict()}, path)
    sections["image_question_matching_model"].update(finetuned=str(path), embed_dim=8)
    got = loader.load_model("pnp_vqa", "base", device="cpu", seed=5,
                            vocab_path=str(tmp_path / "vocab.txt"),
                            **{k: v for k, v in sections.items() if k.endswith("_model")})
    assert isinstance(got, PnpVqaPipeline) and got.prompt == "a picture of "
    assert isinstance(got.qa_tokenizer, WhitespaceTokenizer)
    assert got.tokenizer.bos_id == VOCAB.index("[DEC]")
    for name, model in (("itm", pipe.itm_model), ("cap", None), ("qa", None)):
        mine = getattr(got, f"{name}_model").state_dict()
        if model is None:
            sub = dict(sections["image_captioning_model" if name == "cap"
                                else "question_answering_model"])
            model = loader.load_model(sub.pop("arch"), sub.pop("model_type"), device="cpu",
                                      seed=5 + (1 if name == "cap" else 2), **sub)
        for k, v in model.state_dict().items():
            assert torch.equal(mine[k], v), (name, k)
    assert not got.itm_model.training and not got.qa_model.training


def test_evaluate_cli_refusals(tmp_path, capsys):
    """``--model-path`` exits with the JAX CLI's advice; ``--device cuda``
    without a GPU exits nonzero; a pnp pipeline is not a ``build_model``
    model; and ``img2prompt_vqa`` (once refused) runs on the same YAML, its
    captions read by the same reader through ``forward_qa``, and writes its
    result file."""
    from sprc_tpu_torch.cli import evaluate

    ann, images = _write_split(tmp_path, n=1)
    cfg = _pnp_config(ann, images)
    runs = []
    for name, edit, extra in (("model_path", {}, ["--model-path", "x.pth"]),
                              ("img2prompt", {"arch": "img2prompt_vqa"}, []),
                              ("cuda", {}, ["--device", "cuda"])):
        path = tmp_path / f"{name}.yaml"
        path.write_text(yaml.safe_dump({**cfg, "model": {**cfg["model"], **edit}}))
        argv = ["--cfg-path", str(path), "--vocab-path", str(tmp_path / "vocab.txt"),
                "--output-dir", str(tmp_path / name)]
        if name != "cuda":
            argv += ["--device", "cpu"]
        if name == "cuda" and torch.cuda.is_available():
            continue
        if name == "img2prompt":
            evaluate.main(argv + extra)
            metrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
            assert "agg_metrics" in metrics
            result = json.loads((tmp_path / name / "result" / "val_vqa_result.json").read_text())
            assert len(result) == 1 and result[0]["question_id"] == 70
            continue
        with pytest.raises(SystemExit) as exc:
            evaluate.main(argv + extra)
        runs.append((name, str(exc.value.code)))
    assert "finetuned: <path>" in runs[0][1]
    assert all(code not in ("0", "None") for _, code in runs)
    with pytest.raises(ValueError, match="load_model"):
        loader.build_model("pnp_vqa", "base", device="cpu")
