"""Img2Prompt-VQA in the port (models/pnp_vqa.py's ``Img2PromptVqaPipeline``,
``qg_beam_search`` and ``plain_t5``, models/generation.py's
``cached_beam_loop``, text/pos.py, cli/evaluate.py's ``img2prompt_vqa`` run)
against sprc_tpu's.

The framework-free parts equal the JAX functions on the same inputs: the
tagger on a caption corpus, the answer extraction, the prompt strings, and
the beam search over one logits function written in both frameworks (ties in
the logits included: ``jax.lax.top_k`` gives the lower index first, and the
port's stable sort does too). On tiny models (BLIP-1's ITM and captioner as
in tests/test_torch_pnp_vqa.py, a T5 v1.0 of width 32 with the 512-word
vocabulary of the whitespace tokenizer), the port's from ``init_weights`` and
read by the JAX package's importers (the T5's read back through the bridge's
``plain_t5_from_jax``), fp32, within 1e-5: the ITM filter's match
probabilities and kept captions, the generated questions, and whole prompts.
The random draws differ (``torch.Generator`` against ``jax.random``), so the
sampled captions are given to both sides. Both evaluate CLIs run
one tiny ``img2prompt_vqa`` YAML: the JAX CLI's pipeline is given the port
CLI's weights, GradCAM maps and sampled captions, and filters and answers
itself; the result files and metric JSON are the same.
"""

import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
yaml = pytest.importorskip("yaml")
import jax.numpy as jnp  # noqa: E402

from sprc_tpu_torch.interop.jax_params import plain_t5_from_jax  # noqa: E402
from test_torch_blip1 import numpy_state, port_model  # noqa: E402
from test_torch_opt import jnp_tree  # noqa: E402
from test_torch_pnp_vqa import (IMG, T5, TXT, VIT, VOCAB, IdTokenizer, _pnp_config,  # noqa: E402
                                _write_split, t)
from test_torch_threads import one_torch_thread  # noqa: E402,F401  (one thread a module)

TOL = 1e-5
CAPTIONS = [
    "a man riding a bike down a street", "a man with a hat", "two dogs playing in the snow",
    "a photo of Barack Obama in Paris", "New York began to glow at night.",
    "the red building next to a wooden table", "3 cats sleeping on a bed",
    "a woman is holding an umbrella in the rain", "Someone wearing a striped shirt",
    "a plate of fresh vegetables and a glass of milk", "an airplane flying over the city",
    "The quick brown fox jumps over the lazy dog", "a trip to paris in may",
    "a big clock tower with a flag on top", "people walking along the beach at sunset",
    "a skateboarder does a trick", "a white and black cat", "",
]


def _jax_pipeline(sd, qa_tokenizer):
    """The JAX Img2PromptVqaPipeline of the tiny configuration over the
    port's state dicts ``sd`` (ITM, captioner, T5 as numpy), read by the JAX
    package's importers."""
    from sprc_tpu.interop.lavis_import import (blip_caption_params_from_torch,
                                               blip_retrieval_params_from_torch)
    from sprc_tpu.models.blip1 import BlipCaption, BlipCaptionConfig, BlipITM, BlipRetrievalConfig
    from sprc_tpu.models.pnp_vqa import Img2PromptVqaPipeline as JPipe
    from sprc_tpu.models.qformer import QFormerConfig
    from sprc_tpu.models.t5 import T5Config, T5ForConditionalGeneration, t5_params_from_hf
    from sprc_tpu.models.vit import ViTConfig
    from sprc_tpu.text.tokenizer import BertWordPieceTokenizer as JBert

    jv, jq = ViTConfig(**{**VIT, "dtype": jnp.float32}), QFormerConfig(**TXT)
    itm = BlipITM(BlipRetrievalConfig(image_size=IMG, embed_dim=8, vocab_size=len(VOCAB),
                                      vit_dtype=jnp.float32, vit_config_override=jv,
                                      text_config_override=jq))
    cap = BlipCaption(BlipCaptionConfig(image_size=IMG, vocab_size=len(VOCAB),
                                        vit_dtype=jnp.float32, vit_config_override=jv,
                                        text_config_override=jq))
    vocab = {w: i for i, w in enumerate(VOCAB)}
    return JPipe(itm_model=itm, itm_params=blip_retrieval_params_from_torch(sd[0], itm),
                 cap_model=cap, cap_params=blip_caption_params_from_torch(sd[1], cap),
                 qa_model=T5ForConditionalGeneration(T5Config(**T5, gated_act=False,
                                                              tie_word_embeddings=True)),
                 qa_params=jnp_tree(t5_params_from_hf(sd[2], num_layers=2, num_decoder_layers=2,
                                                      gated_act=False, tie_word_embeddings=True)),
                 tokenizer=JBert(vocab, extra_special_tokens=["[DEC]"]),
                 qa_tokenizer=qa_tokenizer)


@pytest.fixture(scope="module")
def pipes():
    """(the JAX Img2PromptVqaPipeline, the port's) over the same tiny
    weights: the towers as in test_torch_pnp_vqa.py, and a plain T5 v1.0 from
    ``plain_t5`` (its dense weights and embeddings times 4, its pad row
    shrunk, so that the beams neither echo the start token nor tie),
    read by ``t5_params_from_hf`` and back through ``plain_t5_from_jax``."""
    from sprc_tpu_torch.models.pnp_vqa import Img2PromptVqaPipeline, plain_t5
    from sprc_tpu_torch.text.tokenizer import BertWordPieceTokenizer

    blip = dict(vit_config_override=VIT, text_config_override=TXT)
    qg = plain_t5({"t5_model": "t5-large", **T5}, device="cpu", seed=9)
    assert (qg.cfg.gated_act, qg.cfg.tie_word_embeddings) == (False, True)
    with torch.no_grad():
        for name, p in qg.named_parameters():
            if "layer_norm" not in name:
                p.mul_(4.0)
        qg.shared.weight[0].mul_(0.05)
    port = [port_model("blip_image_text_matching", "large", 0, embed_dim=8, **blip),
            port_model("blip_caption", "large_coco", 1, **blip), qg]
    jpipe = _jax_pipeline([numpy_state(m) for m in port], IdTokenizer())
    bridged = plain_t5_from_jax(jpipe.qa_params)
    assert sorted(bridged) == sorted(qg.state_dict())
    assert all(torch.equal(bridged[k], v) for k, v in qg.state_dict().items())
    pipe = Img2PromptVqaPipeline(*port, tokenizer=BertWordPieceTokenizer(
        {w: i for i, w in enumerate(VOCAB)}, extra_special_tokens=["[DEC]"]),
        qa_tokenizer=IdTokenizer())
    return jpipe, pipe


def test_pos_tagger_equals_jax():
    """text/pos.py on a caption corpus (entities, numbers, sentence-initial
    capitals, lowercase gazetteer words, an empty caption): every function
    gives the original's output."""
    from sprc_tpu.text import pos as jpos

    from sprc_tpu_torch.text import pos

    for cap in CAPTIONS:
        words = pos.tokenize(cap)
        assert words == jpos.tokenize(cap)
        assert pos.tag(words) == jpos.tag(words) and pos.tag_text(cap) == jpos.tag_text(cap)
        tagged = pos.tag_text(cap)
        assert pos.noun_chunks(tagged) == jpos.noun_chunks(tagged)
        assert pos.entities(words) == jpos.entities(words)
        assert pos.answer_candidates(cap) == jpos.answer_candidates(cap)
        assert pos.pos_of_last_word(cap) == jpos.pos_of_last_word(cap)
    assert pos.OPEN_POS == jpos.OPEN_POS
    assert "Barack Obama" in pos.answer_candidates(CAPTIONS[3])


def test_answer_extraction_equals_jax():
    """``answer_extraction``: the contexts, the answers (counted, stably
    sorted, "." added, cut to ``num_question_generation``, "yes." last) and
    the answer -> captions map, with the bundled tagger and an injected one,
    on several caption groups (none among them)."""
    from sprc_tpu.models.pnp_vqa import Img2PromptVqaPipeline as JPipe

    from sprc_tpu_torch.models.pnp_vqa import Img2PromptVqaPipeline

    def blank(cls, tagger):
        obj = cls.__new__(cls)
        obj.tagger = tagger
        return obj

    def words(caption):
        return [w for w in caption.split() if len(w) > 2]

    groups = [CAPTIONS[:2], CAPTIONS[2:9], CAPTIONS, [], ["a man", "A man", "a MAN"]]
    for tagger in (None, words):
        jp, p = blank(JPipe, tagger), blank(Img2PromptVqaPipeline, tagger)
        for group in groups:
            for n in (30, 3):
                got = p.answer_extraction(group, num_question_generation=n)
                assert got == jp.answer_extraction(group, num_question_generation=n)
    contexts, answers, ans_to_cap = blank(Img2PromptVqaPipeline, None).answer_extraction(
        CAPTIONS[:2])
    assert answers[0] == "man." and answers[-1] == "yes." and ans_to_cap["man"] == [0, 1]
    assert contexts[0].startswith("answer: man.  context: ")


def _beam_fns(table, shift):
    """One cached step in both frameworks: the logits of a row are
    ``table[tok] + shift[state % 5]``, its state the sum of its tokens (so
    that the state must follow the chosen beams)."""
    jt, js = jnp.asarray(table), jnp.asarray(shift)

    def jstep(tok, pos, state):
        state = state + tok
        return jt[tok] + js[state % 5], state

    tt, ts = t(table), t(shift)

    def step(tok, pos, state):
        state = state + tok
        return tt[tok] + ts[state % 5], state

    return jstep, step


def test_cached_beam_loop_equals_jax():
    """``cached_beam_loop`` against JAX's on the same logits function: the
    best ids of each item, with ties in the logits (several tokens of equal
    logit in every row: the lower index goes first in both), finished beams
    padding on, ``min_new_tokens`` and the length penalty, 1 to 4 beams."""
    from sprc_tpu.models.generation import cached_beam_loop as jbeam

    from sprc_tpu_torch.models.generation import cached_beam_loop

    rs = np.random.RandomState(5)
    V = 14
    table = rs.randint(0, 4, (V, V)).astype(np.float32)  # ties in every row
    table[:, 1] = rs.choice([0.0, 3.0, 5.0], V)  # eos
    shift = rs.randint(0, 3, (5, V)).astype(np.float32) * 0.5
    jstep, step = _beam_fns(table, shift)
    seen_tie = False
    for K, B, kw in ((3, 2, {}), (3, 3, dict(min_new_tokens=4)),
                     (2, 2, dict(length_penalty=0.5)), (4, 1, dict(length_penalty=2.0)),
                     (1, 2, {})):
        start = rs.randint(2, V, B)
        logits0 = np.repeat(table[start], K, axis=0)
        seen_tie |= any(len(set(row.tolist())) < V for row in logits0)
        state0 = np.repeat(start, K)
        common = dict(num_beams=K, eos_token_id=1, pad_token_id=0, max_new_tokens=9, **kw)
        want = np.asarray(jbeam(jnp.asarray(logits0), jnp.asarray(state0, jnp.int32),
                                jnp.ones(B * K, jnp.int32), jstep,
                                lambda s, rows: s[rows], **common))
        got = cached_beam_loop(t(logits0), t(state0), torch.ones(B * K, dtype=torch.long), step,
                               lambda s, rows: s[rows], **common).numpy()
        assert got.shape == (B, 9)
        np.testing.assert_array_equal(got, want, err_msg=str((K, B, kw)))
    assert seen_tie


def test_question_generation_equals_jax(pipes):
    """``forward_qa_generation`` on bridged T5 weights: the same questions
    (KV-cached beam search, 3 beams, batches of 10 contexts and a last short
    one), answers and map as the JAX pipeline's; ``qg_beam_search`` without
    the cache gives the cached ids."""
    from sprc_tpu_torch.models.pnp_vqa import qg_beam_search

    jpipe, pipe = pipes
    captions = CAPTIONS[:6]
    stats = {}
    got = pipe.forward_qa_generation(captions, stats=stats)
    want = jpipe.forward_qa_generation(captions)
    assert got == want
    assert len(got["questions"]) == len(got["answers"]) > 10
    assert len(set(got["questions"])) > 1 and all(got["questions"])
    assert {"qg_encode_s", "qg_decode_s", "qg_steps"} <= set(stats)
    contexts = pipe.answer_extraction(captions)[0][:10]
    ids, mask = pipe._ids(pipe.qa_tokenizer(contexts, max_length=128))
    with torch.no_grad():
        enc = pipe.qa_model.encode_ids(ids, mask)
        kw = dict(num_beams=3, pad_id=0, eos_id=1, max_length=30)
        cached = qg_beam_search(pipe.qa_model, enc, mask, **kw)
        again = qg_beam_search(pipe.qa_model, enc, mask, use_cache=False, **kw)
    assert torch.equal(cached, again)
    assert [pipe.qa_tokenizer.decode(r) for r in cached.numpy()] == got["questions"][:10]


def _p_match(pipe, jpipe, image, group):
    """The ITM match probabilities of ``group`` against ``image``, the port's
    and the JAX pipeline's (its filter's own calls)."""
    ids, mask = pipe._ids(pipe.tokenizer(group, max_length=35, enc_token=True))
    with torch.no_grad():
        rows = pipe.itm_model.encode_image(t(image[None]))
        got = pipe.itm_model.itm_embeds(ids, mask, rows.expand(len(group), -1, -1)).numpy()
    enc = jpipe.tokenizer(group, max_length=35, enc_token=True)
    jrows = jpipe.itm_model.apply({"params": jpipe.itm_params}, jnp.asarray(image[None]),
                                  method=lambda m, im: m.visual_encoder(im))
    want = np.asarray(jpipe.itm_model.apply(
        {"params": jpipe.itm_params}, jnp.asarray(enc["input_ids"]),
        jnp.asarray(enc["attention_mask"]), jnp.broadcast_to(jrows, (len(group),) + jrows.shape[1:]),
        method=jpipe.itm_model.itm_embeds))
    return got, want


def test_itm_filter_keeps_what_jax_keeps(pipes, monkeypatch):
    """The caption filter over given captions (PNP-VQA's sampling patched in
    both packages to return them): the match probabilities within 1e-5; at a
    threshold between them the JAX filter's kept captions, and at every
    threshold between them (none within 1e-5 of one), 0 and 1 the captions
    that JAX's probabilities keep, in order, an image without captions left
    empty."""
    from sprc_tpu.models import pnp_vqa as jpnp

    from sprc_tpu_torch.models import pnp_vqa

    jpipe, pipe = pipes
    images = np.random.RandomState(6).rand(3, IMG, IMG, 3).astype(np.float32)
    groups = [CAPTIONS[:8], [], CAPTIONS[8:16]]  # one size: one set of JAX compiles
    p = [_p_match(pipe, jpipe, images[b], g) for b, g in enumerate(groups) if g]
    for got, want in p:
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    values = np.sort(np.concatenate([got for got, _ in p]))
    mids = [float(v) for v in (values[1:] + values[:-1]) / 2 if np.abs(values - v).min() > TOL]
    assert len(mids) > 5
    monkeypatch.setattr(pnp_vqa.PnpVqaPipeline, "forward_cap", lambda *a, **kw: groups)
    monkeypatch.setattr(jpnp.PnpVqaPipeline, "forward_cap", lambda *a, **kw: groups)
    cut = mids[len(mids) // 2]
    pipe.itm_filter_threshold = jpipe.itm_filter_threshold = cut
    kept = pipe.forward_cap(None, t(images), None)
    assert kept == jpipe.forward_cap(None, images, None)
    sizes = set()
    for cut in [0.0, 1.0] + mids:  # against the captions JAX's probabilities keep
        pipe.itm_filter_threshold = cut
        kept = pipe.forward_cap(None, t(images), None)
        wants = iter(want for _, want in p)
        assert kept == [[c for c, q in zip(g, next(wants)) if q >= cut] if g else []
                        for g in groups], cut
        sizes.add(sum(map(len, kept)))
    pipe.itm_filter_threshold = jpipe.itm_filter_threshold = 0.5
    assert len(sizes) == len(mids) + 2 and kept[1] == []


def test_prompts_construction_equals_jax():
    """The context and task prompts and the whole prompt on samples of
    random answers, maps (answers without a caption, captions past the list)
    and questions, at several ``num_caps_per_img``."""
    from sprc_tpu.models.pnp_vqa import Img2PromptVqaPipeline as JPipe

    from sprc_tpu_torch.models.pnp_vqa import Img2PromptVqaPipeline

    rs = np.random.RandomState(7)
    jp, p = JPipe.__new__(JPipe), Img2PromptVqaPipeline.__new__(Img2PromptVqaPipeline)
    for n_caps in (1, 4, 9):
        captions = [" ".join(rs.choice(CAPTIONS[0].split(), 3)) for _ in range(n_caps)]
        answers = [f"w{rs.randint(12)}." for _ in range(rs.randint(1, 8))] + ["yes."]
        ans_to_cap = {a[:-1]: sorted(set(rs.randint(0, n_caps + 2, rs.randint(1, 4)).tolist()))
                      for a in answers if rs.rand() < 0.7}
        sample = {"captions": captions, "answers": answers, "ans_to_cap_dict": ans_to_cap,
                  "questions": [f"q{i}?" for i in range(len(answers))],
                  "text_input": "what is it?"}
        for num in (1, 3, 30):
            assert p.create_context_prompt(sample, num) == jp.create_context_prompt(sample, num)
            assert p.create_task_prompt(sample, num) == jp.create_task_prompt(sample, num)
            assert p.prompts_construction(sample, num_caps_per_img=num) == \
                jp.prompts_construction(sample, num_caps_per_img=num)
        assert p.prompts_construction(sample).endswith("Question:what is it?\nAnswer:")


def test_predict_prompts_with_given_captions(pipes, monkeypatch):
    """``predict_prompts`` on two images and questions, the sampled captions
    given to both pipelines (their draws differ) and the JAX GradCAM maps
    the port's: the rest (the ITM filter, answer extraction, question
    generation in batches of 10 and 1, the prompt) gives the same prompts;
    the port's stages are timed."""
    from sprc_tpu.models import pnp_vqa as jpnp

    from sprc_tpu_torch.models import pnp_vqa

    jpipe, pipe = pipes
    images = np.random.RandomState(8).rand(2, IMG, IMG, 3).astype(np.float32)
    questions = ["what color is the dress?", "is it a dog"]
    groups = [CAPTIONS[:7], CAPTIONS[9:2:-1]]
    kw = dict(block_num=1, num_captions=4, num_patches=2, cap_max_length=8)
    cams = pipe.forward_itm(t(images), questions, block_num=1)
    monkeypatch.setattr(jpnp.PnpVqaPipeline, "forward_itm", lambda *a, **kw: cams)
    for cls in (jpnp.PnpVqaPipeline, pnp_vqa.PnpVqaPipeline):
        monkeypatch.setattr(cls, "forward_cap", lambda *a, **kw: groups)
    jpipe.itm_filter_threshold = pipe.itm_filter_threshold = 0.0
    want = jpipe.predict_prompts(images, questions, **kw)
    stats = {}
    got = pipe.predict_prompts(images, questions, stats=stats, **kw)
    jpipe.itm_filter_threshold = pipe.itm_filter_threshold = 0.5
    assert got == want and len(got) == 2
    assert all(g.startswith("Please reason the answer") for g in got)
    assert got[1].endswith("Question:is it a dog\nAnswer:")
    assert {"tower_s", "gradcam_s", "itm_filter_s", "qg_encode_s", "qg_decode_s",
            "qg_steps"} <= set(stats)


def test_evaluate_cli_img2prompt_as_jax(tmp_path, monkeypatch, capsys):
    """Both CLIs on a tiny ``img2prompt_vqa`` YAML (the question generator a
    plain T5, ``arch: t5``; the YAML's threshold 0.5) over 3 questions in
    batches of 2, the captions read in one FiD context. The port's pipeline
    comes from ``load_model`` (its T5 the ``plain_t5`` of seed + 2); the JAX
    CLI's pipeline has the port's weights, GradCAM maps and sampled captions,
    and filters the captions and answers from them itself: the same kept
    captions, result file and metric JSON. ``load_model`` passes an injected
    ``tagger`` and ``qa_tokenizer`` on to the pipeline."""
    from sprc_tpu.cli import evaluate as jevaluate
    from sprc_tpu.models import pnp_vqa as jpnp
    from sprc_tpu.text.llm_tokenizers import WhitespaceTokenizer

    from sprc_tpu_torch.cli import evaluate
    from sprc_tpu_torch.models import pnp_vqa

    ann, images = _write_split(tmp_path, n=3)
    cfg = _pnp_config(ann, images)
    cfg["run"]["num_captions_fid"] = 3  # one FiD context a question: one JAX compile
    cfg["model"].update(arch="img2prompt_vqa", question_answering_model={
        "arch": "t5", "t5_model": "t5-large", **T5})
    cfg_path = tmp_path / "img2prompt.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    argv = ["--cfg-path", str(cfg_path), "--vocab-path", str(tmp_path / "vocab.txt")]
    port = {"pipe": [], "cams": [], "caps": [], "kept": []}
    real = {"itm": pnp_vqa.PnpVqaPipeline.forward_itm, "cap": pnp_vqa.PnpVqaPipeline.forward_cap,
            "filter": pnp_vqa.Img2PromptVqaPipeline.forward_cap}

    def keep(key, fn):
        def wrapped(self, *a, **kw):
            port["pipe"].append(self)
            out = fn(self, *a, **kw)
            port[key].append(out)
            return out
        return wrapped

    monkeypatch.setattr(pnp_vqa.PnpVqaPipeline, "forward_itm", keep("cams", real["itm"]))
    monkeypatch.setattr(pnp_vqa.PnpVqaPipeline, "forward_cap", keep("caps", real["cap"]))
    monkeypatch.setattr(pnp_vqa.Img2PromptVqaPipeline, "forward_cap",
                        keep("kept", real["filter"]))
    evaluate.main(argv + ["--output-dir", str(tmp_path / "port"), "--device", "cpu"])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    pipe = port["pipe"][0]
    assert isinstance(pipe, pnp_vqa.Img2PromptVqaPipeline) and pipe.itm_filter_threshold == 0.5
    qg = pnp_vqa.plain_t5({"t5_model": "t5-large", **T5}, device="cpu", seed=42 + 2)
    assert all(torch.equal(v, qg.state_dict()[k]) for k, v in pipe.qa_model.state_dict().items())
    assert len(port["kept"]) == 2 and any(k != c for k, c in zip(port["kept"], port["caps"]))

    sd = [numpy_state(m) for m in (pipe.itm_model, pipe.cap_model, pipe.qa_model)]
    cams, caps, jkept = iter(port["cams"]), iter(port["caps"]), []
    real_filter = jpnp.Img2PromptVqaPipeline.forward_cap
    monkeypatch.setattr(jpnp.PnpVqaPipeline, "from_config", classmethod(
        lambda cls, mcfg, **kw: _jax_pipeline(sd, WhitespaceTokenizer())))
    monkeypatch.setattr(jpnp.PnpVqaPipeline, "forward_itm", lambda *a, **kw: next(cams))
    monkeypatch.setattr(jpnp.PnpVqaPipeline, "forward_cap", lambda *a, **kw: next(caps))
    monkeypatch.setattr(jpnp.Img2PromptVqaPipeline, "forward_cap",
                        lambda *a, **kw: jkept.append(real_filter(*a, **kw)) or jkept[-1])
    jevaluate.main(argv + ["--output-dir", str(tmp_path / "jax")])
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got == want and "agg_metrics" in got
    assert jkept == port["kept"]
    name = "val_vqa_result.json"
    assert (tmp_path / "port" / "result" / name).read_text() == \
        (tmp_path / "jax" / "result" / name).read_text()

    # load_model passes a tagger and a reader tokenizer on, as sprc_tpu.loader does
    from sprc_tpu_torch import loader
    from sprc_tpu_torch.text.llm_tokenizers import WhitespaceTokenizer as PortTokenizer

    def tagger(caption):
        return caption.split()[-1:]

    tok = PortTokenizer()
    built = loader.load_model("img2prompt_vqa", "base", device="cpu", tagger=tagger,
                              qa_tokenizer=tok, vocab_path=str(tmp_path / "vocab.txt"),
                              **{k: v for k, v in cfg["model"].items() if k.endswith("_model")})
    assert built.tagger is tagger and built.qa_tokenizer is tok
    assert built.answer_extraction(["a man with a hat"])[1] == ["hat.", "yes."]
