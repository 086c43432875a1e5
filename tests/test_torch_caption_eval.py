"""The caption evaluation's host pieces against sprc_tpu's: the copied
metrics (``retrieval/caption_eval.py``), the whitespace tokenizer and the
LLM presets pinned equal, ``cached_greedy_loop`` against JAX's on one fixed
step function (``min_new_tokens``, finished rows, pads, the early exit),
``eval_loader``'s padding and ``collate_eval``, ``CaptionTask``'s result
file and metrics, and the stage-2 heads' ``MODEL_CONFIGS`` rows against
what ``sprc_tpu.loader`` builds from configs/models/{blip2_opt,blip2_t5}.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from test_torch_threads import one_torch_thread  # noqa: E402,F401  (one thread a module)

WORDS = ["a", "dog", "cat", "on", "the", "red", "car", "two", "man", "sits", "near", "tree"]


def _captions(rng, n, refs):
    def cap():
        return " ".join(rng.choice(WORDS, rng.randint(1, 9)))
    return [cap() for _ in range(n)], [[cap() for _ in range(refs)] for _ in range(n)]


def test_caption_metrics_equal_jax():
    from sprc_tpu.retrieval import caption_eval as jce

    from sprc_tpu_torch.retrieval import caption_eval as ce

    rng = np.random.RandomState(9)
    for n, refs in ((1, 1), (7, 5), (40, 3)):
        cands, references = _captions(rng, n, refs)
        cands[0] = references[0][0]  # one exact hit
        assert ce.corpus_bleu(cands, references) == jce.corpus_bleu(cands, references)
        assert ce.cider_d(cands, references) == jce.cider_d(cands, references)
        got = ce.caption_metrics(cands, references)
        assert got == jce.caption_metrics(cands, references)
        assert got["agg_metrics"] == got["CIDEr"] + got["Bleu_4"]
        assert (got["CIDEr"] > 0) == (n > 1)  # one image: every idf is 0


def test_whitespace_tokenizer_equals_jax():
    from sprc_tpu.text.llm_tokenizers import WhitespaceTokenizer as J

    from sprc_tpu_torch.text.llm_tokenizers import WhitespaceTokenizer

    texts = ["a photo of", "two red cars near a tree on the street", "", "x " * 40]
    for vocab in (12, 76, 512):  # 12: more words than slots, the probe wraps
        a, b = J(vocab_size=vocab), WhitespaceTokenizer(vocab_size=vocab)
        for length in (4, 16):
            ja, pb = a(texts, max_length=length), b(texts, max_length=length)
            for key in ("input_ids", "attention_mask"):
                assert ja[key].dtype == pb[key].dtype
                np.testing.assert_array_equal(ja[key], pb[key])
            assert [a.decode(r) for r in ja["input_ids"]] == [b.decode(r) for r in pb["input_ids"]]


def test_presets_and_llm_keys_equal_jax():
    from sprc_tpu.loader import GENERATION_KEYS as JKEYS
    from sprc_tpu.models import llm_presets as jp

    from sprc_tpu_torch.loader import GENERATION_KEYS
    from sprc_tpu_torch.models import llm_presets as p

    assert GENERATION_KEYS == JKEYS
    assert {k: v[0] for k, v in p.LLM_KEYS.items()} == {k: v[0] for k, v in jp.LLM_KEYS.items()}
    names = {"t5": ["google/flan-t5-small", "google/flan-t5-base", "flan-t5-large",
                    "google/flan-t5-xl", "google/flan-t5-xxl", "t5-base", "t5-large", "t5-3b",
                    "allenai/unifiedqa-v2-t5-base-1363200"],
             "opt": ["facebook/opt-125m", "facebook/opt-1.3b", "facebook/opt-2.7b",
                     "facebook/opt-6.7b"],
             "llama": ["lmsys/vicuna-7b-v1.1", "vicuna-7b", "lmsys/vicuna-13b-v1.1",
                       "vicuna-13b", "llama-7b", "huggyllama/llama-13b"]}
    for kind, resolve, jresolve in (("t5", p.t5_preset, jp.t5_preset),
                                    ("opt", p.opt_preset, jp.opt_preset),
                                    ("llama", p.llama_preset, jp.llama_preset)):
        for name in names[kind]:
            got, want = resolve(name), jresolve(name)
            fields = {f.name for f in dataclasses.fields(want)} - {"dtype"}
            assert {f.name for f in dataclasses.fields(got)} - {"dtype"} == fields
            assert {k: getattr(got, k) for k in fields} == {k: getattr(want, k) for k in fields}
            assert got.dtype == torch.float32 and jnp.dtype(want.dtype) == jnp.float32
        with pytest.raises(KeyError, match="unknown"):
            resolve({"opt": "facebook/opt-13b", "t5": "t5-11b", "llama": "llama-65b"}[kind])
    assert p.LLM_KEYS["llm_model"][1]("lmsys/vicuna-7b-v1.1").vocab_size == 32001


V, B, EOS, PAD = 11, 4, 3, 0


def _table():
    rng = np.random.RandomState(12)
    return rng.randn(V, V).astype(np.float32), rng.randn(40, V).astype(np.float32) * 0.5


@pytest.mark.parametrize("cases", [[(0, 9), (3, 9)], [(0, 1), (2, 16)]],
                         ids=["min_new_tokens", "one_token_and_early_exit"])
def test_cached_greedy_loop_equals_jax(cases):
    """One fixed step function (logits of the next position from the token
    and the position) through both loops, at each (min_new_tokens,
    max_new_tokens): the same ids, the eos suppressed before
    ``min_new_tokens``, finished rows padded, the early exit."""
    from sprc_tpu.models.generation import cached_greedy_loop as jloop

    from sprc_tpu_torch.models.generation import cached_greedy_loop

    tok_t, pos_t = _table()
    tok_t[:, EOS] += np.linspace(-2.0, 3.0, V)  # rows finish at different steps
    pos_t[9:, EOS] = 20.0  # and every row by its position 9
    logits0 = np.random.RandomState(13).randn(B, V).astype(np.float32)
    logits0[0, EOS] = 9.0  # row 0's first pick is eos (suppressed while min_new_tokens)
    pos0 = np.arange(B, dtype=np.int32) + 2
    jt, jp = jnp.asarray(tok_t), jnp.asarray(pos_t)
    tt, tp = torch.from_numpy(tok_t), torch.from_numpy(pos_t)

    def jstep(tok, pos, cache):
        return jt[tok] + jp[pos], cache + 1

    for min_new, max_new in cases:
        want = np.asarray(jloop(jnp.asarray(logits0), jnp.zeros((), jnp.int32),
                                jnp.asarray(pos0), jstep, eos_token_id=EOS, pad_token_id=PAD,
                                max_new_tokens=max_new, min_new_tokens=min_new))
        calls = []

        def step(tok, pos, cache):
            calls.append(1)
            return tt[tok] + tp[pos], cache + 1

        got = cached_greedy_loop(torch.from_numpy(logits0), 0, torch.from_numpy(pos0).long(),
                                 step, eos_token_id=EOS, pad_token_id=PAD,
                                 max_new_tokens=max_new, min_new_tokens=min_new)
        assert got.dtype == torch.long
        np.testing.assert_array_equal(got.numpy(), want)
        assert len(calls) <= max_new - 1
        if min_new:
            assert (got.numpy()[:, :min_new] != EOS).all()
        else:
            assert got[0, 0] == EOS and (got[0, 1:] == PAD).all()
        if max_new == 16:  # every row finished: the loop stopped at a readback
            assert (want == EOS).any(axis=1).all() and len(calls) < max_new - 1


def test_eval_loader_padding_and_collate_equal_jax():
    from sprc_tpu.train.eval_glue import collate_eval as jcollate, eval_loader as jloader

    from sprc_tpu_torch.train.eval_glue import collate_eval, eval_loader

    rng = np.random.RandomState(14)
    data = [{"image": rng.rand(3, 3, 3).astype(np.float32), "image_id": i,
             "instance_id": str(i)} for i in range(11)]
    got, want = list(eval_loader(data, 4)), list(jloader(data, 4))
    assert [i for i, _ in got] == [i for i, _ in want] == [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9, 10]]
    for (_, items), (_, jitems) in zip(got, want):
        assert len(items) == 4 and items == jitems
        a, b = collate_eval(items), jcollate(jitems)
        assert a.keys() == b.keys() and a["image_id"] == b["image_id"]
        np.testing.assert_array_equal(a["image"], b["image"])
    assert [it["image_id"] for it in got[-1][1]] == [8, 9, 10, 10]


def test_caption_task_result_file_and_metrics_equal_jax(tmp_path):
    """valid_step over a stub glue, after_evaluation with repeated image ids
    and an image without ground truth: the same result file, metrics and
    evaluate.txt line."""
    from sprc_tpu.train.eval_tasks import CaptionTask as J

    from sprc_tpu_torch.registry import registry
    from sprc_tpu_torch.train.eval_tasks import CaptionTask

    assert registry.get("task", "captioning") is CaptionTask
    rng = np.random.RandomState(15)
    cands, refs = _captions(rng, 6, 4)
    gt = {i: refs[i] for i in range(5)}  # image 5 has none
    seen = []

    def glue(samples, *, num_beams, max_length, min_length):
        seen.append((num_beams, max_length, min_length))
        return [cands[i] for i in samples["image_id"]]

    outs = []
    for cls, sub in ((J, "jax"), (CaptionTask, "port")):
        task = cls(num_beams=1, max_len=7, min_len=2, output_dir=str(tmp_path / sub))
        rows = task.valid_step(glue, {"image_id": [0, 1, 2, 3]})
        rows += task.valid_step(glue, {"image_id": [3, 4, 5, 5]})
        metrics = task.after_evaluation(rows, "test", ground_truth=gt)
        result = json.loads((tmp_path / sub / "result" / "test_epochx.json").read_text())
        log = (tmp_path / sub / "evaluate.txt").read_text()
        outs.append((metrics, result, log))
    assert outs[0] == outs[1]
    assert [r["image_id"] for r in outs[1][1]] == [0, 1, 2, 3, 4, 5]
    assert seen == [(1, 7, 2)] * 4
    port = CaptionTask(output_dir=str(tmp_path / "none"))
    assert port.after_evaluation(rows, "val") == {"agg_metrics": 0.0}


ROWS = [("blip2_opt", t) for t in ("pretrain_opt2.7b", "pretrain_opt6.7b", "caption_coco_opt2.7b",
                                   "caption_coco_opt6.7b")] + \
       [("blip2_t5", t) for t in ("pretrain_flant5xl", "pretrain_flant5xl_vitL",
                                  "pretrain_flant5xxl", "caption_coco_flant5xl")] + \
       [("blip2_t5_instruct", t) for t in ("flant5xl", "flant5xxl")]


def test_stage2_model_configs_equal_the_jax_yaml():
    """Every stage-2 row of MODEL_CONFIGS against what sprc_tpu.loader
    builds from configs/models/<name>/<type>.yaml: the CirConfig fields, the
    tower, and the LLM config the preset resolves."""
    pytest.importorskip("yaml")
    from sprc_tpu.loader import build_model as jbuild

    from sprc_tpu_torch import loader

    assert sorted(k for k in loader.MODEL_CONFIGS if k[0] in loader.LLM_HEADS) == sorted(ROWS)
    for name, model_type in ROWS:
        jm = jbuild(name, model_type)
        jcfg, cfg = jm.cfg, loader.model_config(name, model_type)
        for f in ("vit_model", "image_size", "num_query_token", "cross_attention_freq",
                  "embed_dim", "max_txt_len", "vocab_size", "freeze_vit"):
            assert getattr(cfg, f) == getattr(jcfg, f), (name, model_type, f)
        assert str(cfg.vit_dtype).split(".")[-1] == jnp.dtype(jcfg.vit_dtype).name
        assert str(cfg.qformer_dtype).split(".")[-1] == jnp.dtype(jcfg.qformer_dtype).name
        jv, v = jcfg.vit_config(), cfg.vit_config()
        for f in ("image_size", "width", "depth", "num_heads", "mlp_hidden", "seq_len"):
            assert getattr(v, f) == getattr(jv, f), (name, model_type, f)
        (field, llm), = loader.llm_config(name, model_type).items()
        jllm = getattr(jm, field)
        fields = {f.name for f in dataclasses.fields(jllm)} - {"dtype"}
        assert {k: getattr(llm, k) for k in fields} == {k: getattr(jllm, k) for k in fields}
    cfg = loader.model_config("blip2_opt", "caption_coco_opt2.7b")
    assert (cfg.image_size, cfg.vit_dtype, cfg.freeze_vit) == (364, torch.float32, False)
    assert loader.llm_config("blip2_opt", "caption_coco_opt2.7b",
                             opt_config={"num_layers": 2})["opt_config"].num_layers == 2
