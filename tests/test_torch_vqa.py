"""Zero-shot VQA of the BLIP-2 LLM heads (retrieval/vqa_eval.py,
text/processors.py's QuestionProcessor, data/builders.py's VQA datasets,
train/eval_tasks.py's VQA tasks, train/eval_glue.py's
make_blip2_vqa_predict_fn, cli/evaluate.py's vqa / gqa / aok_vqa branch)
against sprc_tpu's.

The framework-free parts are pinned equal to the JAX modules on fixed
inputs: the answer normalisation and the ten-answer accuracy, the question
processor, the items of the five VQA builders, the three tasks' result
files and metrics (a leaderboard split without ground truth included). Then
both evaluate CLIs run configs shaped as
configs/runs/eval/vqav2_zeroshot_opt_eval.yaml (``blip2_opt``, ``vqa``) and
gqa_zeroshot_flant5xl_eval.yaml (``blip2_t5``, ``gqa``) over 5 synthetic
questions (``batch_size_eval`` 2: the last batch padded) on the instruct
CLI's tiny heads and the same weights, as test_torch_caption_cli.py runs the
caption task: the same metric JSON and result file.
"""

import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
yaml = pytest.importorskip("yaml")

from sprc_tpu_torch.interop.jax_params import state_dict_from_jax  # noqa: E402
from test_torch_caption_cli import IMG, LLM, Q, QF, VIT, VOCAB, WORDS, _jax_params  # noqa: E402
from test_torch_threads import one_torch_thread  # noqa: E402,F401  (one thread a module)

ANSWERS = ["It's a dog.", "three, maybe four", "none", "a red car!", "isnt it", "10,000 dollars",
           "left/right", "What?  YES", "two", "the 2 cats", "Ten\tapples\n", "x-ray", "3.5"]


def test_vqa_eval_equals_jax():
    """The normalisation tables, each step of the normalisation and the
    official accuracy (ten answers a question, per question and answer
    type) equal the JAX module's."""
    from sprc_tpu.retrieval import vqa_eval as jv

    from sprc_tpu_torch.retrieval import vqa_eval as v

    for name in ("CONTRACTIONS", "MANUAL_MAP", "ARTICLES", "PUNCT"):
        assert getattr(v, name) == getattr(jv, name), name
    for text in ANSWERS:
        assert v.process_punctuation(text) == jv.process_punctuation(text), text
        assert v.process_digit_article(text) == jv.process_digit_article(text), text
        assert v.normalize_answer(text) == jv.normalize_answer(text), text
    rng = np.random.RandomState(5)
    anns, results = [], {}
    for qid in range(24):
        pool = rng.choice(ANSWERS + ["red", "blue", "2", "two"], 4)
        anns.append({"question_id": qid, "answers": [{"answer": str(rng.choice(pool))}
                                                     for _ in range(10)],
                     "question_type": f"q{qid % 3}", "answer_type": ["yes/no", "number",
                                                                     "other"][qid % 3]})
        results[qid] = str(rng.choice(pool))
    got, want = v.VQAEval(), jv.VQAEval()
    assert got.evaluate(results, anns) == want.evaluate(results, anns)
    assert got.eval_qa == want.eval_qa and 0.0 < got.accuracy["overall"] < 100.0


def _write_vqa(root, n=5, seed=30):
    """``n`` PNG images and VQA annotations with every key the five builders
    read (ten answers, a question id, GQA's answer, AOKVQA's direct answers)."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    (root / "imgs").mkdir(exist_ok=True)
    ann = []
    for i in range(n):
        name = f"q{i:02d}.png"
        h, w = 24 + 7 * (i % 3), 36 - 5 * (i % 2)
        Image.fromarray((rng.rand(h, w, 3) * 255).astype(np.uint8)).save(root / "imgs" / name)
        words = [str(w) for w in rng.choice(WORDS, 3)]
        ann.append({"image": name, "question": f"What is the {words[0]}, {words[1]}?!",
                    "question_id": 500 + i,
                    "answers": [{"answer": str(rng.choice(words))} for _ in range(10)],
                    "answer": [str(rng.choice(words))], "direct_answers": list(words),
                    "question_type": "what is", "answer_type": "other"})
    path = root / "vqa.json"
    path.write_text(json.dumps(ann))
    return str(path), str(root / "imgs")


def test_question_processor_and_vqa_items_equal_jax(tmp_path):
    """``blip_question`` and the train / eval items of coco_vqa, ok_vqa,
    aok_vqa, gqa and vg_vqa equal the JAX builders' on the same files (a
    string answer, and weights given and derived, among them)."""
    from sprc_tpu.registry import registry as jregistry
    from sprc_tpu.text.processors import QuestionProcessor as JQ

    import sprc_tpu.data.builders  # noqa: F401  (registers them)
    import sprc_tpu.data.processors  # noqa: F401  (registers them)
    from sprc_tpu_torch.data import builders  # noqa: F401  (registers them)
    from sprc_tpu_torch.registry import registry
    from sprc_tpu_torch.text.processors import QuestionProcessor

    for words in (50, 3):
        for text in ANSWERS + ["  What colour is the (big) car ? ", "Is it #1; or ~2:"]:
            assert QuestionProcessor(words)(text) == JQ(words)(text), text
    path, images = _write_vqa(tmp_path)
    ann = json.loads(open(path).read())
    ann[1]["answer"], ann[2]["weights"] = "yes", [0.5] * 10
    ann[3]["answer"] = [a["answer"] for a in ann[3].pop("answers")]
    (tmp_path / "train.json").write_text(json.dumps(ann))
    cfg = {"build_info": {"annotations": {"train": [str(tmp_path / "train.json")],
                                          "val": [path]}, "images": images},
           "vis_processor": {"train": {"name": "blip_image_eval", "image_size": IMG},
                             "eval": {"name": "blip_image_eval", "image_size": IMG}},
           "text_processor": {"train": {"name": "blip_question"},
                              "eval": {"name": "blip_question"}}}
    for name in ("coco_vqa", "ok_vqa", "aok_vqa", "gqa", "vg_vqa"):
        got = registry.get("dataset", name)(cfg).build()
        want = jregistry.get("dataset", name)(cfg).build()
        assert set(got) == set(want) == {"train", "val"}
        for split in want:
            assert len(got[split]) == len(want[split]) == 5
            for i in range(5):
                g, w = got[split][i], want[split][i]
                assert set(g) == set(w), (name, split)
                np.testing.assert_array_equal(g.pop("image"), w.pop("image"))
                assert g == w, (name, split, i)


@pytest.mark.parametrize("task_name", ["vqa", "gqa", "aok_vqa"])
def test_vqa_tasks_equal_jax(task_name, tmp_path):
    """Each task's valid_step rows, result file, metrics and evaluate.txt
    against the JAX task's, from the same answers; and on a leaderboard split
    (no ground truth): the result file, no metric. The glue sees the task's
    prompt (none for aok_vqa, as in JAX)."""
    from sprc_tpu.registry import registry as jregistry

    import sprc_tpu.train.eval_tasks  # noqa: F401  (registers them)
    from sprc_tpu_torch.registry import registry
    from sprc_tpu_torch.train import eval_tasks  # noqa: F401  (registers them)

    rng = np.random.RandomState(8)
    qids = [10, 11, 12, 11, 13]  # a repeated id: the first row is kept
    words = ["red", "two", "a cat", "2", "yes", "no"]
    samples = {"question_id": qids, "text_input": ["q"] * 5,
               "answer": [str(rng.choice(words)) for _ in qids],
               "direct_answers": [list(rng.choice(words, 4)) for _ in qids]}
    annotations = {q: {"answers": [{"answer": str(rng.choice(words))} for _ in range(10)],
                       "question_type": "what", "answer_type": ["number", "other"][q % 2]}
                   for q in qids}
    answers = ["red", "2", "A cat!", "no", "two"]
    seen = []

    def predict_fn(s, **kw):
        seen.append(kw.get("prompt"))
        return answers

    out = {}
    for side, reg in (("jax", jregistry), ("port", registry)):
        for split, gt in (("val", True), ("test", False)):
            task = reg.get("task", task_name)(
                annotations=annotations if gt else None, prompt="Question: {} Short answer:",
                output_dir=str(tmp_path / side))
            s = dict(samples) if gt else {**samples, "answer": [None] * 5,
                                          "direct_answers": [None] * 5}
            rows = task.valid_step(predict_fn, s)
            out[side, split] = (rows, task.after_evaluation(rows, split))
    assert seen[0] == seen[2] and seen[0] == (None if task_name == "aok_vqa"
                                              else "Question: {} Short answer:")
    assert out["port", "val"] == out["jax", "val"] and out["port", "val"][1]
    assert out["port", "test"] == out["jax", "test"]
    assert out["port", "test"][1] == {}
    files = sorted(p.name for p in (tmp_path / "jax" / "result").iterdir())
    assert files == sorted(p.name for p in (tmp_path / "port" / "result").iterdir())
    assert len(files) == 2
    for name in files + ["../evaluate.txt"]:
        assert (tmp_path / "port" / "result" / name).read_text() == \
            (tmp_path / "jax" / "result" / name).read_text(), name


def _vqa_config(arch, task, ann, images):
    model_type, field, llm = LLM[arch]
    ds = "coco_vqa" if task == "vqa" else task
    return {"run": {"task": task, "evaluate": True, "batch_size_eval": 2,
                    "inference_method": "generate", "prompt": "Question: {} Short answer:",
                    "max_len": 4, "min_len": 1, "test_splits": ["val"]},
            "model": {"arch": arch, "model_type": model_type, "image_size": IMG,
                      "num_query_token": Q, "max_txt_len": 6, "vocab_size": VOCAB,
                      "embed_dim": 16, "vit_dtype": "fp32", "vit_config_override": VIT,
                      "qformer_config_override": QF, field: llm},
            "datasets": {ds: {
                "build_info": {"annotations": {"val": [ann]}, "images": images},
                "vis_processor": {"eval": {"name": "blip_image_eval", "image_size": IMG}},
                "text_processor": {"eval": {"name": "blip_question"}}}}}


@pytest.mark.parametrize("arch,task", [("blip2_opt", "vqa"), ("blip2_t5", "gqa")])
def test_evaluate_cli_vqa_equals_jax(arch, task, tmp_path, monkeypatch, capsys):
    """Both evaluate CLIs on the tiny head: the same metric JSON, the same
    result file (answers from the greedy decode after the rendered
    question)."""
    from sprc_tpu.cli import evaluate as jevaluate
    from sprc_tpu.interop import torch_import

    from sprc_tpu_torch.cli import evaluate

    ann, images = _write_vqa(tmp_path)
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + WORDS + ["what", "is", "question",
                                                                      "short", "answer", ":"]
    (tmp_path / "vocab.txt").write_text("\n".join(vocab))
    cfg = _vqa_config(arch, task, ann, images)
    cfg_path = tmp_path / "vqa_eval.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    params = _jax_params(cfg)
    ckpt = tmp_path / f"{arch}.pth"
    torch.save({"model": state_dict_from_jax(params, vit="eva_clip_g")}, ckpt)
    monkeypatch.setattr(torch_import, "load_checkpoint_auto", lambda path, model: params)
    argv = ["--cfg-path", str(cfg_path), "--vocab-path", str(tmp_path / "vocab.txt"),
            "--model-path", str(ckpt)]
    jevaluate.main(argv + ["--output-dir", str(tmp_path / "jax")])
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    evaluate.main(argv + ["--output-dir", str(tmp_path / "port"), "--device", "cpu"])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got == want and "agg_metrics" in got
    name = f"val_{task}_result.json"
    rows = [json.loads((tmp_path / side / "result" / name).read_text())
            for side in ("jax", "port")]
    assert rows[0] == rows[1] and len(rows[1]) == 5
    key = "answer" if task == "vqa" else "pred_ans"
    assert any(r[key] for r in rows[1])


def test_evaluate_vqa_refuses_what_is_not_ported(tmp_path, monkeypatch):
    """No VQA glue fits ALPRO's video QA, in either package (it evaluates
    as multimodal_classification: test_torch_alpro_cli.py; BLIP-1 / ALBEF's
    VQA, once refused, runs: test_torch_blip_vqa_cli.py); ``img2prompt_vqa``
    (once refused) goes on to build its pipeline for any VQA task, whatever
    the run's ``inference_method``, as ``pnp_vqa`` does (both run:
    test_torch_pnp_vqa.py, test_torch_img2prompt.py); a
    BLIP-2 head asked for another ``inference_method`` than ``generate``
    (the run's default ``rank`` included) refuses, in the CLI and in the
    glue, as ranking is BLIP-1 / ALBEF's; and the VQA glue refuses a model
    that is not an LLM head."""
    import argparse

    from sprc_tpu_torch import loader
    from sprc_tpu_torch.cli import evaluate
    from sprc_tpu_torch.config import Config
    from sprc_tpu_torch.train.eval_glue import make_blip2_vqa_predict_fn

    args = argparse.Namespace(device="cpu", model_path=None, vocab_path=None, split=None)
    for task, arch in (("vqa", "alpro_qa"), ("aok_vqa", "alpro_qa")):
        with pytest.raises(SystemExit, match="glue fits ALPRO's video QA, in either package"):
            evaluate.evaluate(Config(defaults={"run": {"task": task},
                                               "model": {"arch": arch}}), args)
    built = []

    def load_model(name, model_type, **kw):
        built.append((name, model_type, kw["vocab_path"]))
        raise LookupError("built")

    monkeypatch.setattr(loader, "load_model", load_model)
    for task in ("gqa", "vqa", "aok_vqa"):
        with pytest.raises(LookupError, match="built"):
            evaluate.evaluate(Config(defaults={"run": {"task": task},
                                               "model": {"arch": "img2prompt_vqa",
                                                         "model_type": "base"}}), args)
    assert built == [("img2prompt_vqa", "base", None)] * 3
    monkeypatch.undo()
    for run in ({"task": "vqa", "inference_method": "rank"}, {"task": "gqa"}):
        with pytest.raises(SystemExit, match="answer generatively"):
            evaluate.evaluate(Config(defaults={"run": run, "model": {"arch": "blip2_t5"}}),
                              args)
    with pytest.raises(NotImplementedError, match="this glue is the BLIP-2 LLM heads'"):
        make_blip2_vqa_predict_fn(torch.nn.Linear(2, 2), None)
    section = _vqa_config("blip2_opt", "vqa", None, None)["model"]
    model = loader.load_model(section.pop("arch"), section.pop("model_type"), device="cpu",
                              **section)
    with pytest.raises(NotImplementedError, match="answer generatively"):
        make_blip2_vqa_predict_fn(model, None)({"text_input": ["q"]}, inference_method="rank")
