"""``cli/train.py`` and ``cli/evaluate.py`` on the dialogue's run YAMLs
against sprc_tpu's ``run_generic`` and evaluate CLI.

configs/runs/dialogue_avsd_ft.yaml and configs/runs/eval/dialogue_avsd_eval.yaml
are read as they are, with test_torch_gpt_dialogue.py's tiny GPT-2 (vocabulary
64, width 32, 2 layers) and ``len_video_ft`` 8 in the model section, and the
processors given the synthetic tokenizer (``synthetic_vocab`` 57: the seven
dialogue tokens at 57..63) and the three seeded feature streams
(``i3d_flow`` + ``i3d_rgb`` 3 wide each, ``vggish`` 2). The synthetic
tokenizer hashes words with Python's salted ``hash``, so both packages run
in this one process. Both start from one JAX init: the port reads it as a
state dict through ``--model-path``, the JAX runs are handed it as their
adapter's init. Training: 3 steps at batch 4, each step's loss within 1e-5;
evaluation: 10 items at 4 a batch (the last batch of 2 real items), the
metric within 1e-6 relative. A run whose streams are not ``len_video_ft``
wide exits before any model is built, naming both widths.
"""

import argparse
import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
yaml = pytest.importorskip("yaml")

from sprc_tpu_torch.interop.jax_params import gpt_dialogue_from_jax  # noqa: E402
from test_torch_gpt_dialogue import FT, GPT, jax_model, jax_params  # noqa: E402
from test_torch_threads import one_torch_thread  # noqa: E402,F401  (one thread a module)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
BASE_VOCAB = 57  # GPT["vocab_size"] less the seven dialogue tokens
STREAMS = {"i3d_flow": 3, "i3d_rgb": 3, "vggish": 2}
WORDS = ["a", "man", "walks", "the", "dog", "in", "park", "yes", "no", "red", "is", "there"]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """12 train and 10 val dialogues over 12 videos, whose three streams
    differ in length; a synthetic BERT vocabulary (the JAX CLIs read one)."""
    from sprc_tpu_torch.utils.artifacts import write_synthetic_bert_vocab

    root = tmp_path_factory.mktemp("avsd")
    rng = np.random.RandomState(24)
    for stream, width in STREAMS.items():
        (root / stream).mkdir()
        for v in range(12):
            frames = 4 + (v + width) % 5
            np.save(root / stream / f"v{v}.npy", rng.randn(frames, width).astype(np.float32))

    def say(n):
        return " ".join(rng.choice(WORDS, n))

    def dialogue(v):
        return {"image_id": f"v{v}", "caption": say(5), "summary": say(4), "question": say(5),
                "answer": say(int(rng.randint(2, 6))),
                "dialog": [{"question": say(4), "answer": say(3)}
                           for _ in range(int(rng.randint(1, 5)))]}

    for split, n in (("train", 12), ("val", 10)):
        (root / f"{split}.json").write_text(json.dumps([dialogue(v) for v in range(n)]))
    return {"root": str(root), "vocab": write_synthetic_bert_vocab(str(root / "vocab.txt"))}


def run_config(name, data, split, streams=("i3d_flow", "i3d_rgb"), **run):
    with open(os.path.join(ROOT, "configs", "runs", name)) as f:
        cfg = yaml.safe_load(f)
    cfg["run"].update(run)
    cfg["model"].update(gpt=dict(GPT), len_video_ft=FT)
    ds = cfg["datasets"]["avsd_dialogue"]
    ds["build_info"] = {"annotations": {split: [os.path.join(data["root"], f"{split}.json")]},
                        "videos": data["root"]}
    (vis,) = ds["vis_processor"].values()
    vis.update(visual_ft=list(streams), audio_ft=["vggish"], synthetic_vocab=BASE_VOCAB)
    (text,) = ds["text_processor"].values()
    text.update(synthetic_vocab=BASE_VOCAB)
    return cfg


def weights(tmp_path, seed):
    """A JAX init and the port's state-dict file of it."""
    params = jax_params(jax_model(), seed)
    path = str(tmp_path / "gpt_dialogue.pth")
    torch.save(gpt_dialogue_from_jax(params), path)
    return params, path


def _rows(out):
    with open(os.path.join(out, "log.jsonl")) as f:
        return [r for r in map(json.loads, f) if r["kind"] == "step"]


def test_cli_train_equals_jax(data, tmp_path, monkeypatch):
    from sprc_tpu.config import Config as JConfig
    from sprc_tpu.train import checkpoint as jcheckpoint
    from sprc_tpu.train import generic as jgeneric

    from sprc_tpu_torch.cli import train as train_cli
    from sprc_tpu_torch.config import Config

    params, ckpt = weights(tmp_path, seed=7)
    cfg = run_config("dialogue_avsd_ft.yaml", data, "train", batch_size=4, max_epochs=1,
                     log_freq=1)
    monkeypatch.setattr(jcheckpoint, "save_state", lambda path, state: None)
    monkeypatch.setattr(jgeneric.DialogueAdapter, "init_params",
                        lambda self, model, rng, size: params)

    def args(side):
        return argparse.Namespace(output_dir=str(tmp_path / side), vocab_path=data["vocab"],
                                  model_path=ckpt, device="cpu", data_path=None)

    jgeneric.run_generic(JConfig(defaults=cfg), args("jax"))
    train_cli.train(Config(defaults=cfg), args("port"))
    want, got = _rows(tmp_path / "jax"), _rows(tmp_path / "port")
    assert [r["step"] for r in got] == [r["step"] for r in want] == [0, 1, 2]
    for g, w in zip(got, want):
        assert not w["skipped_nonfinite"] and not g["skipped_nonfinite"]
        assert abs(g["loss"] - w["loss"]) <= TOL * max(1.0, abs(w["loss"])), (g, w)
    assert len({r["loss"] for r in got}) == 3  # the steps moved the weights


def test_cli_evaluate_equals_jax(data, tmp_path, monkeypatch, capsys):
    from sprc_tpu.cli import evaluate as jevaluate
    from sprc_tpu.train import generic as jgeneric

    from sprc_tpu_torch.cli import evaluate

    params, ckpt = weights(tmp_path, seed=8)
    monkeypatch.setattr(jgeneric.DialogueAdapter, "init_params",
                        lambda self, model, rng, size: params)
    path = tmp_path / "run.yaml"
    path.write_text(yaml.safe_dump(run_config("eval/dialogue_avsd_eval.yaml", data, "val",
                                              batch_size_eval=4)))
    argv = ["--cfg-path", str(path), "--vocab-path", data["vocab"]]
    jevaluate.main(argv + ["--output-dir", str(tmp_path / "jax")])
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    stats = {}
    from sprc_tpu_torch.config import Config

    got = evaluate.evaluate(Config(str(path)), argparse.Namespace(
        model_path=ckpt, vocab_path=data["vocab"], output_dir=str(tmp_path / "port"),
        split=None, device="cpu"), stats)
    assert abs(got["agg_metrics"] - want["agg_metrics"]) <= 1e-6 * abs(want["agg_metrics"])
    assert stats["loss_s"] > 0
    evaluate.main(argv + ["--model-path", ckpt, "--device", "cpu",
                          "--output-dir", str(tmp_path / "port")])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == {"agg_metrics": got["agg_metrics"]}


def test_a_stream_width_that_is_not_len_video_ft_exits_before_building(data, tmp_path,
                                                                      monkeypatch):
    """The shipped YAMLs name no streams: the processor's default i3d_rgb +
    vggish is 5 wide here (2176 at full size), the model's 8 (4224)."""
    from sprc_tpu_torch import loader
    from sprc_tpu_torch.cli import evaluate
    from sprc_tpu_torch.config import Config
    from sprc_tpu_torch.train import generic

    def built(*a, **k):
        raise AssertionError("a model was built")

    monkeypatch.setattr(loader, "load_model", built)
    cfg = run_config("dialogue_avsd_ft.yaml", data, "train", streams=("i3d_rgb",))
    args = argparse.Namespace(output_dir=str(tmp_path), vocab_path=data["vocab"],
                              model_path=None, device="cpu")
    with pytest.raises(SystemExit, match="5 wide .*i3d_rgb \\+ vggish.*len_video_ft is 8"):
        generic.run_generic(Config(defaults=cfg), args)
    cfg = run_config("eval/dialogue_avsd_eval.yaml", data, "val", streams=("i3d_rgb",))
    with pytest.raises(SystemExit, match="5 wide .*len_video_ft is 8"):
        evaluate.evaluate(Config(defaults=cfg), argparse.Namespace(
            model_path=None, vocab_path=data["vocab"], output_dir=str(tmp_path), split=None,
            device="cpu"))
    # the dialogue task takes only the dialogue model, and the model only that task
    with pytest.raises(SystemExit, match="the dialogue: gpt_dialogue"):
        generic.run_generic(Config(defaults=dict(cfg, run={"task": "dialogue"},
                                                 model={"arch": "blip2"})), args)
    with pytest.raises(SystemExit, match="the dialogue task: gpt_dialogue"):
        evaluate.evaluate(Config(defaults={"run": {"task": "captioning"},
                                           "model": {"arch": "gpt_dialogue"}}), args)
