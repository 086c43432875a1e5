"""``cli/train.py`` and ``cli/evaluate.py`` on BLIP-1 / ALBEF's VQA run
YAMLs against sprc_tpu's ``run_generic`` and ``evaluate``.

Each YAML is read as it is, with tiny towers (test_torch_blip_vqa.py's, the
med-BERTs' vocabulary BLIP-1's 30,524 rows so that the synthetic
tokenizer's ids and its ``[DEC]`` fit; dropout off, so that both packages'
steps are deterministic), 32 px images through the YAML's processors and
one epoch at batch 4 over 12 seeded PNG questions with weighted answers.
Both packages start from one LAVIS-layout file written from the port's
weights (the JAX train run's init is handed what its LAVIS importer reads;
its orbax checkpoint write is replaced by a no-op). The towers are cut
further here (ViT depth 1, 2 med layers) to keep the JAX step's compile
short; the JAX evaluations run op by op (``jax.disable_jit``), since
``rank_answers`` compiles new closures for every batch.

- ``vqav2_albef_ft.yaml`` with ``model.use_distill: true`` (the YAML names
  no model type, so both packages build ``albef_vqa`` from the dataclass
  defaults, which do not distill): each step's loss within 1e-5, the
  parameters and the momentum copies after the run within 1e-5.
- ``vqav2_eval.yaml`` (rank over ``run.answer_list``) and ``gqa_eval.yaml``
  (generate): the same metrics and result rows.
- ``okvqa_ft``, ``aokvqa_ft`` and their evaluations: the port's runs, one
  step each and the metrics (the JAX runs are the same code paths).
- ``vqa_val_albef_eval.yaml`` gives 480 px images to ALBEF's 384 px tower:
  the JAX CLI fails at its first batch, the port's exits before building.
"""

import argparse
import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
yaml = pytest.importorskip("yaml")

from sprc_tpu_torch.interop.jax_params import momentum_copies_from_jax, vqa_from_jax  # noqa: E402
from test_torch_blip1 import IMG, VIT, numpy_state, port_model  # noqa: E402
from test_torch_blip_vqa import TXT  # noqa: E402
from test_torch_threads import one_torch_thread  # noqa: E402,F401  (one thread a module)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
VOCAB = 30524
TINY_TXT = dict(TXT, vocab_size=VOCAB, num_layers=2)
TINY_VIT = dict(VIT, depth=1)
WORDS = ["dog", "cat", "red", "two", "car", "sky", "grass", "blue"]


def tiny_model_section(arch):
    out = {"image_size": IMG, "vit_config_override": TINY_VIT, "text_config_override": TINY_TXT}
    if arch.startswith("albef"):
        out["fusion_layer"] = 1
    return out


@pytest.fixture(scope="module")
def questions(tmp_path_factory):
    """12 PNG questions over 8 images, a train and a val annotation file, the
    answer list and a synthetic BERT vocabulary."""
    from PIL import Image

    from sprc_tpu_torch.utils.artifacts import write_synthetic_bert_vocab

    root = tmp_path_factory.mktemp("vqa")
    rng = np.random.RandomState(12)
    train, val = [], []
    for i in range(12):
        name = f"q{i % 8:02d}.png"
        if i < 8:
            Image.fromarray((rng.rand(30 + 2 * i, 36, 3) * 255).astype(np.uint8)).save(
                root / name)
        words = [str(w) for w in rng.choice(WORDS, 4, replace=False)]
        question = f"what is the {words[0]} near the {words[1]}"
        train.append({"image": name, "question": question, "answer": words[1:]})
        val.append({"image": name, "question": question, "question_id": 100 + i,
                    "answers": [{"answer": w} for w in words[1:] * 3], "answer": words[2],
                    "direct_answers": words[1:], "question_type": "what is the",
                    "answer_type": "other"})
    for split, ann in (("train", train), ("val", val)):
        (root / f"{split}.json").write_text(json.dumps(ann))
    vocab = write_synthetic_bert_vocab(str(root / "vocab.txt"))
    return {"root": str(root), "vocab": vocab}


def lavis_file(model, path):
    """The port's weights as a LAVIS checkpoint, the momentum modules beside
    them."""
    sd = {k: torch.from_numpy(np.array(v)) for k, v in numpy_state(model).items()}
    for k in [k for k in sd if k.split(".")[0] in ("visual_encoder", "text_encoder",
                                                   "text_decoder")]:
        head, _, rest = k.partition(".")
        sd[f"{head}_m.{rest}"] = sd[k] + 1.0
    torch.save({"model": sd}, path)
    return sd


def run_config(name, questions, split, **model):
    with open(os.path.join(ROOT, "configs", "runs", name)) as f:
        cfg = yaml.safe_load(f)
    cfg["run"].update({"batch_size": 4, "max_epochs": 1, "log_freq": 1})
    cfg["model"].update(tiny_model_section(cfg["model"]["arch"]), **model)
    (builder, ds), = cfg["datasets"].items()
    ds["build_info"] = {"annotations": {split: [os.path.join(questions["root"],
                                                              f"{split}.json")]},
                        "images": questions["root"]}
    kind = "train" if split == "train" else "eval"
    ds["vis_processor"] = {kind: {"name": f"blip_image_{kind}", "image_size": IMG}}
    return cfg


def _args(questions, out, ckpt, **kw):
    return argparse.Namespace(output_dir=str(out), vocab_path=questions["vocab"], model_path=ckpt,
                              device="cpu", data_path=None, split=None, **kw)


def _rows(out):
    with open(os.path.join(out, "log.jsonl")) as f:
        return [r for r in map(json.loads, f) if r["kind"] == "step"]


def test_cli_train_albef_vqa_distilled_equals_jax(questions, tmp_path, monkeypatch):
    from sprc_tpu.config import Config as JConfig
    from sprc_tpu.interop.lavis_import import lavis_params_from_torch
    from sprc_tpu.train import checkpoint as jcheckpoint
    from sprc_tpu.train import generic as jgeneric
    from sprc_tpu.train import runner as jrunner

    from sprc_tpu_torch.cli import train as train_cli
    from sprc_tpu_torch.config import Config

    arch = "albef_vqa"
    model = port_model(arch, "pretrain", 5, flavor="albef", use_distill=True,
                       **tiny_model_section(arch))
    ckpt = str(tmp_path / "lavis.pth")
    sd = lavis_file(model, ckpt)
    cfg = run_config("vqav2_albef_ft.yaml", questions, "train", use_distill=True)
    captured = {}
    train = jrunner.EpochRunner.train

    def keep_state(self):
        best = train(self)
        captured["state"] = jax.tree_util.tree_map(np.asarray, self.state)
        return best

    monkeypatch.setattr(jrunner.EpochRunner, "train", keep_state)
    monkeypatch.setattr(jcheckpoint, "save_state", lambda path, state: None)
    monkeypatch.setattr(jgeneric.VQAAdapter, "init_params", lambda self, jm, rng, size: (
        lavis_params_from_torch({k: v.numpy() for k, v in sd.items()}, jm)), raising=False)
    jgeneric.run_generic(JConfig(defaults=cfg), _args(questions, tmp_path / "jax", ckpt))
    train_cli.train(Config(defaults=cfg), _args(questions, tmp_path / "port", ckpt, resume=None))
    state = torch.load(tmp_path / "port" / "last_state.pt", weights_only=True)
    jstate = captured["state"]
    want, got = _rows(tmp_path / "jax"), _rows(tmp_path / "port")
    assert [r["step"] for r in got] == [r["step"] for r in want] == [0, 1, 2]
    for g, w in zip(got, want):
        assert not w["skipped_nonfinite"] and not g["skipped_nonfinite"]
        assert abs(g["loss"] - w["loss"]) <= TOL * max(1.0, abs(w["loss"])), g["step"]
    assert state["updates"] == 3
    want_params = vqa_from_jax(jstate.params)
    for n, value in state["trainable"].items():
        np.testing.assert_allclose(value.numpy(), want_params[n].numpy(), atol=TOL, err_msg=n)
    want_m = momentum_copies_from_jax(jstate.aux, model, vqa_from_jax)["params_m"]
    assert sorted(state["aux"]["params_m"]) == sorted(want_m)
    for n, m in state["aux"]["params_m"].items():
        np.testing.assert_allclose(m.numpy(), want_m[n].numpy(), atol=TOL, err_msg=n)


@pytest.mark.parametrize("name,method", [("eval/vqav2_eval.yaml", "rank"),
                                         ("eval/gqa_eval.yaml", "generate")])
def test_cli_evaluate_equals_jax(questions, tmp_path, name, method):
    """BLIP's VQA by rank over the answer list (every candidate rescored:
    ``num_ans_candidates`` 128 over 8 answers) and by greedy generation:
    the metrics and the result rows of both CLIs."""
    from sprc_tpu.cli import evaluate as jevaluate
    from sprc_tpu.config import Config as JConfig

    from sprc_tpu_torch.cli import evaluate as evaluate_cli
    from sprc_tpu_torch.config import Config

    model = port_model("blip_vqa", "vqav2", 6, **tiny_model_section("blip_vqa"))
    ckpt = str(tmp_path / "lavis.pth")
    lavis_file(model, ckpt)
    cfg = run_config(name, questions, "val")
    cfg["run"]["answer_list"] = WORDS
    assert cfg["run"]["inference_method"] == method
    with jax.disable_jit():  # rank_answers jits new closures a batch: op by op is faster
        want = jevaluate.evaluate(JConfig(defaults=cfg), _args(questions, tmp_path / "jax", ckpt))
    got = evaluate_cli.evaluate(Config(defaults=cfg), _args(questions, tmp_path / "port", ckpt))
    assert got == want and "agg_metrics" in got
    result = "val_vqa_result.json" if method == "rank" else "val_gqa_result.json"
    rows = [json.loads((tmp_path / kind / "result" / result).read_text())
            for kind in ("jax", "port")]
    assert rows[0] == rows[1] and len(rows[0]) == 12


@pytest.mark.parametrize("name", ["okvqa_ft.yaml", "aokvqa_ft.yaml", "eval/okvqa_eval.yaml",
                                  "eval/aokvqa_eval.yaml"])
def test_cli_accepts_okvqa_aokvqa(questions, tmp_path, name):
    """The OK-VQA and A-OKVQA YAMLs run through the port's CLIs: 3 steps of
    the blip_vqa fine-tune, or the ranked evaluation's metric."""
    from sprc_tpu_torch.cli import evaluate as evaluate_cli
    from sprc_tpu_torch.cli import train as train_cli
    from sprc_tpu_torch.config import Config

    train = not name.startswith("eval/")
    cfg = run_config(name, questions, "train" if train else "val")
    if train:
        train_cli.train(Config(defaults=cfg), _args(questions, tmp_path, None, resume=None))
        rows = _rows(tmp_path)
        assert len(rows) == 3 and all(np.isfinite(r["loss"]) for r in rows)
    else:
        cfg["run"]["answer_list"] = WORDS
        metrics = evaluate_cli.evaluate(Config(defaults=cfg), _args(questions, tmp_path, None))
        assert 0.0 <= metrics["agg_metrics"] <= 100.0


def test_vqa_val_albef_eval_refused_as_jax_fails(questions, tmp_path):
    """vqa_val_albef_eval.yaml's eval images are not its tower's size (480
    against 384 px; here 48 against 32): the JAX CLI fails at the first
    batch, the port's exits before building the model, with the reason."""
    from sprc_tpu.cli import evaluate as jevaluate
    from sprc_tpu.config import Config as JConfig

    from sprc_tpu_torch.cli import evaluate as evaluate_cli
    from sprc_tpu_torch.config import Config

    model = port_model("albef_vqa", "vqav2", 7, **tiny_model_section("albef_vqa"))
    ckpt = str(tmp_path / "lavis.pth")
    lavis_file(model, ckpt)
    cfg = run_config("eval/vqa_val_albef_eval.yaml", questions, "val")
    cfg["run"]["answer_list"] = WORDS
    cfg["datasets"]["coco_vqa"]["vis_processor"]["eval"]["image_size"] = 48
    with pytest.raises(TypeError, match="broadcast"):
        jevaluate.evaluate(JConfig(defaults=cfg), _args(questions, tmp_path / "jax", ckpt))
    with pytest.raises(SystemExit, match="eval images are 48 px"):
        evaluate_cli.evaluate(Config(defaults=cfg), _args(questions, tmp_path / "port", ckpt))
