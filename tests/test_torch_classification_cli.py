"""``cli/train.py`` and ``cli/evaluate.py`` on the SNLI-VE and NLVR2 run
YAMLs against sprc_tpu's ``run_generic`` and ``evaluate``.

Each YAML is read as it is, with tiny towers (ViT width 64 / depth 1 at 32
px; med-BERTs hidden 64, 3 layers, 2 heads, BERT's 30,523 rows; ALBEF's
fusion and BLIP NLVR's merge from layer 1), 32 px images through the
YAML's processors, 12 seeded PNG items over 8 images. Both packages start
from one LAVIS-layout file written from the port's weights (the JAX train
run's init is handed what its LAVIS importer reads; its orbax checkpoint
write is replaced by a no-op).

- ``nlvr_ft.yaml`` (ALBEF's NLVR with momentum distillation and the
  two-epoch ramp), one epoch at batch 4: each step's loss within 1e-5, the
  parameters and the momentum copies after the run within 1e-5.
- ``snli_ve_eval.yaml``, ``nlvr_eval.yaml`` (BLIP's twin cross-attention)
  and ``nlvr_albef_eval.yaml``: the same accuracy and result rows.
- ``snli_ve_ft.yaml``: the port's run (3 finite distilled steps; the JAX
  run is the same code path as the classifier step held in
  test_torch_nlvr.py).
"""

import argparse
import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
yaml = pytest.importorskip("yaml")

from sprc_tpu_torch.interop.jax_params import momentum_copies_from_jax, nlvr_from_jax  # noqa: E402
from test_torch_blip1 import IMG, VIT, numpy_state, port_model  # noqa: E402
from test_torch_threads import one_torch_thread  # noqa: E402,F401  (one thread a module)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
TXT = dict(vocab_size=30523, hidden_size=64, num_layers=3, num_heads=2, intermediate_size=128,
           encoder_width=64, dropout_rate=0.0)
TINY_VIT = dict(VIT, depth=1)
WORDS = ["a", "dog", "on", "the", "grass", "red", "car", "two", "cats", "sky"]
# run YAML -> (arch, model type, builder, split)
RUNS = {"nlvr_ft.yaml": ("albef_nlvr", "pretrain", "nlvr", "train"),
        "snli_ve_ft.yaml": ("albef_classification", "pretrain", "snli_ve", "train"),
        "eval/snli_ve_eval.yaml": ("albef_classification", "ve", "snli_ve", "test"),
        "eval/nlvr_eval.yaml": ("blip_nlvr", "nlvr", "nlvr", "test"),
        "eval/nlvr_albef_eval.yaml": ("albef_nlvr", "nlvr", "nlvr", "test")}


def tiny_model_section(arch):
    out = {"image_size": IMG, "vit_config_override": TINY_VIT, "text_config_override": TXT,
           "fusion_layer": 1}
    return out


@pytest.fixture(scope="module")
def items(tmp_path_factory):
    """8 PNG images; 12 SNLI-VE items and 12 NLVR2 pairs (labels True /
    False) for each split; a synthetic BERT vocabulary."""
    from PIL import Image

    from sprc_tpu_torch.utils.artifacts import write_synthetic_bert_vocab

    root = tmp_path_factory.mktemp("cls")
    rng = np.random.RandomState(21)
    for i in range(8):
        Image.fromarray((rng.rand(30 + 2 * i, 34, 3) * 255).astype(np.uint8)).save(
            root / f"c{i}.png")
    for builder in ("snli_ve", "nlvr"):
        for split in ("train", "test"):
            ann = []
            for i in range(12):
                sentence = " ".join(rng.choice(WORDS, 5))
                if builder == "snli_ve":
                    ann.append({"image": f"c{i % 8}.png", "sentence": sentence,
                                "label": int(rng.randint(3))})
                else:
                    ann.append({"images": [f"c{i % 8}.png", f"c{(i + 3) % 8}.png"],
                                "sentence": sentence, "label": str(bool(rng.randint(2)))})
            (root / f"{builder}_{split}.json").write_text(json.dumps(ann))
    return {"root": str(root), "vocab": write_synthetic_bert_vocab(str(root / "vocab.txt"))}


def lavis_file(model, path):
    """The port's weights as a LAVIS checkpoint, the momentum modules beside
    them."""
    sd = {k: torch.from_numpy(np.array(v)) for k, v in numpy_state(model).items()}
    for k in [k for k in sd if k.split(".")[0] in ("visual_encoder", "text_encoder",
                                                   "cls_head")]:
        head, _, rest = k.partition(".")
        sd[f"{head}_m.{rest}"] = sd[k] - 1.0
    torch.save({"model": sd}, path)
    return sd


def run_config(name, items):
    with open(os.path.join(ROOT, "configs", "runs", name)) as f:
        cfg = yaml.safe_load(f)
    arch, _, builder, split = RUNS[name]
    cfg["run"].update({"batch_size": 4, "batch_size_eval": 4, "max_epochs": 1, "log_freq": 1})
    cfg["model"].update(tiny_model_section(arch))
    ds = cfg["datasets"][builder]
    ds["build_info"] = {"annotations": {split: [os.path.join(items["root"],
                                                              f"{builder}_{split}.json")]},
                        "images": items["root"]}
    kind = "train" if split == "train" else "eval"
    ds["vis_processor"] = {kind: {"name": f"blip_image_{kind}", "image_size": IMG}}
    return cfg


def _args(items, out, ckpt, **kw):
    return argparse.Namespace(output_dir=str(out), vocab_path=items["vocab"], model_path=ckpt,
                              device="cpu", data_path=None, split=None, **kw)


def _rows(out):
    with open(os.path.join(out, "log.jsonl")) as f:
        return [r for r in map(json.loads, f) if r["kind"] == "step"]


def test_cli_train_nlvr_equals_jax(items, tmp_path, monkeypatch):
    from sprc_tpu.config import Config as JConfig
    from sprc_tpu.interop.lavis_import import lavis_params_from_torch
    from sprc_tpu.train import checkpoint as jcheckpoint
    from sprc_tpu.train import generic as jgeneric
    from sprc_tpu.train import runner as jrunner

    from sprc_tpu_torch.cli import train as train_cli
    from sprc_tpu_torch.config import Config

    name = "nlvr_ft.yaml"
    cfg = run_config(name, items)
    model_cfg = dict(cfg["model"])
    arch = model_cfg.pop("arch")
    model = port_model(arch, "pretrain", 8, **model_cfg)
    ckpt = str(tmp_path / "lavis.pth")
    sd = lavis_file(model, ckpt)
    captured = {}
    train = jrunner.EpochRunner.train

    def keep_state(self):
        best = train(self)
        captured["state"] = jax.tree_util.tree_map(np.asarray, self.state)
        return best

    monkeypatch.setattr(jrunner.EpochRunner, "train", keep_state)
    monkeypatch.setattr(jcheckpoint, "save_state", lambda path, state: None)
    monkeypatch.setattr(jgeneric.ClassificationAdapter, "init_params", lambda self, jm, rng, size: (
        lavis_params_from_torch({k: v.numpy() for k, v in sd.items()}, jm)))
    jgeneric.run_generic(JConfig(defaults=cfg), _args(items, tmp_path / "jax", ckpt))
    train_cli.train(Config(defaults=cfg), _args(items, tmp_path / "port", ckpt, resume=None))
    state = torch.load(tmp_path / "port" / "last_state.pt", weights_only=True)
    jstate = captured["state"]
    want, got = _rows(tmp_path / "jax"), _rows(tmp_path / "port")
    assert [r["step"] for r in got] == [r["step"] for r in want] == [0, 1, 2]
    for g, w in zip(got, want):
        assert not w["skipped_nonfinite"] and not g["skipped_nonfinite"]
        assert abs(g["loss"] - w["loss"]) <= TOL * max(1.0, abs(w["loss"])), g["step"]
    want_params = nlvr_from_jax(jstate.params)
    for n, value in state["trainable"].items():
        np.testing.assert_allclose(value.numpy(), want_params[n].numpy(), atol=TOL, err_msg=n)
    want_m = momentum_copies_from_jax(jstate.aux, model, nlvr_from_jax)["params_m"]
    assert sorted(state["aux"]["params_m"]) == sorted(want_m)
    for n, m in state["aux"]["params_m"].items():
        np.testing.assert_allclose(m.numpy(), want_m[n].numpy(), atol=TOL, err_msg=n)


@pytest.mark.parametrize("name", ["eval/snli_ve_eval.yaml", "eval/nlvr_eval.yaml",
                                  "eval/nlvr_albef_eval.yaml"])
def test_cli_evaluate_equals_jax(items, tmp_path, name):
    """The accuracy and the result rows of both CLIs (3 batches of 4)."""
    from sprc_tpu.cli import evaluate as jevaluate
    from sprc_tpu.config import Config as JConfig

    from sprc_tpu_torch.cli import evaluate as evaluate_cli
    from sprc_tpu_torch.config import Config

    cfg = run_config(name, items)
    arch, model_type = RUNS[name][:2]
    model = port_model(arch, model_type, 9, **tiny_model_section(arch))
    ckpt = str(tmp_path / "lavis.pth")
    lavis_file(model, ckpt)
    want = jevaluate.evaluate(JConfig(defaults=cfg), _args(items, tmp_path / "jax", ckpt))
    got = evaluate_cli.evaluate(Config(defaults=cfg), _args(items, tmp_path / "port", ckpt))
    assert got == want and set(got) == {"agg_metrics", "acc"}
    rows = [json.loads((tmp_path / kind / "result" / "test_epochx.json").read_text())
            for kind in ("jax", "port")]
    assert rows[0] == rows[1] and len(rows[0]) == 12


def test_cli_train_snli_ve(items, tmp_path):
    """snli_ve_ft.yaml through the port's cli/train.py: three finite steps of
    the distilled classifier, its momentum copies in the saved state."""
    from sprc_tpu_torch.cli import train as train_cli
    from sprc_tpu_torch.config import Config

    train_cli.train(Config(defaults=run_config("snli_ve_ft.yaml", items)),
                    _args(items, tmp_path, None, resume=None))
    rows = _rows(tmp_path)
    assert len(rows) == 3 and all(np.isfinite(r["loss"]) for r in rows)
    state = torch.load(tmp_path / "last_state.pt", weights_only=True)
    assert state["updates"] == 3 and any(n.startswith("cls_head.")
                                         for n in state["aux"]["params_m"])
