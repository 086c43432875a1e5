"""The port's YAML training layer (train/generic.py, train/runner.py,
cli/train.py) against sprc_tpu's.

``run_generic`` on an ``image_text_pretrain`` run config over a synthetic
``conceptual_caption_3m`` split (12 PNG pairs, batch 4, 3 steps, the
``blip2_image_train`` transform with its seeded draws) runs the tiny
``blip2`` of test_torch_stage1.py in both packages from the same weights
(the JAX run's init is handed the tree the port's ``--model-path`` file was
made from; its orbax checkpoint write is replaced by a no-op: the test reads
the JAX state from the runner, and orbax is an optional dependency). The vocabulary is the full 30,523 rows here, so that both take
the LM's default ``bos_token_id`` 30522. The second batch's pixels are NaN
in both: that step is skipped, the others' losses (``log.jsonl``) and the
parameters after the run (the tower, decayed by AdamW through its zero
gradients, included) agree within 1e-5. The learning rate is the pretrain
YAML's 1e-4: Adam's first updates are about ``lr x g / |g|``, so an element
whose gradient is small moves by a share of lr that fp32 rounding of g
shifts (at 3e-3, 2 of 16,384 elements of one weight differed by 4.5e-5);
the weight decay is 2.0, so that the tower's decay (lr x wd a step) shows
above the bound. Then, on the port alone: a run
stopped after one epoch and resumed equals the run that was not stopped;
``IterRunner`` takes ``max_iters`` steps in the inner epochs JAX's takes
(both runners over one stub step); and ``cli/train.py`` routes a CIR run
config to ``cli/finetune.finetune`` with the flags the JAX CLI would give it
and runs configs/runs/pretrain_stage1.yaml on the tiny model.
"""

import argparse
import json
import math
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
yaml = pytest.importorskip("yaml")

from sprc_tpu.train import checkpoint as jcheckpoint  # noqa: E402
from sprc_tpu.train import generic as jgeneric  # noqa: E402
from sprc_tpu.train import runner as jrunner  # noqa: E402

from sprc_tpu_torch.interop.jax_params import state_dict_from_jax  # noqa: E402
from sprc_tpu_torch.train import generic, runner  # noqa: E402
from test_torch_stage1 import jax_params  # noqa: E402
from test_torch_train_losses import EMBED, IMG, Q, QF, TXT, VIT  # noqa: E402
from test_torch_threads import one_torch_thread  # noqa: E402,F401  (one thread a module)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = 30523
ATOL = 1e-5
TINY = {"arch": "blip2", "image_size": IMG, "num_query_token": Q, "max_txt_len": TXT,
        "vocab_size": VOCAB, "embed_dim": EMBED, "vit_dtype": "fp32",
        "vit_config_override": dict(VIT, dtype="fp32"),
        "qformer_config_override": dict(QF, vocab_size=VOCAB, dropout_rate=0.0)}


def _jax_model():
    from sprc_tpu.loader import build_model

    model_cfg = dict(TINY)
    return build_model(model_cfg.pop("arch"), "pretrain", **model_cfg)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """12 PNG pairs of mixed sizes, their captions, a synthetic BERT vocab,
    the shared weights (a JAX tree and the port's checkpoint of it)."""
    from PIL import Image

    from sprc_tpu_torch.utils.artifacts import write_synthetic_bert_vocab

    root = tmp_path_factory.mktemp("pairs")
    rng = np.random.RandomState(7)
    words = ["a", "dog", "on", "the", "grass", "red", "car", "two", "cats", "sky"]
    ann = []
    for i in range(12):
        name = f"p{i:02d}.png"
        Image.fromarray((rng.rand(30 + 3 * i, 36, 3) * 255).astype(np.uint8)).save(root / name)
        ann.append({"image": name, "caption": " ".join(rng.choice(words, 5)),
                    "image_id": f"i{i}"})
    (root / "train.json").write_text(json.dumps(ann))
    vocab = write_synthetic_bert_vocab(str(root / "vocab.txt"))
    params = jax_params(_jax_model())
    ckpt = root / "blip2.pth"
    torch.save({"model": state_dict_from_jax(params, vit="eva_clip_g")}, ckpt)
    return {"root": str(root), "vocab": vocab, "params": params, "ckpt": str(ckpt)}


def run_config(data, **run):
    return {"run": {"task": "image_text_pretrain", "batch_size": 4, "max_epochs": 1,
                    "learning_rate": 1e-4, "weight_decay": 2.0, "max_txt_len": TXT, "seed": 42,
                    "log_freq": 1, **run},
            "model": dict(TINY),
            "datasets": {"conceptual_caption_3m": {
                "build_info": {"annotations": {"train": [os.path.join(data["root"],
                                                                      "train.json")]},
                               "images": data["root"]},
                "vis_processor": {"train": {"name": "blip2_image_train", "image_size": IMG}},
                "text_processor": {"train": {"name": "blip_caption"}}}}}


def _args(data, out, **kw):
    return argparse.Namespace(output_dir=str(out), vocab_path=data["vocab"],
                              model_path=data["ckpt"], device="cpu", **kw)


def _rows(out, kind):
    with open(os.path.join(out, "log.jsonl")) as f:
        return [r for r in map(json.loads, f) if r["kind"] == kind]


def _poison_second_batch(monkeypatch, adapter_cls):
    """The second collated batch's pixels NaN (a non-finite step)."""
    collate, calls = adapter_cls.collate, []

    def poisoned(self, items):
        out = collate(self, items)
        calls.append(1)
        if len(calls) == 2:
            out["images"] = np.full_like(out["images"], np.nan)
        return out

    monkeypatch.setattr(adapter_cls, "collate", poisoned)


def test_run_generic_equals_jax(data, tmp_path, monkeypatch):
    from sprc_tpu.config import Config as JConfig

    from sprc_tpu_torch.config import Config

    cfg = run_config(data)
    captured = {}
    train = jrunner.EpochRunner.train

    def keep_state(self):
        best = train(self)
        captured["params"] = jax.tree_util.tree_map(np.asarray, self.state.params)
        return best

    monkeypatch.setattr(jrunner.EpochRunner, "train", keep_state)
    monkeypatch.setattr(jcheckpoint, "save_state", lambda path, state: None)
    monkeypatch.setattr(jgeneric.PretrainAdapter, "init_params",
                        lambda self, model, rng, size: data["params"], raising=False)
    _poison_second_batch(monkeypatch, jgeneric.PretrainAdapter)
    _poison_second_batch(monkeypatch, generic.PretrainAdapter)
    jgeneric.run_generic(JConfig(defaults=cfg), _args(data, tmp_path / "jax"))
    generic.run_generic(Config(defaults=cfg), _args(data, tmp_path / "port"))

    want, got = _rows(tmp_path / "jax", "step"), _rows(tmp_path / "port", "step")
    assert [r["step"] for r in got] == [r["step"] for r in want] == [0, 1, 2]
    assert [r["skipped_nonfinite"] for r in got] == [r["skipped_nonfinite"] for r in want] \
        == [0.0, 1.0, 0.0]
    assert len(_rows(tmp_path / "port", "nonfinite_skip")) == 1
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in ("loss", "loss_itc", "loss_itm", "loss_lm"):
            if w["skipped_nonfinite"]:
                assert not math.isfinite(g[key]) and not math.isfinite(w[key])
            else:
                assert abs(g[key] - w[key]) <= ATOL * abs(w[key]), (g["step"], key)

    state = torch.load(tmp_path / "port" / "last_state.pt", weights_only=True)
    assert state["updates"] == 2 and state["step"] == 3
    tensors = {**state["trainable"], **state["decayed"]}
    want_params = state_dict_from_jax(captured["params"], vit="eva_clip_g")
    start = state_dict_from_jax(data["params"], vit="eva_clip_g")
    assert set(tensors) == set(want_params) - {"Qformer.bert.embeddings.position_ids"}
    for name, value in tensors.items():
        np.testing.assert_allclose(value.numpy(), want_params[name].numpy(), atol=ATOL,
                                   err_msg=name)
    tower = [n for n in state["decayed"] if n.startswith("visual_encoder")]
    assert tower and sorted(tower) == sorted(state["decayed"])
    moved = max((want_params[n] - start[n]).abs().max().item() for n in tower)
    assert moved > 1e-4  # the tower decays: by up to lr x weight_decay = 2e-4 a step


def test_resumed_run_equals_uninterrupted(data, tmp_path):
    """Two epochs in one run, and one epoch then a resume from its
    ``last_state.pt`` for the second (the same OneCycle horizon): the same
    parameters, the tower's fp32 masters included, bit for bit. The pixels
    come through the deterministic eval transform: the train transform's
    RandomState is the dataset's, not the trainer's, and starts again in a
    new process (in JAX too)."""
    from sprc_tpu_torch.config import Config

    def config(**run):
        cfg = run_config(data, total_steps=6, **run)
        cfg["datasets"]["conceptual_caption_3m"]["vis_processor"]["train"] = {
            "name": "blip_image_eval", "image_size": IMG}
        return cfg

    cfg = config(max_epochs=2)
    generic.run_generic(Config(defaults=cfg), _args(data, tmp_path / "whole"))
    first = config(max_epochs=1)
    generic.run_generic(Config(defaults=first), _args(data, tmp_path / "a"))
    generic.run_generic(Config(defaults=cfg), _args(data, tmp_path / "a",
                                                    resume=str(tmp_path / "a" / "last_state.pt")))
    whole = torch.load(tmp_path / "whole" / "last_state.pt", weights_only=True)
    resumed = torch.load(tmp_path / "a" / "last_state.pt", weights_only=True)
    assert whole["step"] == resumed["step"] == 6 and whole["epoch"] == resumed["epoch"] == 2
    for part in ("trainable", "decayed"):
        for name, value in whole[part].items():
            assert torch.equal(value, resumed[part][name]), name
    assert [r["epoch"] for r in _rows(tmp_path / "a", "train")] == [0, 1]


class _StubTask:
    """Batches 0, 1, 2 an epoch, by number."""

    def __init__(self):
        self.epochs = []

    def train_loader(self, epoch):
        self.epochs.append(epoch)
        return iter(range(3))

    def prepare_batch(self, batch):
        return batch

    def evaluation(self, *a):
        return {}

    def selection_metric(self, results):
        return None


def test_iter_runner_step_count_equals_jax(tmp_path, monkeypatch):
    """``IterRunner``'s budget over a stub step: 7 steps in inner epochs of
    3, 3, 1, the task's epochs rolling over, the same ``inner`` rows as the
    JAX runner's."""
    monkeypatch.setattr(jcheckpoint, "save_state", lambda path, state: None)

    class Trainer:
        skip_nonfinite, epoch, step = True, 0, 0

        def train_step(self, batch):
            self.step += 1
            return {"loss": float(batch), "skipped_nonfinite": 0.0}

        def state_dict(self):
            return {"step": self.step}

    jtask, task, trainer = _StubTask(), _StubTask(), Trainer()
    from types import SimpleNamespace

    def jstep(state, batch):
        return SimpleNamespace(params=None, step=state.step + 1), {"loss": float(batch)}

    jrun = jrunner.IterRunner(None, SimpleNamespace(params=None, step=0), None, jstep, jtask,
                              jrunner.RunnerConfig(output_dir=str(tmp_path / "jax")),
                              max_iters=7, iters_per_inner=3)
    jrun.train()
    port = runner.IterRunner(torch.nn.Identity(), trainer, task,
                             runner.RunnerConfig(output_dir=str(tmp_path / "port")),
                             max_iters=7, iters_per_inner=3)
    port.train()
    assert jrun.state.step == trainer.step == 7
    assert task.epochs == jtask.epochs == [0, 1, 2]
    strip = lambda rows: [{k: v for k, v in r.items() if k != "skipped_nonfinite"}  # noqa: E731
                          for r in rows]
    assert strip(_rows(tmp_path / "port", "inner")) == _rows(tmp_path / "jax", "inner")
    assert os.path.isfile(tmp_path / "port" / "last_state.pt")


def test_cli_train_routes_as_jax(data, tmp_path, monkeypatch, caplog):
    """A CIR run config (configs/runs/cirr_finetune.yaml) starts the fine-tune
    that the equivalent cli/finetune.py flags start, with the JAX CLI's
    translation (``run.remat`` as ``--remat``, ``run.mesh`` as ``--mesh``:
    applied, as in JAX, not warned about); the generic route trains
    configs/runs/pretrain_stage1.yaml on the tiny model."""
    from sprc_tpu.cli import finetune as jfinetune
    from sprc_tpu.cli import train as jtrain

    from sprc_tpu_torch.cli import finetune, train

    seen = {}
    monkeypatch.setattr(jfinetune, "finetune", lambda ft: seen.setdefault("jax", ft))
    monkeypatch.setattr(finetune, "finetune", lambda ft: seen.setdefault("port", ft))
    argv = ["--cfg-path", os.path.join(ROOT, "configs", "runs", "cirr_finetune.yaml"),
            "--data-path", "/data/cirr", "--vocab-path", data["vocab"], "--output-dir",
            str(tmp_path / "cir"), "--options", "run.remat=true", "run.learning_rate=2e-5",
            "run.mesh=1x1"]
    jtrain.main(argv)
    with caplog.at_level("WARNING"):
        train.main(argv)
    assert not any("is not a finetune flag" in r.getMessage() for r in caplog.records)
    want = finetune.make_parser().parse_args(
        ["--dataset", "CIRR", "--data-path", "/data/cirr", "--vocab-path", data["vocab"],
         "--output-dir", str(tmp_path / "cir"), "--batch-size", "128", "--num-epochs", "50",
         "--schedule-epochs", "80", "--learning-rate", "2e-5", "--loss-rtc", "0.4",
         "--loss-align", "0.4", "--target-ratio", "1.25", "--selection-metric",
         "arithmetic_mean", "--remat"])
    got = vars(seen["port"])
    assert got == dict(vars(want), mesh="1x1") and got["remat"] is True
    assert vars(seen["jax"])["mesh"] == "1x1"
    port_only = {"device"}  # the port's flag beyond the JAX CLI's
    assert {k: v for k, v in vars(seen["jax"]).items() if k in got} == {
        k: v for k, v in got.items() if k not in port_only}

    out = tmp_path / "stage1"
    opts = [f"model.{k}={json.dumps(v)}" for k, v in TINY.items()]
    ds = "datasets.conceptual_caption_3m"
    train.main(["--cfg-path", os.path.join(ROOT, "configs", "runs", "pretrain_stage1.yaml"),
                "--vocab-path", data["vocab"], "--output-dir", str(out), "--model-path",
                data["ckpt"], "--device", "cpu", "--options", "run.batch_size=4",
                "run.max_epochs=1", f"run.max_txt_len={TXT}",
                f"{ds}.build_info.annotations.train=[{os.path.join(data['root'], 'train.json')}]",
                f"{ds}.build_info.images={data['root']}",
                f"{ds}.vis_processor.train.image_size={IMG}", *opts])
    rows = _rows(out, "train")
    assert len(rows) == 1 and all(math.isfinite(rows[0][k])
                                  for k in ("loss_itc", "loss_itm", "loss_lm"))
    assert torch.load(out / "last_state.pt", weights_only=True)["step"] == 3
