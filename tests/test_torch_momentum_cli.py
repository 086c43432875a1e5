"""``cli/train.py`` on the momentum-queue run YAMLs against sprc_tpu's
``run_generic``, and a resumed run against an uninterrupted one.

Each of configs/runs/{retrieval_coco_ft, retrieval_flickr_ft,
retrieval_coco_albef_ft, retrieval_flickr_albef_ft, pretrain_14m,
pretrain_albef}.yaml is read as it
is, with the tiny towers of test_torch_momentum.py (the med-BERT's
vocabulary BLIP-1's 30,524 rows; the tokenizer's is the synthetic BERT
vocabulary of 30,522 and ``[DEC]`` after it), batch 4, one epoch, its
dataset over 12 PNG pairs of 8 images (so image ids repeat) through the
YAML's ``blip_image_train`` at 32 px. Both runs start from one LAVIS-layout
file written from the port's weights with LAVIS's momentum modules
(``visual_encoder_m.*``, ``text_encoder_m.*``, ...) and queue buffers
beside them, which both readers skip (the JAX run's init is handed what the
JAX LAVIS importer reads; its orbax checkpoint write is replaced by a
no-op). Both hard-negative samplers are patched to the argmax in this test
process (``jax.random.categorical``, ``albef.sample_negatives``). Each
step's losses, the parameters after the run and the aux state (momentum
copies, queues within 1e-5; ``ptr`` and ``idx_queue`` equal) agree.
"""

import argparse
import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
yaml = pytest.importorskip("yaml")
import jax.numpy as jnp  # noqa: E402

from sprc_tpu_torch.interop.jax_params import momentum_state_from_jax  # noqa: E402
from sprc_tpu_torch.models import albef  # noqa: E402
from test_torch_blip1 import IMG, VIT, numpy_state, port_model  # noqa: E402
from test_torch_momentum import TXT, bridge  # noqa: E402
from test_torch_threads import one_torch_thread  # noqa: E402,F401  (one thread a module)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
VOCAB = 30524
TINY_TXT = dict(TXT, vocab_size=VOCAB)
# run YAML -> (arch, its model type, its dataset builder)
RUNS = {"retrieval_coco_ft.yaml": ("blip_retrieval", "pretrain", "coco_retrieval"),
        "retrieval_flickr_ft.yaml": ("blip_retrieval", "pretrain", "flickr30k"),
        "retrieval_coco_albef_ft.yaml": ("albef_retrieval", "pretrain", "coco_retrieval"),
        "retrieval_flickr_albef_ft.yaml": ("albef_retrieval", "pretrain", "flickr30k"),
        "pretrain_14m.yaml": ("blip_pretrain", "base", "conceptual_caption_3m"),
        "pretrain_albef.yaml": ("albef_pretrain", "base", "conceptual_caption_3m")}
LAVIS_EXTRAS = ("image_queue", "text_queue", "idx_queue", "ptr_queue", "queue_ptr")


def tiny_model_section(arch):
    out = {"image_size": IMG, "embed_dim": 16, "queue_size": 8, "vit_config_override": VIT,
           "text_config_override": TINY_TXT}
    if arch.startswith("albef"):
        out["fusion_layer"] = 1
    return out


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """12 PNG pairs of 8 images and a synthetic BERT vocabulary."""
    from PIL import Image

    from sprc_tpu_torch.utils.artifacts import write_synthetic_bert_vocab

    root = tmp_path_factory.mktemp("pairs")
    rng = np.random.RandomState(11)
    words = ["a", "dog", "on", "the", "grass", "red", "car", "two", "cats", "sky"]
    ann = []
    for i in range(12):
        name = f"p{i % 8:02d}.png"
        if i < 8:
            Image.fromarray((rng.rand(30 + 3 * i, 36, 3) * 255).astype(np.uint8)).save(
                root / name)
        ann.append({"image": name, "caption": " ".join(rng.choice(words, 6)),
                    "image_id": f"i{i % 8}"})
    (root / "train.json").write_text(json.dumps(ann))
    vocab = write_synthetic_bert_vocab(str(root / "vocab.txt"))
    return {"root": str(root), "vocab": vocab}


def lavis_file(model, path):
    """The port's weights as a LAVIS checkpoint (``{"model": ...}``), the
    tied ``cls.predictions.bias`` and LAVIS's momentum modules and queue
    buffers beside them."""
    sd = {k: torch.from_numpy(np.array(v)) for k, v in numpy_state(model).items()}
    for k in [k for k in sd if k.split(".")[0] in ("visual_encoder", "text_encoder",
                                                   "vision_proj", "text_proj")]:
        head, _, rest = k.partition(".")
        sd[f"{head}_m.{rest}"] = sd[k] + 1.0
    for k in LAVIS_EXTRAS:
        sd[k] = torch.zeros((16, 8) if "queue" in k and "ptr" not in k else (1,))
    torch.save({"model": sd}, path)
    return sd


def run_config(name, pairs, **run):
    with open(os.path.join(ROOT, "configs", "runs", name)) as f:
        cfg = yaml.safe_load(f)
    arch, _, builder = RUNS[name]
    cfg["run"].update({"batch_size": 4, "max_epochs": 1, "log_freq": 1, **run})
    cfg["model"].update(tiny_model_section(arch))
    ds = cfg["datasets"][builder]
    ds["build_info"] = {"annotations": {"train": [os.path.join(pairs["root"], "train.json")]},
                        "images": pairs["root"]}
    ds["vis_processor"]["train"]["image_size"] = IMG
    ds["vis_processor"].pop("eval", None)
    return cfg


def _rows(out, kind="step"):
    with open(os.path.join(out, "log.jsonl")) as f:
        return [r for r in map(json.loads, f) if r["kind"] == kind]


def _args(pairs, out, ckpt, **kw):
    return argparse.Namespace(output_dir=str(out), vocab_path=pairs["vocab"], model_path=ckpt,
                              device="cpu", data_path=None, **kw)


def run_both(name, pairs, tmp_path, monkeypatch, **run):
    """Both packages' runs of ``name`` (``run``: run-section overrides):
    (the port's model before training, JAX state, the port's last_state)."""
    from sprc_tpu.config import Config as JConfig
    from sprc_tpu.interop.lavis_import import lavis_params_from_torch
    from sprc_tpu.train import checkpoint as jcheckpoint
    from sprc_tpu.train import generic as jgeneric
    from sprc_tpu.train import runner as jrunner

    from sprc_tpu_torch.cli import train as train_cli
    from sprc_tpu_torch.config import Config

    arch, model_type, _ = RUNS[name]
    model = port_model(arch, model_type, 5, **tiny_model_section(arch))
    ckpt = str(tmp_path / "lavis.pth")
    sd = lavis_file(model, ckpt)
    cfg = run_config(name, pairs, **run)
    captured = {}
    train = jrunner.EpochRunner.train

    def keep_state(self):
        best = train(self)
        captured["state"] = jax.tree_util.tree_map(np.asarray, self.state)
        return best

    monkeypatch.setattr(jrunner.EpochRunner, "train", keep_state)
    monkeypatch.setattr(jcheckpoint, "save_state", lambda path, state: None)
    monkeypatch.setattr(jgeneric.RetrievalAdapter, "init_params", lambda self, jm, rng, size: (
        lavis_params_from_torch({k: v.numpy() for k, v in sd.items()}, jm)))
    monkeypatch.setattr(jax.random, "categorical",
                        lambda key, logits, axis=-1, **kw: jnp.argmax(logits, axis=axis))
    monkeypatch.setattr(albef, "sample_negatives", lambda weights, generator: weights.argmax(1))
    jgeneric.run_generic(JConfig(defaults=cfg), _args(pairs, tmp_path / "jax", ckpt))
    train_cli.train(Config(defaults=cfg), _args(pairs, tmp_path / "port", ckpt))
    state = torch.load(tmp_path / "port" / "last_state.pt", weights_only=True)
    return model, captured["state"], state


def check_equal(name, model, jstate, state, tmp_path):
    want, got = _rows(tmp_path / "jax"), _rows(tmp_path / "port")
    assert [r["step"] for r in got] == [r["step"] for r in want] == [0, 1, 2]
    for g, w in zip(got, want):
        assert set(g) == set(w) and not w["skipped_nonfinite"]
        for key in [k for k in w if k.startswith("loss")]:
            assert abs(g[key] - w[key]) <= TOL * max(1.0, abs(w[key])), (g["step"], key)
    assert state["updates"] == 3
    want_params = bridge(RUNS[name][0])(jstate.params)
    for n, value in state["trainable"].items():
        np.testing.assert_allclose(value.numpy(), want_params[n].numpy(), atol=TOL, err_msg=n)
    want_aux = momentum_state_from_jax(jstate.aux, model)
    aux = state["aux"]
    for n, m in aux["params_m"].items():
        np.testing.assert_allclose(m.numpy(), want_aux["params_m"][n].numpy(), atol=TOL,
                                   err_msg=n)
    for key in ("image_queue", "text_queue"):
        np.testing.assert_allclose(aux[key].numpy(), want_aux[key].numpy(), atol=TOL)
    assert aux["idx_queue"].tolist() == want_aux["idx_queue"].tolist()
    assert int(aux["ptr"]) == int(want_aux["ptr"]) == 4  # 12 rows into 8 columns
    assert sorted(set(aux["idx_queue"].tolist())) != [-100]


@pytest.mark.parametrize("name", ["retrieval_coco_ft.yaml", "retrieval_flickr_ft.yaml",
                                  "retrieval_coco_albef_ft.yaml",
                                  "retrieval_flickr_albef_ft.yaml"])
def test_cli_train_retrieval_equals_jax(name, pairs, tmp_path, monkeypatch):
    model, jstate, state = run_both(name, pairs, tmp_path, monkeypatch)
    check_equal(name, model, jstate, state, tmp_path)


def test_resumed_run_equals_uninterrupted(pairs, tmp_path):
    """pretrain_albef.yaml (the MLM masks' RandomState is state too) over two
    epochs in one run, and one epoch then a resume from its
    ``last_state.pt``: the same parameters, aux state (momentum copies,
    queues, ``idx_queue``, ``ptr``) and mask stream, bit for bit. The pixels
    come through the deterministic eval transform (the train transform's
    RandomState is the dataset's and starts again in a new process)."""
    from sprc_tpu_torch.cli import train as train_cli
    from sprc_tpu_torch.config import Config

    model = port_model("albef_pretrain", "base", 6, **tiny_model_section("albef_pretrain"))
    ckpt = str(tmp_path / "lavis.pth")
    lavis_file(model, ckpt)

    def config(epochs):
        cfg = run_config("pretrain_albef.yaml", pairs, total_steps=6, max_epochs=epochs)
        cfg["datasets"]["conceptual_caption_3m"]["vis_processor"]["train"] = {
            "name": "blip_image_eval", "image_size": IMG}
        return Config(defaults=cfg)

    train_cli.train(config(2), _args(pairs, tmp_path / "whole", ckpt))
    train_cli.train(config(1), _args(pairs, tmp_path / "a", ckpt))
    train_cli.train(config(2), _args(pairs, tmp_path / "a", ckpt,
                                     resume=str(tmp_path / "a" / "last_state.pt")))
    whole = torch.load(tmp_path / "whole" / "last_state.pt", weights_only=True)
    resumed = torch.load(tmp_path / "a" / "last_state.pt", weights_only=True)
    assert whole["updates"] == resumed["updates"] == 6

    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from flat(v, f"{prefix}{k}.")
        elif torch.is_tensor(tree):
            yield prefix, tree

    a, b = dict(flat(whole["trainable"])), dict(flat(resumed["trainable"]))
    a.update(flat(whole["aux"], "aux.")), b.update(flat(resumed["aux"], "aux."))
    assert set(a) == set(b) and any(k.startswith("aux.params_m.") for k in a)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert int(whole["aux"]["ptr"]) == (6 * 4) % 8
    np.testing.assert_array_equal(whole["adapter"]["mlm_rng"][1].numpy(),
                                  resumed["adapter"]["mlm_rng"][1].numpy())
    assert _rows(tmp_path / "whole")[-1]["loss_mlm"] == _rows(tmp_path / "a")[-1]["loss_mlm"]
