"""BLIP-1's caption fine-tune (train/generic.py's ``CaptionAdapter`` over
``BlipCaption``, cli/train.py) against sprc_tpu's, and the other caption run
YAMLs through the port's CLIs.

Both train CLIs run configs/runs/caption_coco_ft.yaml (``blip_caption`` with
no model type: the dataclass's defaults in both packages) on
test_torch_blip1.py's tiny captioner cut to ViT depth 1 (its med decoder's
dropout 0: the packages draw their masks from different generators) over
12 seeded PNG captions (batch 4: 3 steps), from one
LAVIS file: the JAX run's init is handed what its LAVIS importer reads from
it, its orbax checkpoint write a no-op. Held: each step's loss within 1e-5
of its value, the parameters after the three AdamW steps within 1e-5, and
the tower among them (JAX's captioner has no ``FROZEN_PREFIXES``: it
trains). Then the port alone runs caption_coco_ft_iter.yaml
(``runner_iter``), caption_coco_large_ft.yaml (``large_coco``) and the
evaluations caption_coco_large_eval.yaml and nocaps_eval.yaml on the same
model (their code paths are the ones held above and in
test_torch_blip_caption.py).
"""

import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
yaml = pytest.importorskip("yaml")

from sprc_tpu.train import checkpoint as jcheckpoint  # noqa: E402
from sprc_tpu.train import generic as jgeneric  # noqa: E402
from sprc_tpu.train import runner as jrunner  # noqa: E402

from sprc_tpu_torch.interop.jax_params import blip_caption_from_jax  # noqa: E402
from test_torch_blip1 import IMG, TXT, VIT, numpy_state, port_model  # noqa: E402
from test_torch_caption_cli import WORDS  # noqa: E402
from test_torch_threads import one_torch_thread  # noqa: E402,F401  (one thread a module)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
TINY = {"image_size": IMG, "vit_config_override": dict(VIT, depth=1),
        "text_config_override": dict(TXT, num_layers=2)}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """12 PNG images of mixed sizes with a caption each and a BERT vocabulary."""
    from PIL import Image

    root = tmp_path_factory.mktemp("coco_caption")
    rng = np.random.RandomState(21)
    ann = []
    for i in range(12):
        name = f"c{i:02d}.png"
        Image.fromarray((rng.rand(26 + 5 * (i % 4), 40 - 4 * (i % 3), 3) * 255).astype(
            np.uint8)).save(root / name)
        ann.append({"image": name, "caption": " ".join(rng.choice(WORDS, 4 + i % 3)),
                    "image_id": f"i{i}"})
    (root / "train.json").write_text(json.dumps(ann))
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + WORDS + [".", ","]
    (root / "vocab.txt").write_text("\n".join(vocab))
    return {"root": str(root), "vocab": str(root / "vocab.txt")}


@pytest.fixture(scope="module")
def lavis(data, tmp_path_factory):
    """The tiny captioner's weights as a LAVIS file (with the tied
    ``cls.predictions.bias``) and as the state dict it holds."""
    model = port_model("blip_caption", "pretrain", 8, **TINY)
    sd = {k: torch.from_numpy(v) for k, v in numpy_state(model).items()}
    path = str(tmp_path_factory.mktemp("caption") / "blip_caption.pth")
    torch.save({"model": sd}, path)
    return path, sd


def argv(data, name, out, *extra):
    ds = "datasets.coco_caption"
    opts = [f"model.{k}={json.dumps(v)}" for k, v in TINY.items()]
    return ["--cfg-path", os.path.join(ROOT, "configs", "runs", name), "--vocab-path",
            data["vocab"], "--output-dir", str(out), "--options", "run.batch_size=4",
            "run.max_epochs=1", "run.max_txt_len=8", "run.log_freq=1",
            f"{ds}.build_info.annotations.train=[{os.path.join(data['root'], 'train.json')}]",
            f"{ds}.build_info.images={data['root']}",
            f"{ds}.vis_processor.train.image_size={IMG}", *opts, *extra]


def _rows(out, kind="step"):
    with open(os.path.join(out, "log.jsonl")) as f:
        return [r for r in map(json.loads, f) if r["kind"] == kind]


def test_cli_train_caption_coco_ft_equals_jax(data, lavis, tmp_path, monkeypatch):
    from sprc_tpu.cli import train as jtrain
    from sprc_tpu.interop.lavis_import import blip_caption_params_from_torch

    from sprc_tpu_torch.cli import train

    path, sd = lavis
    captured = {}
    jrun = jrunner.EpochRunner.train

    def keep_jax(self):
        best = jrun(self)
        captured["jax"] = jax.tree_util.tree_map(np.asarray, self.state.params)
        return best

    monkeypatch.setattr(jrunner.EpochRunner, "train", keep_jax)
    monkeypatch.setattr(jcheckpoint, "save_state", lambda path, state: None)
    monkeypatch.setattr(jgeneric.CaptionAdapter, "init_params", lambda self, jm, rng, size: (
        blip_caption_params_from_torch({k: v.numpy() for k, v in sd.items()}, jm)),
        raising=False)
    jtrain.main(argv(data, "caption_coco_ft.yaml", tmp_path / "jax"))
    train.main(argv(data, "caption_coco_ft.yaml", tmp_path / "port")
               + ["--model-path", path, "--device", "cpu"])
    want, got = _rows(tmp_path / "jax"), _rows(tmp_path / "port")
    assert [r["step"] for r in got] == [r["step"] for r in want] == [0, 1, 2]
    for g, w in zip(got, want):
        assert not g["skipped_nonfinite"] and not w["skipped_nonfinite"]
        assert abs(g["loss"] - w["loss"]) <= TOL * abs(w["loss"]), (g, w)
    state = torch.load(tmp_path / "port" / "last_state.pt", weights_only=True)
    assert state["updates"] == 3
    want_params = blip_caption_from_jax(captured["jax"])
    trained = state["trainable"]
    assert set(trained) == set(want_params) - {k for k in want_params if "position_ids" in k}
    moved = 0
    for n, value in trained.items():
        np.testing.assert_allclose(value.numpy(), want_params[n].numpy(), atol=TOL, err_msg=n)
        moved += n.startswith("visual_encoder.") and not torch.equal(value, sd[n])
    assert moved > 0  # the tower trains


def test_other_caption_yamls_run(data, lavis, tmp_path, capsys):
    """caption_coco_ft_iter.yaml (``runner_iter``, 2 iterations) and
    caption_coco_large_ft.yaml (``large_coco``) train in the port; the
    evaluations caption_coco_large_eval.yaml and nocaps_eval.yaml decode and
    score the 12 captions' images, and print the JAX CLI's metric JSON."""
    from sprc_tpu_torch.cli import evaluate, train

    path, _ = lavis
    for name, kind, extra in (("caption_coco_ft_iter.yaml", "inner",
                               ["run.max_iters=2", "run.iters_per_inner_epoch=2"]),
                              ("caption_coco_large_ft.yaml", "step", [])):
        out = tmp_path / name
        train.main(argv(data, name, out, *extra) + ["--model-path", path, "--device", "cpu"])
        rows = _rows(out, kind)
        assert rows and all(np.isfinite(r["loss"]) for r in rows), name
    ann = [{"image": r["image"], "image_id": i, "caption": [r["caption"]]}
           for i, r in enumerate(json.load(open(os.path.join(data["root"], "train.json"))))]
    (tmp_path / "test.json").write_text(json.dumps(ann))
    for name, builder, split in (("caption_coco_large_eval.yaml", "coco_caption", "test"),
                                 ("nocaps_eval.yaml", "nocaps", "val")):
        ds = f"datasets.{builder}"
        opts = [f"model.{k}={json.dumps(v)}" for k, v in TINY.items()]
        evaluate.main(["--cfg-path", os.path.join(ROOT, "configs", "runs", "eval", name),
                       "--vocab-path", data["vocab"], "--model-path", path, "--device", "cpu",
                       "--output-dir", str(tmp_path / name), "--options", "run.max_len=5",
                       f"{ds}.build_info.annotations.{split}=[{tmp_path / 'test.json'}]",
                       f"{ds}.build_info.images={data['root']}",
                       f"{ds}.vis_processor.eval.image_size={IMG}", *opts])
        metrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert "agg_metrics" in metrics and "CIDEr" in metrics, (name, metrics)
        rows = json.loads((tmp_path / name / "result" / f"{split}_epochx.json").read_text())
        assert len(rows) == 12
