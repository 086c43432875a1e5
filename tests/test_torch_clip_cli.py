"""CLIP through ``cli/evaluate.py`` against sprc_tpu's: retrieval
(configs/runs/eval/exp_{coco,flickr}_ret_eval.yaml: the cosine of the two
towers' features alone) and zero-shot classification
(configs/runs/eval/imnet_zs_eval.yaml: the classifier over the labels as
class names and the 80 templates), and what the CLI still refuses.

Each YAML is read as it is, with test_torch_clip.py's tiny CLIP (the model
section's ``vision`` / ``text`` overrides) and 32 px images through the
YAML's ``blip_image_eval``, over 6 seeded PNG images (2 captions each; 3
classes). Both CLIs read one OpenAI-layout file (the port's state dict) and
tokenize with the BERT WordPiece fallback, as the JAX CLI does without
``run.clip_tokenizer_json``. The JAX evaluations run op by op
(``jax.disable_jit``). Held: the same metrics, the same result rows.
"""

import argparse
import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
yaml = pytest.importorskip("yaml")

from test_torch_clip import EMBED, IMG, TEXT, VISION, clip_pair  # noqa: E402
from test_torch_threads import one_torch_thread  # noqa: E402,F401  (one thread a module)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORDS = ["a", "photo", "of", "the", "cat", "dog", "red", "car", "bad", "many"]


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """6 PNG images, a retrieval and a classification annotation file, a
    BERT vocabulary, and the tiny CLIP's weights as a file."""
    from PIL import Image

    root = tmp_path_factory.mktemp("clip")
    rng = np.random.RandomState(31)
    ret, cls = [], []
    for i in range(6):
        name = f"p{i}.png"
        Image.fromarray((rng.rand(30 + 3 * i, 36, 3) * 255).astype(np.uint8)).save(root / name)
        ret.append({"image": name, "caption": [" ".join(rng.choice(WORDS, 5)) for _ in range(2)]})
        cls.append({"image": name, "label": i % 3})
    (root / "test.json").write_text(json.dumps(ret))
    (root / "val.json").write_text(json.dumps(cls))
    (root / "vocab.txt").write_text("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
                                              + WORDS + [".", ",", "0", "1", "2"]))
    model, _, _ = clip_pair(seed=32)
    torch.save(model.state_dict(), root / "clip.pth")
    return root


def _config(name, split, ann):
    with open(os.path.join(ROOT, "configs", "runs", "eval", name)) as f:
        cfg = yaml.safe_load(f)
    cfg["run"]["batch_size_eval"] = 4  # the last batch padded
    cfg["model"].update(embed_dim=EMBED, image_size=IMG, vision=VISION, text=TEXT)
    (builder, ds), = cfg["datasets"].items()
    sp = cfg["run"]["test_splits"][0]
    ds["build_info"] = {"annotations": {sp: [str(split / ann)]}, "images": str(split)}
    ds["vis_processor"]["eval"]["image_size"] = IMG
    return cfg


def _both(cfg, split, tmp_path):
    from sprc_tpu.cli import evaluate as jevaluate
    from sprc_tpu.config import Config as JConfig

    from sprc_tpu_torch.cli import evaluate
    from sprc_tpu_torch.config import Config

    out = {}
    for kind, fn, conf in (("jax", jevaluate.evaluate, JConfig),
                           ("port", evaluate.evaluate, Config)):
        args = argparse.Namespace(model_path=str(split / "clip.pth"),
                                  vocab_path=str(split / "vocab.txt"), split=None, device="cpu",
                                  output_dir=str(tmp_path / kind))
        with jax.disable_jit():
            out[kind] = fn(conf(defaults=cfg), args)
    return out["port"], out["jax"]


@pytest.mark.parametrize("name", ["exp_coco_ret_eval.yaml", "exp_flickr_ret_eval.yaml"])
def test_retrieval_cli_equals_jax(name, split, tmp_path):
    got, want = _both(_config(name, split, "test.json"), split, tmp_path)
    assert got == want
    assert {"txt_r1", "img_r1", "r_mean", "agg_metrics"} <= set(got)


def test_zero_shot_cli_equals_jax(split, tmp_path):
    got, want = _both(_config("imnet_zs_eval.yaml", split, "val.json"), split, tmp_path)
    assert got == want and 0.0 <= got["acc"] <= 1.0
    rows = [json.loads((tmp_path / kind / "result" / "val_epochx.json").read_text())
            for kind in ("jax", "port")]
    assert rows[0] == rows[1] and len(rows[0]) == 6


def test_evaluate_refusals(split, tmp_path, monkeypatch):
    """Zero-shot labels that are not 0..C-1 need class names; a model with
    no captioning glue exits in both packages' terms; ALPRO's retrieval,
    once refused, goes on to build its model (it runs:
    test_torch_alpro_cli.py); CLIP's and the CIR extractor's training
    refuses (no generic adapter fits their forward)."""
    from sprc_tpu_torch.cli import evaluate
    from sprc_tpu_torch.config import Config
    from sprc_tpu_torch.train.generic import run_generic

    cfg = _config("imnet_zs_eval.yaml", split, "val.json")
    (split / "odd.json").write_text(json.dumps([{"image": "p0.png", "label": 4}]))
    cfg["datasets"]["imagenet"]["build_info"]["annotations"]["val"] = [str(split / "odd.json")]
    args = argparse.Namespace(model_path=None, vocab_path=str(split / "vocab.txt"), split=None,
                              device="cpu", output_dir=str(tmp_path))
    with pytest.raises(SystemExit, match="run.classnames"):
        evaluate.evaluate(Config(defaults=cfg), args)
    cfg["run"]["classnames"] = ["cat", "dog", "car", "red", "sky"]
    assert "acc" in evaluate.evaluate(Config(defaults=cfg), args)
    with pytest.raises(SystemExit, match="no captioning glue fits it"):
        evaluate.evaluate(Config(defaults={"run": {"task": "captioning"},
                                           "model": {"arch": "blip2"}}), args)
    from sprc_tpu_torch import loader

    def load_model(name, model_type, **kw):
        raise LookupError(f"built {name}")

    monkeypatch.setattr(loader, "load_model", load_model)
    with pytest.raises(LookupError, match="built alpro_retrieval"):
        evaluate.evaluate(Config(defaults={"run": {"task": "retrieval"},
                                           "model": {"arch": "alpro_retrieval"}}), args)
    monkeypatch.undo()
    for arch in ("clip", "blip_cir_base"):
        with pytest.raises(SystemExit, match="no generic task adapter fits its forward"):
            run_generic(Config(defaults={"run": {"task": "captioning"},
                                         "model": {"arch": arch}}), args)
