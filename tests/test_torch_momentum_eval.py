"""The momentum-queue families' retrieval evaluation and checkpoint reading
in the port (train/tasks.py's ``evaluate_pairs_itc``, cli/evaluate.py's
branch for them, loader.read_checkpoint on LAVIS's layouts) against
sprc_tpu's.

The tiny models of test_torch_momentum.py (the med-BERT's vocabulary
BLIP-1's 30,524 rows) from one LAVIS-layout file of the port's weights, its
momentum modules and queue buffers beside them, which both readers skip.
``evaluate_pairs_itc`` ranks 6 images x 2 captions (k_test 4) in both
packages: the rescored matrices (each row's top set equal, its scores within
1e-5) and the recalls equal. ``cli/evaluate.py`` on
configs/runs/eval/ret_{coco,flickr}{,_albef}_eval.yaml (k_test 4, 32 px,
the same split written as PNGs) prints JSON equal to the JAX CLI's.
"""

import argparse
import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
yaml = pytest.importorskip("yaml")

from sprc_tpu_torch import loader  # noqa: E402
from test_torch_blip1 import IMG, port_model  # noqa: E402
from test_torch_momentum import bridge  # noqa: E402
from test_torch_momentum_cli import lavis_file, tiny_model_section  # noqa: E402
from test_torch_threads import one_torch_thread  # noqa: E402,F401  (one thread a module)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
N_IMAGES, CAPTIONS, K_TEST = 6, 2, 4
EVALS = {"ret_coco_eval.yaml": ("blip_retrieval", "coco", "coco_retrieval"),
         "ret_flickr_eval.yaml": ("blip_retrieval", "flickr", "flickr30k"),
         "ret_coco_albef_eval.yaml": ("albef_retrieval", "coco", "coco_retrieval"),
         "ret_flickr_albef_eval.yaml": ("albef_retrieval", "flickr", "flickr30k")}


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """A retrieval test split of 6 PNG images with 2 captions each, its pixels
    (the eval transform at 32 px), a synthetic BERT vocabulary and the LAVIS
    file of each family's tiny model."""
    from PIL import Image

    from sprc_tpu_torch.data.processors import BlipImageEvalProcessor
    from sprc_tpu_torch.utils.artifacts import write_synthetic_bert_vocab

    root = tmp_path_factory.mktemp("split")
    rng = np.random.RandomState(21)
    words = ["a", "dog", "on", "the", "grass", "red", "car", "two", "cats", "sky"]
    ann, pixels, proc = [], [], BlipImageEvalProcessor(image_size=IMG)
    for i in range(N_IMAGES):
        name = f"t{i}.png"
        Image.fromarray((rng.rand(34, 40, 3) * 255).astype(np.uint8)).save(root / name)
        pixels.append(np.asarray(proc(Image.open(root / name).convert("RGB")), np.float32))
        ann.append({"image": name, "image_id": i,
                    "caption": [" ".join(rng.choice(words, 5)) for _ in range(CAPTIONS)]})
    (root / "test.json").write_text(json.dumps(ann))
    texts = [c for a in ann for c in a["caption"]]
    out = {"root": str(root), "vocab": write_synthetic_bert_vocab(str(root / "vocab.txt")),
           "pixels": np.stack(pixels), "texts": texts,
           "img2txt": {i: [CAPTIONS * i + j for j in range(CAPTIONS)] for i in range(N_IMAGES)},
           "txt2img": {t: t // CAPTIONS for t in range(len(texts))}, "models": {}}
    for arch in ("blip_retrieval", "albef_retrieval"):
        model = port_model(arch, "coco", 8, **tiny_model_section(arch))
        path = str(root / f"{arch}.pth")
        out["models"][arch] = (path, lavis_file(model, path))
    return out


def _jax_model(arch, model_type):
    from sprc_tpu.loader import build_model

    return build_model(arch, model_type, **tiny_model_section(arch))


def _capture(monkeypatch, module, into):
    real = module.retrieval_recalls

    def recalls(s_i2t, s_t2i, img2txt, txt2img):
        into.append((np.asarray(s_i2t), np.asarray(s_t2i)))
        return real(s_i2t, s_t2i, img2txt, txt2img)

    monkeypatch.setattr(module, "retrieval_recalls", recalls)


@pytest.mark.parametrize("arch", ["blip_retrieval", "albef_retrieval"])
def test_evaluate_pairs_itc_equals_jax(arch, split, monkeypatch):
    from sprc_tpu.interop.lavis_import import lavis_params_from_torch
    from sprc_tpu.retrieval import sim_matrix as jsim
    from sprc_tpu.text.tokenizer import BertWordPieceTokenizer as JTok
    from sprc_tpu.train.tasks import ImageTextRetrievalTask as JTask

    from sprc_tpu_torch.retrieval import sim_matrix
    from sprc_tpu_torch.text.tokenizer import BertWordPieceTokenizer
    from sprc_tpu_torch.train.tasks import ImageTextRetrievalTask

    path, sd = split["models"][arch]
    jm = _jax_model(arch, "coco")
    params = lavis_params_from_torch({k: v.numpy() for k, v in sd.items()}, jm)
    model = loader.load_model(arch, "coco", path, device="cpu", **tiny_model_section(arch))
    want_m, got_m = [], []
    _capture(monkeypatch, jsim, want_m)
    _capture(monkeypatch, sim_matrix, got_m)
    args = (split["pixels"], split["texts"], split["img2txt"], split["txt2img"])
    want = JTask(JTok.from_vocab_file(split["vocab"]), k_test=K_TEST).evaluate_pairs_itc(
        jm, params, *args)
    stats = {}
    got = ImageTextRetrievalTask(BertWordPieceTokenizer.from_vocab_file(split["vocab"]),
                                 k_test=K_TEST).evaluate_pairs_itc(model, *args, stats=stats)
    assert got == want
    assert set(stats) == {"image_encode_s", "text_encode_s", "itc_s", "itm_s"}
    for g, w in zip(got_m[0], want_m[0]):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g == -100.0, w == -100.0)
        assert ((g != -100.0).sum(axis=1) == K_TEST).all()
        np.testing.assert_allclose(g, w, atol=TOL)


def _eval_config(name, split):
    with open(os.path.join(ROOT, "configs", "runs", "eval", name)) as f:
        cfg = yaml.safe_load(f)
    arch, _, builder = EVALS[name]
    cfg["run"]["k_test"] = K_TEST
    cfg["model"].update(tiny_model_section(arch))
    ds = cfg["datasets"][builder]
    ds["build_info"] = {"annotations": {"test": [os.path.join(split["root"], "test.json")]},
                        "images": split["root"]}
    ds["vis_processor"]["eval"]["image_size"] = IMG
    return cfg


@pytest.mark.parametrize("name", list(EVALS))
def test_cli_evaluate_equals_jax(name, split, tmp_path, capsys):
    from sprc_tpu.cli import evaluate as jevaluate
    from sprc_tpu.config import Config as JConfig

    from sprc_tpu_torch.cli import evaluate
    from sprc_tpu_torch.config import Config

    arch = EVALS[name][0]
    cfg = _eval_config(name, split)
    args = argparse.Namespace(model_path=split["models"][arch][0], vocab_path=split["vocab"],
                              output_dir=str(tmp_path), split=None, device="cpu")
    want = jevaluate.evaluate(JConfig(defaults=cfg), args)
    stats = {}
    got = evaluate.evaluate(Config(defaults=cfg), args, stats=stats)
    scalars = {k: v for k, v in want.items() if isinstance(v, (int, float, str))}
    assert json.dumps({k: v for k, v in got.items() if isinstance(v, (int, float, str))}) == \
        json.dumps(scalars)
    assert "r_mean" in got and got["agg_metrics"] == got["r_mean"]
    assert stats["itm_s"] > 0


def test_read_lavis_layouts(split, tmp_path):
    """``loader.read_checkpoint`` on LAVIS's four layouts against the JAX
    readers (``lavis_params_from_torch``, bridged to the port's names):
    retrieval files for both retrieval models, pretraining files for both
    pretrainers and for the retrieval models (ALBEF's ``text_encoder.bert.``
    read as ``text_encoder.``, its MLM head and BLIP-1's decoder dropped; the
    JAX trees keep those heads, which a retrieval forward never reads); the
    momentum modules and queues dropped by name; an unknown key raises."""
    from sprc_tpu.interop.lavis_import import lavis_params_from_torch

    files = {}
    for arch, model_type in (("blip_pretrain", "base"), ("albef_pretrain", "base")):
        model = port_model(arch, model_type, 9, **tiny_model_section(arch))
        path = str(tmp_path / f"{arch}.pth")
        files[arch] = (path, lavis_file(model, path))
    files.update(split["models"])
    cases = [("blip_retrieval", "coco", "blip_retrieval"), ("albef_retrieval", "coco",
                                                            "albef_retrieval"),
             ("blip_pretrain", "base", "blip_pretrain"), ("albef_pretrain", "base",
                                                          "albef_pretrain"),
             ("blip_retrieval", "coco", "blip_pretrain"),
             ("albef_retrieval", "coco", "albef_pretrain")]
    for arch, model_type, source in cases:
        path, sd = files[source]
        model = loader.build_model(arch, model_type, device="cpu", **tiny_model_section(arch))
        got = loader.read_checkpoint(path, model)
        model.load_state_dict(got, strict=True)
        jm = _jax_model(arch, model_type)
        tree = dict(lavis_params_from_torch({k: v.numpy() for k, v in sd.items()}, jm))
        # the JAX tree of a retrieval model read from a pretraining file also
        # holds the pretraining heads, which its forward never reads
        unread = {k for k in ("mlm_head", "text_decoder", "lm_head")
                  if k in tree and "retrieval" in arch}
        assert bool(unread) == (source != arch), (arch, source, unread)
        want = bridge(arch)({k: v for k, v in tree.items() if k not in unread})
        assert set(got) == set(want), (arch, source)
        for k, v in got.items():
            np.testing.assert_array_equal(v.numpy(), want[k].numpy(), err_msg=f"{source} {k}")
    assert any(loader.MOMENTUM_CHECKPOINT_DROPS.match(k) for k in files["blip_pretrain"][1])
    path, sd = files["albef_retrieval"]
    bad = str(tmp_path / "bad.pth")
    torch.save({"model": {**sd, "text_encoder.pooler.dense.weight": torch.zeros(2, 2)}}, bad)
    model = loader.build_model("albef_retrieval", "coco", device="cpu",
                               **tiny_model_section("albef_retrieval"))
    with pytest.raises(ValueError, match="text_encoder.pooler.dense.weight"):
        loader.read_checkpoint(bad, model)
    # the families' processors, as the JAX load_model_and_preprocess picks them
    vis, txt = loader.preprocessors("blip_retrieval", "coco")
    assert (type(vis["train"]).__name__, type(vis["eval"]).__name__) == (
        "BlipImageTrainProcessor", "BlipImageEvalProcessor")
    assert vis["eval"].image_size == 384 and type(txt["train"]).__name__ == "CaptionProcessor"
    assert loader.preprocessors("albef_pretrain", "base")[0]["train"].image_size == 224
