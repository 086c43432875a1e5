"""The port's image <-> text retrieval evaluation (retrieval/sim_matrix.py,
train/tasks.py, cli/evaluate.py) against sprc_tpu's.

The tiny ``blip2_image_text_matching`` of test_torch_stage1.py (JAX
weights carried across, strict load, fp32, the CPU: K1 and K3 run their
plain versions). ``compute_sim_matrix`` gets the same frozen rows and
features in both packages: the same -100 pattern, scores within 1e-5, equal
recalls; rescoring ``itm_batch`` candidates a call or all of a row's in one
call gives the same scores. Then both evaluate CLIs run one YAML run config
over a synthetic ``coco_retrieval`` test split (12 PNG images of mixed sizes,
2 or 3 captions each, ``k_test`` 4 through ``--options``) on the same
weights, and print the same metric JSON (the JAX CLI cannot read a torch
file for a stage-1 model, so its ``load_checkpoint_auto`` is handed the
tree that the port's ``--model-path`` file was made from).
"""

import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
yaml = pytest.importorskip("yaml")
import jax.numpy as jnp  # noqa: E402

from sprc_tpu.retrieval import sim_matrix as jsim  # noqa: E402

from sprc_tpu_torch.interop.jax_params import state_dict_from_jax  # noqa: E402
from sprc_tpu_torch.retrieval import sim_matrix  # noqa: E402
from test_torch_stage1 import jax_model, jax_params, port_model  # noqa: E402
from test_torch_train_losses import EMBED, IMG, Q, QF, TXT, VIT, VOCAB  # noqa: E402
from test_torch_threads import one_torch_thread  # noqa: E402,F401  (one thread a module)

ATOL = 1e-5
N_IMG, N_TXT = 7, 11


@pytest.fixture(scope="module")
def itm_models():
    jm = jax_model("blip2_image_text_matching")
    params = jax_params(jax_model())
    return jm, params, port_model(params, "blip2_image_text_matching").eval()


@pytest.fixture(scope="module")
def features(itm_models):
    jm, params, _ = itm_models
    rng = np.random.RandomState(21)
    images = rng.rand(N_IMG, IMG, IMG, 3).astype(np.float32)
    ids = rng.randint(4, VOCAB, (N_TXT, TXT)).astype(np.int32)
    ids[:, 0] = 2
    mask = np.ones((N_TXT, TXT), np.int32)
    mask[::3, -2:] = 0
    feats, frozen = jm.apply({"params": params}, jnp.asarray(images),
                             method=jm.extract_target_features)
    text = jm.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask),
                    method=jm.encode_text_cls)
    return np.array(frozen), np.array(feats), ids, mask, np.array(text)


@pytest.mark.parametrize("itm_batch,shard", [(3, (0, 1)), (16, (0, 1)), (3, (1, 2))])
def test_compute_sim_matrix_equals_jax(itm_models, features, itm_batch, shard):
    jm, params, model = itm_models
    frozen, feats, ids, mask, text = features
    want = jsim.compute_sim_matrix(jm, params, frozen, feats, ids, mask, text, k_test=4,
                                   itm_batch=3, shard_index=shard[0], num_shards=shard[1])
    stats = {}
    got = sim_matrix.compute_sim_matrix(model, frozen, torch.from_numpy(feats), ids, mask,
                                        torch.from_numpy(text), k_test=4, itm_batch=itm_batch,
                                        shard_index=shard[0], num_shards=shard[1], stats=stats)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_array_equal(g == -100.0, w == -100.0)
        np.testing.assert_allclose(g, w, atol=ATOL)
    rows = sum(len(range(shard[0] * (n // shard[1] + 1), min(n, (shard[0] + 1) * (n // shard[1] + 1))))
               for n in (N_IMG, N_TXT))
    assert stats["itm_calls"] == rows * -(-4 // itm_batch)
    img2txt = {i: [t for t in range(N_TXT) if t % N_IMG == i] for i in range(N_IMG)}
    txt2img = {t: t % N_IMG for t in range(N_TXT)}
    if shard == (0, 1):
        assert sim_matrix.retrieval_recalls(*got, img2txt, txt2img) == \
            jsim.retrieval_recalls(*want, img2txt, txt2img)


def _write_split(root):
    """12 PNG images of mixed sizes, 2 or 3 captions each (coco_retrieval's
    eval schema), a vocabulary of the caption words."""
    from PIL import Image

    rng = np.random.RandomState(5)
    words = ["red", "blue", "cat", "dog", "tree", "car", "sky", "sea", "two", "a", "on", "the"]
    ann = []
    (root / "imgs").mkdir()
    for i in range(12):
        h, w = 24 + 7 * (i % 4), 40 - 5 * (i % 3)
        name = f"im{i:02d}.png"
        Image.fromarray((rng.rand(h, w, 3) * 255).astype(np.uint8)).save(root / "imgs" / name)
        caps = [" ".join(rng.choice(words, 4)) + "." for _ in range(2 + i % 2)]
        ann.append({"image": name, "caption": caps, "image_id": i})
    (root / "test.json").write_text(json.dumps(ann))
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + words + [".", ","]
    (root / "vocab.txt").write_text("\n".join(vocab))
    return str(root / "test.json"), str(root / "imgs"), str(root / "vocab.txt")


def test_evaluate_cli_prints_the_jax_metrics(itm_models, tmp_path, monkeypatch, capsys):
    """``cli/evaluate.py`` on a run config like ret_coco_blip2_eval.yaml
    (task retrieval, ``k_test`` and the tiny model through ``--options`` and
    the YAML): the JAX CLI's JSON, key for key and value for value."""
    from sprc_tpu.cli import evaluate as jevaluate
    from sprc_tpu.interop import torch_import

    from sprc_tpu_torch.cli import evaluate

    _, params, _ = itm_models
    ann, images, vocab = _write_split(tmp_path)
    ckpt = tmp_path / "blip2_itm.pth"
    torch.save({"model": state_dict_from_jax(params, vit="eva_clip_g")}, ckpt)
    vit = dict(VIT, dtype="fp32")
    qf = dict(QF, dropout_rate=0.0)
    cfg = {"run": {"task": "retrieval", "evaluate": True, "k_test": 128, "max_txt_len": TXT,
                   "test_splits": ["test"]},
           "model": {"arch": "blip2_image_text_matching", "image_size": IMG,
                     "num_query_token": Q, "max_txt_len": TXT, "vocab_size": VOCAB,
                     "embed_dim": EMBED, "vit_dtype": "fp32", "vit_config_override": vit,
                     "qformer_config_override": qf},
           "datasets": {"coco_retrieval": {
               "build_info": {"annotations": {"test": [ann]}, "images": images},
               "vis_processor": {"eval": {"name": "blip_image_eval", "image_size": IMG}},
               "text_processor": {"eval": {"name": "blip_caption"}}}}}
    cfg_path = tmp_path / "ret_eval.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    argv = ["--cfg-path", str(cfg_path), "--vocab-path", vocab, "--model-path", str(ckpt),
            "--output-dir", str(tmp_path / "out"), "--options", "run.k_test=4"]
    monkeypatch.setattr(torch_import, "load_checkpoint_auto", lambda path, model: params)
    jevaluate.main(argv)
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    evaluate.main(argv + ["--device", "cpu"])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got == want
    assert set(got) == {"txt_r1", "txt_r5", "txt_r10", "img_r1", "img_r5", "img_r10", "r_mean",
                        "agg_metrics"}
    assert 0.0 < got["r_mean"] < 100.0


def test_evaluate_refuses_what_is_not_ported(tmp_path, monkeypatch):
    """A model with no captioning glue says so (BLIP-1's captioner and CLIP,
    once refused, run: test_torch_blip_caption.py, test_torch_clip_cli.py);
    ALPRO's retrieval, once refused, goes on to build its model (it runs:
    test_torch_alpro_cli.py); the default device is the card (nonzero exit
    without one)."""
    import argparse

    from sprc_tpu_torch import loader
    from sprc_tpu_torch.cli import evaluate
    from sprc_tpu_torch.config import Config

    args = argparse.Namespace(device="cpu", model_path=None, vocab_path=None, split=None)
    with pytest.raises(SystemExit, match="no captioning glue fits it"):
        evaluate.evaluate(Config(defaults={"run": {"task": "captioning"},
                                           "model": {"arch": "blip2"}}), args)

    def load_model(name, model_type, **kw):
        raise LookupError(f"built {name}")

    monkeypatch.setattr(loader, "load_model", load_model)
    with pytest.raises(LookupError, match="built alpro_retrieval"):
        evaluate.evaluate(Config(defaults={"run": {"task": "retrieval"},
                                           "model": {"arch": "alpro_retrieval"}}), args)
    monkeypatch.undo()
    assert evaluate.make_parser().parse_args(["--cfg-path", "x"]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA"):
            evaluate.evaluate(Config(defaults={"run": {"task": "retrieval"},
                                               "model": {"arch": "blip2"}}),
                              argparse.Namespace(device="cuda", model_path=None))
