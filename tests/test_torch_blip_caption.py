"""BLIP-1's greedy caption decode, its caption evaluation CLI, the BLIP-1
CIR feature extractor (models/blip1.py) and ``features.extract_features``
over every family, in the port against sprc_tpu's.

The models are test_torch_blip1.py's tiny ones (ViT width 64 at 32 px,
med-BERT hidden 64): the captioner from its ``caption`` fixture; the CIR
extractor (``blip_cir_base``: 4 prompts, the med-BERT in text mode) read
into JAX by ``blip_cir_base_params_from_torch``; BLIP-2 stage 1, BLIP-1 and
ALBEF retrieval from test_torch_stage1.py's and test_torch_momentum.py's
pairs; CLIP from test_torch_clip.py's. Seeded numpy inputs, fp32, within
1e-5; ids and metrics equal.
"""

import argparse
import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sprc_tpu_torch import loader  # noqa: E402
from sprc_tpu_torch.interop.jax_params import blip_cir_base_from_jax  # noqa: E402
from test_torch_blip1 import (IMG, TXT, VIT, VOCAB, caption, inputs, jax_configs,  # noqa: E402,F401
                              numpy_state, port_model, t)
from test_torch_threads import one_torch_thread  # noqa: E402,F401  (one thread a module)

TOL = 1e-5
P = 4  # prompts of the tiny CIR extractor
CIR_TXT = dict(TXT, query_length=P, cross_attention_freq=1)


def close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, atol=tol * max(1.0, float(np.abs(want).max())), rtol=0)


def test_generate_ids_equal_jax(caption):
    """Greedy ids from the ``[DEC]``-prefixed prompt: 12 new tokens with an
    eos no row emits, then with the token a row emits at its third step as
    the eos (that row stops and pads; the rest go on), from the tower and
    from given tower rows."""
    jm, params, model = caption
    img = inputs(21, B=3)[0]
    prompt = np.tile(np.asarray([[4, 11, 12, 13]], np.int32), (3, 1))
    with torch.no_grad():
        free = model.generate_ids(t(img), t(prompt), eos_token_id=VOCAB + 1, pad_token_id=0,
                                  max_new_tokens=12).numpy()
    want = np.asarray(jm.generate_ids(params, jnp.asarray(img), jnp.asarray(prompt),
                                      eos_token_id=VOCAB + 1, pad_token_id=0, max_new_tokens=12))
    np.testing.assert_array_equal(free, want)
    eos = int(free[1, 2])
    stats = {}
    with torch.no_grad():
        rows = model.encode_image(t(img))
        got = model.generate_ids(None, t(prompt), eos_token_id=eos, pad_token_id=0,
                                 max_new_tokens=12, image_embeds=rows, stats=stats).numpy()
    want = np.asarray(jm.generate_ids(params, jnp.asarray(img), jnp.asarray(prompt),
                                      eos_token_id=eos, pad_token_id=0, max_new_tokens=12))
    np.testing.assert_array_equal(got, want)
    first = int(np.argmax(got[1] == eos))
    assert first <= 2 and (got[1, first + 1:] == 0).all()
    assert set(stats) == {"tower", "decode", "steps"} and 1 <= stats["steps"] <= 12


@pytest.fixture(scope="module")
def cir():
    """(JAX BlipCirBase, its params from the port's weights, the port's model)."""
    from sprc_tpu.models.blip1 import Blip1Config, BlipCirBase, blip_cir_base_params_from_torch
    from sprc_tpu.models.qformer import QFormerConfig

    jv, _ = jax_configs()
    jm = BlipCirBase(Blip1Config(image_size=IMG, embed_dim=16, vocab_size=VOCAB, num_prompts=P,
                                 vit_dtype=jnp.float32, vit_config_override=jv,
                                 text_config_override=QFormerConfig(**CIR_TXT)))
    model = port_model("blip_cir_base", "base", 2, image_size=IMG, embed_dim=16,
                       vocab_size=VOCAB, num_prompts=P, vit_config_override=VIT,
                       text_config_override=CIR_TXT)
    return jm, blip_cir_base_params_from_torch(numpy_state(model), jm), model


def test_blip_cir_base_equals_jax(cir, tmp_path):
    """The CLS projection, the prompt-conditioned text feature at index P
    (every row through the text FFN: the Q-Former's no-image pass) and the
    forward; the med-BERT holds no cross-attention or query FFN, and a LAVIS
    file that holds med's cross-attention reads strictly."""
    jm, params, model = cir
    img, ids, mask = inputs(22, B=3)
    prompts = np.random.RandomState(23).randn(3, P, 64).astype(np.float32)
    j = [jnp.asarray(a) for a in (img, ids, mask, prompts)]
    want_txt, want_img = jm.apply({"params": params}, *j)
    with torch.no_grad():
        got_txt, got_img = model(t(img), t(ids), t(mask), t(prompts))
        close(model.extract_target_features(t(img)).numpy(), want_img)
    close(got_txt.numpy(), want_txt)
    close(got_img.numpy(), want_img)
    keys = set(model.state_dict())
    assert not any("crossattention" in k or "_query" in k for k in keys)
    back = blip_cir_base_from_jax(params)  # the bridge gives the tree back bit for bit
    assert set(back) == keys and all(torch.equal(back[k], v)
                                     for k, v in model.state_dict().items())
    assert "text_encoder.encoder.layer.1.intermediate.dense.weight" in keys
    sd = {k: torch.from_numpy(v) for k, v in numpy_state(model).items()}
    sd["text_encoder.encoder.layer.0.crossattention.self.key.weight"] = torch.zeros(64, 64)
    path = str(tmp_path / "cir.pth")
    torch.save({"model": sd}, path)
    loaded = loader.load_model("blip_feature_extractor", "base", path, device="cpu",
                               image_size=IMG, embed_dim=16, vocab_size=VOCAB, num_prompts=P,
                               vit_config_override=VIT, text_config_override=CIR_TXT)
    with torch.no_grad():
        np.testing.assert_array_equal(loaded(t(img), t(ids), t(mask), t(prompts))[0].numpy(),
                                      got_txt.numpy())


def _family(name):
    """(the port's model, the JAX model, its params) of ``name``."""
    if name == "blip2":
        from test_torch_stage1 import jax_model
        from test_torch_stage1 import jax_params as stage1_params
        from test_torch_stage1 import port_model as stage1_port

        jm = jax_model()
        params = stage1_params(jm)
        return stage1_port(params), jm, params
    if name in ("blip_retrieval", "albef_retrieval"):
        from test_torch_momentum import tiny_pair

        return tiny_pair(name, seed=4)
    if name == "clip":
        from test_torch_clip import clip_pair

        return clip_pair(seed=5)
    return None


@pytest.mark.parametrize("name", ["blip2", "blip_retrieval", "albef_retrieval",
                                  "blip_cir_base", "clip"])
def test_extract_features_equal_jax(name, cir):
    """``extract_features`` in the image, text and multimodal modes (the CIR
    extractor refuses the last in both packages) on pre-tokenized samples;
    every field the JAX function fills, the port fills equally."""
    from sprc_tpu.features import extract_features as jextract

    from sprc_tpu_torch.features import extract_features

    if name == "blip_cir_base":
        jm, params, model = cir
    else:
        model, jm, params = _family(name)
    size = getattr(jm.cfg, "image_size", IMG)
    vocab = {"clip": 60, "blip2": 40}.get(name, VOCAB)
    rs = np.random.RandomState(24)
    samples = {"image": rs.rand(2, size, size, 3).astype(np.float32),
               "input_ids": rs.randint(5, vocab, (2, 6)).astype(np.int32),
               "attention_mask": np.asarray([[1] * 6, [1] * 4 + [0] * 2], np.int32)}
    if name == "blip_cir_base":
        samples["prompts"] = rs.randn(2, P, 64).astype(np.float32)
    for mode in ("image", "text", "multimodal"):
        if name == "blip_cir_base" and mode == "multimodal":
            for fn, args in ((extract_features, (model,)), (jextract, (jm, params))):
                with pytest.raises(ValueError, match="no multimodal mode"):
                    fn(*args, samples, mode)
            continue
        want = jextract(jm, params, samples, mode)
        got = extract_features(model, samples, mode)
        for field in ("image_embeds", "image_embeds_proj", "text_embeds", "text_embeds_proj",
                      "multimodal_embeds"):
            w, g = getattr(want, field), getattr(got, field)
            assert (w is None) == (g is None), (mode, field)
            if w is not None:
                close(g, w)


def test_caption_eval_cli_equals_jax(caption, tmp_path):
    """configs/runs/eval/caption_coco_eval.yaml's run section on the tiny
    captioner over 5 PNG images (``batch_size_eval`` 2: the last batch
    padded): both CLIs read one LAVIS file, decode from ``[DEC]`` + the
    prompt until ``[SEP]`` or ``max_len``, and give the same captions,
    result file and metrics."""
    from sprc_tpu.cli import evaluate as jevaluate
    from sprc_tpu.config import Config as JConfig

    from sprc_tpu_torch.cli import evaluate
    from sprc_tpu_torch.config import Config
    from test_torch_caption_cli import _write_split

    yaml = pytest.importorskip("yaml")
    _, _, model = caption
    ann, images, vocab = _write_split(tmp_path)
    ckpt = str(tmp_path / "caption.pth")
    torch.save({"model": {k: torch.from_numpy(v) for k, v in numpy_state(model).items()}}, ckpt)
    with open("configs/runs/eval/caption_coco_eval.yaml") as f:
        cfg = yaml.safe_load(f)
    cfg["run"].update(batch_size_eval=2, max_len=8)
    cfg["model"].update(image_size=IMG, vit_config_override=VIT, text_config_override=TXT)
    cfg["datasets"]["coco_caption"]["build_info"] = {"annotations": {"test": [ann]},
                                                     "images": images}
    cfg["datasets"]["coco_caption"]["vis_processor"]["eval"]["image_size"] = IMG
    out = {}
    for kind, fn, conf in (("jax", jevaluate.evaluate, JConfig), ("port", evaluate.evaluate,
                                                                   Config)):
        args = argparse.Namespace(model_path=ckpt, vocab_path=vocab, split=None, device="cpu",
                                  output_dir=str(tmp_path / kind))
        out[kind] = fn(conf(defaults=cfg), args)
    assert out["port"] == out["jax"] and "agg_metrics" in out["port"]
    rows = [json.loads((tmp_path / kind / "result" / "test_epochx.json").read_text())
            for kind in ("jax", "port")]
    assert rows[0] == rows[1] and len(rows[0]) == 5 and any(r["caption"] for r in rows[0])
