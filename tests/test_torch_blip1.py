"""BLIP-1's ITM scorer and captioner in the port (models/vit.py's timm tower,
models/albef.py's MedEncoder, models/blip1.py, the loader rows and
interop/jax_params.py's bridges) against sprc_tpu's; GradCAM
(utils/gradcam.py) is held in test_torch_pnp_vqa.py, through the pipeline.

Tiny models (ViT width 64 / depth 2 at 32 px, patch 16; med-BERT hidden 64,
3 layers, 2 heads), built once a module: the port's from ``init_weights``
(its biases and norms moved by seeded noise), the JAX model's from those
weights through the JAX package's LAVIS importer; the same seeded numpy
inputs go through the JAX function (XLA on the CPU,
unfused, as its own tests run it) and the port's, fp32, within 1e-5 unless
stated.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sprc_tpu_torch import loader  # noqa: E402
from sprc_tpu_torch.interop.jax_params import (blip_caption_from_jax,  # noqa: E402
                                               blip_itm_from_jax)
from test_torch_threads import one_torch_thread  # noqa: E402,F401  (one thread a module)

IMG, VOCAB = 32, 40
VIT = dict(image_size=IMG, patch_size=16, width=64, depth=2, num_heads=2, mlp_hidden=128,
           final_norm=True, dtype="fp32")
TXT = dict(vocab_size=VOCAB, hidden_size=64, num_layers=3, num_heads=2, intermediate_size=128,
           encoder_width=64, dropout_rate=0.0)
TOL = 1e-5


def jax_configs():
    from sprc_tpu.models.qformer import QFormerConfig
    from sprc_tpu.models.vit import ViTConfig

    return (ViTConfig(**{**VIT, "dtype": jnp.float32}), QFormerConfig(**TXT))


def port_model(name, model_type, seed, **kw):
    """A tiny port model (``kw``: the overrides) from ``init_weights(seed)``,
    every bias and LayerNorm parameter moved off its init by seeded noise
    (so that a bias in the wrong place shows)."""
    model = loader.load_model(name, model_type, device="cpu", seed=seed, **kw)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            if p.dim() <= 1:
                p.add_(torch.randn(p.shape, generator=gen) * 0.05)
    return model


def numpy_state(model) -> dict:
    """The port's state dict as numpy, with LAVIS's tied
    ``cls.predictions.bias`` beside ``decoder.bias`` where there is a head."""
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    for k in [k for k in sd if k.endswith("cls.predictions.decoder.bias")]:
        sd[k.replace("decoder.bias", "bias")] = sd[k]
    return sd


def t(a) -> torch.Tensor:
    a = np.asarray(a)
    return torch.from_numpy(a.astype(np.int64) if a.dtype.kind in "iu" else a.copy())


def inputs(seed=0, B=2, L=7):
    rs = np.random.RandomState(seed)
    img = rs.rand(B, IMG, IMG, 3).astype(np.float32)
    ids = rs.randint(5, VOCAB, (B, L)).astype(np.int32)
    mask = np.ones((B, L), np.int32)
    mask[1, L - 2:] = 0
    return img, ids, mask


@pytest.fixture(scope="module")
def itm():
    """(JAX BlipITM, its params, the port's model): the port's random weights
    read by the JAX package's LAVIS importer (no JAX init to compile)."""
    from sprc_tpu.interop.lavis_import import blip_retrieval_params_from_torch
    from sprc_tpu.models.blip1 import BlipITM, BlipRetrievalConfig

    jv, jq = jax_configs()
    jm = BlipITM(BlipRetrievalConfig(image_size=IMG, embed_dim=16, vocab_size=VOCAB,
                                     vit_dtype=jnp.float32, vit_config_override=jv,
                                     text_config_override=jq))
    model = port_model("blip_image_text_matching", "large", 0, embed_dim=16,
                       vit_config_override=VIT, text_config_override=TXT)
    return jm, blip_retrieval_params_from_torch(numpy_state(model), jm), model


@pytest.fixture(scope="module")
def caption():
    from sprc_tpu.interop.lavis_import import blip_caption_params_from_torch
    from sprc_tpu.models.blip1 import BlipCaption, BlipCaptionConfig

    jv, jq = jax_configs()
    jm = BlipCaption(BlipCaptionConfig(image_size=IMG, vocab_size=VOCAB, vit_dtype=jnp.float32,
                                       vit_config_override=jv, text_config_override=jq))
    model = port_model("blip_caption", "large_coco", 1, vit_config_override=VIT,
                       text_config_override=TXT)
    return jm, blip_caption_params_from_torch(numpy_state(model), jm), model


@pytest.mark.parametrize("route", ["block", "none"])
def test_blip_tower_equals_jax(itm, route):
    """The timm tower (packed qkv with bias, exact GELU, final LayerNorm) on
    the whole-block route and op by op, against the JAX ClipViT with
    ``final_norm``; its names are LAVIS's."""
    from sprc_tpu.models.vit import ClipViT

    from sprc_tpu_torch.models.vit import EvaViT, ViTConfig

    jm, params, model = itm
    img = inputs(3, B=3)[0]
    want = np.asarray(ClipViT(jax_configs()[0]).apply({"params": params["visual_encoder"]},
                                                      jnp.asarray(img)))
    cfg = ViTConfig(**{**VIT, "dtype": torch.float32, "fused_block": route})
    tower = EvaViT(cfg)
    tower.load_state_dict(model.visual_encoder.state_dict(), strict=True)
    with torch.no_grad():
        got = tower(t(img)).numpy()
    assert got.shape == (3, 5, 64)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    keys = set(model.visual_encoder.state_dict())
    assert {"norm.weight", "blocks.1.attn.qkv.bias", "patch_embed.proj.bias", "cls_token",
            "pos_embed"} <= keys and not any("q_bias" in k for k in keys)


def test_med_encoder_modes_equal_jax(itm):
    """MedEncoder in ``text``, ``multimodal`` (with and without an
    ``image_mask``), ``fusion`` and ``is_decoder`` modes against the JAX
    module on the same weights and inputs."""
    from sprc_tpu.models.albef import MedEncoder as JMed

    jm, params, model = itm
    img, ids, mask = inputs(4)
    rows = np.random.RandomState(5).randn(2, 5, 64).astype(np.float32)
    image_mask = np.ones((2, 5), np.int32)
    image_mask[0, 3:] = 0
    jmed = JMed(jax_configs()[1], fusion_layer=2, cross_from=0)
    med = model.text_encoder
    med.fusion_layer = 2  # the JAX module's fusion_layer: modes split at layer 2
    cases = [dict(mode="text"), dict(mode="multimodal", image_embeds=rows),
             dict(mode="multimodal", image_embeds=rows, image_mask=image_mask),
             dict(mode="multimodal", image_embeds=rows, is_decoder=True),
             dict(mode="text", is_decoder=True)]
    try:
        for kw in cases:
            want = np.asarray(jmed.apply({"params": params["text_encoder"]},
                                         input_ids=jnp.asarray(ids),
                                         attention_mask=jnp.asarray(mask),
                                         **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                                            for k, v in kw.items()}))
            with torch.no_grad():
                got = med(input_ids=t(ids), attention_mask=t(mask),
                          **{k: t(v) if isinstance(v, np.ndarray) else v
                             for k, v in kw.items()}).numpy()
            np.testing.assert_allclose(got, want, atol=TOL, rtol=0, err_msg=str(kw.keys()))
        hidden = np.asarray(jmed.apply({"params": params["text_encoder"]},
                                       inputs_embeds=jnp.asarray(want), mode="fusion",
                                       image_embeds=jnp.asarray(rows)))
        with torch.no_grad():
            got = med(inputs_embeds=t(want), mode="fusion", image_embeds=t(rows)).numpy()
        np.testing.assert_allclose(got, hidden, atol=TOL, rtol=0)
    finally:
        med.fusion_layer = 3
    with pytest.raises(ValueError, match="mode"):
        med(input_ids=t(ids), mode="unimodal")


def test_itm_and_itc_equal_jax(itm):
    """``itm`` logits [B, 2], ``itc`` scores [B] and ``itm_embeds``' match
    probabilities against the JAX scorer's."""
    jm, params, model = itm
    img, ids, mask = inputs(6, B=3)
    j = [jnp.asarray(a) for a in (img, ids, mask)]
    with torch.no_grad():
        got_itm = model.itm(t(img), t(ids), t(mask)).numpy()
        got_itc = model.itc(t(img), t(ids), t(mask)).numpy()
        rows = model.encode_image(t(img))
        got_p = model.itm_embeds(t(ids), t(mask), rows).numpy()
    want_itm, want_itc, want_p = map(np.asarray, jax.jit(lambda p, im, i, m, r: (
        jm.apply({"params": p}, im, i, m, method=jm.itm),
        jm.apply({"params": p}, im, i, m, method=jm.itc),
        jm.apply({"params": p}, i, m, r, method=jm.itm_embeds)))(params, *j, rows.numpy()))
    assert got_itm.shape == (3, 2) and got_itc.shape == (3,)
    np.testing.assert_allclose(got_itm, want_itm, atol=TOL, rtol=0)
    # scores over the temperature (1 / 0.07): the cosine within 1e-5 of that scale
    np.testing.assert_allclose(got_itc, want_itc, atol=TOL / 0.07, rtol=0)
    np.testing.assert_allclose(got_p, want_p, atol=TOL, rtol=0)


def test_caption_logits_and_loss_equal_jax(caption):
    """``decode_logits`` (causal, cross-attending the image rows on every
    layer) and the label-smoothed loss (pads and the prompt masked) against
    the JAX captioner's."""
    jm, params, model = caption
    img, ids, mask = inputs(7, B=3, L=9)
    ids[:, 0] = 4  # bos
    ids[2, 6:] = 0
    mask[2, 6:] = 0
    j = [jnp.asarray(a) for a in (img, ids, mask)]
    with torch.no_grad():
        rows = model.encode_image(t(img))
        got = model.decode_logits(t(ids), t(mask), rows).numpy()
        loss = model(t(img), t(ids), t(mask))
    want, want_rows, want_loss = jax.jit(lambda p, im, i, m, r: (
        jm.apply({"params": p}, i, m, r, method=jm.decode_logits),
        jm.apply({"params": p}, im, method=lambda mod, x: mod.visual_encoder(x)),
        jm.apply({"params": p}, im, i, m)))(params, *j, rows.numpy())
    np.testing.assert_allclose(rows.numpy(), np.asarray(want_rows), atol=TOL, rtol=0)
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=0)
    for k in ("loss", "loss_lm"):
        assert abs(loss[k].item() - float(want_loss[k])) <= TOL, k


def test_bridges_and_read_checkpoint(itm, caption, tmp_path):
    """The names are LAVIS's: every test here runs the JAX models on the
    port's state dicts read by the JAX importers
    (``lavis_import.blip_retrieval_params_from_torch`` /
    ``blip_caption_params_from_torch``); ``blip_itm_from_jax`` /
    ``blip_caption_from_jax`` give those trees back as the same state dicts,
    bit for bit, which load with ``strict=True``; and saved in the released
    ``{"model": ...}`` layout with a key the model lacks (and the caption
    head's tied ``cls.predictions.bias``), a state dict loads through
    ``loader.read_checkpoint`` with ``strict=True``."""
    for (jm, params, model), bridge, name, model_type, kw in (
            (itm, blip_itm_from_jax, "blip_image_text_matching", "large", {"embed_dim": 16}),
            (caption, blip_caption_from_jax, "blip_caption", "large_coco", {})):
        back = bridge(params)
        sd = model.state_dict()
        assert set(back) == set(sd), set(back) ^ set(sd)
        for k, v in sd.items():
            assert torch.equal(back[k].to(v.dtype), v), k
        path = tmp_path / f"{name}.pth"
        torch.save({"model": {**{k: torch.from_numpy(v) for k, v in numpy_state(model).items()},
                              "extra.unused": torch.zeros(1)}}, path)
        fresh = loader.build_model(name, model_type, device="cpu", vit_config_override=VIT,
                                   text_config_override=TXT, **kw)
        fresh.load_state_dict(back, strict=True)
        fresh.load_state_dict(loader.read_checkpoint(str(path), fresh), strict=True)
        for k, v in sd.items():
            assert torch.equal(fresh.state_dict()[k], v), k


def test_loader_rows_equal_jax():
    """FAMILY_CONFIGS and PIPELINE_CONFIGS against what sprc_tpu.loader
    builds from configs/models/: BLIP-1's ITM (base, large) and caption
    (base_coco, large_coco) configs field by field, their towers and
    med-BERTs, the FiD readers' T5 dimensions (v1.0: ReLU, tied), and the
    pnp_vqa and img2prompt_vqa sections."""
    import os

    from sprc_tpu.config import load_yaml, model_config_path
    from sprc_tpu.loader import build_model as jbuild

    for (name, model_type) in loader.FAMILY_CONFIGS:
        if name in loader.CLIP_MODELS:  # no med-BERT: test_torch_clip.py pins CLIP's rows
            continue
        if name in loader.VIDEO_MODELS:  # a TimeSformer: test_torch_alpro.py pins these rows
            continue
        if name in loader.DIALOGUE_MODELS:  # GPT-2: test_torch_gpt_dialogue.py pins these rows
            continue
        jmodel = jbuild(name, model_type)
        jcfg = getattr(jmodel, "cfg", None) or jmodel.config  # FiDT5 holds ``config``
        cfg = loader.family_config(name, model_type)
        if name == "pnp_unifiedqav2_fid":
            for f in dataclasses.fields(cfg):
                if f.name != "dtype":
                    assert getattr(cfg, f.name) == getattr(jcfg, f.name), (model_type, f.name)
            assert (cfg.gated_act, cfg.tie_word_embeddings, cfg.dtype) == (
                False, True, torch.float32)
            continue
        for f in dataclasses.fields(cfg):
            if not f.name.endswith(("dtype", "override")):
                assert getattr(cfg, f.name) == getattr(jcfg, f.name), (name, f.name)
        assert cfg.vit_dtype == cfg.vit_config().dtype == torch.bfloat16
        v, jv = cfg.vit_config(), jcfg.vit_config()
        for f in ("image_size", "patch_size", "width", "depth", "num_heads", "mlp_hidden",
                  "layer_norm_eps", "use_ln_pre", "qkv_fused_no_kbias", "quick_gelu",
                  "final_norm", "patch_bias", "seq_len", "head_dim"):
            assert getattr(v, f) == getattr(jv, f), (name, model_type, f)
        q, jq = cfg.text_config(), jcfg.text_config()
        for f in ("vocab_size", "hidden_size", "num_layers", "num_heads", "intermediate_size",
                  "encoder_width", "max_position_embeddings", "layer_norm_eps"):
            assert getattr(q, f) == getattr(jq, f), (name, model_type, f)
    assert loader.family_config("blip_caption", "large_coco").vit_config().seq_len == 577
    for (name, model_type), row in loader.PIPELINE_CONFIGS.items():
        raw = dict(load_yaml(model_config_path(name, model_type))["model"])
        raw.pop("arch")
        assert raw == row, model_type
    assert sorted(loader.PIPELINE_CONFIGS) == sorted(
        (name, f[:-5]) for name in ("pnp_vqa", "img2prompt_vqa")
        for f in os.listdir(os.path.dirname(model_config_path(name, "base"))))
