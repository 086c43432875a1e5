"""CLIP in the port (models/clip.py, models/resnet_clip.py,
models/clip_zero_shot.py, the CLIP tokenizer adapter and processors, the
``imagenet`` builder, retrieval/clip_index.py, the loader's rows and
readers) against sprc_tpu's.

Tiny models (ViT width 64, depth 2 at 32 px, patch 16; text width 64, 2
layers, 2 heads, 16 positions; RN50 ``layers [1, 1, 1, 1]``, width 8 at 64
px), the port's from ``init_weights`` with every bias, norm and BatchNorm
statistic moved by seeded noise; the JAX model's params are read from the
port's state dict by the JAX package's OpenAI reader
(``clip_params_from_openai``: the port holds OpenAI's names). Seeded numpy
inputs go through the JAX function (XLA on the CPU) and the port's, fp32,
within 1e-5 of the output's scale.
"""

import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sprc_tpu_torch import loader  # noqa: E402
from test_torch_blip1 import t  # noqa: E402
from test_torch_threads import one_torch_thread  # noqa: E402,F401  (one thread a module)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
IMG, VOCAB, CTX, EMBED = 32, 60, 16, 32
VISION = dict(image_size=IMG, patch_size=16, width=64, depth=2, num_heads=2, mlp_hidden=256,
              layer_norm_eps=1e-5, use_ln_pre=True, quick_gelu=True, final_norm=True,
              patch_bias=False, dtype="fp32")
TEXT = dict(vocab_size=VOCAB, width=64, layers=2, heads=2, context_length=CTX)
RESNET = dict(layers=[1, 1, 1, 1], width=8, heads=2, output_dim=EMBED, image_size=64)


def clip_pair(resnet=False, seed=0, route="block"):
    """(the port's tiny CLIP, the JAX model, its params from the port's weights)."""
    from sprc_tpu.models.clip import Clip, ClipConfig, ClipTextConfig, clip_params_from_openai
    from sprc_tpu.models.resnet_clip import ResNetConfig
    from sprc_tpu.models.vit import ViTConfig

    kw = dict(embed_dim=EMBED, text=TEXT)
    if resnet:
        kw.update(image_size=64, vision_resnet=RESNET)
    else:
        kw.update(image_size=IMG, vision=dict(VISION, fused_block=route))
    model = loader.load_model("clip", "resnet50" if resnet else "vit_base16", device="cpu",
                              seed=seed, **kw)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            if p.dim() <= 1:
                p.add_(torch.randn(p.shape, generator=gen) * 0.05)
        for name, b in model.named_buffers():
            if name.endswith("running_mean"):
                b.copy_(torch.randn(b.shape, generator=gen) * 0.1)
            elif name.endswith("running_var"):
                b.copy_(torch.rand(b.shape, generator=gen) + 0.5)
    jcfg = ClipConfig(
        embed_dim=EMBED, image_size=64 if resnet else IMG, text=ClipTextConfig(**TEXT),
        vision=None if resnet else ViTConfig(**{**VISION, "dtype": jnp.float32}),
        vision_resnet=ResNetConfig(**RESNET) if resnet else None)
    jm = Clip(jcfg)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    return model, jm, clip_params_from_openai(sd, jm)


def images(seed, n=3, size=IMG):
    return np.random.RandomState(seed).rand(n, size, size, 3).astype(np.float32)


def text_inputs(seed, n=3):
    rs = np.random.RandomState(seed)
    ids = rs.randint(3, VOCAB, (n, CTX)).astype(np.int32)
    eot = rs.randint(2, CTX, (n,)).astype(np.int32)
    return ids, eot


def close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=tol * max(1.0, float(np.abs(want).max())), rtol=0)


@pytest.mark.parametrize("route", ["block", "none"])
def test_clip_vit_and_text_towers_equal_jax(route):
    """The ViT tower (``ln_pre``, QuickGELU, ``ln_post``, no patch bias) on
    the whole-block route and op by op, the causal text tower pooled at the
    end-of-text positions, and the logits of ``forward``."""
    model, jm, params = clip_pair(route=route)
    img, (ids, eot) = images(1), text_inputs(2)
    want = [np.asarray(a) for a in jm.apply({"params": params}, jnp.asarray(img),
                                            jnp.asarray(ids), jnp.asarray(eot))]
    with torch.no_grad():
        got = [a.numpy() for a in model(t(img), t(ids), t(eot))]
        close(model.encode_image(t(img)).numpy(),
              jm.apply({"params": params}, jnp.asarray(img), method=jm.encode_image))
        close(model.encode_text(t(ids), t(eot)).numpy(),
              jm.apply({"params": params}, jnp.asarray(ids), jnp.asarray(eot),
                       method=jm.encode_text))
    for g, w in zip(got, want):
        close(g, w)
    keys = set(model.state_dict())
    assert {"visual.ln_post.weight", "visual.proj", "visual.conv1.weight",
            "transformer.resblocks.1.attn.in_proj_weight", "text_projection",
            "logit_scale"} <= keys and "visual.conv1.bias" not in keys
    _round_trip(model, params)


def _round_trip(model, params):
    """``jax_params.clip_from_jax`` gives the JAX tree back as the port's
    state dict, bit for bit, and it loads with ``strict=True``."""
    from sprc_tpu_torch.interop.jax_params import clip_from_jax

    back, sd = clip_from_jax(params), model.state_dict()
    assert set(back) == set(sd), set(back) ^ set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k].to(v.dtype), v), k
    model.load_state_dict(back, strict=True)


def test_clip_resnet_equals_jax():
    """The RN50 tower (frozen BatchNorm over its running statistics, the
    anti-aliased strides, the attention pool's projection) and the logits."""
    model, jm, params = clip_pair(resnet=True, seed=3)
    img, (ids, eot) = images(4, size=64), text_inputs(5)
    with torch.no_grad():
        close(model.encode_image(t(img)).numpy(),
              jm.apply({"params": params}, jnp.asarray(img), method=jm.encode_image))
        got = model(t(img), t(ids), t(eot))[0].numpy()
    close(got, jm.apply({"params": params}, jnp.asarray(img), jnp.asarray(ids),
                        jnp.asarray(eot))[0])
    assert "visual.layer2.0.downsample.1.running_var" in model.state_dict()
    _round_trip(model, params)


def hf_layout(sd: dict, depth: int, layers: int) -> dict:
    """The port's (OpenAI's) CLIP names -> HF ``CLIPModel``'s."""
    out = {}

    def blocks(src, dst, n):
        for i in range(n):
            s, d = f"{src}.{i}.", f"{dst}.{i}."
            w, b = sd[f"{s}attn.in_proj_weight"], sd[f"{s}attn.in_proj_bias"]
            for j, p in enumerate("qkv"):
                out[f"{d}self_attn.{p}_proj.weight"] = w[j * w.shape[1]: (j + 1) * w.shape[1]]
                out[f"{d}self_attn.{p}_proj.bias"] = b[j * w.shape[1]: (j + 1) * w.shape[1]]
            for a, c in (("ln_1", "layer_norm1"), ("ln_2", "layer_norm2"),
                         ("attn.out_proj", "self_attn.out_proj"), ("mlp.c_fc", "mlp.fc1"),
                         ("mlp.c_proj", "mlp.fc2")):
                for end in ("weight", "bias"):
                    out[f"{d}{c}.{end}"] = sd[f"{s}{a}.{end}"]

    vp, tp = "vision_model.", "text_model."
    out[f"{vp}embeddings.class_embedding"] = sd["visual.class_embedding"]
    out[f"{vp}embeddings.position_embedding.weight"] = sd["visual.positional_embedding"]
    out[f"{vp}embeddings.patch_embedding.weight"] = sd["visual.conv1.weight"]
    for a, c in (("visual.ln_pre", f"{vp}pre_layrnorm"), ("visual.ln_post", f"{vp}post_layernorm"),
                 ("ln_final", f"{tp}final_layer_norm")):
        out[f"{c}.weight"], out[f"{c}.bias"] = sd[f"{a}.weight"], sd[f"{a}.bias"]
    blocks("visual.transformer.resblocks", f"{vp}encoder.layers", depth)
    blocks("transformer.resblocks", f"{tp}encoder.layers", layers)
    out["visual_projection.weight"] = sd["visual.proj"].T.copy()
    out["text_projection.weight"] = sd["text_projection"].T.copy()
    out[f"{tp}embeddings.token_embedding.weight"] = sd["token_embedding.weight"]
    out[f"{tp}embeddings.position_embedding.weight"] = sd["positional_embedding"]
    out[f"{tp}embeddings.position_ids"] = np.arange(CTX)[None]
    out["logit_scale"] = sd["logit_scale"].reshape(())
    return out


@pytest.mark.parametrize("layout", ["hf", "openai"])
def test_checkpoint_readers_equal_jax(layout, tmp_path):
    """A seeded torch state dict in HF's layout (read by the JAX
    ``clip_params_from_hf`` and by ``loader.read_checkpoint``) or OpenAI's
    (the RN50's, with the ``num_batches_tracked`` buffers a released file
    holds): the strictly loaded port model equals the JAX model on its
    reader's params, and the model the file was written from."""
    from sprc_tpu.models.clip import clip_params_from_hf, clip_params_from_openai

    resnet = layout == "openai"
    model, jm, _ = clip_pair(resnet=resnet, seed=6)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    if resnet:
        sd.update({k.replace("running_var", "num_batches_tracked"): np.asarray(7)
                   for k in sd if k.endswith("running_var")})
        params = clip_params_from_openai(sd, jm)
    else:
        sd = hf_layout(sd, VISION["depth"], TEXT["layers"])
        params = clip_params_from_hf(sd, vision_depth=VISION["depth"],
                                     text_depth=TEXT["layers"])
    path = str(tmp_path / "clip.pth")
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, path)
    kw = dict(embed_dim=EMBED, text=TEXT, **(dict(image_size=64, vision_resnet=RESNET) if resnet
                                             else dict(image_size=IMG, vision=VISION)))
    loaded = loader.load_model("clip", "resnet50" if resnet else "vit_base16", path,
                               device="cpu", **kw)
    img = images(7, size=64 if resnet else IMG)
    ids, eot = text_inputs(8)
    with torch.no_grad():
        got = [a.numpy() for a in loaded(t(img), t(ids), t(eot))]
        mine = [a.numpy() for a in model(t(img), t(ids), t(eot))]
    want = jm.apply({"params": params}, jnp.asarray(img), jnp.asarray(ids), jnp.asarray(eot))
    for g, m, w in zip(got, mine, want):
        close(g, w)
        np.testing.assert_array_equal(g, m)


def test_zero_shot_and_clip_index_equal_jax():
    """The zero-shot classifier over 3 class names x the 80 templates, the
    predictions, and the flat gallery features with ``element_wise_sum``."""
    from sprc_tpu.models.clip_zero_shot import (
        OPENAI_IMAGENET_TEMPLATES as JTEMPLATES, make_zero_shot_predict_fn as jpredict,
        zero_shot_classifier as jclassifier)
    from sprc_tpu.retrieval.clip_index import (element_wise_sum as jsum,
                                               extract_clip_index_features as jindex)
    from sprc_tpu.text.tokenizer import BertWordPieceTokenizer as JTok
    from sprc_tpu.text.llm_tokenizers import clip_tokenize as jclip_tokenize

    from sprc_tpu_torch.models.clip_zero_shot import (OPENAI_IMAGENET_TEMPLATES,
                                                      make_zero_shot_predict_fn,
                                                      zero_shot_classifier)
    from sprc_tpu_torch.retrieval.clip_index import (element_wise_sum,
                                                     extract_clip_index_features)
    from sprc_tpu_torch.text.llm_tokenizers import clip_tokenize
    from sprc_tpu_torch.text.tokenizer import BertWordPieceTokenizer

    assert OPENAI_IMAGENET_TEMPLATES == JTEMPLATES and len(JTEMPLATES) == 80
    words = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + [
        w for w in "a the of photo cat dog car bad many sculpture".split()]
    vocab = {w: i for i, w in enumerate(words)}
    tok, jtok = BertWordPieceTokenizer(vocab), JTok(vocab)
    model, jm, params = clip_pair(seed=9)
    names = ["cat", "dog", "car"]
    clf = zero_shot_classifier(model, names, lambda x: clip_tokenize(tok, x, CTX))
    jclf = jclassifier(jm, params, names, lambda x: jclip_tokenize(jtok, x, CTX))
    close(clf, jclf)
    samples = {"image": images(10, n=4), "label": [0, 2, 1, 1]}
    got = make_zero_shot_predict_fn(model, clf)(samples)
    want = jpredict(jm, params, jclf)(samples)
    close(got["predictions"], want["predictions"], tol=1e-4)  # 100 x unit cosines
    np.testing.assert_array_equal(got["targets"], want["targets"])
    assert (got["predictions"].argmax(1) == np.asarray(want["predictions"]).argmax(1)).all()
    stream = [(["a", "b", "c"], images(11, n=3)), (["d", "e"], images(12, n=2))]
    for normalize in (False, True):
        feats, names_out = extract_clip_index_features(stream, model, encode_batch=2,
                                                       normalize=normalize)
        jfeats, jnames = jindex(stream, jm, params, encode_batch=2, normalize=normalize)
        close(feats, jfeats)
        assert names_out == jnames == list("abcde")
    x, y = np.random.RandomState(13).randn(2, 4, EMBED).astype(np.float32)
    close(element_wise_sum(t(x), t(y)).numpy(), jsum(jnp.asarray(x), jnp.asarray(y)))


def test_tokenizer_processors_and_imagenet_builder_equal_jax(tmp_path):
    """``clip_tokenizer`` / ``clip_tokenize`` over a tokenizer.json (a
    word-level one made here: the real BPE file is not in the repository),
    the ``clip_image_{train,eval}`` processors on a non-square image, and the
    ``imagenet`` builder's items."""
    from PIL import Image
    from sprc_tpu.data import builders as _jb  # noqa: F401  (registers them)
    from sprc_tpu.data import processors as _jp  # noqa: F401  (registers them)
    from sprc_tpu.registry import registry as jregistry
    from sprc_tpu.text.llm_tokenizers import clip_tokenize as jclip_tokenize
    from sprc_tpu.text.llm_tokenizers import clip_tokenizer as jclip_tokenizer
    from tokenizers import Tokenizer, models, pre_tokenizers

    from sprc_tpu_torch.data import builders as _b  # noqa: F401  (registers them)
    from sprc_tpu_torch.registry import registry
    from sprc_tpu_torch.text.llm_tokenizers import clip_tokenize, clip_tokenizer

    vocab = {w: i for i, w in enumerate(["<unk>", "a", "photo", "of", "cat", "dog"])}
    bpe = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    bpe.pre_tokenizer = pre_tokenizers.Whitespace()
    path = str(tmp_path / "tokenizer.json")
    bpe.save(path)
    texts = ["a photo of a cat", "dog", "a photo of a dog of a cat of a dog of a cat"]
    got = clip_tokenize(clip_tokenizer(path), texts, 8)
    want = jclip_tokenize(jclip_tokenizer(path), texts, 8)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[0][0, 0] == 49406 and got[0][0, got[1][0]] == 49407 and got[1][2] == 7
    root = tmp_path / "imgs"
    root.mkdir()
    rs = np.random.RandomState(14)
    for i, (h, w) in enumerate([(40, 52), (61, 33), (36, 36)]):
        Image.fromarray((rs.rand(h, w, 3) * 255).astype(np.uint8)).save(root / f"{i}.png")
    image = Image.open(root / "0.png")
    for kind in ("clip_image_train", "clip_image_eval"):
        got = registry.get_processor_class(kind)(image_size=24)(image)
        np.testing.assert_array_equal(got, jregistry.get_processor_class(kind)(image_size=24)(
            image))
        assert got.shape == (24, 24, 3)
    ann = [{"image": f"{i}.png", "label": i % 2} for i in range(3)]
    (tmp_path / "val.json").write_text(json.dumps(ann))
    cfg = {"build_info": {"annotations": {"val": [str(tmp_path / "val.json")]},
                          "images": str(root)},
           "vis_processor": {"eval": {"name": "clip_image_eval", "image_size": 24}},
           "text_processor": {"eval": {"name": "blip_caption"}}}
    mine = registry.get("dataset", "imagenet")(cfg).build()["val"]
    theirs = jregistry.get("dataset", "imagenet")(cfg).build()["val"]
    assert len(mine) == len(theirs) == 3
    for i in range(3):
        a, b = mine[i], theirs[i]
        assert sorted(a) == sorted(b) and a["label"] == b["label"] and a["text_input"] == ""
        np.testing.assert_array_equal(a["image"], b["image"])


def test_loader_rows_equal_jax():
    """Every CLIP row and the BLIP-1 rows this slice adds equal the config the
    JAX loader builds from their YAMLs (``configs/models/{clip,
    clip_feature_extractor,blip_cir_base,blip_feature_extractor}``, and
    ``blip_caption`` without a model type)."""
    pytest.importorskip("yaml")
    import dataclasses

    from sprc_tpu.loader import build_model as jbuild

    rows = [("clip", m) for m in ("vit_base16", "vit_base32", "vit_large14",
                                  "vit_large14_336", "resnet50", "pretrain")]
    rows += [("clip_feature_extractor", "vit_base16"), ("blip_cir_base", "base"),
             ("blip_feature_extractor", "base"), ("blip_caption", "pretrain")]
    for name, model_type in rows:
        mine = loader.family_config(name, model_type)
        theirs = jbuild(name, model_type).cfg

        def fields(cfg):
            out = {}
            for f in dataclasses.fields(cfg):
                v = getattr(cfg, f.name)
                if dataclasses.is_dataclass(v):
                    v = fields(v)
                elif "dtype" in f.name:
                    v = str(v).split(".")[-1].replace("'>", "").replace("float32", "f32") \
                        .replace("bfloat16", "bf16")
                out[f.name] = v
            return out

        own, ref = fields(mine), fields(theirs)
        for key in set(ref) - set(own):  # the JAX-only knobs (scan_blocks, initialisers)
            assert key in ("scan_blocks",), (name, model_type, key)
            ref.pop(key)
        for sub in ("vision", "vision_resnet", "text"):
            for d in (own.get(sub), ref.get(sub)):
                if isinstance(d, dict):
                    for k in ("scan_blocks", "fused_block", "fused_mlp", "quant", "act_scales",
                              "remat", "qkv_fused_no_kbias"):
                        d.pop(k, None)
        own = {k: v for k, v in own.items() if k in ref}
        assert own == ref, (name, model_type)
        vcfg = (mine.vision_config() if hasattr(mine, "vision_config") and name.startswith("clip")
                and mine.vision_resnet is None else None)
        if vcfg is not None:
            assert vcfg.use_ln_pre and vcfg.final_norm and vcfg.quick_gelu
