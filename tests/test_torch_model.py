"""The port's flagship (sprc_tpu_torch) against sprc_tpu on shared weights.

A tiny CLIP-style blip2_cir_align_prompt (ViT width 128 / 2 heads / depth 2
/ MLP 256 on 28 px images; Q-Former hidden 128 / 2 heads / 2 layers /
intermediate 256, Q=4, text length 8, vocab 60) is initialised once in
JAX, carried across with interop/jax_params.py and loaded with
strict=True. Everything is fp32 on the CPU, where the port runs its plain
paths and the JAX package its unfused ones. Tolerances: 1e-4 absolute on
features and scores (fp32 sums in another order through 2 ViT blocks and
two Q-Former passes of 2 layers).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sprc_tpu.models.cir_base import CirConfig as JCirConfig  # noqa: E402
from sprc_tpu.models.qformer import QFormerConfig as JQFormerConfig  # noqa: E402
from sprc_tpu.models.vit import ViTConfig as JViTConfig  # noqa: E402
from sprc_tpu.registry import registry as jregistry  # noqa: E402

from sprc_tpu_torch.interop.jax_params import state_dict_from_jax  # noqa: E402
from sprc_tpu_torch.loader import build_model, model_config  # noqa: E402
from sprc_tpu_torch.models.qformer import QFormerConfig  # noqa: E402
from sprc_tpu_torch.models.vit import ViTConfig  # noqa: E402
from test_torch_threads import one_torch_thread  # noqa: E402,F401  (one thread a module)

IMG, Q, TXT, VOCAB, EMBED, B = 28, 4, 8, 60, 64, 3
ATOL = 1e-4


def jax_model(q=Q, scan=False):
    vcfg = JViTConfig(image_size=IMG, patch_size=14, width=128, depth=2, num_heads=2,
                      mlp_hidden=256, layer_norm_eps=1e-5, use_ln_pre=True, quick_gelu=True,
                      patch_bias=False, dtype=jnp.float32, scan_blocks=scan)
    qcfg = JQFormerConfig(vocab_size=VOCAB, hidden_size=128, num_layers=2, num_heads=2,
                          intermediate_size=256, encoder_width=128, query_length=q,
                          dropout_rate=0.0, attention_dropout_rate=0.0)
    cfg = JCirConfig(vit_model="clip_L", image_size=IMG, num_query_token=q, max_txt_len=TXT,
                     vocab_size=VOCAB, embed_dim=EMBED, vit_dtype=jnp.float32,
                     vit_config_override=vcfg, qformer_config_override=qcfg)
    return jregistry.get_model_class("blip2_cir_align_prompt")(cfg)


def jax_params(model):
    """The training init of sprc_tpu.loader.init_params (same key, same
    dummy inputs), jitted, plus the itm_head, which only compute_itm
    creates; numpy leaves."""
    img = jnp.zeros((1, IMG, IMG, 3), jnp.float32)
    ids, ones = jnp.zeros((1, TXT), jnp.int32), jnp.ones((1, TXT), jnp.int32)
    params = dict(jax.jit(lambda k: model.init(k, img, img, ids, ones))(
        jax.random.PRNGKey(0))["params"])
    S = (IMG // 14) ** 2 + 1
    itm = jax.jit(lambda k: model.init(k, jnp.zeros((1, S, 128)), ids, ones,
                                       method=model.compute_itm))(jax.random.PRNGKey(1))
    params["itm_head"] = itm["params"]["itm_head"]
    return jax.tree_util.tree_map(np.asarray, params)


def japply(model, params, method):
    """model.apply(params, ..., method=method), jitted."""
    fn = jax.jit(lambda p, *a: model.apply({"params": p}, *a, method=method))
    return lambda *a: fn(params, *a)


def port_model(state, q=Q, **overrides):
    vcfg = ViTConfig(image_size=IMG, patch_size=14, width=128, depth=2, num_heads=2,
                     mlp_hidden=256, layer_norm_eps=1e-5, use_ln_pre=True, quick_gelu=True,
                     patch_bias=False, dtype=torch.float32)
    qcfg = QFormerConfig(vocab_size=VOCAB, hidden_size=128, num_layers=2, num_heads=2,
                         intermediate_size=256, encoder_width=128, query_length=q)
    model = build_model("blip2_cir_align_prompt", "pretrain_vitL", image_size=IMG,
                        num_query_token=q, max_txt_len=TXT, vocab_size=VOCAB, embed_dim=EMBED,
                        vit_dtype=torch.float32, vit_config_override=vcfg,
                        qformer_config_override=qcfg, device="cpu", **overrides)
    model.load_state_dict(state, strict=True)
    return model.eval()


def inputs(seed=0, b=B):
    rng = np.random.RandomState(seed)
    images = rng.rand(b, IMG, IMG, 3).astype(np.float32)
    ids = rng.randint(0, VOCAB, (b, TXT)).astype(np.int32)
    mask = np.ones((b, TXT), np.int32)
    mask[0, -3:] = 0  # a padded caption
    return images, ids, mask


@pytest.fixture(scope="module")
def flagship():
    jm = jax_model()
    params = jax_params(jm)
    return jm, params, port_model(state_dict_from_jax(params))


def test_extract_target_features_matches_jax(flagship):
    jm, params, pm = flagship
    images, _, _ = inputs()
    want_feats, want_frozen = japply(jm, params, jm.extract_target_features)(images)
    with torch.inference_mode():
        feats, frozen = pm.extract_target_features(torch.from_numpy(images))
    np.testing.assert_allclose(frozen.numpy(), np.asarray(want_frozen), atol=ATOL)
    np.testing.assert_allclose(feats.numpy(), np.asarray(want_feats), atol=ATOL)


def test_fusion_feature_and_inference_match_jax(flagship):
    """Also the index-Q read of the prompt pass (cir_base.py:275): the tiny
    model has Q=4, not 32."""
    jm, params, pm = flagship
    images, ids, mask = inputs(1)
    gallery, _, _ = inputs(2, b=5)
    ref = japply(jm, params, jm.encode_image)(images)
    tgt, _ = japply(jm, params, jm.extract_target_features)(gallery)
    want_fuse = japply(jm, params, jm.fusion_feature)(ref, ids, mask)
    want_sims = japply(jm, params, jm.inference)(ref, tgt, ids, mask)
    with torch.inference_mode():
        pref = pm.encode_image(torch.from_numpy(images))
        ptgt, _ = pm.extract_target_features(torch.from_numpy(gallery))
        fuse = pm.fusion_feature(pref, torch.from_numpy(ids), torch.from_numpy(mask))
        sims = pm.inference(pref, ptgt, torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(fuse.numpy(), np.asarray(want_fuse), atol=ATOL)
    np.testing.assert_allclose(sims.numpy(), np.asarray(want_sims), atol=ATOL)


def test_bridge_equals_torch_export_on_unscanned_tree(flagship):
    from sprc_tpu.interop.torch_export import params_to_torch_state_dict

    jm, params, _ = flagship
    ours = state_dict_from_jax(params)
    theirs = params_to_torch_state_dict(params, jm)
    assert sorted(ours) == sorted(theirs)
    for k, v in theirs.items():
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(v), err_msg=k)


def test_bridge_reads_scanned_tree():
    """Full-size configs scan their blocks (trunk/blocks/block with a depth
    axis). torch_export drops them; the bridge keeps every block, loads
    strictly and gives the JAX tower's output."""
    from sprc_tpu.interop.torch_export import params_to_torch_state_dict

    jm = jax_model(scan=True)
    params = jax_params(jm)
    assert "blocks" in params["visual_encoder"]["trunk"]
    exported = params_to_torch_state_dict(params, jm)
    assert not any("resblocks" in k for k in exported)  # the trap
    state = state_dict_from_jax(params)
    assert sum(k.endswith("attn.in_proj_weight") for k in state) == 2
    pm = port_model(state)  # strict=True
    images, _, _ = inputs(4)
    want = japply(jm, params, jm.encode_tower)(images)
    with torch.inference_mode():
        got = pm.encode_tower(torch.from_numpy(images))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_strict_load_fails_on_a_missing_block(flagship):
    _, params, _ = flagship
    state = state_dict_from_jax(params)
    state.pop("visual_encoder.transformer.resblocks.1.attn.in_proj_weight")
    with pytest.raises(RuntimeError, match="Missing key"):
        port_model(state)


@pytest.mark.parametrize("model_type", ["pretrain_vitL", "pretrain"])
def test_pretrain_vitl_config_equals_jax_yaml(model_type):
    assert_config_equals_jax("blip2_cir_align_prompt", model_type)


def assert_config_equals_jax(name, model_type):
    """MODEL_CONFIGS' row against what sprc_tpu.loader builds from the YAML
    (test_torch_rerank.py holds the variants' rows with it)."""
    from sprc_tpu.loader import build_model as jbuild

    jcfg = jbuild(name, model_type).cfg
    cfg = model_config(name, model_type)
    for f in ("vit_model", "image_size", "num_query_token", "cross_attention_freq",
              "embed_dim", "max_txt_len", "vocab_size"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert str(cfg.vit_dtype).split(".")[-1] == jnp.dtype(jcfg.vit_dtype).name
    assert str(cfg.qformer_dtype).split(".")[-1] == jnp.dtype(jcfg.qformer_dtype).name
    jv, v = jcfg.vit_config(), cfg.vit_config()
    for f in ("image_size", "patch_size", "width", "depth", "num_heads", "mlp_hidden",
              "layer_norm_eps", "seq_len", "head_dim", "use_ln_pre", "qkv_fused_no_kbias",
              "quick_gelu", "patch_bias"):
        assert getattr(v, f) == getattr(jv, f), f
    assert (v.width, v.head_dim) == {"pretrain_vitL": (1024, 64), "pretrain": (1408, 88)}[model_type]
    jq, q = jcfg.qformer_config(), cfg.qformer_config()
    for f in ("vocab_size", "hidden_size", "num_layers", "num_heads", "intermediate_size",
              "encoder_width", "cross_attention_freq", "max_position_embeddings",
              "layer_norm_eps", "query_length"):
        assert getattr(q, f) == getattr(jq, f), f


def test_build_and_load_default_to_the_gpu():
    """The port's entry points run on the card unless asked for the CPU:
    without a GPU the default raises, it does not build on the CPU."""
    import inspect

    from sprc_tpu_torch.loader import load_model

    for fn in (build_model, load_model):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__name__
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for fn in (build_model, load_model):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn("blip2_cir_align_prompt", "pretrain_vitL")
