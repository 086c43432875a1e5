"""BLIP-2 stage 1 of the port (models/blip2_stage1.py, models/lm.py, the
Q-Former's decoder mask) against sprc_tpu.

The tiny EVA-style model of test_torch_train_losses.py (ViT width 128 /
depth 2 on 28 px; Q-Former hidden 128 / 2 layers, Q=4, text length 8, vocab
60, embed 64) as ``blip2``: JAX parameters from the stage-1 forward's init,
every leaf moved by seeded noise, carried across with interop/jax_params.py
(the LM head included) and loaded with strict=True. fp32, dropout 0, the
CPU: the port runs its kernels' plain versions. The LM's ``bos_token_id``
(30522 by default) lies outside the tiny vocabulary, where JAX clamps the
gather and ``nn.Embedding`` raises: both packages are given 1.

Tolerances: losses within 1e-5 relative; every trainable gradient within
1e-4 of its tensor's largest |gradient| (``kernel_checks.grad_gap``'s scale,
as in test_torch_train_losses.py), except the three ITC-only tensors
(``vision_proj``, ``text_proj``, ``temp``), held at ``ITC_GRAD_TOL`` = 3e-4
of their scale: there fp32 itself is that far off (below); eval surfaces and
masks within 1e-5 absolute.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sprc_tpu.models.cir_base import CirConfig as JCirConfig  # noqa: E402
from sprc_tpu.models.qformer import QFormer as JQFormer  # noqa: E402
from sprc_tpu.models.qformer import QFormerConfig as JQFormerConfig  # noqa: E402
from sprc_tpu.models.qformer import make_unilm_mask as j_unilm  # noqa: E402
from sprc_tpu.models.vit import ViTConfig as JViTConfig  # noqa: E402
from sprc_tpu.registry import registry as jregistry  # noqa: E402

from sprc_tpu_torch import kernel_checks  # noqa: E402
from sprc_tpu_torch.interop.jax_params import qformer_from_jax, state_dict_from_jax, to_torch  # noqa: E402
from sprc_tpu_torch.loader import build_model  # noqa: E402
from sprc_tpu_torch.models import qformer as port_qformer  # noqa: E402
from sprc_tpu_torch.models.qformer import QFormer, QFormerConfig, make_unilm_mask  # noqa: E402
from sprc_tpu_torch.models.vit import ViTConfig  # noqa: E402
from test_torch_train_losses import B, EMBED, IMG, Q, QF, TXT, VIT, VOCAB, W  # noqa: E402
from test_torch_threads import one_torch_thread  # noqa: E402,F401  (one thread a module)

LOSS_RTOL, GRAD_TOL, ATOL = 1e-5, 1e-4, 1e-5
# The ITC-only gradients are sums with cancellation over 1 / temp ~ 14 times
# the token-max scores. On this test's weights and batch, as a share of each
# tensor's largest |gradient| (vision_proj.bias, the worst): the port against
# JAX 1.42e-4; JAX's fp32 against the port run in float64 2.78e-4, the port's
# fp32 1.36e-4; either package on the batch in another order 3.4e-5 (JAX) and
# 1.35e-4 (the port). Every other tensor stays below 5e-6 against JAX.
ITC_GRAD_TOL = 3e-4
ITC_ONLY = ("vision_proj.", "text_proj.", "temp")
BOS = 1


def jax_model(name="blip2"):
    cfg = JCirConfig(vit_model="eva_clip_g", image_size=IMG, num_query_token=Q, max_txt_len=TXT,
                     vocab_size=VOCAB, embed_dim=EMBED, vit_dtype=jnp.float32,
                     vit_config_override=JViTConfig(**VIT, dtype=jnp.float32),
                     qformer_config_override=JQFormerConfig(**QF, dropout_rate=0.0,
                                                            attention_dropout_rate=0.0))
    return jregistry.get_model_class(name)(cfg)


def make_batch(seed=11, b=B):
    rng = np.random.RandomState(seed)
    ids = rng.randint(4, VOCAB, (b, TXT)).astype(np.int32)
    ids[:, 0] = 2
    mask = np.ones((b, TXT), np.int32)
    mask[0, -3:] = 0
    ids[0, -3:] = 0  # pads: the LM ignores them
    mask[-1, -1:] = 0
    ids[-1, -1:] = 0
    return rng.rand(b, IMG, IMG, 3).astype(np.float32), ids, mask


def jax_params(model, seed=5):
    """The stage-1 training init, every leaf moved by seeded noise; numpy."""
    images, ids, mask = (jnp.asarray(a) for a in make_batch())
    params = jax.jit(lambda k: model.init({"params": k, "sample": jax.random.PRNGKey(1)},
                                          images, ids, mask, bos_token_id=BOS))(
        jax.random.PRNGKey(seed))["params"]
    rng = np.random.RandomState(seed)

    def noisy(a):
        a = np.asarray(a)
        return a if a.ndim == 0 else a + (rng.standard_normal(a.shape) * 0.02).astype(a.dtype)

    return jax.tree_util.tree_map(noisy, dict(params))


def port_model(params, name="blip2"):
    model = build_model(name, "pretrain", image_size=IMG, num_query_token=Q, max_txt_len=TXT,
                        vocab_size=VOCAB, embed_dim=EMBED, vit_dtype=torch.float32,
                        vit_config_override=ViTConfig(**VIT, dtype=torch.float32),
                        qformer_config_override=QFormerConfig(**QF, dropout_rate=0.0),
                        device="cpu")
    model.load_state_dict(state_dict_from_jax(params, vit="eva_clip_g"), strict=True)
    return model


def refuse_k3(monkeypatch):
    """The layer kernel's wrapper and its plain version raise if called."""
    def refuse(*a, **k):
        raise AssertionError("the pass reached K3")

    monkeypatch.setattr(port_qformer, "fused_qformer_layer", refuse)
    monkeypatch.setattr(port_qformer, "fused_qformer_layer_plain", refuse)


@pytest.fixture(scope="module")
def shared():
    jm = jax_model()
    return jm, jax_params(jm), make_batch()


def test_losses_and_gradients_equal_jax(shared):
    """The three losses of one training forward, and every trainable
    gradient, against JAX's ``Blip2Stage1.__call__`` under ``jax.grad``; the
    tower gets none (JAX's is zero behind the stop_gradient)."""
    jm, params, (images, ids, mask) = shared

    jargs = tuple(jnp.asarray(a) for a in (images, ids, mask))

    def loss_fn(p):
        losses = jm.apply({"params": p}, *jargs, bos_token_id=BOS,
                          deterministic=False, rngs={"dropout": jax.random.PRNGKey(0)})
        return sum(losses.values()), losses

    (_, want), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)

    model = port_model(params).train()
    losses = model(*(torch.from_numpy(a) for a in (images, ids, mask)), bos_token_id=BOS)
    sum(losses.values()).backward()
    assert set(losses) == set(want) == set(model.LOSSES)
    for key, value in want.items():
        assert abs(losses[key].item() - float(value)) <= LOSS_RTOL * abs(float(value)), key
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    want_grads = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jgrads),
                                     vit="eva_clip_g")
    assert not any(n.startswith("visual_encoder") for n in names)
    assert all(p.grad is None for p in model.visual_encoder.parameters())
    assert all(np.abs(np.asarray(v)).max() == 0
               for v in jax.tree_util.tree_leaves(jgrads["visual_encoder"]))
    got = [dict(model.named_parameters())[n].grad for n in names]
    assert all(g is not None for g in got), [n for n, g in zip(names, got) if g is None]
    want = [want_grads[n] for n in names]
    gap = kernel_checks.grad_gap(got, want, names)
    floor = 1e-4 * max(w.abs().max().item() for w in want)
    assert sum(n.startswith(ITC_ONLY) for n in names) == 5
    for n, g, w in zip(names, got, want):
        scale = max(w.abs().max().item(), floor)
        tol = ITC_GRAD_TOL if n.startswith(ITC_ONLY) else GRAD_TOL
        assert (g - w).abs().max().item() <= tol * scale, (n, gap)
    assert want_grads["Qformer.cls.predictions.decoder.weight"].abs().max() > 0
    assert want_grads["itm_head.weight"].abs().max() > 0


@pytest.mark.parametrize("name", ["blip2", "blip2_image_text_matching"])
def test_eval_surfaces_equal_jax(shared, name):
    """``extract_image_features``, ``extract_text_features`` (and for
    ``blip2_image_text_matching`` ``itm`` and ``itc``) in eval mode."""
    _, params, (images, ids, mask) = shared
    jm = jax_model(name)
    model = port_model(params, name).eval()
    ti, tids, tmask = (torch.from_numpy(a) for a in (images, ids, mask))
    images, ids, mask = (jnp.asarray(a) for a in (images, ids, mask))
    calls = [("extract_image_features", (images,), (ti,)),
             ("extract_text_features", (ids, mask), (tids, tmask))]
    if name == "blip2_image_text_matching":
        calls += [("itm", (images, ids, mask), (ti, tids, tmask)),
                  ("itc", (images, ids, mask), (ti, tids, tmask))]
    for method, jargs, targs in calls:
        want = jm.apply({"params": params}, *jargs, method=getattr(jm, method))
        with torch.no_grad():
            got = getattr(model, method)(*targs)
        for g, w in zip(*(x if isinstance(x, tuple) else (x,) for x in (got, want))):
            assert g.shape == w.shape, method
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, err_msg=method)


def test_unilm_mask_and_decoder_pass_equal_jax(shared, monkeypatch):
    """``make_unilm_mask`` equals JAX's; a decoder pass of the Q-Former in
    eval mode equals JAX's ``is_decoder=True`` pass and never reaches the
    layer kernel's wrapper (K3)."""
    _, params, (images, ids, mask) = shared
    attn = np.concatenate([np.ones((B, Q), np.int32), mask], axis=1)
    np.testing.assert_array_equal(make_unilm_mask(torch.from_numpy(attn), Q).numpy(),
                                  np.asarray(j_unilm(jnp.asarray(attn), Q)))
    qcfg = QFormerConfig(**QF, dropout_rate=0.0)
    qf = QFormer(qcfg)
    qf.load_state_dict(to_torch(qformer_from_jax(params["qformer"], "")), strict=True)
    qf.eval()
    rng = np.random.RandomState(3)
    queries = (rng.standard_normal((B, Q, W)) * 0.5).astype(np.float32)
    image = rng.standard_normal((B, 5, W)).astype(np.float32)
    jq = JQFormer(JQFormerConfig(**QF, dropout_rate=0.0))
    want = jq.apply({"params": params["qformer"]}, input_ids=ids, query_embeds=queries,
                    attention_mask=attn, image_embeds=image, is_decoder=True)

    refuse_k3(monkeypatch)
    with torch.no_grad():
        got = qf(input_ids=torch.from_numpy(ids), query_embeds=torch.from_numpy(queries),
                 attention_mask=torch.from_numpy(attn), image_embeds=torch.from_numpy(image),
                 is_decoder=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_model_configs_equal_the_yaml():
    """The stage-1 rows of ``loader.MODEL_CONFIGS`` against what
    ``sprc_tpu.loader`` builds from configs/models/<name>/<type>.yaml
    (``freeze_vit`` included: the ``coco`` rows train their tower); the
    loader takes ``freeze_vit=False`` on any row and refuses it with an int8
    tower."""
    from sprc_tpu.loader import build_model as jbuild

    from sprc_tpu_torch import loader

    rows = [k for k in loader.MODEL_CONFIGS if k[0] in loader.STAGE1_MODELS]
    assert sorted(rows) == sorted([("blip2", "pretrain"), ("blip2", "coco"),
                                   ("blip2_feature_extractor", "pretrain"),
                                   ("blip2_image_text_matching", "pretrain"),
                                   ("blip2_image_text_matching", "coco")])
    for name, model_type in rows:
        jcfg = jbuild(name, model_type).cfg
        cfg = loader.model_config(name, model_type)
        for f in ("vit_model", "image_size", "num_query_token", "cross_attention_freq",
                  "embed_dim", "max_txt_len", "vocab_size", "freeze_vit"):
            assert getattr(cfg, f) == getattr(jcfg, f), (name, model_type, f)
        assert str(cfg.vit_dtype).split(".")[-1] == jnp.dtype(jcfg.vit_dtype).name
        assert str(cfg.qformer_dtype).split(".")[-1] == jnp.dtype(jcfg.qformer_dtype).name
        assert ((name, model_type) in loader.UNFROZEN_VIT) == (not jcfg.freeze_vit)
        jv, v = jcfg.vit_config(), cfg.vit_config()
        for f in ("image_size", "width", "depth", "num_heads", "mlp_hidden", "seq_len"):
            assert getattr(v, f) == getattr(jv, f), f
    assert loader.model_config("blip2", "coco").vit_config().seq_len == 677
    assert loader.model_config("blip2", "pretrain", freeze_vit=False).freeze_vit is False
    with pytest.raises(ValueError, match="freeze_vit=False with vit_quant"):
        loader.model_config("blip2", "coco", vit_quant="int8")
