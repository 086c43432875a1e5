"""SNLI-VE classification and NLVR2 in the port (models/classification.py,
models/nlvr.py, interop/jax_params.py's ``classifier_from_jax``,
``nlvr_from_jax`` and ``momentum_copies_from_jax``, the LAVIS reader of
``loader.read_checkpoint``) against sprc_tpu's.

Tiny models (ViT width 64 / depth 2 at 32 px, patch 16; med-BERTs hidden
64, 3 layers, 2 heads, a 60-row vocabulary; ALBEF's fusion and BLIP NLVR's
merge from layer 1, so ALBEF's layers 1 and 2 share their cross key and
value), the port's from ``init_weights`` with every bias and norm moved by
seeded noise, the JAX model's from those weights through the JAX package's
LAVIS importers. The same seeded numpy inputs go through both, fp32, the
JAX functions applied as its train steps apply them (deterministically).
Logits and losses agree within 1e-5, gradients within 1e-4, the momentum
copies after a step within 1e-6.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sprc_tpu_torch import loader  # noqa: E402
from sprc_tpu_torch.interop.jax_params import (classifier_from_jax,  # noqa: E402
                                               momentum_copies_from_jax, nlvr_from_jax)
from test_torch_blip1 import IMG, VIT, numpy_state, port_model, t  # noqa: E402
from test_torch_threads import one_torch_thread  # noqa: E402,F401  (one thread a module)

TOL, GRAD_TOL, MOMENTUM_TOL = 1e-5, 1e-4, 1e-6
V = 60
TXT = dict(vocab_size=V, hidden_size=64, num_layers=3, num_heads=2, intermediate_size=128,
           encoder_width=64, dropout_rate=0.0)
B, L = 4, 7
# (port name, model type, its overrides, the JAX config's fields)
MODELS = {
    "classifier_albef": ("albef_classification", "ve", {"fusion_layer": 1}, {"fusion_layer": 1}),
    "classifier_blip": ("blip_classification", "base", {},
                        {"cross_on_all_layers": True}),
    "nlvr_albef": ("albef_nlvr", "nlvr", {"fusion_layer": 1},
                   {"flavor": "albef", "fusion_layer": 1}),
    "nlvr_blip": ("blip_nlvr", "nlvr", {"fusion_layer": 1}, {"flavor": "blip", "fusion_layer": 1}),
}


def overrides(kind):
    return dict(vit_config_override=VIT, text_config_override=TXT, image_size=IMG, vocab_size=V,
                **MODELS[kind][2])


def tiny(kind, seed=0):
    """(the port's tiny model, the JAX model, its params from the port's weights)."""
    from sprc_tpu.interop import lavis_import as li
    from sprc_tpu.models.classification import ClassifierConfig, MultimodalClassifier
    from sprc_tpu.models.nlvr import NLVRClassifier, NLVRConfig
    from sprc_tpu.models.qformer import QFormerConfig
    from sprc_tpu.models.vit import ViTConfig

    name, model_type, _, jfields = MODELS[kind]
    model = port_model(name, model_type, seed, **overrides(kind))
    common = dict(image_size=IMG, vocab_size=V, vit_dtype=jnp.float32,
                  vit_config_override=ViTConfig(**{**VIT, "dtype": jnp.float32}),
                  text_config_override=QFormerConfig(**TXT), **jfields)
    if kind.startswith("nlvr"):
        jm = NLVRClassifier(NLVRConfig(num_classes=2, **common))
        return model, jm, li.nlvr_params_from_torch(numpy_state(model), jm)
    jm = MultimodalClassifier(ClassifierConfig(num_classes=3, **common))
    return model, jm, li.classifier_params_from_torch(numpy_state(model), jm)


def bridge(kind):
    return nlvr_from_jax if kind.startswith("nlvr") else classifier_from_jax


def batch(kind, seed=0):
    rs = np.random.RandomState(seed)
    ids = rs.randint(5, V, (B, L)).astype(np.int32)
    ids[:, 0] = 2
    mask = np.ones((B, L), np.int32)
    mask[1, L - 2:] = ids[1, L - 2:] = 0
    out = {"input_ids": ids, "text_mask": mask,
           "labels": rs.randint(0, 2 if kind.startswith("nlvr") else 3, B).astype(np.int32)}
    keys = ("image0", "image1") if kind.startswith("nlvr") else ("images",)
    for key in keys:
        out[key] = rs.rand(B, IMG, IMG, 3).astype(np.float32)
    return out


def inputs(kind, b):
    return [b[k] for k in (("image0", "image1") if kind.startswith("nlvr") else ("images",))] + [
        b["input_ids"], b["text_mask"]]


@pytest.mark.parametrize("kind", ["nlvr_blip", "nlvr_albef"])
def test_nlvr_logits_and_loss_equal_jax(kind):
    """Both NLVR flavours' logits over the stacked pair, and the CE with and
    without momentum soft targets."""
    model, jm, params = tiny(kind, 1)
    b = batch(kind, 2)
    args = inputs(kind, b)
    soft = np.random.RandomState(3).randn(B, 2).astype(np.float32)
    want_logits = jm.apply({"params": params}, *args, method=jm.predict)
    want = jm.apply({"params": params}, *args, b["labels"])
    want_d = jm.apply({"params": params}, *args, b["labels"], soft, 0.3)
    with torch.no_grad():
        got_logits = model.predict(*map(t, args))
        got = model(*map(t, args), t(b["labels"]))
        got_d = model(*map(t, args), t(b["labels"]), t(soft), 0.3)
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits), atol=TOL, rtol=0)
    for g, w in ((got, want), (got_d, want_d)):
        assert abs(float(g["loss"]) - float(w["loss"])) <= TOL, kind


def _step_against_jax(kind, seed):
    """One distilled step of ``kind`` in both packages from momentum copies
    that differ from the weights: (port losses, grads, new state; JAX's)."""
    from sprc_tpu.models.classification import classifier_train_step as jcls_step
    from sprc_tpu.models.nlvr import nlvr_train_step as jnlvr_step

    from sprc_tpu_torch.models.classification import classifier_train_step
    from sprc_tpu_torch.models.nlvr import nlvr_train_step

    model, jm, params = tiny(kind, seed)
    b = batch(kind, seed + 10)
    rs = np.random.RandomState(seed + 20)
    params_m = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.01 * rs.randn(*np.shape(x)).astype(np.float32),
        {k: params[k] for k in ("visual_encoder", "text_encoder", "cls_head")})
    jstep = jnlvr_step if kind.startswith("nlvr") else jcls_step

    def loss_fn(p):
        out, new = jstep(jm, p, {"params_m": params_m}, b, alpha=0.3)
        return out["loss"], new

    step_grad = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))  # faster than op by op
    (want_loss, want_state), want_grads = step_grad(params)
    state = momentum_copies_from_jax({"params_m": params_m}, model, bridge(kind))
    values = dict(model.named_parameters())
    step = nlvr_train_step if kind.startswith("nlvr") else classifier_train_step
    model.train()
    out, new = step(model, values, state, {k: t(v) for k, v in b.items()}, alpha=0.3)
    out["loss"].backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    return (model, out, grads, new), (want_loss, want_grads, want_state)


def _check_step(kind, seed):
    (model, out, grads, new), (want_loss, want_grads, want_state) = _step_against_jax(kind, seed)
    assert abs(out["loss"].item() - float(want_loss)) <= TOL, kind
    want_g = bridge(kind)(jax.tree_util.tree_map(np.asarray, want_grads))
    scale = max(float(g.abs().max()) for g in grads.values())
    for n, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want_g[n].numpy(), atol=GRAD_TOL * scale,
                                   err_msg=n)
    want_m = momentum_copies_from_jax(jax.tree_util.tree_map(np.asarray, want_state), model,
                                      bridge(kind))["params_m"]
    assert sorted(new["params_m"]) == sorted(want_m)
    for n, m in new["params_m"].items():
        np.testing.assert_allclose(m.numpy(), want_m[n].numpy(), atol=MOMENTUM_TOL, err_msg=n)
    return model, new


@pytest.mark.parametrize("kind", ["classifier_albef", "classifier_blip"])
def test_classifier_distilled_step_equals_jax(kind):
    """``classifier_train_step``: the momentum update, the momentum logits,
    ``(1 - a) CE - a E[log p . soft]``; its loss, every gradient and the
    momentum copies after it."""
    _check_step(kind, 4)


def test_albef_nlvr_distilled_step_equals_jax():
    """``nlvr_train_step`` (ALBEF): the momentum tower and head over the
    ONLINE med-BERT (the reference quirk: the momentum med-BERT's copies are
    updated and not read), against the JAX step."""
    from sprc_tpu_torch.models.albef import momentum_weights

    model, new = _check_step("nlvr_albef", 5)
    b = {k: t(v) for k, v in batch("nlvr_albef", 15).items()}
    args = (b["image0"], b["image1"], b["input_ids"], b["text_mask"])
    text_m = {n: m + 1.0 for n, m in new["params_m"].items() if n.startswith("text_encoder.")}
    with torch.no_grad():
        live = model.predict(*args)
        with momentum_weights(model, text_m):
            moved = model.predict(*args)
    assert (live - moved).abs().max() > 1e-2  # the text copies would change the logits


def test_bridges_and_lavis_readers(tmp_path):
    """``classifier_from_jax`` / ``nlvr_from_jax`` load with ``strict=True``
    to the port's weights; LAVIS-layout files (the momentum modules
    ``*_m`` beside them, the classifier's med-BERT as ``text_encoder.bert.``)
    load through ``read_checkpoint`` to the same weights, and the JAX readers
    read them to the same trees."""
    from sprc_tpu.interop import lavis_import as li

    for kind in MODELS:
        model, jm, params = tiny(kind, 6)
        name, model_type = MODELS[kind][:2]
        fresh = loader.build_model(name, model_type, device="cpu", **overrides(kind))
        fresh.load_state_dict(bridge(kind)(params), strict=True)
        for k, v in model.state_dict().items():
            assert torch.equal(fresh.state_dict()[k], v), (kind, k)
        sd = numpy_state(model)
        for k in [k for k in sd if k.split(".")[0] in ("visual_encoder", "text_encoder",
                                                       "cls_head")]:
            head, _, rest = k.partition(".")
            sd[f"{head}_m.{rest}"] = sd[k] - 1.0
        if kind.startswith("classifier"):
            sd = {(k.replace("text_encoder.", "text_encoder.bert.", 1)
                   if k.startswith("text_encoder.") else k): v for k, v in sd.items()}
        torch.save({"model": {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}},
                   tmp_path / f"{kind}.pth")
        read = loader.load_model(name, model_type, checkpoint_path=str(tmp_path / f"{kind}.pth"),
                                 device="cpu", **overrides(kind))
        for k, v in model.state_dict().items():
            assert torch.equal(read.state_dict()[k], v), (kind, k)
        again = (li.nlvr_params_from_torch if kind.startswith("nlvr")
                 else li.classifier_params_from_torch)(sd, jm)
        for a, b_ in zip(jax.tree_util.tree_leaves(again), jax.tree_util.tree_leaves(params)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b_))


def test_albef_nlvr_ties_cross_key_value():
    """ALBEF's NLVR med-BERT holds one key and one value projection for its
    layer pair (1, 2): both names in the state dict, one trainable tensor,
    and an update moves both names together."""
    from sprc_tpu_torch.train.loop import TrainConfig, Trainer

    model, _, _ = tiny("nlvr_albef", 7)
    sd = model.state_dict()
    pair = [f"text_encoder.encoder.layer.{i}.crossattention.self.key.weight" for i in (1, 2)]
    assert all(k in sd for k in pair) and torch.equal(sd[pair[0]], sd[pair[1]])
    names = [n for n, _ in model.named_parameters()]
    assert pair[0] in names and pair[1] not in names
    trainer = Trainer(model, TrainConfig(learning_rate=1e-3, total_steps=4))
    b = {k: t(v) for k, v in batch("nlvr_albef", 8).items()}
    before = sd[pair[0]].clone()
    trainer.forward = lambda batch: model(batch["image0"], batch["image1"], batch["input_ids"],
                                          batch["text_mask"], batch["labels"])
    trainer.train_step(b)
    after = model.state_dict()
    assert torch.equal(after[pair[0]], after[pair[1]])
    assert not torch.equal(after[pair[0]], before)
