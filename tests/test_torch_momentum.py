"""The momentum-queue families in the port (models/albef.py's momentum state,
AlbefRetrieval, AlbefPretrain and mlm_mask; models/blip1.py's BlipRetrieval
and BlipPretrain; interop/jax_params.py's bridges) against sprc_tpu's.

Tiny models (ViT width 64 / depth 2 at 32 px, patch 16; med-BERT hidden 64,
2 layers, 2 heads, ALBEF's fusion from layer 1; embed 16, queues of 8), the
port's from ``init_weights`` with every bias and norm moved by seeded noise
(test_torch_blip1.py's ``port_model``), the JAX model's from those weights
through the JAX package's LAVIS importers, so no JAX init compiles. The
same seeded numpy inputs go through both, fp32. Hard negatives are JAX's
own draw: ``jax.random.categorical`` is wrapped (in this test process) to
record what it returns, and the port's forward is handed those indices.
Losses agree within 1e-5, gradients within 1e-4.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sprc_tpu_torch.interop.jax_params import (albef_retrieval_from_jax,  # noqa: E402
                                               blip_retrieval_from_jax)
from sprc_tpu_torch.models import albef  # noqa: E402
from test_torch_blip1 import IMG, VIT, VOCAB, numpy_state, port_model, t  # noqa: E402
from test_torch_threads import one_torch_thread  # noqa: E402,F401  (one thread a module)

LOSS_TOL, GRAD_TOL = 1e-5, 1e-4
E, K, B, L = 16, 8, 4, 7
TXT = dict(vocab_size=VOCAB, hidden_size=64, num_layers=2, num_heads=2, intermediate_size=128,
           encoder_width=64, dropout_rate=0.0)
FUSION = 1  # ALBEF: layer 0 text-only, layer 1 fusion
# (model name, model type) of each family
MODELS = {"blip_retrieval": "coco", "albef_retrieval": "coco", "blip_pretrain": "base",
          "albef_pretrain": "base"}
# the forward's positional arguments, as both packages take them
ARGS = {
    "blip_retrieval": ("images", "input_ids", "text_mask", "enc_input_ids", "image_ids"),
    "albef_retrieval": ("images", "input_ids", "text_mask", "image_ids"),
    "blip_pretrain": ("images", "input_ids", "text_mask", "enc_input_ids", "dec_input_ids",
                      "image_ids"),
    "albef_pretrain": ("images", "input_ids", "text_mask", "masked_ids", "mlm_labels",
                       "image_ids")}
QUEUE_ARGS = ("image_feat_m", "text_feat_m", "image_queue", "text_queue", "idx_queue")


def overrides(name):
    kw = dict(embed_dim=E, queue_size=K, vit_config_override=VIT, text_config_override=TXT)
    if name.startswith("albef"):
        kw["fusion_layer"] = FUSION
    return kw


def jax_configs():
    from sprc_tpu.models.qformer import QFormerConfig
    from sprc_tpu.models.vit import ViTConfig

    return ViTConfig(**{**VIT, "dtype": jnp.float32}), QFormerConfig(**TXT)


def tiny_pair(name, seed=0):
    """(the port's tiny model, the JAX model, its params from the port's weights)."""
    from sprc_tpu.interop import lavis_import as li
    from sprc_tpu.models import albef as ja
    from sprc_tpu.models import blip1 as jb

    model = port_model(name, MODELS[name], seed, **overrides(name))
    jv, jq = jax_configs()
    common = dict(image_size=IMG, embed_dim=E, vocab_size=VOCAB, queue_size=K,
                  vit_dtype=jnp.float32, vit_config_override=jv, text_config_override=jq)
    if name.startswith("albef"):
        cls = ja.AlbefPretrain if name == "albef_pretrain" else ja.AlbefRetrieval
        jm = cls(ja.AlbefConfig(fusion_layer=FUSION, **common))
        params = li.albef_retrieval_params_from_torch(numpy_state(model), jm)
    else:
        cls = jb.BlipPretrain if name == "blip_pretrain" else jb.BlipRetrieval
        jm = cls(jb.BlipRetrievalConfig(**common))
        params = li.blip_retrieval_params_from_torch(numpy_state(model), jm)
    return model, jm, params


def bridge(name):
    return albef_retrieval_from_jax if name.startswith("albef") else blip_retrieval_from_jax


def _unit(x, axis):
    return (x / np.linalg.norm(x, axis=axis, keepdims=True)).astype(np.float32)


def batch(name, seed, ids_of=(5, 7, 5, 9)):
    """One seeded batch of ``name``'s inputs (numpy): pixels, ids with a
    padded row, ``[ENC]`` / ``[DEC]`` ids, image ids with a repeat, and for
    the forward's own tests momentum features, queues and an id queue
    that matches some of the batch's ids."""
    rs = np.random.RandomState(seed)
    ids = rs.randint(5, VOCAB, (B, L)).astype(np.int32)
    ids[:, 0] = 2
    mask = np.ones((B, L), np.int32)
    mask[1, L - 2:] = 0
    ids[1, L - 2:] = 0
    out = {"images": rs.rand(B, IMG, IMG, 3).astype(np.float32), "input_ids": ids,
           "text_mask": mask, "image_ids": np.asarray(ids_of, np.int32)}
    out["enc_input_ids"] = np.where(np.arange(L) == 0, 3, ids).astype(np.int32)
    out["dec_input_ids"] = np.where(np.arange(L) == 0, 1, ids).astype(np.int32)
    masked, labels = albef.mlm_mask(rs, ids, VOCAB, 4, pad_token_id=0, cls_token_id=2,
                                    probability=0.3)
    out["masked_ids"], out["mlm_labels"] = masked, labels
    return out


def queue_inputs(seed):
    rs = np.random.RandomState(seed)
    return {"image_feat_m": _unit(rs.randn(B, E), 1), "text_feat_m": _unit(rs.randn(B, E), 1),
            "image_queue": _unit(rs.randn(E, K), 0), "text_queue": _unit(rs.randn(E, K), 0),
            "idx_queue": np.asarray([7, -100, 3, 5, -100, -100, 9, -100], np.int32)}


@pytest.fixture
def jax_draws(monkeypatch):
    """``jax.random.categorical`` wrapped to record its draws: a list with a
    ``{0: neg_img, 1: neg_txt}`` dict for each executed call pair (the image
    picks come first in both packages)."""
    orig = jax.random.categorical
    draws, traced = [], [0]

    def record(slot, value):
        if slot == 0:
            draws.append({})
        draws[-1][slot] = np.asarray(value).astype(np.int64)

    def categorical(key, logits, axis=-1, **kw):
        out = orig(key, logits, axis=axis, **kw)
        slot = traced[0] % 2
        traced[0] += 1
        jax.debug.callback(lambda v, s=slot: record(s, v), out, ordered=True)
        return out

    monkeypatch.setattr(jax.random, "categorical", categorical)
    return draws


def test_momentum_state_equals_jax():
    """``init_albef_state`` (fp32 copies in fresh storage, the JAX queue
    draws), ``momentum_update``, the ring ``enqueue`` wrapping past the end
    and ``rampup_alpha``, against the JAX functions."""
    from sprc_tpu.models import albef as ja

    from sprc_tpu_torch.interop.jax_params import momentum_state_from_jax

    model, jm, params = tiny_pair("albef_retrieval")
    values = dict(model.named_parameters())
    state = albef.init_albef_state(values, model.cfg, seed=3, keys=model.MOMENTUM_KEYS)
    want = ja.init_albef_state(params, jm.cfg, seed=3)
    assert set(state["params_m"]) == set(albef.momentum_names(model))
    assert not any(n.startswith("itm_head") or n == "temp" for n in state["params_m"])
    for n, m in state["params_m"].items():
        assert m.dtype == torch.float32 and m.data_ptr() != values[n].data_ptr()
    jwant = momentum_state_from_jax(jax.tree_util.tree_map(np.asarray, want), model)
    for key in ("image_queue", "text_queue"):
        np.testing.assert_array_equal(state[key].numpy(), jwant[key].numpy())
    assert state["idx_queue"].tolist() == [-100] * K and int(state["ptr"]) == 0

    rs = np.random.RandomState(4)
    moved = {n: p.detach() + torch.from_numpy(np.asarray(rs.randn(*p.shape), np.float32))
             for n, p in values.items()}
    jmoved = bridge_tree(params, moved, model)
    state = albef.momentum_update(moved, state, 0.9)
    want = ja.momentum_update(jmoved, want, 0.9)
    feats = queue_inputs(5)
    for step, ids in enumerate(([1, 2, 3], [4, 5, 6], [7, 8, 9])):  # the third wraps
        iids = np.asarray(ids, np.int32)
        img, txt = feats["image_feat_m"][:3] + step, feats["text_feat_m"][:3] - step
        state = albef.enqueue(state, t(img), t(txt), t(iids))
        want = ja.enqueue(want, jnp.asarray(img), jnp.asarray(txt), jnp.asarray(iids))
    jwant = momentum_state_from_jax(jax.tree_util.tree_map(np.asarray, want), model)
    for n, m in state["params_m"].items():
        np.testing.assert_allclose(m.numpy(), jwant["params_m"][n].numpy(), atol=1e-6, err_msg=n)
    for key in ("image_queue", "text_queue"):
        np.testing.assert_array_equal(state[key].numpy(), jwant[key].numpy())
    assert state["idx_queue"].tolist() == jwant["idx_queue"].tolist() == [9, 2, 3, 4, 5, 6, 7,
                                                                         8]
    assert int(state["ptr"]) == int(jwant["ptr"]) == 1
    for epoch, i, n in ((0, 0, 10), (0, 7, 10), (1, 3, 10), (2, 0, 10), (0, 5, 3)):
        assert albef.rampup_alpha(model.cfg, epoch, i, n) == pytest.approx(
            ja.rampup_alpha(jm.cfg, epoch, i, n), abs=0, rel=0)


def bridge_tree(params, values, model):
    """``values`` (the port's names) as a JAX tree shaped as ``params``."""
    from sprc_tpu.interop.lavis_import import albef_retrieval_params_from_torch
    from sprc_tpu.models import albef as ja

    sd = {n: v.detach().numpy() for n, v in values.items()}
    for n, b in model.named_buffers():
        sd[n] = b.numpy()
    jm = ja.AlbefRetrieval(ja.AlbefConfig(fusion_layer=FUSION, image_size=IMG, embed_dim=E,
                                          vocab_size=VOCAB, queue_size=K, vit_dtype=jnp.float32,
                                          vit_config_override=jax_configs()[0],
                                          text_config_override=jax_configs()[1]))
    return albef_retrieval_params_from_torch(sd, jm)


def test_mlm_mask_bit_for_bit():
    """``mlm_mask`` against the JAX function on one RandomState stream (three
    calls in a row, special ids kept), and the pretraining adapter's saved
    RandomState continues the stream after a restore."""
    from sprc_tpu.models.albef import mlm_mask as jmask

    from sprc_tpu_torch.train.generic import AlbefPretrainAdapter
    from sprc_tpu_torch.text.tokenizer import BertWordPieceTokenizer
    from sprc_tpu_torch.utils.artifacts import write_synthetic_bert_vocab

    ids = np.random.RandomState(1).randint(0, 300, (6, 40)).astype(np.int32)
    ids[:, 0] = 101
    ids[2, 30:] = 0
    got_rng, want_rng = np.random.RandomState(0), np.random.RandomState(0)
    picked = 0
    for _ in range(3):
        got = albef.mlm_mask(got_rng, ids, 30523, 103, pad_token_id=0, cls_token_id=101)
        want = jmask(want_rng, ids, 30523, 103, pad_token_id=0, cls_token_id=101)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.int32
            np.testing.assert_array_equal(g, w)
        assert (got[1][:, 0] == -100).all() and (got[1][2, 30:] == -100).all()
        picked += int((got[1] != -100).sum())
    assert picked > 0

    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        tok = BertWordPieceTokenizer.from_vocab_file(write_synthetic_bert_vocab(f"{tmp}/v.txt"))
    items = [{"image": np.zeros((2, 2, 3), np.float32), "text_input": "a b c d e f g h",
              "image_id": i} for i in range(4)]
    a = AlbefPretrainAdapter(tok, 12)
    a.collate(items)
    saved = torch.load(_round_trip(a.state_dict()), weights_only=True)
    want = a.collate(items)
    b = AlbefPretrainAdapter(tok, 12)
    b.load_state_dict(saved)
    got = b.collate(items)
    for key in ("masked_ids", "mlm_labels"):
        np.testing.assert_array_equal(got[key], want[key])


def _round_trip(state):
    import io

    buf = io.BytesIO()
    torch.save(state, buf)
    buf.seek(0)
    return buf


@pytest.mark.parametrize("name", list(MODELS))
def test_losses_equal_jax(name, jax_draws):
    """The forward's losses (and ``loss``, the pretrainers' sum) and every
    parameter's gradient of the total against JAX's ``value_and_grad``, on
    JAX's hard negatives; ``alpha`` 0.3; the id queue holds some of the
    batch's ids (multi-positive targets)."""
    model, jm, params = tiny_pair(name, seed=1)
    b = {**batch(name, 2), **queue_inputs(3)}
    extra = ({"mlm_logits_m": np.random.RandomState(4).randn(B, L, VOCAB).astype(np.float32)}
             if name == "albef_pretrain" else {})
    args = [b[k] for k in ARGS[name] + QUEUE_ARGS] + list(extra.values())

    def loss_fn(p):
        out = jm.apply({"params": p}, *map(jnp.asarray, args), jnp.asarray(0.3, jnp.float32),
                       rngs={"sample": jax.random.PRNGKey(7)})
        return (out["loss"] if "loss" in out else out["loss_itc"] + out["loss_itm"]), out

    (_, want), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    jax.effects_barrier()  # the recorded draws are on the host
    draw = jax_draws[-1]
    model.train()
    got = model(*map(t, args), torch.tensor(0.3), negatives=(t(draw[0]), t(draw[1])))
    assert set(got) == set(want) >= {"loss_itc", "loss_itm"}
    for key, value in want.items():
        assert abs(float(got[key]) - float(value)) <= LOSS_TOL * max(1.0, abs(float(value))), key
    total = got["loss"] if "loss" in got else got["loss_itc"] + got["loss_itm"]
    total.backward()
    want_g = bridge(name)(jax.tree_util.tree_map(np.asarray, grads))
    for n, p in model.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        np.testing.assert_allclose(g.numpy(), want_g[n].numpy(), atol=GRAD_TOL, err_msg=n)
    assert model.visual_encoder.blocks[0].attn.qkv.weight.grad.abs().max() > 0
