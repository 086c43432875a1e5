"""The port's ALPRO models (``sprc_tpu_torch/models/alpro.py``) against
sprc_tpu's, at the JAX tests' tiny shapes (tests/test_alpro.py: the
TimeSformer at 32 px, patch 16, width 24, depth 2, 2 frames; the med-BERT 4
layers of 24, fusion from layer 2, vocabulary 60, dropout 0).

The port's models come from ``loader.load_model`` (``init_weights``), every
tensor then moved by seeded noise; the JAX models get the same weights
through the JAX package's LAVIS reader (``alpro_params_from_torch``), which
is also how a released checkpoint reaches them, and the JAX trees come back
through the port's bridge (``alpro_from_jax``) into a strict load. Losses,
features, VTM scores and logits are held within 1e-5 absolute; the
hard-negative picks are JAX's argmax (no ``sample`` rng) or JAX's own
categorical draws handed to the port.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sprc_tpu.models import alpro as jalpro  # noqa: E402
from sprc_tpu.models.qformer import QFormerConfig as JQ  # noqa: E402
from sprc_tpu.models.timesformer import TimeSformerConfig as JT  # noqa: E402

from sprc_tpu_torch import loader  # noqa: E402
from sprc_tpu_torch.interop.jax_params import alpro_from_jax  # noqa: E402
from test_torch_threads import one_torch_thread  # noqa: E402,F401  (one thread a module)

TOL = 1e-5
VIDEO = dict(image_size=32, patch_size=16, width=24, depth=2, num_heads=2, mlp_hidden=48,
             num_frames=2)
TEXT = dict(vocab_size=60, hidden_size=24, num_layers=4, num_heads=2, intermediate_size=48,
            encoder_width=24, dropout_rate=0.0)
MODEL = dict(image_size=32, num_frames=2, embed_dim=8, max_txt_len=6, fusion_layer=2,
             vocab_size=60)


def overrides(**kw):
    return dict(MODEL, video_config_override=VIDEO, text_config_override=TEXT, **kw)


def port_model(name="alpro_retrieval", seed=0, **kw):
    model = loader.load_model(name, "pretrain", device="cpu", seed=seed, **overrides(**kw))
    gen = torch.Generator().manual_seed(seed + 7)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn(p.shape, generator=gen) * 0.05)
    return model


def jax_model(name="alpro_retrieval", **kw):
    cls = {"alpro_retrieval": jalpro.AlproRetrieval, "alpro_qa": jalpro.AlproQA}[name]
    return cls(jalpro.AlproConfig(**MODEL, **kw, video_config_override=JT(**VIDEO),
                                  text_config_override=JQ(**TEXT)))


def numpy_state(model):
    return {k: v.numpy() for k, v in model.state_dict().items()}


def batch(seed=0, B=3):
    rs = np.random.RandomState(seed)
    mask = np.ones((B, 6), np.int64)
    mask[1, 4:] = 0
    return (rs.rand(B, 2, 32, 32, 3).astype(np.float32), rs.randint(1, 60, (B, 6)), mask)


def t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


@pytest.fixture(scope="module")
def retrieval():
    model = port_model(seed=1)
    jm = jax_model()
    return model, jm, jalpro.alpro_params_from_torch(numpy_state(model), jm)


def japply(jm, params, *args, method=None):
    """The JAX module applied under ``jit`` (eager Flax runs op by op, several
    times slower at these shapes)."""
    return jax.jit(lambda p, *a: jm.apply({"params": p}, *a, method=method))(
        params, *(jnp.asarray(a) for a in args))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=TOL, rtol=0)


def test_retrieval_losses_equal_jax_argmax(retrieval):
    """VTC and VTM on JAX's argmax negatives (no ``sample`` rng; the port
    without a generator): the three losses within 1e-5; the JAX tree bridged
    back loads strictly into a fresh model and gives the same losses."""
    model, jm, params = retrieval
    video, ids, mask = batch()
    want = japply(jm, params, video, ids, mask)
    with torch.no_grad():
        got = model(*t(video, ids, mask))
    for key in ("loss", "loss_vtc", "loss_vtm"):
        _close(got[key].item(), float(want[key]))
    fresh = loader.build_model("alpro_retrieval", "pretrain", device="cpu", **overrides())
    fresh.load_state_dict(alpro_from_jax(jax.tree_util.tree_map(np.asarray, params)),
                          strict=True)
    with torch.no_grad():
        _close(fresh(*t(video, ids, mask))["loss"].item(), float(want["loss"]))


def test_retrieval_losses_on_jax_sampled_negatives(retrieval, monkeypatch):
    """With a ``sample`` rng JAX draws the negatives by
    ``jax.random.categorical`` (the videos' first); those draws handed to the
    port's forward give JAX's losses, and the port's own draws come from
    ``sample_negatives`` on the caller's generator, the videos' first."""
    from sprc_tpu_torch.models import alpro

    model, jm, params = retrieval
    video, ids, mask = batch(seed=2, B=4)
    draws = []
    real = jax.random.categorical

    def keep(key, logits, axis=-1, **kw):  # the draws reach the host from the jitted step
        out = real(key, logits, axis=axis, **kw)
        jax.debug.callback(lambda x: draws.append(np.asarray(x)), out)
        return out

    monkeypatch.setattr(jax.random, "categorical", keep)
    want = jax.jit(lambda p, *a: jm.apply({"params": p}, *a,
                                          rngs={"sample": jax.random.PRNGKey(7)}))(
        params, *(jnp.asarray(a) for a in (video, ids, mask)))
    jax.effects_barrier()
    assert len(draws) == 2
    with torch.no_grad():
        got = model(*t(video, ids, mask), negatives=tuple(torch.from_numpy(d).long()
                                                          for d in draws))
    for key in ("loss", "loss_vtc", "loss_vtm"):
        _close(got[key].item(), float(want[key]))
    seen = []
    monkeypatch.setattr(alpro, "sample_negatives",
                        lambda w, g: seen.append((w.clone(), g)) or w.argmax(1))
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        model(*t(video, ids, mask), generator=gen)
    assert len(seen) == 2 and all(g is gen for _, g in seen)
    for w, _ in seen:  # softmax rows with the diagonal masked out
        assert torch.allclose(w.sum(1), torch.ones(4)) and bool((w.diagonal() < 1e-6).all())


def test_eval_helpers_equal_jax(retrieval):
    """video_feats, text_feats and vtm_score (the retrieval evaluation's
    calls) equal JAX's."""
    model, jm, params = retrieval
    video, ids, mask = batch(seed=3)
    ve, vf = japply(jm, params, video, method=jm.video_feats)
    te, tf = japply(jm, params, ids, mask, method=jm.text_feats)
    score = japply(jm, params, te, mask, ve, method=jm.vtm_score)
    with torch.no_grad():
        pe, pf = model.video_feats(*t(video))
        pte, ptf = model.text_feats(*t(ids, mask))
        ps = model.vtm_score(pte, *t(mask), pe)
    for got, want in ((pe, ve), (pf, vf), (pte, te), (ptf, tf), (ps, score)):
        _close(got.numpy(), want)
    assert pf.shape == (3, 8) and ps.shape == (3,)


def test_qa_predict_and_loss_with_an_oov_target():
    """AlproQA's logits (LAVIS's ``classifier.0`` / ``classifier.2``) equal
    JAX's; a target of -1 (an answer outside the vocabulary) is left out of
    the loss, in both packages; the bridge round-trips the tree."""
    model = port_model("alpro_qa", seed=4, num_classes=5)
    jm = jax_model("alpro_qa", num_classes=5)
    params = jalpro.alpro_params_from_torch(numpy_state(model), jm)
    video, ids, mask = batch(seed=4)
    targets = np.asarray([3, -1, 0])
    want = japply(jm, params, video, ids, mask, targets)
    with torch.no_grad():
        got = model(*t(video, ids, mask, targets))
        logits = model.predict(*t(video, ids, mask))
    _close(got["logits"].numpy(), want["logits"])
    _close(logits.numpy(), want["logits"])
    _close(got["loss"].item(), float(want["loss"]))
    lp = torch.log_softmax(logits, -1)
    _close(got["loss"].item(), -(lp[0, 3] + lp[2, 0]).item() / 2)
    assert sorted(k for k in model.state_dict() if k.startswith("classifier")) == [
        "classifier.0.bias", "classifier.0.weight", "classifier.2.bias", "classifier.2.weight"]
    back = alpro_from_jax(jax.tree_util.tree_map(np.asarray, params))
    assert set(back) == set(model.state_dict())


@pytest.mark.parametrize("name", ["alpro_retrieval", "alpro_qa"])
def test_lavis_checkpoint_read_equals_jax(name, tmp_path):
    """A LAVIS-layout ALPRO file: the trunk under ``visual_encoder.model.``,
    BERT's ``token_type_embeddings`` (its row 0 folded into every position
    row), the pooler and the tower's head the model does not hold, no
    ``position_ids``. ``loader.read_checkpoint`` loads it strictly and the
    port then equals JAX's model read by ``alpro_params_from_torch`` from the
    same file."""
    kw = {"num_classes": 5} if name == "alpro_qa" else {}
    source = port_model(name, seed=5, **kw)
    rng = np.random.RandomState(6)
    sd = {}
    for k, v in source.state_dict().items():
        if k.endswith("position_ids"):
            continue
        sd[k.replace("visual_encoder.", "visual_encoder.model.", 1)] = v.clone()
    sd["text_encoder.embeddings.token_type_embeddings.weight"] = torch.from_numpy(
        rng.randn(2, 24).astype(np.float32))
    sd["text_encoder.pooler.dense.weight"] = torch.zeros(24, 24)
    sd["visual_encoder.model.head.weight"] = torch.zeros(4, 24)
    path = tmp_path / "alpro.pth"
    torch.save({"model": sd}, path)
    model = loader.load_model(name, "pretrain", checkpoint_path=str(path), device="cpu",
                              **overrides(**kw))
    jm = jax_model(name, **kw)
    params = jalpro.alpro_params_from_torch({k: v.numpy() for k, v in sd.items()}, jm)
    video, ids, mask = batch(seed=7)
    with torch.no_grad():
        if name == "alpro_qa":
            got = model.predict(*t(video, ids, mask)).numpy()
            want = japply(jm, params, video, ids, mask, method=jm.predict)
        else:
            got = model.video_feats(*t(video))[1].numpy()
            got = np.concatenate([got, model.text_feats(*t(ids, mask))[1].numpy()])
            want = np.concatenate([
                np.asarray(japply(jm, params, video, method=jm.video_feats)[1]),
                np.asarray(japply(jm, params, ids, mask, method=jm.text_feats)[1])])
    _close(got, want)
    pos = model.state_dict()["text_encoder.embeddings.position_embeddings.weight"]
    np.testing.assert_allclose(
        pos.numpy(), (sd["text_encoder.embeddings.position_embeddings.weight"]
                      + sd["text_encoder.embeddings.token_type_embeddings.weight"][0]).numpy())


def test_loader_rows_and_registry_equal_jax():
    """The video rows of ``loader.FAMILY_CONFIGS`` against what sprc_tpu's
    loader builds from configs/models/{alpro_retrieval,alpro_qa,timesformer}:
    the config fields, the TimeSformer and med-BERT dimensions, the clip
    processors ``loader.preprocessors`` gives them (the JAX
    ``load_model_and_preprocess``' branch); ``timesformer`` (the tower under
    ``model``) equals JAX's TimeSformerModel."""
    from sprc_tpu.loader import build_model as jbuild

    rows = [k for k in loader.FAMILY_CONFIGS if k[0] in loader.VIDEO_MODELS]
    assert sorted(rows) == sorted([("alpro_retrieval", "pretrain"), ("alpro_retrieval", "msrvtt"),
                                   ("alpro_retrieval", "didemo"), ("alpro_qa", "pretrain"),
                                   ("alpro_qa", "msrvtt"), ("alpro_qa", "msvd"),
                                   ("timesformer", "pretrain"), ("timesformer", "base")])
    for name, model_type in rows:
        cfg, jcfg = loader.family_config(name, model_type), jbuild(name, model_type).cfg
        for f in dataclasses.fields(cfg):
            if not f.name.endswith(("dtype", "override")):
                assert getattr(cfg, f.name) == getattr(jcfg, f.name), (name, model_type, f.name)
        v, jv = cfg.video_config(), jcfg.video_config()
        for f in dataclasses.fields(v):
            if f.name != "dtype":
                assert getattr(v, f.name) == getattr(jv, f.name), (name, model_type, f.name)
        assert v.dtype == cfg.text_config().dtype == torch.float32
        q, jq = cfg.text_config(), jcfg.text_config()
        for f in ("vocab_size", "hidden_size", "num_layers", "num_heads", "intermediate_size",
                  "encoder_width", "max_position_embeddings", "layer_norm_eps"):
            assert getattr(q, f) == getattr(jq, f), (name, model_type, f)
    assert loader.family_config("alpro_qa", "msvd").video_config().num_frames == 16
    vis, txt = loader.preprocessors("alpro_qa", "msvd")  # the ALPRO clip processors
    assert [type(vis[k]).__name__ for k in ("train", "eval")] == [
        "AlproVideoTrainProcessor", "AlproVideoEvalProcessor"]
    assert vis["eval"].image_size == 224 and type(txt["eval"]).__name__ == "CaptionProcessor"
    model = port_model("timesformer", seed=8)
    jm = jalpro.TimeSformerModel(jalpro.AlproConfig(**MODEL, video_config_override=JT(**VIDEO)))
    from sprc_tpu.models.timesformer import timesformer_params_from_torch

    params = {"model": timesformer_params_from_torch(numpy_state(model), "model.", 2)}
    video = batch(seed=8)[0]
    with torch.no_grad():
        _close(model(*t(video)).numpy(), japply(jm, params, video))
