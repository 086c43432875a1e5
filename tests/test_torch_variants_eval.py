"""The port's CIR variant zoo beyond the training losses: the Q-Former's
``output_attentions``, the forwards that return tensors (``blip2_cir_slt``,
``blip2_cir_prompt``), the cached training forward of every variant, the
hard negatives' sampling branch, the optimizer's rule on the rerank twin,
and the configuration rows of all eleven CIR models.

The tiny EVA-style model of test_torch_variants_losses.py (fp32, CPU), the
JAX side initialised through each class's forward and carried across with
strict=True. Tolerances: 1e-5 absolute on the attention probabilities,
hidden states, sims and features (fp32 sums in another order through two
Q-Former layers, values of order 1); the cached forward equals the live one
exactly (the same ops on the same rows, dropout masks from one seed); the
AdamW step equals optax's on the same gradients within 1e-6 relative.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from sprc_tpu.models.qformer import QFormer as JQFormer  # noqa: E402
from sprc_tpu.models.qformer import QFormerConfig as JQFormerConfig  # noqa: E402

from sprc_tpu_torch.interop.jax_params import state_dict_from_jax  # noqa: E402
from sprc_tpu_torch.loader import CIR_MODELS, MODEL_CONFIGS, build_model, init_weights  # noqa: E402
from sprc_tpu_torch.models.cir_variants import CirCls, _HardNegMixin  # noqa: E402
from sprc_tpu_torch.train.loop import TrainConfig, Trainer  # noqa: E402

from test_torch_train_losses import QF, Q, TXT, VIT, W, torch_batch  # noqa: E402
from test_torch_variants_losses import (B, TRAINABLE, jax_variant, port_variant,  # noqa: E402
                                        variant_batch, variant_params)
from test_torch_threads import one_torch_thread  # noqa: E402,F401  (one thread a module)

ATOL = 1e-5


@pytest.fixture(scope="module")
def slt():
    jm = jax_variant("blip2_cir_slt")
    params = variant_params(jm)
    return jm, params, port_variant("blip2_cir_slt", params).eval()


def test_output_attentions_equal_jax(slt):
    """The last layer's self-attention probabilities and the hidden states,
    with an image and padded captions: in eval (the other layer through
    K3's plain version) and in training mode with autograd (dropout 0)."""
    _, params, model = slt
    batch = variant_batch()
    rng = np.random.RandomState(2)
    queries = (rng.standard_normal((B, Q, W)) * 0.5).astype(np.float32)
    image = rng.standard_normal((B, (VIT["image_size"] // 14) ** 2 + 1, W)).astype(np.float32)
    mask = np.concatenate([np.ones((B, Q), np.int32), batch["text_mask"]], axis=1)
    args = (batch["input_ids"], queries, mask, image)
    jq = JQFormer(JQFormerConfig(**QF, dropout_rate=0.0, attention_dropout_rate=0.0))
    want_h, want_p = jax.jit(lambda p, *a: jq.apply({"params": p}, *a, output_attentions=True))(
        params["qformer"], *(jnp.asarray(a) for a in args))
    assert want_p.shape == (B, QF["num_heads"], Q + TXT, Q + TXT)
    targs = [torch.from_numpy(a) for a in args]
    with torch.no_grad():
        got_h, got_p = model.qformer(*targs, output_attentions=True)
        plain_h = model.qformer(*targs)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), atol=ATOL)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), atol=ATOL)
    np.testing.assert_allclose(got_h.numpy(), plain_h.numpy(), atol=ATOL)
    model.train()
    try:
        train_h, train_p = model.qformer(*targs, output_attentions=True)
    finally:
        model.eval()
    assert train_p.requires_grad
    np.testing.assert_allclose(train_p.detach().numpy(), np.asarray(want_p), atol=ATOL)
    np.testing.assert_allclose(train_h.detach().numpy(), np.asarray(want_h), atol=ATOL)
    torch.testing.assert_close(got_p.sum(-1), torch.ones_like(got_p.sum(-1)))


def test_slt_sims_equal_jax(slt):
    """``blip2_cir_slt``'s forward: the top 4 query tokens by the CLS row's
    attention, fused with the text, against the targets over the temperature."""
    jm, params, model = slt
    batch = variant_batch()
    want = jax.jit(lambda p, *a: jm.apply({"params": p}, *a))(
        params, *(jnp.asarray(batch[k]) for k in ("reference", "target", "input_ids",
                                                   "text_mask")))
    with torch.no_grad():
        got = model(*torch_batch(batch).values())
    assert got.shape == (B, B)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL / 0.07)  # over temp


def test_prompt_forward_and_inference_equal_jax():
    """``blip2_cir_prompt``: the fused queries, and ``inference`` against a
    gallery's target feats."""
    jm = jax_variant("blip2_cir_prompt")
    params = variant_params(jm)
    model = port_variant("blip2_cir_prompt", params).eval()
    batch = variant_batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = jax.jit(lambda p, *a: jm.apply({"params": p}, *a))(
        params, jb["reference"], jb["target"], jb["input_ids"], jb["text_mask"])
    tb = torch_batch(batch)
    with torch.no_grad():
        got = model(tb["reference"], tb["target"], tb["input_ids"], tb["text_mask"])
        feats, frozen = model.extract_target_features(tb["target"])
        scores = model.inference(model.encode_image(tb["reference"]), feats, tb["input_ids"],
                                 tb["text_mask"])
    assert got.shape == (B, Q, W)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)

    def jinfer(p, ref, tgt, ids, mask):
        jfeats, _ = jm.apply({"params": p}, tgt, method=jm.extract_target_features)
        ref_embeds = jm.apply({"params": p}, ref, method=jm.encode_image)
        return jfeats, jm.apply({"params": p}, ref_embeds, jfeats, ids, mask, method=jm.inference)

    want_feats, want_scores = jax.jit(jinfer)(params, jb["reference"], jb["target"],
                                              jb["input_ids"], jb["text_mask"])
    np.testing.assert_allclose(feats.numpy(), np.asarray(want_feats), atol=ATOL)
    np.testing.assert_allclose(scores.numpy(), np.asarray(want_scores), atol=ATOL)


def _tiny(name, seed=0, dropout=0.1):
    from sprc_tpu_torch.models.qformer import QFormerConfig
    from sprc_tpu_torch.models.vit import ViTConfig

    model = build_model(name, "pretrain", image_size=VIT["image_size"], num_query_token=Q,
                        max_txt_len=TXT, vocab_size=QF["vocab_size"], embed_dim=64,
                        vit_dtype=torch.float32,
                        vit_config_override=ViTConfig(**VIT, dtype=torch.float32),
                        qformer_config_override=QFormerConfig(**QF, dropout_rate=dropout),
                        device="cpu")
    init_weights(model, seed)
    return model.train()


def test_forward_cached_equals_live_for_every_variant():
    """Every variant's training forward from the tower's rows (the feature
    cache's boundary) equals its live forward, dropout 0.1 masks included:
    the losses and gradients of the eight loss variants through the
    trainer, the tensors ``blip2_cir_slt`` and ``blip2_cir_prompt`` return."""
    tb = torch_batch(variant_batch())
    names = [n for n in CIR_MODELS if n != "blip2_cir_align_prompt"]
    assert sorted(names) == sorted(TRAINABLE + ("blip2_cir_slt", "blip2_cir_prompt"))
    for name in names:
        model = _tiny(name)
        with torch.no_grad():
            ref_rows = model.encode_tower(tb["reference"])
            pair = model.encode_tower(torch.cat([tb["reference"], tb["target"]]))
        # the live forward's own rows: CirPrompt encodes the reference alone
        rows = (ref_rows, pair[B:]) if name == "blip2_cir_prompt" else (pair[:B], pair[B:])
        if name in TRAINABLE:
            live = Trainer(model, TrainConfig(), seed=5).loss_and_grads(tb)
            cached = Trainer(model, TrainConfig(), seed=5, from_embeds=True).loss_and_grads(
                dict(tb, reference_embeds=rows[0], target_embeds=rows[1]))
            assert torch.equal(live[0], cached[0]), name
            assert all(torch.equal(live[1][k], cached[1][k]) for k in live[1]), name
            assert all(torch.equal(a, b) for a, b in zip(live[2], cached[2])), name
            continue
        out = [model(*tb.values(), generator=torch.Generator().manual_seed(5)),
               model.forward_cached(*rows, tb["input_ids"], tb["text_mask"],
                                    generator=torch.Generator().manual_seed(5)),
               model(*tb.values(), generator=torch.Generator().manual_seed(6))]
        assert torch.equal(out[0], out[1]), name
        assert not torch.equal(out[0], out[2]), name  # dropout is on


def test_sampling_branch_is_seeded_and_off_the_diagonal():
    """With a ``sample_generator`` the hard negatives are drawn (the
    reference's ``torch.multinomial``): reproducible from a seed, never the
    sample itself, and not the argmax picks everywhere; ``blip2_cir_cls``
    draws 4 distinct negative captions and permutes the 5 candidates."""
    rng = np.random.RandomState(0)
    bs = 16
    sim = torch.from_numpy(rng.standard_normal((bs, bs)).astype(np.float32))
    mixin = _HardNegMixin()
    argmax = mixin._neg_indices(sim)
    draws = [mixin._neg_indices(sim, torch.Generator().manual_seed(s)) for s in (1, 1, 2)]
    for a, b in zip(draws[0], draws[1]):
        assert torch.equal(a, b)
    assert any(not torch.equal(a, b) for a, b in zip(draws[0], draws[2]))
    for picks in draws + [argmax]:
        for side in picks:
            assert not (side == torch.arange(bs)).any()
    assert any(not torch.equal(a, b) for a, b in zip(draws[0], argmax))
    cls = CirCls.__new__(CirCls)
    sim_t2t = sim + torch.eye(bs) * -10000.0
    cand, label = CirCls._candidates(cls, sim_t2t, None)
    assert (label == 4).all() and torch.equal(cand[:, 4], torch.arange(bs))
    torch.testing.assert_close(cand[:, :4], torch.sort(-sim_t2t, dim=1, stable=True).indices[:, :4])
    runs = [CirCls._candidates(cls, sim_t2t, torch.Generator().manual_seed(s)) for s in (3, 3)]
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    cand, label = runs[0]
    for row, lab, i in zip(cand, label, range(bs)):
        assert len(set(row.tolist())) == 5 and row[lab] == i and (row == i).sum() == 1


def test_adamw_touches_the_jax_trees_leaves_and_not_the_twin():
    """The port's rule: AdamW updates every tensor with ``requires_grad``
    (the model's tree without the frozen tower and the class's
    ``FROZEN_PREFIXES``); one the losses do not reach gets a zero gradient
    and decays. optax updates every leaf of the JAX tree outside the same
    prefixes, so on a tree that holds the same modules one step from the
    same gradients gives the same tensors. ``blip2_cir_rerank``'s init tree
    lacks ``vision_proj`` / ``text_proj`` (its forward never reads them), so
    from ``init_params`` the JAX CLI leaves them where they are; here the
    tree holds them (as a strict load needs) and both packages decay them."""
    from sprc_tpu.train.loop import TrainConfig as JTrainConfig
    from sprc_tpu.train.loop import make_optimizer

    jm = jax_variant("blip2_cir_rerank")
    img = jnp.zeros((B, VIT["image_size"], VIT["image_size"], 3), jnp.float32)
    ids = jnp.ones((B, TXT), jnp.int32)
    bare = jax.jit(lambda k: jm.init(k, img, img, ids, ids))(jax.random.PRNGKey(0))["params"]
    assert "vision_proj" not in bare and "text_proj" not in bare and "itm_head" in bare
    params = variant_params(jm)
    lr = 0.1
    model = port_variant("blip2_cir_rerank", params)
    trainer = Trainer(model, TrainConfig(learning_rate=lr, total_steps=100))
    rng = np.random.RandomState(1)
    grads = jax.tree_util.tree_map(
        lambda a: (rng.standard_normal(a.shape) * 1e-2).astype(np.float32), params)
    grads["vision_proj"] = jax.tree_util.tree_map(np.zeros_like, grads["vision_proj"])
    jcfg = JTrainConfig(learning_rate=lr, total_steps=100,
                        frozen_prefixes=("visual_encoder",) + type(jm).FROZEN_PREFIXES)
    tx = make_optimizer(jcfg, params)
    updates, _ = jax.jit(tx.update)(grads, tx.init(params), params)

    want = state_dict_from_jax(jax.tree_util.tree_map(
        np.asarray, optax.apply_updates(params, updates)), vit="eva_clip_g")
    port_grads = state_dict_from_jax(grads, vit="eva_clip_g")
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    trainer.apply_gradients([port_grads[n] for n in trainer.names])
    got = model.state_dict()
    assert not any(n.startswith(type(model).FROZEN_PREFIXES) for n in trainer.names)
    for key in want:
        if key.endswith("position_ids"):
            continue
        torch.testing.assert_close(got[key], want[key], rtol=1e-6, atol=1e-7, msg=key)
        frozen = key.startswith(("visual_encoder",) + type(model).FROZEN_PREFIXES)
        assert torch.equal(got[key], before[key]) == frozen, key
    decay = 1.0 - trainer.schedule(0) * 0.05
    torch.testing.assert_close(got["vision_proj.weight"], before["vision_proj.weight"] * decay)


@pytest.mark.parametrize("model_type", ["pretrain_vitL", "pretrain"])
def test_model_configs_pinned_to_the_yamls(model_type):
    """MODEL_CONFIGS holds all eleven CIR names (and, at ``pretrain``, the
    three BLIP-2 stage-1 names, held by test_torch_stage1.py), each row
    equal to what sprc_tpu.loader builds from its YAML, the class the JAX
    registry's."""
    from sprc_tpu.loader import build_model as jbuild

    from sprc_tpu_torch.loader import STAGE1_MODELS
    from test_torch_model import assert_config_equals_jax

    stage1 = STAGE1_MODELS if model_type == "pretrain" else ()
    assert sorted(n for n, t in MODEL_CONFIGS if t == model_type) == sorted(CIR_MODELS + stage1)
    assert len(CIR_MODELS) == 11
    for name in CIR_MODELS:
        assert_config_equals_jax(name, model_type)
        assert type(jbuild(name, model_type)).__name__ == type(
            build_model(name, model_type, device="meta")).__name__
