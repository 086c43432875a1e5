"""The training forward of the port (sprc_tpu_torch) against sprc_tpu.

A tiny EVA-style blip2_cir_align_prompt (ViT width 128 / 2 heads / depth 2
/ MLP 256 on 28 px images; Q-Former hidden 128 / 2 heads / 2 layers /
intermediate 256, Q=4, text length 8, vocab 60, embed 64) is initialised in
JAX (biases and LayerNorms moved off their init by seeded noise), carried
across with interop/jax_params.py and loaded with strict=True. Everything is
fp32 on the CPU: the port runs the Q-Former's training branch and its
kernels' plain versions, the JAX package its unfused modules.

Tolerances: losses within 1e-5 relative and every trainable gradient within
1e-4 of its tensor's largest |gradient| (fp32 sums in another order through
2 ViT blocks, three Q-Former passes of 2 layers and their backward; worst
reading 3.5e-5), that largest taken as at least 1e-4 of the step's largest
|gradient| (the attention key biases' gradient is 0 in exact arithmetic); the
prompt pass's embeddings and feature within 1e-5 absolute; K1's gradient
within 1e-6 absolute (one fp32 product a score). Dropout is 0 where the two
packages are compared (their masks come from different generators); with
dropout 0.1, cached and live steps from one seed are held equal.
"""

import contextlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sprc_tpu.models.cir_base import CirConfig as JCirConfig  # noqa: E402
from sprc_tpu.models.qformer import QFormerConfig as JQFormerConfig  # noqa: E402
from sprc_tpu.models.qformer import QFormerEmbeddings as JQFormerEmbeddings  # noqa: E402
from sprc_tpu.models.vit import ViTConfig as JViTConfig  # noqa: E402
from sprc_tpu.ops.sim_kernels import _xla_token_max_sim  # noqa: E402
from sprc_tpu.registry import registry as jregistry  # noqa: E402

from sprc_tpu_torch import kernel_checks  # noqa: E402
from sprc_tpu_torch.interop.jax_params import state_dict_from_jax  # noqa: E402
from sprc_tpu_torch.loader import build_model  # noqa: E402
from sprc_tpu_torch.models.qformer import QFormerConfig  # noqa: E402
from sprc_tpu_torch.models.vit import ViTConfig  # noqa: E402
from sprc_tpu_torch.ops import sim_kernels  # noqa: E402
from sprc_tpu_torch.train.loop import TrainConfig, Trainer  # noqa: E402
from test_torch_threads import one_torch_thread  # noqa: E402,F401  (one thread a module)

IMG, Q, TXT, VOCAB, EMBED, B, W = 28, 4, 8, 60, 64, 4, 128
LOSS_RTOL, GRAD_TOL = 1e-5, 1e-4
QF = dict(vocab_size=VOCAB, hidden_size=W, num_layers=2, num_heads=2, intermediate_size=256,
          encoder_width=W, query_length=Q)
VIT = dict(image_size=IMG, patch_size=14, width=W, depth=2, num_heads=2, mlp_hidden=256,
           qkv_fused_no_kbias=True)


def jax_model(dropout=0.0):
    cfg = JCirConfig(vit_model="eva_clip_g", image_size=IMG, num_query_token=Q, max_txt_len=TXT,
                     vocab_size=VOCAB, embed_dim=EMBED, vit_dtype=jnp.float32,
                     vit_config_override=JViTConfig(**VIT, dtype=jnp.float32),
                     qformer_config_override=JQFormerConfig(
                         **QF, dropout_rate=dropout, attention_dropout_rate=dropout))
    return jregistry.get_model_class("blip2_cir_align_prompt")(cfg)


def jax_params(model, seed=3):
    """The training init (plus the itm_head, which only compute_itm makes),
    every leaf moved by seeded noise so no bias or LayerNorm sits at its
    init; numpy leaves."""
    img = jnp.zeros((1, IMG, IMG, 3), jnp.float32)
    ids, ones = jnp.zeros((1, TXT), jnp.int32), jnp.ones((1, TXT), jnp.int32)
    params = dict(jax.jit(lambda k: model.init(k, img, img, ids, ones))(
        jax.random.PRNGKey(seed))["params"])
    S = (IMG // 14) ** 2 + 1
    itm = jax.jit(lambda k: model.init(k, jnp.zeros((1, S, W)), ids, ones,
                                       method=model.compute_itm))(jax.random.PRNGKey(1))
    params["itm_head"] = itm["params"]["itm_head"]
    rng = np.random.RandomState(seed)

    def noisy(a):
        a = np.asarray(a)
        return a if a.ndim == 0 else a + (rng.standard_normal(a.shape) * 0.02).astype(a.dtype)

    return jax.tree_util.tree_map(noisy, params)


def port_model(params, dropout=0.0):
    """The port's model on the CPU with the JAX weights, in training mode."""
    model = build_model("blip2_cir_align_prompt", "pretrain", image_size=IMG, num_query_token=Q,
                        max_txt_len=TXT, vocab_size=VOCAB, embed_dim=EMBED,
                        vit_dtype=torch.float32,
                        vit_config_override=ViTConfig(**VIT, dtype=torch.float32),
                        qformer_config_override=QFormerConfig(**QF, dropout_rate=dropout),
                        device="cpu")
    model.load_state_dict(state_dict_from_jax(params, vit="eva_clip_g"), strict=True)
    return model.train()


def make_batch(seed=9, b=B):
    rng = np.random.RandomState(seed)
    mask = np.ones((b, TXT), np.int32)
    mask[0, -3:] = 0
    mask[-1, -1:] = 0
    return {"reference": rng.rand(b, IMG, IMG, 3).astype(np.float32),
            "target": rng.rand(b, IMG, IMG, 3).astype(np.float32),
            "input_ids": rng.randint(1, VOCAB, (b, TXT)).astype(np.int32), "text_mask": mask}


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def shared():
    jm = jax_model()
    return jm, jax_params(jm), make_batch()


@pytest.fixture(scope="module")
def jax_step(shared):
    """One step of the JAX model under jax.grad: the losses and the gradient
    tree (the ViT's zero: its features pass stop_gradient)."""
    jm, params, batch = shared
    w = TrainConfig().weights()

    def loss_fn(p):
        losses = jm.apply({"params": p}, batch["reference"], batch["target"],
                          batch["input_ids"], batch["text_mask"], deterministic=False,
                          rngs={"dropout": jax.random.PRNGKey(0)})
        total = losses["loss_itc"] + w["loss_rtc"] * losses["loss_rtc"] + (
            w["loss_align"] * losses["loss_align"])
        return total, losses

    (total, losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    grads = jax.tree_util.tree_map(np.asarray, grads)
    return float(total), {k: float(v) for k, v in losses.items()}, grads


def test_step_losses_and_gradients_equal_jax(shared, jax_step):
    _, params, batch = shared
    want_total, want, jgrads = jax_step
    trainer = Trainer(port_model(params), TrainConfig())
    total, losses, grads = trainer.loss_and_grads(torch_batch(batch))
    for key, value in want.items():
        assert abs(losses[key].item() - value) <= LOSS_RTOL * abs(value), (key, losses[key], value)
    assert abs(total.item() - want_total) <= LOSS_RTOL * abs(want_total)
    want_grads = state_dict_from_jax(jgrads, vit="eva_clip_g")
    assert set(trainer.names) == {k for k in want_grads if not k.startswith("visual_encoder")
                                  and k != "Qformer.bert.embeddings.position_ids"}
    # the key biases' gradient is 0 in exact arithmetic (it adds one constant
    # to a row's scores): both sides leave ~1e-10 of rounding, and grad_gap
    # floors a tensor's scale at 1e-4 of the step's largest gradient
    gap = kernel_checks.grad_gap(grads, [want_grads[n] for n in trainer.names], trainer.names)
    assert gap["gap"] <= GRAD_TOL, gap
    assert want_grads["temp"].abs().item() > 0 and want_grads["prompt_tokens"].abs().max() > 0


def test_vit_gets_no_gradient(shared):
    _, params, batch = shared
    model = port_model(params)
    vit = list(model.visual_encoder.parameters())
    assert vit and not any(p.requires_grad for p in vit)
    losses = model(*torch_batch(batch).values())
    sum(losses.values()).backward()
    assert all(p.grad is None for p in vit)
    assert model.ln_vision.weight.grad is not None and model.query_tokens.grad is not None
    assert not model.visual_encoder.training and model.qformer.training
    trainer = Trainer(model, TrainConfig())
    assert not any(n.startswith("visual_encoder") for n in trainer.names)


def test_forward_cached_equals_live_with_dropout(shared):
    """The step from the tower's rows (the feature cache's boundary) takes
    the same losses and gradients as the live step, dropout masks included."""
    _, params, batch = shared
    model = port_model(params, dropout=0.1)
    tb = torch_batch(batch)
    with torch.no_grad():
        tower = model.encode_tower(torch.cat([tb["reference"], tb["target"]]))
    runs = {}
    for mode in ("live", "cached"):
        trainer = Trainer(model, TrainConfig(), seed=5, from_embeds=mode == "cached")
        step = dict(tb, reference_embeds=tower[:B], target_embeds=tower[B:])
        runs[mode] = trainer.loss_and_grads(step)
    (t_live, l_live, g_live), (t_cached, l_cached, g_cached) = runs["live"], runs["cached"]
    assert torch.equal(t_live, t_cached)
    for key in l_live:
        assert torch.equal(l_live[key], l_cached[key]), key
    for a, b in zip(g_live, g_cached):
        assert torch.equal(a, b)
    other = Trainer(model, TrainConfig(), seed=6).loss_and_grads(tb)[0]
    assert not torch.equal(other, t_live)  # dropout is on: another seed, other losses


def test_no_img_embeddings_and_prompt_feature_equal_jax(shared):
    """The prompt pass's spliced embeddings (CLS, the queries, the rest of
    the text; positions over all of it) and its feature, in eval mode."""
    jm, params, batch = shared
    model = port_model(params).eval()
    rng = np.random.RandomState(4)
    prompt = (rng.standard_normal((B, Q, W)) * 0.5).astype(np.float32)
    ids = batch["input_ids"]
    qcfg = JQFormerConfig(**QF, dropout_rate=0.0)
    want = JQFormerEmbeddings(qcfg).apply(
        {"params": params["qformer"]["embeddings"]}, jnp.asarray(ids), jnp.asarray(prompt),
        no_img=True)
    with torch.no_grad():
        got = model.qformer.embeddings(torch.from_numpy(ids), torch.from_numpy(prompt),
                                       no_img=True)
    assert got.shape == (B, TXT + Q, W)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    feat = jax.jit(lambda p, i, m: jm.apply({"params": p}, i, m,
                                            method=jm._prompt_text_feature))(
        params, ids, batch["text_mask"])
    with torch.no_grad():
        got_feat = model._prompt_text_feature(torch.from_numpy(ids),
                                              torch.from_numpy(batch["text_mask"]))
    np.testing.assert_allclose(got_feat.numpy(), np.asarray(feat), atol=1e-5)


@pytest.mark.parametrize("ties", [False, True])
def test_token_max_sim_gradient_equals_jax_vjp(ties, monkeypatch):
    """``TokenMaxSim`` against the VJP of ``_xla_token_max_sim``; with exact
    ties (item n's tokens 0 and 1 equal query n's feature) the gradient
    splits evenly over them in both. Its forward is K1's wrapper; the
    model's scoring goes through it, and it records a graph exactly when a
    gradient is wanted."""
    rng = np.random.RandomState(8)
    Bq, N, Qt, E = 6, 6, 4, 16
    f = rng.standard_normal((Bq, E)).astype(np.float32)
    t = rng.standard_normal((N, Qt, E)).astype(np.float32)
    if ties:
        t[:, 0] = t[:, 1] = f[np.arange(N) % Bq] * 3.0
    g = rng.standard_normal((Bq, N)).astype(np.float32)
    out, vjp = jax.vjp(_xla_token_max_sim, jnp.asarray(f), jnp.asarray(t))
    want_f, want_t = vjp(jnp.asarray(g))

    calls = []
    wrapper = sim_kernels.TokenMaxSim.kernel
    monkeypatch.setattr(sim_kernels.TokenMaxSim, "kernel",
                        lambda *a: calls.append(1) or wrapper(*a))
    from sprc_tpu_torch.models.cir_base import Blip2CirBase

    ft = torch.from_numpy(f).requires_grad_()
    tt = torch.from_numpy(t).requires_grad_()
    got = Blip2CirBase.token_max_sim(ft, tt)
    got.backward(torch.from_numpy(g))
    assert len(calls) == 1  # through TokenMaxSim's forward
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), atol=1e-5)
    np.testing.assert_allclose(ft.grad.numpy(), np.asarray(want_f), atol=1e-6)
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(want_t), atol=1e-6)
    if ties:
        assert np.array_equal(tt.grad[:, 0].numpy(), tt.grad[:, 1].numpy())
        assert np.abs(tt.grad[:, 0].numpy()).sum() > 0
    with torch.no_grad():  # no gradient wanted: the wrapper once, nothing recorded
        again = Blip2CirBase.token_max_sim(ft, tt)
    assert len(calls) == 2 and again.grad_fn is None
    assert torch.equal(again, got.detach())


def test_recompute_keeps_the_step_bit_for_bit(shared):
    """Inside ``layers.recomputing`` the training Q-Former's attention,
    GELUs and LayerNorms keep only their inputs and run again in the
    backward: the losses and every gradient of the flagship's step equal
    those of the step that keeps every intermediate, bit for bit, dropout
    0.1 included (the variants' ITM passes run so)."""
    from sprc_tpu_torch.ops.layers import recomputing

    _, params, batch = shared
    model = port_model(params, dropout=0.1)
    runs = []
    for ctx in (recomputing, contextlib.nullcontext):
        with ctx():
            runs.append(Trainer(model, TrainConfig(), seed=5).loss_and_grads(torch_batch(batch)))
    (t0, l0, g0), (t1, l1, g1) = runs
    assert torch.equal(t0, t1) and all(torch.equal(l0[k], l1[k]) for k in l0)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
