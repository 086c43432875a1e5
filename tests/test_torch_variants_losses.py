"""The training forwards of the port's CIR variant zoo against sprc_tpu.

The tiny EVA-style model of test_torch_train_losses.py (ViT width 128 /
depth 2 on 28 px images; Q-Former hidden 128 / 2 layers, Q=4, text length 8,
vocab 60, embed 64) of each of the eight variants whose training forward
returns losses is initialised in JAX through that forward (batch 8, so that
``blip2_cir_cls`` draws 4 true negative captions), plus the modules only the
eval side reads (``vision_proj`` / ``text_proj`` of ``blip2_cir_rerank``,
``itm_head`` where the forward does not run it), every leaf moved by seeded
noise; carried across by interop/jax_params.py and loaded with strict=True.
fp32, dropout 0, on the CPU: the port runs the Q-Former's training branch
where a gradient is wanted and K3's plain version in its no-grad passes,
the JAX package its unfused modules. The hard negatives are the argmax /
stable-argsort picks of both packages (the JAX train step passes no
``sample`` rng), compared directly.

Tolerances: test_torch_train_losses.py's: every loss within 1e-5 relative,
every trainable gradient within 1e-4 of its tensor's largest |gradient|
(kernel_checks.grad_gap).
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

from sprc_tpu_torch import kernel_checks  # noqa: E402
from sprc_tpu_torch.interop.jax_params import state_dict_from_jax  # noqa: E402
from sprc_tpu_torch.loader import build_model  # noqa: E402
from sprc_tpu_torch.train.loop import TrainConfig, Trainer  # noqa: E402

from test_torch_train_losses import (IMG, LOSS_RTOL, GRAD_TOL, QF, Q, TXT, VIT,  # noqa: E402
                                     VOCAB, EMBED, W, port_model as _flagship_port_model,
                                     make_batch, torch_batch)
from test_torch_threads import one_torch_thread  # noqa: E402,F401  (one thread a module)

B = 8
TRAINABLE = ("blip2_cir_cat", "blip2_cir_rel", "blip2_cir_z_learn_pos_align", "blip2_cir_neg",
             "blip2_cir_neg_rel", "blip2_cir_full", "blip2_cir_rerank", "blip2_cir_cls")
del _flagship_port_model


def jax_variant(name, dropout=0.0):
    cfg = JCirConfig(vit_model="eva_clip_g", image_size=IMG, num_query_token=Q, max_txt_len=TXT,
                     vocab_size=VOCAB, embed_dim=EMBED, vit_dtype=jnp.float32,
                     vit_config_override=JViTConfig(**VIT, dtype=jnp.float32),
                     qformer_config_override=JQFormerConfig(
                         **QF, dropout_rate=dropout, attention_dropout_rate=dropout))
    return jregistry.get_model_class(name)(cfg)


def variant_params(model, seed=3, noise=True):
    """The training forward's init at batch B, plus the eval side's modules
    the forward does not create, every leaf moved by seeded noise; numpy."""
    img = jnp.zeros((B, IMG, IMG, 3), jnp.float32)
    ids = jnp.tile(jnp.arange(1, TXT + 1, dtype=jnp.int32)[None], (B, 1))
    ones = jnp.ones((B, TXT), jnp.int32)
    params = dict(jax.jit(lambda k: model.init(k, img, img, ids, ones))(
        jax.random.PRNGKey(seed))["params"])
    emb = jnp.zeros((1, (IMG // 14) ** 2 + 1, W))

    def eval_side(m, emb, ids, ones):
        return m.fusion_feature(emb, ids, ones), m.target_features(emb), m.compute_itm(
            emb, ids, ones)

    extra = jax.jit(lambda k: model.init(k, emb, ids[:1], ones[:1], method=eval_side))(
        jax.random.PRNGKey(seed + 1))["params"]
    for name in ("vision_proj", "text_proj", "itm_head"):
        params.setdefault(name, extra[name])
    rng = np.random.RandomState(seed)

    def noisy(a):
        a = np.asarray(a)
        if a.ndim == 0 or not noise:
            return a
        return a + (rng.standard_normal(a.shape) * 0.02).astype(a.dtype)

    return jax.tree_util.tree_map(noisy, params)


def port_variant(name, params, dropout=0.0):
    """The port's model on the CPU with the JAX weights (strict), in training mode."""
    from sprc_tpu_torch.models.qformer import QFormerConfig
    from sprc_tpu_torch.models.vit import ViTConfig

    model = build_model(name, "pretrain", image_size=IMG, num_query_token=Q, max_txt_len=TXT,
                        vocab_size=VOCAB, embed_dim=EMBED, vit_dtype=torch.float32,
                        vit_config_override=ViTConfig(**VIT, dtype=torch.float32),
                        qformer_config_override=QFormerConfig(**QF, dropout_rate=dropout),
                        device="cpu")
    model.load_state_dict(state_dict_from_jax(params, vit="eva_clip_g"), strict=True)
    return model.train()


def jax_step(jm, params, batch, weights):
    """One JAX step under jax.grad: the weighted total, the losses, the
    gradient tree."""
    batch = {k: jnp.asarray(v) for k, v in batch.items()}  # traced indices gather from them

    def loss_fn(p):
        losses = jm.apply({"params": p}, batch["reference"], batch["target"],
                          batch["input_ids"], batch["text_mask"], deterministic=False,
                          rngs={"dropout": jax.random.PRNGKey(0)})
        total = sum(weights.get(k, 1.0) * v for k, v in losses.items())
        return total, losses

    (total, losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    return (float(total), {k: float(v) for k, v in losses.items()},
            jax.tree_util.tree_map(np.asarray, grads))


def variant_batch(seed=9):
    """make_batch at B, with one caption repeated (an exact tie in
    ``blip2_cir_cls``'s text similarities, which the stable sort breaks to
    the lower index in both packages)."""
    batch = make_batch(seed, b=B)
    batch["input_ids"][5] = batch["input_ids"][2]
    batch["text_mask"][5] = batch["text_mask"][2]
    return batch


@pytest.mark.parametrize("name", TRAINABLE)
def test_variant_losses_and_gradients_equal_jax(name):
    jm = jax_variant(name)
    params = variant_params(jm)
    batch = variant_batch()
    weights = TrainConfig().weights()
    want_total, want, jgrads = jax_step(jm, params, batch, weights)
    model = port_variant(name, params)
    assert sorted(want) == sorted(type(model).LOSSES)  # jit returns the dict's keys sorted
    trainer = Trainer(model, TrainConfig())
    total, losses, grads = trainer.loss_and_grads(torch_batch(batch))
    assert tuple(losses) == type(model).LOSSES
    for key, value in want.items():
        assert abs(losses[key].item() - value) <= LOSS_RTOL * abs(value), (key, losses[key], value)
    assert abs(total.item() - want_total) <= LOSS_RTOL * abs(want_total)
    want_grads = state_dict_from_jax(jgrads, vit="eva_clip_g")
    frozen = ("visual_encoder",) + getattr(type(model), "FROZEN_PREFIXES", ())
    assert set(trainer.names) == {k for k in want_grads if not k.startswith(frozen)
                                  and not k.endswith("position_ids")}
    gap = kernel_checks.grad_gap(grads, [want_grads[n] for n in trainer.names], trainer.names)
    assert gap["gap"] <= GRAD_TOL, gap
    reached = {n for n, g in zip(trainer.names, grads) if g.abs().max() > 0}
    assert "query_tokens" in reached or name == "blip2_cir_rerank"
    if "loss_itm" in want:
        assert "itm_head.weight" in reached
    if name == "blip2_cir_neg_rel":
        assert "rel_tokens" in reached
    if name == "blip2_cir_cls":
        assert "temp2" in reached
