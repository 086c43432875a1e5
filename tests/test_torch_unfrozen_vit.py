"""Training the tower (``freeze_vit=False``) in the port against sprc_tpu.

(a) The autograd Functions of kernels K2, K6, K7 and K8
(``FusedViTBlock``, ``FusedAttnBlock``, ``FusedMlpBlock``,
``FlashAttention``): forward and VJP (the input and every parameter)
against the JAX custom VJPs (``pallas_block.fused_vit_block`` /
``fused_attn_block``, ``pallas_mlp.fused_mlp_block``,
``pallas_attention.flash_attention``), whose forward runs the Pallas kernel
in interpret mode here, at test_torch_half_blocks.py's small shapes. On the
CPU the Function's forward is the wrapper's plain version; its backward is
autograd over that version recomputed, the JAX backward's ``jax.vjp`` over
the XLA composition. Each wrapper, and each CUDA primitive of its chain,
refuses a tensor that autograd records through.

(b) to (e) run the tiny ``blip2`` of test_torch_generic_train.py (ViT width
128 / depth 2 on 28 px, Q-Former hidden 128 / 2 layers, Q = 4, the full
30,523-row vocabulary for the LM's ``bos_token_id``) as the ``coco`` row,
whose tower trains; one JAX init, every leaf moved by seeded noise, carried
across with interop/jax_params.py. fp32, the CPU. (b) and (c) share one
``run_generic`` of each package (a module fixture): (b) holds the first
step's losses and gradients (JAX's ``value_and_grad`` inside its generic
train step, kept by a recording optimizer; the port's kept by its trainer),
(c) the parameters after the two updates.

Tolerances: forwards 3e-5 absolute (test_torch_half_blocks.py's); a
gradient within 1e-4 of its tensor's largest |gradient| (fp32 sums in
another order), that largest floored at 1e-4 of the step's largest; the
three ITC-only tensors of (b) at test_torch_stage1.py's ``ITC_GRAD_TOL``
(where fp32 itself is that far off); losses 1e-5 relative; parameters after
``run_generic``'s two updates 1e-5 absolute (the Adam step is about lr, so
the tower is also checked to have moved by more than that); remat bit for
bit; (d) layer decay's two updates 1e-6 absolute. (f) is the loader's rule
for a trainable tower.
"""

import json
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
yaml = pytest.importorskip("yaml")
import jax.numpy as jnp  # noqa: E402

from sprc_tpu.ops.pallas_attention import flash_attention as jax_flash_attention  # noqa: E402
from sprc_tpu.ops.pallas_block import fused_attn_block as jax_fused_attn_block  # noqa: E402
from sprc_tpu.ops.pallas_block import fused_vit_block as jax_fused_vit_block  # noqa: E402
from sprc_tpu.ops.pallas_mlp import fused_mlp_block as jax_fused_mlp_block  # noqa: E402

from sprc_tpu_torch import loader  # noqa: E402
from sprc_tpu_torch.interop.jax_params import state_dict_from_jax  # noqa: E402
from sprc_tpu_torch.ops import fused_block, primitives  # noqa: E402
from sprc_tpu_torch.ops.attention import FlashAttention, flash_attention  # noqa: E402
from sprc_tpu_torch.train import generic  # noqa: E402
from sprc_tpu_torch.train.loop import TrainConfig, Trainer  # noqa: E402
from test_torch_generic_train import TINY, _rows  # noqa: E402
from test_torch_stage1 import ITC_GRAD_TOL, ITC_ONLY, jax_params, make_batch  # noqa: E402
from test_torch_train_losses import IMG, TXT  # noqa: E402
from test_torch_threads import one_torch_thread  # noqa: E402,F401  (one thread a module)

FWD_ATOL, GRAD_TOL, LOSS_RTOL, PARAM_ATOL = 3e-5, 1e-4, 1e-5, 1e-5


def _np(rng, *shape, scale=1.0, mean=0.0):
    return (mean + scale * rng.standard_normal(shape)).astype(np.float32)


def _torch(arrays):
    """JAX-layout arrays -> leaf tensors that require grad: [in, out]
    kernels become [out, in] weights."""
    return [torch.from_numpy(np.ascontiguousarray(a.T if a.ndim == 2 else a)).requires_grad_()
            for a in arrays]


def _block_case(name, rng):
    """(JAX function of the tensors, numpy tensors in JAX layout, port
    Function, wrapper, its kwargs, the CUDA primitives its chain runs)."""
    if name == "K8 flash_attention":
        q, k, v = (_np(rng, 2, 37, 2, 88) for _ in range(3))
        scale = 88 ** -0.5
        return (lambda *a: jax_flash_attention(*a, scale), [q, k, v], FlashAttention,
                flash_attention, {"scale": scale}, ("flash_attention",))
    B, S, W, H, M = 4, 37, 128, 2, 256
    x = _np(rng, B, S, W)
    ln = lambda: [_np(rng, W, scale=0.1, mean=1.0), _np(rng, W, scale=0.1)]  # noqa: E731
    attn = ln() + [_np(rng, W, 3 * W, scale=0.05), _np(rng, 3 * W, scale=0.05),
                   _np(rng, W, W, scale=0.05), _np(rng, W, scale=0.05)]
    mlp = ln() + [_np(rng, W, M, scale=0.05), _np(rng, M, scale=0.05),
                  _np(rng, M, W, scale=0.05), _np(rng, W, scale=0.05)]
    scale = (W // H) ** -0.5
    if name == "K2 fused_vit_block":
        return (lambda *a: jax_fused_vit_block(*a, H, 1e-6, scale, False, 4), [x] + attn + mlp,
                fused_block.FusedViTBlock, fused_block.fused_vit_block,
                dict(heads=H, eps=1e-6, scale=scale, quick=False), ("gemm", "attention", "layer_norm"))
    if name == "K6 fused_attn_block":  # bproj 0 in JAX, None in the port (test below)
        return (lambda *a: jax_fused_attn_block(*a, H, 1e-5, scale, 4),
                [x] + attn[:-1] + [np.zeros_like(attn[-1])],
                fused_block.FusedAttnBlock, fused_block.fused_attn_block,
                dict(heads=H, eps=1e-5, scale=scale), ("gemm", "attention", "layer_norm"))
    return (lambda *a: jax_fused_mlp_block(*a, 1e-6, True), [x] + mlp, fused_block.FusedMlpBlock,
            fused_block.fused_mlp_block, dict(eps=1e-6, quick=True), ("gemm", "layer_norm"))


def _refuses(op, x):
    """A CUDA primitive on a CPU tensor that requires grad: refused for the
    grad before anything else is checked."""
    args = {"gemm": (x, x.detach()), "layer_norm": (x, x[0, 0].detach(), x[0, 0].detach(), 1e-6),
            "attention": (x, x, x, 2, 0.1), "flash_attention": (x, x, x, 0.1)}[op]
    with pytest.raises(RuntimeError, match="inference-only"):
        getattr(primitives.CUDA, op)(*args)


@pytest.mark.parametrize("name", ["K2 fused_vit_block", "K6 fused_attn_block",
                                  "K7 fused_mlp_block", "K8 flash_attention"])
def test_function_vjp_equals_jax_custom_vjp(name):
    rng = np.random.default_rng(int(name[1]))
    jfn, arrays, function, wrapper, kw, chain = _block_case(name, rng)
    want, vjp = jax.vjp(jfn, *map(jnp.asarray, arrays))
    cot = _np(rng, *want.shape)
    want_grads = [np.asarray(g) for g in vjp(jnp.asarray(cot))]
    tensors = _torch(arrays)
    if name == "K6 fused_attn_block":  # a None bias gets no gradient
        tensors[-1] = want_grads[-1] = None
    got = function.call(*tensors, **kw)
    assert got.grad_fn is not None
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=FWD_ATOL)
    got.backward(torch.from_numpy(cot))
    scales = [np.abs(w).max() for w in want_grads if w is not None]
    floor = 1e-4 * max(scales)
    for i, (t, w) in enumerate(zip(tensors, want_grads)):
        if t is None:
            continue
        g = t.grad.numpy()
        g = g.T if g.ndim == 2 else g
        assert np.abs(g - w).max() <= GRAD_TOL * max(np.abs(w).max(), floor), (name, i)

    with pytest.raises(RuntimeError, match="inference-only"):
        wrapper(*tensors, **kw)
    for op in chain:
        _refuses(op, tensors[0])


# --------------------------------------------------------- the tiny model


def _jax_model(model_type="coco"):
    from sprc_tpu.loader import build_model

    model_cfg = dict(TINY)
    return build_model(model_cfg.pop("arch"), model_type, **model_cfg)


def _port_model(params, **overrides):
    model_cfg = {k: v for k, v in TINY.items() if k != "arch"}
    model = loader.build_model("blip2", "coco", device="cpu", **{**model_cfg, **overrides})
    model.load_state_dict(state_dict_from_jax(params, vit="eva_clip_g"), strict=True)
    return model


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The JAX coco model (its tower trains), the shared weights (a JAX tree
    and the port's checkpoint of it), 8 PNG pairs as coco_retrieval
    annotations, a synthetic vocab."""
    from PIL import Image

    from sprc_tpu_torch.utils.artifacts import write_synthetic_bert_vocab

    jm = _jax_model()
    assert not jm.cfg.freeze_vit
    params = jax_params(jm)
    root = tmp_path_factory.mktemp("coco")
    rng = np.random.RandomState(9)
    words = ["a", "dog", "on", "the", "grass", "red", "car", "two", "cats", "sky"]
    ann = []
    for i in range(8):
        name = f"c{i:02d}.png"
        Image.fromarray((rng.rand(30 + 4 * i, 34, 3) * 255).astype(np.uint8)).save(root / name)
        ann.append({"image": name, "caption": " ".join(rng.choice(words, 5)), "image_id": i,
                    "instance_id": str(i)})
    (root / "train.json").write_text(json.dumps(ann))
    ckpt = root / "blip2_coco.pth"
    torch.save({"model": state_dict_from_jax(params, vit="eva_clip_g")}, ckpt)
    return {"jm": jm, "params": params, "root": str(root), "ckpt": str(ckpt),
            "vocab": write_synthetic_bert_vocab(str(root / "vocab.txt"))}


def _recording(tx):
    """``tx`` that also keeps the gradient of its first update in its state."""
    import optax

    def init(p):
        return tx.init(p), jax.tree_util.tree_map(jnp.zeros_like, p), jnp.zeros((), jnp.int32)

    def update(g, state, p=None):
        inner, first, n = state
        first = jax.tree_util.tree_map(lambda f, x: jnp.where(n == 0, x, f), first, g)
        updates, inner = tx.update(g, inner, p)
        return updates, (inner, first, n + 1)

    return optax.GradientTransformation(init, update)


@pytest.fixture(scope="module")
def generic_runs(tree, tmp_path_factory):
    """``run_generic`` on a config shaped like retrieval_coco_blip2_ft.yaml
    (image_text_pretrain, ``blip2`` / ``coco``, ``coco_retrieval`` through
    ``blip2_image_train``; 8 pairs at batch 4: 2 updates) in both packages
    from the same weights, one run each for (b) and (c): the step logs, the
    first step's gradients (JAX's kept by its optimizer, the port's by its
    trainer) and the parameters after the run."""
    from argparse import Namespace

    from sprc_tpu.config import Config as JConfig
    from sprc_tpu.train import checkpoint as jcheckpoint
    from sprc_tpu.train import generic as jgeneric
    from sprc_tpu.train import loop as jloop
    from sprc_tpu.train import runner as jrunner

    from sprc_tpu_torch.config import Config

    cfg = {"run": {"task": "image_text_pretrain", "batch_size": 4, "max_epochs": 1,
                   "learning_rate": 1e-4, "weight_decay": 0.05, "max_txt_len": TXT, "seed": 42,
                   "log_freq": 1},
           "model": {**TINY, "model_type": "coco"},
           "datasets": {"coco_retrieval": {
               "build_info": {"annotations": {"train": [os.path.join(tree["root"], "train.json")]},
                              "images": tree["root"]},
               "vis_processor": {"train": {"name": "blip2_image_train", "image_size": IMG}},
               "text_processor": {"train": {"name": "blip_caption"}}}}}
    out, runs = tmp_path_factory.mktemp("generic"), {}
    train, create = jrunner.EpochRunner.train, jloop.create_train_state
    apply_gradients = generic.GenericTrainer.apply_gradients

    def keep_state(self):
        best = train(self)
        runs["jax"] = jax.tree_util.tree_map(np.asarray, (self.state.params,
                                                           self.state.opt_state[1]))
        return best

    def recording_state(params, tcfg, rng=None):
        state, tx = create(params, tcfg, rng)
        tx = _recording(tx)
        return state.replace(opt_state=tx.init(params)), tx

    def first_grads(self, grads):
        runs.setdefault("port_grads", dict(zip(self.names, (g.clone() for g in grads))))
        return apply_gradients(self, grads)

    def args(name):
        return Namespace(output_dir=str(out / name), vocab_path=tree["vocab"],
                         model_path=tree["ckpt"], device="cpu")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrunner.EpochRunner, "train", keep_state)
        mp.setattr(jloop, "create_train_state", recording_state)
        mp.setattr(jcheckpoint, "save_state", lambda path, state: None)
        mp.setattr(jgeneric.PretrainAdapter, "init_params",
                   lambda self, model, rng, size: tree["params"], raising=False)
        mp.setattr(generic.GenericTrainer, "apply_gradients", first_grads)
        jgeneric.run_generic(JConfig(defaults=cfg), args("jax"))
        generic.run_generic(Config(defaults=cfg), args("port"))
    params, grads = runs["jax"]
    return {"steps": (_rows(out / "jax", "step"), _rows(out / "port", "step")),
            "jax_params": state_dict_from_jax(params, vit="eva_clip_g"),
            "jax_grads": state_dict_from_jax(grads, vit="eva_clip_g"),
            "port_grads": runs["port_grads"],
            "port_state": torch.load(out / "port" / "last_state.pt", weights_only=True)}


def test_unfrozen_losses_and_tower_gradients_equal_jax(generic_runs):
    """The first training step of ``blip2`` / ``coco`` (``freeze_vit=False``):
    the three losses, and the gradient of every tensor, each tower tensor's
    included, against ``jax.value_and_grad`` of JAX's ``Blip2Stage1`` in its
    generic train step, on the same batch."""
    (want, *_), (got, *_) = generic_runs["steps"]
    for key in ("loss", "loss_itc", "loss_itm", "loss_lm"):
        assert abs(got[key] - want[key]) <= LOSS_RTOL * abs(want[key]), key
    grads, want_grads = generic_runs["port_grads"], generic_runs["jax_grads"]
    tower = [n for n in grads if n.startswith("visual_encoder")]
    assert len(tower) == 30 and set(grads) == set(want_grads) - {
        "Qformer.bert.embeddings.position_ids"}
    floor = 1e-4 * max(w.abs().max().item() for n, w in want_grads.items() if n in grads)
    for n, g in grads.items():
        w = want_grads[n]
        scale = max(w.abs().max().item(), floor)
        tol = ITC_GRAD_TOL if n.startswith(ITC_ONLY) else GRAD_TOL
        assert (g - w).abs().max().item() <= tol * scale, n
    for i in range(2):  # every block of the tower gets a gradient
        assert max(grads[n].abs().max().item() for n in tower
                   if n.startswith(f"visual_encoder.blocks.{i}.")) > 0


def test_run_generic_on_the_coco_row_equals_jax(tree, generic_runs):
    """``run_generic`` in both packages (the fixture): the losses of both
    steps, and every parameter after the two updates, the tower's in AdamW's
    trainable set with its moments."""
    want, got = generic_runs["steps"]
    assert [r["step"] for r in got] == [r["step"] for r in want] == [0, 1]
    for g, w in zip(got, want):
        for key in ("loss", "loss_itc", "loss_itm", "loss_lm"):
            assert abs(g[key] - w[key]) <= PARAM_ATOL * abs(w[key]), (g["step"], key)
    state = generic_runs["port_state"]
    assert state["updates"] == 2 and not state["decayed"]
    want_params = generic_runs["jax_params"]
    start = state_dict_from_jax(tree["params"], vit="eva_clip_g")
    tower = [n for n in state["trainable"] if n.startswith("visual_encoder")]
    assert len(tower) == 30
    for name, value in state["trainable"].items():
        np.testing.assert_allclose(value.numpy(), want_params[name].numpy(), atol=PARAM_ATOL,
                                   err_msg=name)
    moved = [(want_params[n] - start[n]).abs().max().item() for n in tower]
    assert min(moved) > 0 and max(moved) > 3 * PARAM_ATOL, moved


def test_layer_decay_updates_equal_jax(tree):
    """``TrainConfig.layer_decay`` 0.75 on the coco row, every tensor
    trainable: two updates from the same seeded gradients equal those of
    JAX's ``make_optimizer`` with ``layer_decay`` 0.75 (its scales on the
    final update), every tensor within 1e-6; the port holds one AdamW group
    a scale (the layer-0 embeddings, the two blocks, the rest)."""
    import optax
    from sprc_tpu.train import loop as jloop

    trainer = Trainer(_port_model(tree["params"]),
                      TrainConfig(learning_rate=1e-3, total_steps=4, layer_decay=0.75))
    assert sorted(g["lr_scale"] for g in trainer.optimizer.param_groups) == [
        0.75 ** 3, 0.75 ** 2, 0.75, 1.0]
    params = tree["params"]
    tx = jloop.make_optimizer(jloop.TrainConfig(learning_rate=1e-3, total_steps=4,
                                                layer_decay=0.75, frozen_prefixes=()), params)
    state, rng = tx.init(params), np.random.default_rng(3)
    for _ in range(2):
        grads = jax.tree_util.tree_map(lambda a: jnp.asarray(_np(rng, *a.shape)), params)
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        got = state_dict_from_jax(grads, vit="eva_clip_g")
        trainer.apply_gradients([got[n] for n in trainer.names])
    want = state_dict_from_jax(params, vit="eva_clip_g")
    for name, value in zip(trainer.names, trainer.params):
        np.testing.assert_allclose(value.detach().numpy(), want[name].numpy(), atol=1e-6,
                                   err_msg=name)


def test_remat_step_is_bit_equal_with_dropout(tree):
    """The loader's ``use_grad_checkpoint`` (``vit_remat``) and
    ``qformer_remat`` on the unfused tower route (where a block keeps its
    intermediates), dropout 0.1 drawn from the trainer's generator: one
    ``train_step`` equals the step without them bit for bit (losses, every
    parameter after the update, the generator's state), while the forward
    keeps fewer tensors for the backward. Inside ``plain_reference`` (where
    every route keeps its intermediates, so ``vit_remat`` takes each block)
    the remat step's backward, run on another thread as the card's autograd
    runs it, recomputes in the forward's context and equals the step without
    remat."""
    qf = dict(TINY["qformer_config_override"], dropout_rate=0.1)
    images, ids, mask = make_batch(seed=12)
    batch = {"images": torch.from_numpy(images), "input_ids": torch.from_numpy(ids),
             "text_mask": torch.from_numpy(mask)}
    runs = []
    for remat in ({}, {"use_grad_checkpoint": True, "qformer_remat": True}):
        model = _port_model(tree["params"], vit_fused_block="none",
                            qformer_config_override=qf, **remat)
        assert model.visual_encoder.cfg.remat == model.qformer.cfg.remat == bool(remat)
        trainer = generic.GenericTrainer(model, TrainConfig(total_steps=4), seed=7)
        saved = []
        with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(1) or t,
                                                      lambda t: t):
            metrics = trainer.train_step(batch)
        runs.append((metrics, [p.detach().clone() for p in trainer.params],
                     trainer.generator.get_state(), len(saved)))
    (m0, p0, g0, n0), (m1, p1, g1, n1) = runs
    assert m0 == m1 and torch.equal(g0, g1)
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
    assert n1 < n0 / 2, (n0, n1)

    grads = []
    for remat in (False, True):
        model = _port_model(tree["params"], vit_remat=remat).train()
        with primitives.plain_reference():
            total = sum(model(*batch.values()).values())
        with ThreadPoolExecutor(1) as pool:
            pool.submit(total.backward).result()
        grads.append([p.grad for p in model.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*grads))


def test_loader_takes_a_trainable_tower_but_not_with_int8():
    """The loader accepts ``freeze_vit=False`` on any row (the ``coco`` rows
    carry it, as their YAMLs do), translates ``use_grad_checkpoint`` into
    ``vit_remat``, and refuses a trainable tower with either int8 mode: K5
    and the quantised modes serve only, in both packages."""
    assert loader.model_config("blip2", "coco").freeze_vit is False
    assert loader.model_config("blip2", "pretrain").freeze_vit is True
    assert loader.model_config("blip2", "coco", use_grad_checkpoint=True).vit_remat is True
    assert loader.model_config("blip2", "pretrain", freeze_vit=False).freeze_vit is False
    for mode in ("int8", "int8_static"):
        with pytest.raises(ValueError, match="freeze_vit=False"):
            loader.model_config("blip2", "coco", vit_quant=mode)
    assert loader.model_config("blip2", "coco", freeze_vit=True, vit_quant="int8").vit_quant
