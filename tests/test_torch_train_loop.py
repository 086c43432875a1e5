"""The port's train loop (sprc_tpu_torch/train/) against sprc_tpu's.

- OneCycle: ``schedules.onecycle_schedule`` against the JAX function (which
  computes its cosine in fp32: within 1e-6 of the peak rate) and
  ``torch.optim.lr_scheduler.OneCycleLR`` (1e-9 relative: both in float64).
- AdamW and accumulation: ``Trainer.apply_gradients`` against
  ``sprc_tpu.train.loop.make_optimizer`` (optax) on the same gradients, with
  a frozen subtree; parameters within 2e-7 absolute after each micro-step
  (fp32 roundings of the same update in another order; the updates are
  about 1e-2).
- ``skip_nonfinite`` and dropout on the tiny model of
  test_torch_train_losses.py (weights from JAX).
"""

import numpy as np
import pytest
import torch
from torch import nn

jax = pytest.importorskip("jax")
import optax  # noqa: E402

from sprc_tpu.train.loop import TrainConfig as JTrainConfig  # noqa: E402
from sprc_tpu.train.loop import make_optimizer  # noqa: E402
from sprc_tpu.train.schedules import onecycle_schedule as jonecycle  # noqa: E402
from test_torch_train_losses import (B, jax_model, jax_params, make_batch,  # noqa: E402
                                     port_model, torch_batch)

from sprc_tpu_torch.ops.layers import dropout  # noqa: E402
from sprc_tpu_torch.train.loop import TrainConfig, Trainer  # noqa: E402
from sprc_tpu_torch.train.schedules import onecycle_schedule  # noqa: E402
from test_torch_threads import one_torch_thread  # noqa: E402,F401  (one thread a module)

PARAM_ATOL = 2e-7


@pytest.mark.parametrize("max_lr,total,pct", [(1e-5, 1000, 1 / 50), (3e-4, 100, 0.3)])
def test_onecycle_equals_jax_and_torch(max_lr, total, pct):
    sched = onecycle_schedule(max_lr, total, pct_start=pct)
    jsched = jonecycle(max_lr, total, pct_start=pct)
    p = nn.Parameter(torch.zeros(1))
    opt = torch.optim.SGD([p], lr=max_lr)
    torch_sched = torch.optim.lr_scheduler.OneCycleLR(opt, max_lr, total_steps=total,
                                                      pct_start=pct, cycle_momentum=False)
    for step in range(total):
        lr = sched(step)
        assert abs(lr - float(jsched(step))) <= 1e-6 * max_lr, step
        assert lr == pytest.approx(opt.param_groups[0]["lr"], rel=1e-9), step
        opt.step()
        torch_sched.step()


class _Params(nn.Module):
    """A frozen ``visual_encoder`` beside two trainable tensors."""

    def __init__(self, rng):
        super().__init__()
        self.visual_encoder = nn.Linear(3, 3)
        self.visual_encoder.requires_grad_(False)
        self.a = nn.Parameter(torch.from_numpy(rng.standard_normal((4, 5)).astype(np.float32)))
        self.b = nn.Parameter(torch.from_numpy(rng.standard_normal(5).astype(np.float32)))


@pytest.mark.parametrize("accum", [1, 2])
def test_adamw_and_accumulation_equal_optax(accum):
    """Three AdamW updates (``accum`` 1) or six micro-steps as three updates
    of two (``optax.MultiSteps``), the frozen partition untouched."""
    rng = np.random.RandomState(0)
    model = _Params(rng)
    frozen = {k: v.clone() for k, v in model.visual_encoder.state_dict().items()}
    # 100 scheduled updates: the first two warm up (pct_start 1/50), the third anneals
    kw = dict(learning_rate=1e-2, total_steps=100, grad_accum_steps=accum)
    trainer = Trainer(model, TrainConfig(**kw))
    assert trainer.names == ["a", "b"]
    params = {"visual_encoder": {k: v.numpy() for k, v in frozen.items()},
              "a": model.a.detach().numpy().copy(), "b": model.b.detach().numpy().copy()}
    tx = make_optimizer(JTrainConfig(**kw), params)
    state = tx.init(params)
    for step in range(3 * accum):
        ga = rng.standard_normal((4, 5)).astype(np.float32)
        gb = rng.standard_normal(5).astype(np.float32)
        grads = {"visual_encoder": {k: np.zeros_like(v) for k, v in params["visual_encoder"].items()},
                 "a": ga, "b": gb}
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        trainer.apply_gradients([torch.from_numpy(ga), torch.from_numpy(gb)])
        np.testing.assert_allclose(model.a.detach().numpy(), np.asarray(params["a"]),
                                   atol=PARAM_ATOL, err_msg=f"micro-step {step}")
        np.testing.assert_allclose(model.b.detach().numpy(), np.asarray(params["b"]),
                                   atol=PARAM_ATOL, err_msg=f"micro-step {step}")
    assert trainer.updates == 3 and trainer.mini_step == 0
    for k, v in model.visual_encoder.state_dict().items():
        assert torch.equal(v, frozen[k])
        assert np.array_equal(np.asarray(params["visual_encoder"][k]), frozen[k].numpy())


@pytest.fixture(scope="module")
def weights():
    return jax_params(jax_model())


def test_skip_nonfinite_keeps_the_state(weights):
    """A NaN step leaves the parameters, AdamW's state and the open
    accumulation as they were; the step count and the generator move on."""
    model = port_model(weights, dropout=0.1)
    trainer = Trainer(model, TrainConfig(grad_accum_steps=2), seed=3, from_embeds=True,
                      skip_nonfinite=True)
    tb = torch_batch(make_batch())
    with torch.no_grad():
        tower = model.encode_tower(torch.cat([tb["reference"], tb["target"]]))
    step = {"reference_embeds": tower[:B], "target_embeds": tower[B:],
            "input_ids": tb["input_ids"], "text_mask": tb["text_mask"]}
    for _ in range(3):  # one update, then an open accumulation
        assert trainer.train_step(step)["skipped_nonfinite"] == 0.0
    assert (trainer.updates, trainer.mini_step) == (1, 1)
    before = {k: (v.clone() if torch.is_tensor(v) else v) for k, v in trainer.state_dict().items()
              if k in ("step", "generator")}
    params = [p.detach().clone() for p in trainer.params]
    opt = {i: {k: v.clone() for k, v in s.items()} for i, s in
           trainer.optimizer.state_dict()["state"].items()}
    acc = [a.clone() for a in trainer.acc]
    bad = dict(step, reference_embeds=torch.full_like(step["reference_embeds"], float("nan")))
    metrics = trainer.train_step(bad)
    assert metrics["skipped_nonfinite"] == 1.0 and not np.isfinite(metrics["loss"])
    assert all(torch.equal(p, q) for p, q in zip(trainer.params, params))
    for i, s in trainer.optimizer.state_dict()["state"].items():
        assert all(torch.equal(v, opt[i][k]) for k, v in s.items())
    assert all(torch.equal(a, b) for a, b in zip(trainer.acc, acc))
    assert (trainer.updates, trainer.mini_step) == (1, 1)
    assert trainer.step == before["step"] + 1
    assert not torch.equal(trainer.generator.get_state(), before["generator"])


def test_dropout_is_active_in_training_and_repeats(weights):
    """Training mode draws dropout masks from the trainer's generator: one
    seed repeats its losses, another gives others; at rate 0 the training
    branch equals the eval-mode layers (kernel K3's plain version) within
    1e-5 relative."""
    tb = torch_batch(make_batch())
    model = port_model(weights, dropout=0.1)

    def losses(seed):
        return Trainer(model, TrainConfig(), seed=seed).loss_and_grads(tb)[0].item()

    assert losses(1) == losses(1) != losses(2)
    x = torch.ones(200, 500)
    kept = dropout(x, 0.1, torch.Generator().manual_seed(0))
    assert abs((kept == 0).float().mean().item() - 0.1) < 0.01
    assert torch.allclose(kept[kept != 0], torch.full((), 1 / 0.9))
    plain = port_model(weights, dropout=0.0)
    train = Trainer(plain, TrainConfig()).loss_and_grads(tb)[0].item()
    with torch.no_grad():
        evals = plain.eval()(*tb.values())
    want = sum(w * evals[k].item() for k, w in
               (("loss_itc", 1.0), ("loss_rtc", 0.4), ("loss_align", 0.4)))
    assert train == pytest.approx(want, rel=1e-5)
