"""The momentum-queue train steps with the trainer's aux state
(train/loop.py's ``Trainer.aux``, train/generic.py's ``RetrievalAdapter``
and the family step functions) against sprc_tpu's jitted generic step
(``make_generic_train_step(uses_aux=True)`` over its ``RetrievalAdapter``).

The tiny models of test_torch_momentum.py from the same weights take 3 AdamW
steps (the run YAMLs' learning rates: 1e-5 for retrieval, 3e-4 for
pretraining; weight decay 0.05; ``alpha`` by the two-epoch ramp) over three
seeded batches whose image ids repeat within and across batches; the queues
(8 columns, 4 rows a step) wrap. The hard negatives of each port step are
the JAX step's own draws (``jax.random.categorical`` recorded, the port's
``sample_negatives`` replaced by them). After the steps the parameters, the
momentum copies and the queues agree within 1e-5, ``ptr`` and ``idx_queue``
are equal, and each step's losses agree within 1e-5. The retrieval models
here, the pretrainers in test_torch_momentum_pretrain_train.py (one file
each so that they run beside each other).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sprc_tpu_torch.interop.jax_params import momentum_state_from_jax  # noqa: E402
from sprc_tpu_torch.models import albef  # noqa: E402
from sprc_tpu_torch.train import generic  # noqa: E402
from sprc_tpu_torch.train.loop import TrainConfig  # noqa: E402
from test_torch_momentum import batch, bridge, jax_draws, tiny_pair  # noqa: E402,F401
from test_torch_threads import one_torch_thread  # noqa: E402,F401  (one thread a module)

TOL = 1e-5
STEPS = 3
IDS = ((5, 7, 5, 9), (9, 2, 3, 5), (11, 7, 12, 13))
LR = {"blip_retrieval": 1e-5, "albef_retrieval": 1e-5, "blip_pretrain": 3e-4,
      "albef_pretrain": 3e-4}


def _batches(name):
    out = []
    for i, ids in enumerate(IDS):
        b = batch(name, 20 + i, ids_of=ids)
        b["alpha"] = np.float32(0.4 * min(1.0, i / (2 * STEPS)))
        out.append(b)
    return out


def _jax_run(name, jm, params, batches):
    from sprc_tpu.train import generic as jgeneric
    from sprc_tpu.train.loop import TrainConfig as JTrainConfig
    from sprc_tpu.train.loop import create_train_state

    adapter = jgeneric.RetrievalAdapter(None)
    tcfg = JTrainConfig(learning_rate=LR[name], weight_decay=0.05, total_steps=STEPS,
                        frozen_prefixes=())
    state, tx = create_train_state(params, tcfg)
    apply_fn = adapter.loss_fn(jm)
    state = state.replace(aux=adapter.init_aux(jm, params))
    step = jgeneric.make_generic_train_step(jm, tx, tcfg, apply_fn, uses_aux=True,
                                            skip_nonfinite=True)
    losses = []
    for b in batches:
        state, metrics = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append({k: float(v) for k, v in metrics.items()})
    jax.effects_barrier()  # the recorded draws are on the host
    return state, losses


@pytest.mark.parametrize("name", ["blip_retrieval", "albef_retrieval"])
def test_train_steps_equal_jax(name, jax_draws, monkeypatch):
    check_train_steps(name, jax_draws, monkeypatch)


def check_train_steps(name, jax_draws, monkeypatch):
    model, jm, params = tiny_pair(name, seed=2)
    batches = _batches(name)
    state, want_losses = _jax_run(name, jm, params, batches)
    assert len(jax_draws) == STEPS and all(len(d) == 2 for d in jax_draws)
    picks = [d[slot] for d in jax_draws for slot in (0, 1)]
    monkeypatch.setattr(albef, "sample_negatives",
                        lambda weights, generator: torch.from_numpy(picks.pop(0)))

    adapter = generic.PretrainAdapter(None).specialize(model) if "pretrain" in name else \
        generic.RetrievalAdapter(None)
    trainer = generic.GenericTrainer(model, TrainConfig(learning_rate=LR[name],
                                                        weight_decay=0.05, total_steps=STEPS),
                                     seed=0, adapter=adapter, skip_nonfinite=True)
    trainer.aux = adapter.init_aux(model, trainer.param_values())
    got_losses = [trainer.train_step({k: torch.as_tensor(v) for k, v in b.items()})
                  for b in batches]
    assert not picks and trainer.updates == STEPS
    for got, want in zip(got_losses, want_losses):
        assert set(got) == set(want)
        for key, value in want.items():
            assert abs(got[key] - value) <= TOL * max(1.0, abs(value)), (key, got, want)

    want_params = bridge(name)(jax.tree_util.tree_map(np.asarray, state.params))
    for n, value in trainer.param_values().items():
        np.testing.assert_allclose(value.detach().numpy(), want_params[n].numpy(), atol=TOL,
                                   err_msg=n)
    want_aux = momentum_state_from_jax(jax.tree_util.tree_map(np.asarray, state.aux), model)
    aux = trainer.aux
    assert set(aux["params_m"]) == set(want_aux["params_m"])
    for n, m in aux["params_m"].items():
        np.testing.assert_allclose(m.numpy(), want_aux["params_m"][n].numpy(), atol=TOL,
                                   err_msg=n)
    for key in ("image_queue", "text_queue"):
        np.testing.assert_allclose(aux[key].numpy(), want_aux[key].numpy(), atol=TOL)
    assert aux["idx_queue"].tolist() == want_aux["idx_queue"].tolist() == [11, 7, 12, 13, 9, 2,
                                                                           3, 5]
    assert int(aux["ptr"]) == int(want_aux["ptr"]) == 4
    # the momentum copies moved off the live weights and off their start
    w = model.visual_encoder.blocks[0].mlp.fc1.weight
    m = aux["params_m"]["visual_encoder.blocks.0.mlp.fc1.weight"]
    assert 0 < (m - w.detach()).abs().max() and m.data_ptr() != w.data_ptr()
