"""Task-driven train runners (counterpart of ``sprc_tpu/train/runner.py:28-284``;
reference src/lavis/runners/runner_base.py:38-641, runner_iter.py:24-317).

A task supplies batches and evaluation; the runner owns the schedule over a
:class:`~sprc_tpu_torch.train.loop.Trainer` (its ``train_step`` is the JAX
package's jitted step): :class:`EpochRunner` runs ``max_epochs`` x (train +
evaluation), :class:`IterRunner` a budget of ``max_iters`` steps in inner
epochs of ``iters_per_inner``. As in JAX:

- ``log.jsonl`` under ``output_dir``: a ``step`` row every
  ``log_every_steps`` steps, a ``train`` row of the epoch's means (an
  ``inner`` row per inner epoch), ``val`` rows, and ``nonfinite_skip``,
  ``diverged`` and ``preempted`` rows;
- the non-finite policy: a step built with ``skip_nonfinite`` leaves the
  state as it was on a non-finite loss or gradient, and the run ends with
  :class:`NonFiniteLossError` after ``max_consecutive_nonfinite`` such steps
  in a row, its state saved to ``diverged_state.pt``; without
  ``skip_nonfinite``, a non-finite logged loss ends it with the state from
  before the last logged step;
- SIGTERM (:class:`~sprc_tpu_torch.utils.preempt.PreemptionGuard`) stops
  between steps, saves ``last_state.pt`` and raises :class:`PreemptedError`;
- ``last_state.pt`` after every ``save_every`` epochs (every inner epoch).

The resume rule: ``resume``, a ``last_state.pt`` that exists, is restored
before the first step. Unlike JAX's runner, which starts again at epoch 0
over the restored state, the port's starts at the epoch after the one the
state was saved at, so a resumed run equals the run that was not stopped.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import math
import os
import time
from typing import Any, Dict, Iterable, Optional

from sprc_tpu_torch.registry import registry


class BaseTask:
    """The task protocol (reference tasks/base_task.py)."""

    def train_loader(self, epoch: int) -> Iterable[dict]:
        raise NotImplementedError

    def prepare_batch(self, batch: dict) -> Dict[str, Any]:
        raise NotImplementedError

    def evaluation(self, model) -> Dict[str, float]:
        return {}

    def selection_metric(self, results: Dict[str, float]) -> Optional[float]:
        return None


@dataclasses.dataclass
class RunnerConfig:
    output_dir: str = "./output"
    max_epochs: int = 1
    evaluate_every: int = 1
    save_every: int = 1
    resume: Optional[str] = None
    log_every_steps: int = 50
    nan_guard: bool = True
    preempt_guard: bool = True
    max_consecutive_nonfinite: int = 10


class NonFiniteLossError(RuntimeError):
    """Training diverged (NaN/Inf loss); the last state was saved."""


class PreemptedError(RuntimeError):
    """SIGTERM received; a resumable state was saved before raising."""


def _cpu_copy(state):
    """A host copy of a trainer's ``state_dict()`` (the JAX runner's
    ``jax.device_get(state)``)."""
    import torch

    if torch.is_tensor(state):
        return state.detach().to("cpu", copy=True)
    if isinstance(state, dict):
        return {k: _cpu_copy(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(_cpu_copy(v) for v in state)
    return copy.deepcopy(state)


class EpochRunner:
    def __init__(self, model, trainer, task: BaseTask, cfg: RunnerConfig):
        self.model = model
        self.trainer = trainer
        self.task = task
        self.cfg = cfg
        os.makedirs(cfg.output_dir, exist_ok=True)

    def _path(self, name: str) -> str:
        return os.path.join(self.cfg.output_dir, f"{name}.pt")

    def _log(self, row: Dict) -> None:
        with open(os.path.join(self.cfg.output_dir, "log.jsonl"), "a") as f:
            f.write(json.dumps(row) + "\n")

    def _install_guard(self):
        if not self.cfg.preempt_guard:
            return None
        from sprc_tpu_torch.utils.preempt import PreemptionGuard

        return PreemptionGuard.install()

    def _check_preempted(self, guard, **where) -> None:
        if guard is None or not guard.should_stop:
            return
        from sprc_tpu_torch.train.checkpoint import save_state

        snap = self._path("last_state")
        save_state(snap, self.trainer)
        self._log({"kind": "preempted", "signal": guard.received_signal, "snapshot": snap,
                   **where})
        guard.restore()
        raise PreemptedError(f"preempted (signal {guard.received_signal}); resumable state "
                             f"saved to {snap}")

    def _skip_policy(self, metrics, consec_skips: int, **where) -> int:
        """A skipped step was already a no-op update; abort after
        ``max_consecutive_nonfinite`` in a row (the state saved then is the
        last finite update's)."""
        if "skipped_nonfinite" not in metrics:
            return consec_skips
        if float(metrics["skipped_nonfinite"]) <= 0.0:
            return 0
        from sprc_tpu_torch.train.checkpoint import save_state

        consec_skips += 1
        self._log({"kind": "nonfinite_skip", "consecutive": consec_skips, **where})
        if consec_skips >= self.cfg.max_consecutive_nonfinite:
            snap = self._path("diverged_state")
            save_state(snap, self.trainer)
            self._log({"kind": "diverged", "snapshot": snap, "consecutive_skips": consec_skips,
                       **where})
            raise NonFiniteLossError(f"{consec_skips} consecutive non-finite steps at {where}; "
                                     f"state (last finite update) saved to {snap}")
        return consec_skips

    def _evaluate(self, keeper, at: int, **where) -> Optional[Dict[str, float]]:
        results = self.task.evaluation(self.model)
        if not results:
            return None
        self._log({"kind": "val", **where, **results})
        metric = self.task.selection_metric(results)
        if metric is not None and keeper.maybe_save(metric, self.model, at):
            return dict(results)
        return None

    def train(self) -> Dict[str, float]:
        from sprc_tpu_torch.train.checkpoint import (BestCheckpointKeeper, restore_state,
                                                     save_state)

        start = 0
        if self.cfg.resume and os.path.isfile(self.cfg.resume):
            restore_state(self.cfg.resume, self.trainer)
            start = self.trainer.epoch
        keeper = BestCheckpointKeeper(self.cfg.output_dir)
        best: Dict[str, float] = {}
        guard = self._install_guard()
        consec_skips = 0
        # the pre-step snapshot of the nan guard, needed only where a step
        # can leave a non-finite state (no skip_nonfinite)
        snapshot = self.cfg.nan_guard and not self.trainer.skip_nonfinite
        for epoch in range(start, self.cfg.max_epochs):
            self.trainer.epoch = epoch
            t0 = time.time()
            running: Dict[str, float] = {}
            n = 0
            for i, batch in enumerate(self.task.train_loader(epoch)):
                prepared = self.task.prepare_batch(batch)
                if snapshot and i % self.cfg.log_every_steps == 0:
                    host_snap = _cpu_copy(self.trainer.state_dict())
                metrics = self.trainer.train_step(prepared)
                self._check_preempted(guard, epoch=epoch, step=i)
                n += 1
                for k, v in metrics.items():
                    running[k] = running.get(k, 0.0) + float(v)
                skip_guarded = "skipped_nonfinite" in metrics
                consec_skips = self._skip_policy(metrics, consec_skips, epoch=epoch, step=i)
                if i % self.cfg.log_every_steps == 0:
                    row = {k: float(v) for k, v in metrics.items()}
                    self._log({"kind": "step", "epoch": epoch, "step": i, **row})
                    if self.cfg.nan_guard and not skip_guarded and not all(
                            math.isfinite(v) for v in row.values()):
                        snap = self._path("diverged_state")
                        import torch

                        torch.save(host_snap, snap)
                        self._log({"kind": "diverged", "epoch": epoch, "step": i,
                                   "snapshot": snap, **row})
                        raise NonFiniteLossError(f"non-finite loss at epoch {epoch} step {i}: "
                                                 f"{row}; pre-divergence state: {snap}")
            epoch_row = {k: v / max(1, n) for k, v in running.items()}
            epoch_row.update(kind="train", epoch=epoch, seconds=round(time.time() - t0, 1))
            self._log(epoch_row)
            if (epoch + 1) % self.cfg.evaluate_every == 0:
                self.model.eval()
                found = self._evaluate(keeper, epoch, epoch=epoch)
                best = found if found is not None else best
            if (epoch + 1) % self.cfg.save_every == 0:
                self.trainer.epoch = epoch + 1  # a resume starts at the next epoch
                save_state(self._path("last_state"), self.trainer)
        if guard is not None:
            guard.restore()
        return best


class IterRunner(EpochRunner):
    """Iteration budget (reference runner_iter.py): ``max_iters`` steps in
    inner epochs of ``iters_per_inner``, evaluation between them; the task's
    epochs roll over as its loader runs out."""

    def __init__(self, *args, max_iters: int = 1000, iters_per_inner: int = 100, **kw):
        super().__init__(*args, **kw)
        self.max_iters = max_iters
        self.iters_per_inner = iters_per_inner

    def train(self) -> Dict[str, float]:
        from sprc_tpu_torch.train.checkpoint import BestCheckpointKeeper, save_state

        keeper = BestCheckpointKeeper(self.cfg.output_dir)
        best: Dict[str, float] = {}
        guard = self._install_guard()
        it = 0
        epoch = 0
        consec_skips = 0
        loader = iter(self.task.train_loader(epoch))
        while it < self.max_iters:
            running: Dict[str, float] = {}
            n = 0
            for _ in range(min(self.iters_per_inner, self.max_iters - it)):
                try:
                    batch = next(loader)
                except StopIteration:
                    epoch += 1
                    loader = iter(self.task.train_loader(epoch))
                    batch = next(loader)
                self.trainer.epoch = epoch
                metrics = self.trainer.train_step(self.task.prepare_batch(batch))
                self._check_preempted(guard, iter=it)
                consec_skips = self._skip_policy(metrics, consec_skips, iter=it)
                it += 1
                n += 1
                for k, v in metrics.items():
                    running[k] = running.get(k, 0.0) + float(v)
            self._log({"kind": "inner", "iter": it,
                       **{k: v / max(1, n) for k, v in running.items()}})
            self.model.eval()
            found = self._evaluate(keeper, it, iter=it)
            best = found if found is not None else best
            save_state(self._path("last_state"), self.trainer)
        if guard is not None:
            guard.restore()
        return best


registry.register("task", "base")(BaseTask)
