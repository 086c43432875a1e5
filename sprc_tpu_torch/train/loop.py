"""The train step and its state (counterpart of ``sprc_tpu/train/loop.py``).

The reference's fine-tune script (blip_fine_tune_2.py:257-307) as the JAX
package has it:

- AdamW (0.9, 0.98, eps 1e-7, weight decay 0.05 unless the config says
  otherwise) over every trainable
  tensor, with no decay mask (``optax.adamw``), and the OneCycle schedule
  counted in optimizer updates. The rule for which tensors it touches: every
  tensor with ``requires_grad``. The model turns it off for the frozen
  tower and for its class's ``FROZEN_PREFIXES`` (the rerank model's twin;
  the BLIP-2 stage-2 heads' tower and LLM, whatever ``freeze_vit`` says),
  as the JAX package's ``frozen_prefixes`` partition gives those leaves
  ``set_to_zero``: they get no gradient, no moments and no update. A
  trainable tensor the losses do not
  reach (the flagship's ``itm_head``, the rerank model's ``vision_proj`` /
  ``text_proj``) gets a zero gradient and so decays, as an optax leaf does.
  optax updates only the leaves its tree holds, and a tree from the JAX
  ``init_params`` lacks the modules the training forward never calls, so
  there the JAX CLI leaves those tensors where they are; on a tree that
  holds them (a strict load needs them) one step is the same in both
  (``tests/test_torch_variants_eval.py``).
- loss = loss_itc + 0.4 loss_rtc + 0.4 loss_align, every other loss a
  variant returns (``loss_itm``, ``loss_p2p``) at weight 1, as in JAX (the
  LM heads' one ``loss`` among them); only a forward's scalar outputs are
  losses (the LM heads also return logits), as the JAX generic step's
  ``_total_and_scalars``.
- ``TrainConfig.layer_decay``: per-layer learning-rate scales for a
  trainable tower, as the JAX package's ``layer_decay_scales`` (LAVIS'
  ``lr_layer_decay``; :func:`layer_decay_scales`), applied to the whole
  update, the Adam step and the decay step alike. No CLI sets it, in either
  package.
- Gradient accumulation as ``optax.MultiSteps``: the running mean of k
  micro-step gradients, then one update; :attr:`Trainer.step` counts
  micro-steps, :attr:`Trainer.updates` the updates.
- ``skip_nonfinite``: a step whose loss or any gradient is not finite leaves
  the parameters and the optimizer state (the accumulation included) as
  they were; the step count and the dropout generator still advance, so the
  data and dropout streams stay aligned.
- Dropout masks come from the trainer's own device ``torch.Generator``
  (seeded), which the JAX package threads as ``state.rng``.
- A trainable tensor that is not fp32 (BLIP-1's and ALBEF's bf16 ViT-B
  tower) keeps an fp32 master, which AdamW updates and which is copied into
  it after each update: the JAX package holds fp32 parameters and computes
  in bf16, and an update of ``lr`` 1e-5 rounds away in a bf16 weight.
- A forward that returns ``loss`` gives the total (the pretrainers' sum of
  their losses), as the JAX generic step's ``_total_and_scalars``.
- :attr:`Trainer.aux`: the momentum-queue families' state (JAX's
  ``TrainState.aux``: the fp32 momentum copies, the feature queues, the id
  queue, the pointer). A step's forward returns the new state with its
  losses; the trainer keeps it where the step's update is applied (a step
  skipped as non-finite keeps the old one, as JAX's), and saves and
  restores it with the rest.

Under ``--mesh`` (``mesh``, a :class:`~sprc_tpu_torch.parallel.mesh.Mesh`;
``parallel/mesh.py``) the model's parameters and buffers start as rank 0's,
each rank runs its rows of the global batch with the mesh active (the
in-batch terms gather the global batch), its loss is the mean over its
rows, and the gradients are all-reduced to their mean once an update, after
the accumulation, so the AdamW update is the global batch's (JAX's step
with the batch sharded over ``data``); frozen tensors take no gradient and
no traffic. ``skip_nonfinite`` decides over every rank (an all-reduce of
the flag, so the ranks skip together), and the losses returned are the
global batch's. Rank r's dropout generator is seeded ``seed + r * 2**32``
(rank 0's is world 1's); the state saves every rank's, and each rank
restores its own.

On the card the step launches kernel K2's chain in the tower (live steps;
with a trainable tower through ``FusedViTBlock``, whose backward recomputes
the plain block) and K1 in the in-batch losses; the Q-Former runs unfused in
training mode (``torch.matmul``), as the JAX package runs it, except in the
variants' no-grad passes (the rerank twin, ``blip2_cir_cls``'s caption
picks), which launch K3; and, unfrozen, the tower's backward runs the
plain blocks recomputed (``torch.matmul``).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Tuple

import torch

from sprc_tpu_torch.parallel import mesh as mesh_lib
from sprc_tpu_torch.train.schedules import onecycle_schedule

Tensor = torch.Tensor

# the reference's AdamW and OneCycleLR settings (blip_fine_tune_2.py:257-261)
BETAS, EPS, WEIGHT_DECAY = (0.9, 0.98), 1e-7, 0.05
PCT_START = 1.0 / 50.0


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-5
    # reference flag defaults --loss-rtc / --loss-align 0.4 (blip_fine_tune_2.py:379-381)
    loss_weights: Optional[Dict[str, float]] = None
    total_steps: int = 10000
    grad_accum_steps: int = 1
    weight_decay: float = WEIGHT_DECAY  # a run config's run.weight_decay (train/generic.py)
    # per-layer learning-rate decay of a trainable tower; None: one rate
    layer_decay: Optional[float] = None

    def weights(self) -> Dict[str, float]:
        return self.loss_weights or {"loss_rtc": 0.4, "loss_align": 0.4}


_BLOCK = re.compile(r"^visual_encoder\.(?:blocks|transformer\.resblocks)\.(\d+)\.")


def layer_decay_scales(names: List[str], depth: int, lr_scale: float) -> List[float]:
    """Learning-rate scales of the named tensors (the JAX package's
    ``layer_decay_scales``, from the reference's get_optimizer_params,
    blip2.py:105-148): block i of the tower's ``depth`` (from 0) gets
    ``lr_scale ** (depth - i)``, the tower's other tensors (patch embedding,
    class token, positions, ``ln_pre``) the layer-0 scale
    ``lr_scale ** (depth + 1)``, and every tensor outside the tower 1."""
    scales = []
    for name in names:
        block = _BLOCK.match(name)
        if block:
            scales.append(lr_scale ** (depth - int(block.group(1))))
        else:
            scales.append(lr_scale ** (depth + 1) if name.startswith("visual_encoder.") else 1.0)
    return scales


class Trainer:
    """The train state (parameters, AdamW, the accumulation, the counters,
    the dropout generator) and the step over it.

    ``from_embeds``: batches carry ``encode_tower`` rows under
    ``reference_embeds`` / ``target_embeds`` (the feature cache) and the step
    runs ``model.forward_cached``; else pixels under ``reference`` /
    ``target`` and the live forward. Both also carry ``input_ids`` and
    ``text_mask``; every tensor on the model's device.

    ``decay_frozen``: the frozen tensors (``requires_grad`` off) take the
    update AdamW gives a tensor whose gradient is always zero, as the JAX
    generic trainer's partition gives a frozen tower that only a
    ``stop_gradient`` cuts off (``train/generic.py``): each update multiplies
    it by ``1 - lr * weight_decay`` (its moments stay zero, and so the
    Adam term is 0; they are not held). A tensor that is not fp32 keeps an
    fp32 master, which takes the decay and is copied into it (a bf16 tensor
    would round a decay of lr x 0.05 away)."""

    def __init__(self, model, cfg: TrainConfig, *, seed: int = 0, from_embeds: bool = False,
                 skip_nonfinite: bool = False, decay_frozen: bool = False, mesh=None):
        self.model, self.cfg, self.mesh = model, cfg, mesh
        if mesh is not None:
            mesh_lib.replicate(mesh, model)
        self.from_embeds, self.skip_nonfinite = from_embeds, skip_nonfinite
        self.names = [n for n, p in model.named_parameters() if p.requires_grad]
        self.params = [p for p in model.parameters() if p.requires_grad]
        frozen = [(n, p) for n, p in model.named_parameters() if decay_frozen and not p.requires_grad]
        self.decayed_names = [n for n, _ in frozen]
        self.decayed = [p for _, p in frozen]
        self.masters = [p if p.dtype == torch.float32 else p.detach().float().clone()
                        for p in self.decayed]
        self.schedule = onecycle_schedule(cfg.learning_rate, cfg.total_steps,
                                          pct_start=PCT_START)
        # what AdamW updates: the tensor itself, or its fp32 master
        self.updated = [p if p.dtype == torch.float32 else p.detach().float().clone()
                        for p in self.params]
        groups = [{"params": self.updated, "lr_scale": 1.0}]
        self.decayed_scales = [1.0] * len(self.decayed)
        if cfg.layer_decay is not None:
            depth = model.visual_encoder.cfg.depth
            scales = layer_decay_scales(self.names, depth, cfg.layer_decay)
            self.decayed_scales = layer_decay_scales(self.decayed_names, depth, cfg.layer_decay)
            groups = [{"params": [p for p, s in zip(self.updated, scales) if s == scale],
                       "lr_scale": scale} for scale in dict.fromkeys(scales)]
        self.optimizer = torch.optim.AdamW(groups, lr=self.schedule(0), betas=BETAS,
                                           eps=EPS, weight_decay=cfg.weight_decay)
        rank = 0 if mesh is None else mesh.rank
        self.generator = torch.Generator(device=self.params[0].device).manual_seed(
            seed + (rank << 32))
        self.step = 0  # micro-steps taken
        self.updates = 0  # optimizer updates applied: the schedule's count
        self.mini_step = 0  # micro-steps in the open accumulation
        self.acc: Optional[List[Tensor]] = None  # their running mean (grad_accum_steps > 1)
        self.epoch = 0  # the loader's epoch, kept with the state
        self.aux: Optional[dict] = None  # the momentum-queue state (JAX's TrainState.aux)
        self.next_aux: Optional[dict] = None  # the state the open step's forward returned

    def param_values(self) -> Dict[str, Tensor]:
        """Every parameter's fp32 value by name: the master where the trainer
        keeps one (JAX's fp32 ``params``), else the tensor."""
        values = dict(self.model.named_parameters())
        values.update(zip(self.names, self.updated))
        values.update(zip(self.decayed_names, self.masters))
        return values

    def loss_and_grads(self, batch: Dict[str, Tensor]) -> Tuple[Tensor, Dict[str, Tensor],
                                                                List[Tensor]]:
        """One forward and backward in training mode: (weighted total, the
        losses, one gradient a trainable tensor, zeros where none flowed)."""
        self.model.train()
        for p in self.params:
            p.grad = None
        losses = {k: v for k, v in self.forward(batch).items() if v.ndim == 0}
        if "loss" in losses:  # a family that sums its own losses
            total = losses["loss"]
        else:
            weights = self.cfg.weights()
            total = 0.0
            for key, value in losses.items():
                total = total + weights.get(key, 1.0) * value
        total.backward()
        grads = [p.grad.float() if p.grad is not None else torch.zeros_like(u)
                 for p, u in zip(self.params, self.updated)]
        for p in self.params:
            p.grad = None
        return total, losses, grads

    def forward(self, batch: Dict[str, Tensor]) -> Dict[str, Tensor]:
        """The model's losses on one batch, in training mode."""
        ids, mask = batch["input_ids"], batch["text_mask"]
        with mesh_lib.active(self.mesh):
            if self.from_embeds:
                return self.model.forward_cached(batch["reference_embeds"],
                                                 batch["target_embeds"], ids, mask,
                                                 generator=self.generator)
            return self.model(batch["reference"], batch["target"], ids, mask,
                              generator=self.generator)

    def train_step(self, batch: Dict[str, Tensor]) -> Dict[str, float]:
        """One micro-step; returns the losses, ``loss`` (the weighted total)
        and, with ``skip_nonfinite``, ``skipped_nonfinite`` (1.0 or 0.0)."""
        self.next_aux = None
        total, losses, grads = self.loss_and_grads(batch)
        values = [total.detach()] + [v.detach() for v in losses.values()]
        if self.skip_nonfinite:
            finite = torch.stack([torch.isfinite(total)]
                                 + [torch.isfinite(g).all() for g in grads]).all()
            values.append(1.0 - finite.float())  # non-finite: summed over the ranks
        values = torch.stack([v.float() for v in values])
        if self.mesh is not None:  # the global batch's losses, every rank's verdict
            torch.distributed.all_reduce(values)
            n = len(values) - (1 if self.skip_nonfinite else 0)
            values[:n] /= self.mesh.world
        host = values.tolist()
        ok = not self.skip_nonfinite or host[-1] == 0.0
        if ok:
            self.apply_gradients(grads)
            if self.next_aux is not None:
                self.aux = self.next_aux
        self.next_aux = None
        self.step += 1
        metrics = dict(zip(losses, host[1:1 + len(losses)]))
        metrics["loss"] = host[0]
        if self.skip_nonfinite:
            metrics["skipped_nonfinite"] = 0.0 if ok else 1.0
        return metrics

    def apply_gradients(self, grads: List[Tensor]) -> None:
        """One micro-step's gradients (one a trainable tensor, in
        :attr:`params` order): accumulated, and every ``grad_accum_steps``-th
        call one AdamW update at the schedule's rate."""
        k = self.cfg.grad_accum_steps
        if k > 1:
            if self.acc is None:
                self.acc = [torch.zeros_like(g) for g in grads]
            for a, g in zip(self.acc, grads):  # optax.MultiSteps' running mean
                a.add_((g - a) / (self.mini_step + 1))
            self.mini_step += 1
            if self.mini_step < k:
                return
            grads, self.mini_step = self.acc, 0
        if self.mesh is not None:  # the global batch's gradient, once an update
            mesh_lib.all_reduce_mean_(grads, self.mesh)
        for u, g in zip(self.updated, grads):
            u.grad = g
        lr = self.schedule(self.updates)
        for group in self.optimizer.param_groups:
            group["lr"] = lr * group.get("lr_scale", 1.0)
        self.optimizer.step()
        with torch.no_grad():
            for p, u in zip(self.params, self.updated):
                if u is not p:
                    p.copy_(u)
            for master, p, scale in zip(self.masters, self.decayed, self.decayed_scales):
                master.mul_(1.0 - lr * scale * self.cfg.weight_decay)
                if master is not p:
                    p.copy_(master)
        for u in self.updated:
            u.grad = None
        if self.acc is not None:
            for a in self.acc:
                a.zero_()
        self.updates += 1

    # ------------------------------------------------------------ state

    def state_dict(self) -> dict:
        """Everything a resume needs (tensors by reference); under a mesh
        every rank's dropout generator (a collective: every rank calls it)."""
        extra = {}
        if self.mesh is not None:
            extra["generators"] = mesh_lib.all_gather_object(self.generator.get_state(),
                                                             self.mesh)
        return {**extra, "step": self.step, "updates": self.updates,
                "mini_step": self.mini_step,
                "epoch": self.epoch,
                "trainable": dict(zip(self.names, (u.detach() for u in self.updated))),
                "decayed": dict(zip(self.decayed_names, (m.detach() for m in self.masters))),
                "optimizer": self.optimizer.state_dict(), "acc": self.acc,
                "generator": self.generator.get_state(), "aux": self.aux}

    def load_state_dict(self, state: dict) -> None:
        if list(state["trainable"]) != self.names:
            raise ValueError("the saved trainable tensors are not this model's")
        if list(state.get("decayed", {})) != self.decayed_names:
            raise ValueError("the saved decayed tensors are not this trainer's")
        with torch.no_grad():
            for p, u, saved in zip(self.params, self.updated, state["trainable"].values()):
                u.copy_(saved)
                if u is not p:
                    p.copy_(u)
            for master, p, saved in zip(self.masters, self.decayed,
                                        state.get("decayed", {}).values()):
                master.copy_(saved)
                if master is not p:
                    p.copy_(master)
        self.optimizer.load_state_dict(state["optimizer"])
        device = self.params[0].device
        self.acc = None if state["acc"] is None else [a.to(device) for a in state["acc"]]
        generator = state["generator"]
        if self.mesh is not None and self.mesh.rank > 0:  # this rank's own stream
            saved = state.get("generators") or []
            if len(saved) != self.mesh.world:
                raise ValueError(f"the state holds {len(saved)} ranks' dropout generators; "
                                 f"the mesh has {self.mesh.world}")
            generator = saved[self.mesh.rank]
        self.generator.set_state(generator.cpu())
        self.step, self.updates = state["step"], state["updates"]
        self.mini_step, self.epoch = state["mini_step"], state["epoch"]
        self.aux = _to_device(state.get("aux"), device)


def _to_device(tree, device):
    """A nested dict of tensors (the aux state) on ``device``."""
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device) if torch.is_tensor(tree) else tree
