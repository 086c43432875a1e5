"""Checkpoints (counterpart of ``sprc_tpu/train/checkpoint.py``).

- :func:`save_state` / :func:`restore_state`: the whole train state for an
  exact resume (the step and update counts, the trainable tensors, AdamW's
  state, the open gradient accumulation, the dropout generator, the loader's
  epoch), in one ``torch.save`` file (orbax needs JAX).
- :class:`BestCheckpointKeeper`: the weights at each new best selection
  metric, in the released layout ``{epoch, "Blip2QformerCirAlignPrompt":
  state_dict}`` under the reference's tensor names (the JAX package's
  ``export_torch_compatible``), which ``sprc_tpu_torch.loader.load_model``
  and ``sprc_tpu.interop.torch_import.cir_align_prompt_params_from_torch``
  both read.
"""

from __future__ import annotations

import os

import torch

CLASS_NAME = "Blip2QformerCirAlignPrompt"


def save_state(path: str, trainer) -> None:
    """Write ``trainer.state_dict()`` to ``path`` (a file). Under a mesh
    every rank calls it (the state gathers each rank's generator) and rank 0
    writes."""
    state = trainer.state_dict()
    mesh = getattr(trainer, "mesh", None)
    if mesh is not None and not mesh.is_main:
        return
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)


def restore_state(path: str, trainer) -> None:
    """Load a :func:`save_state` file into ``trainer`` (built for the same model)."""
    trainer.load_state_dict(torch.load(path, map_location="cpu", weights_only=True))


def export_torch_compatible(path: str, model, epoch: int = 0) -> None:
    """The model's weights in the released ``{epoch, ClassName: state_dict}`` layout."""
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    torch.save({"epoch": epoch, CLASS_NAME: state}, path)


class BestCheckpointKeeper:
    """Keep the weights of the best epoch by a metric (reference utils.py:151-175)."""

    def __init__(self, base_path: str, metric_name: str = "arithmetic_mean"):
        self.base_path = base_path
        self.metric_name = metric_name
        self.best = float("-inf")

    @property
    def path(self) -> str:
        return os.path.join(self.base_path, f"best_{self.metric_name}.pt")

    def maybe_save(self, metric_value: float, model, epoch: int) -> bool:
        if metric_value <= self.best:
            return False
        self.best = metric_value
        export_torch_compatible(self.path, model, epoch)
        with open(os.path.join(self.base_path, f"best_{self.metric_name}.txt"), "w") as f:
            f.write(f"epoch={epoch} {self.metric_name}={metric_value}\n")
        return True
