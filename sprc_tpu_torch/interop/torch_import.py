"""Any checkpoint the port reads, into a model (counterpart of
``sprc_tpu/interop/torch_import.py:304``, ``load_checkpoint_auto``).

Two kinds of file: what :func:`~sprc_tpu_torch.loader.read_checkpoint`
reads (a bare state dict, a ``{"model": ...}`` file, the released
``{epoch, ClassName: state_dict}`` layout, the LAVIS and HF layouts it
maps), and the port's training state ``last_state.pt``
(:func:`~sprc_tpu_torch.train.checkpoint.save_state`), which holds the
tensors that train (``trainable``, and ``decayed``: frozen ones that AdamW
decays) and not those that take no update: their values come from a
``base`` checkpoint, and a state that needs one and has none raises,
naming what is missing. Every load is strict.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


@torch.no_grad()
def load_checkpoint_auto(path: str, model: nn.Module, base: Optional[str] = None) -> nn.Module:
    """Load ``path`` into ``model``, strictly; returns the model."""
    from sprc_tpu_torch.loader import read_checkpoint

    state = torch.load(path, map_location="cpu", weights_only=True)
    if not (isinstance(state, dict) and "trainable" in state and "optimizer" in state):
        model.load_state_dict(read_checkpoint(path, model), strict=True)
        return model
    saved = {**state["trainable"], **state.get("decayed", {})}
    params = dict(model.named_parameters())
    unknown = sorted(set(saved) - set(params))
    if unknown:
        raise ValueError(f"{path}: tensors the model does not hold: {unknown[:8]}")
    if base is not None:
        model.load_state_dict(read_checkpoint(base, model), strict=True)
    elif set(params) - set(saved):
        missing = sorted(set(params) - set(saved))
        raise ValueError(f"{path} is a training state: it holds {len(saved)} of the model's "
                         f"{len(params)} parameters (missing {missing[:4]}...); give the "
                         "checkpoint the run started from for the rest")
    for name, value in saved.items():
        params[name].copy_(value)
    return model
