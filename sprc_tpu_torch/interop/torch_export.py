"""The port's weights in the reference's checkpoint layout (counterpart of
``sprc_tpu/interop/torch_export.py``).

The port's modules carry the reference's tensor names, so the export is the
model's state dict itself: every tensor as contiguous fp32 on the host (the
``position_ids`` buffers too, as the JAX export writes them), under the
model's class name, which is the JAX model's, so that
``torch.load(path)[ClassName]`` reads it as the reference reads a
checkpoint (src/blip_validate.py:107-109).
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn


def reference_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """Every tensor of ``model.state_dict()`` as contiguous fp32 on the host."""
    return {k: v.detach().to("cpu", torch.float32).contiguous()
            for k, v in model.state_dict().items()}


def export_reference_file(model: nn.Module, path: str) -> Dict[str, torch.Tensor]:
    """Write ``{ClassName: reference_state_dict(model)}`` to ``path``; returns
    the state dict."""
    sd = reference_state_dict(model)
    torch.save({type(model).__name__: sd}, path)
    return sd
