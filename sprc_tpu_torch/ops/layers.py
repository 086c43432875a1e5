"""Core building blocks with the JAX package's dtype policy.

LayerNorm computes in fp32 whatever the input dtype and casts back to the
input dtype (the "fp16-safe LayerNorm" bridge, reference blip2.py:193-199);
parameters are fp32 and named ``weight`` / ``bias`` as in ``torch.nn``.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Iterator, Optional

import torch
import torch.utils.checkpoint
from torch import nn

from sprc_tpu_torch.ops import quant
from sprc_tpu_torch.ops.primitives import gemm_plain, layer_norm_plain, quick_gelu

__all__ = ["Linear", "LayerNormFP32", "quick_gelu", "l2_normalize", "dropout", "recompute",
           "recomputing"]


class Linear(nn.Module):
    """``y = x W^T + b`` with ``weight [out, in]`` in the compute dtype and
    an fp32 ``bias`` (or none) (``torch.nn.Linear`` names; parameters start
    uninitialised, the loader fills them). With ``int8`` it also holds the
    weight's int8 codes and per-channel scales, derived from the fp32 source
    at load time (:mod:`sprc_tpu_torch.ops.quant`); the state-dict keys are
    the same either way."""

    def __init__(self, in_features: int, out_features: int, dtype=torch.float32,
                 int8: bool = False, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features, dtype=dtype))
        self.bias = nn.Parameter(torch.empty(out_features)) if bias else None
        if int8:
            quant.register_int8_weights(self, {"weight": "weight"})

    def _load_from_state_dict(self, state_dict, prefix, *args):
        quant.load_int8_weights(self, state_dict, prefix)
        super()._load_from_state_dict(state_dict, prefix, *args)

    def int8_params(self):
        """``(codes [out, in], scale [out], bias)`` for the int8 dense kernels."""
        return (*quant.int8_weight(self, "weight"), self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return gemm_plain(x.to(self.weight.dtype), self.weight, self.bias)


class LayerNormFP32(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm_plain(x, self.weight, self.bias, self.eps)


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """torch.nn.functional.normalize semantics in fp32: x / max(||x||, eps)."""
    x32 = x.float()
    norm = torch.linalg.vector_norm(x32, dim=dim, keepdim=True)
    return (x32 / norm.clamp_min(eps)).to(x.dtype)


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Flax's ``nn.Dropout`` outside ``deterministic``: keep each element with
    probability ``1 - rate`` and scale it by ``1 / (1 - rate)``. The mask is
    drawn from ``generator`` (``torch.rand``; ``F.dropout`` takes none), so a
    trainer that owns the generator repeats its masks."""
    if rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


_RECOMPUTE = contextvars.ContextVar("recompute", default=False)


@contextlib.contextmanager
def recomputing() -> Iterator[None]:
    """Inside this context :func:`recompute` keeps only its pieces' inputs
    for the backward. The variants' largest passes with a gradient (the
    hard-negative ITM's 384 items at batch 128) run in it, so that they fit
    on one card; every other pass keeps its intermediates and saves the
    second run."""
    token = _RECOMPUTE.set(True)
    try:
        yield
    finally:
        _RECOMPUTE.reset(token)


def recompute(fn, *args, always: bool = False,
              generator: Optional[torch.Generator] = None):
    """``fn(*args)``; inside :func:`recomputing`, or with ``always``, while
    autograd records, it keeps only its inputs for the backward, which runs
    ``fn`` again (``torch.utils.checkpoint``, non-reentrant): the same values
    and gradients bit for bit, with fewer activations held.

    Inside :func:`recomputing` it serves pieces that draw no random numbers
    (the training Q-Former's softmax attention, GELUs and LayerNorms, whose
    intermediates are several times their inputs). ``always`` serves the
    ``remat`` options (a tower block, a Q-Former layer, the JAX package's
    ``nn.remat``): the pieces inside ``fn`` then run with
    :func:`recomputing` off, in the forward and in the recompute alike, so
    that both runs take one path. The recompute runs in the context the
    forward ran in (the backward may run on another thread), so it takes the
    forward's path. ``fn`` may draw dropout masks from
    ``generator``: the recompute starts from the state the generator had at
    the forward call and leaves it as it found it, so it draws the same masks
    (without a generator, the default generators' states are kept)."""
    if not ((always or _RECOMPUTE.get()) and torch.is_grad_enabled()):
        return fn(*args)
    # the recompute runs in the forward's context (primitives.plain_reference,
    # stage_check, recomputing): the backward may run on another thread (the
    # card's autograd thread), which starts without it
    context = contextvars.copy_context()
    if always:
        context.run(_RECOMPUTE.set, False)
    start = None if generator is None else generator.get_state()
    calls = []

    def run(*a):
        later = None
        if calls and generator is not None:  # the recompute: the forward's masks
            later = generator.get_state()
            generator.set_state(start)
        calls.append(1)
        try:
            return context.run(fn, *a)
        finally:
            if later is not None:
                generator.set_state(later)

    return torch.utils.checkpoint.checkpoint(run, *args, use_reentrant=False,
                                             preserve_rng_state=always and generator is None)
