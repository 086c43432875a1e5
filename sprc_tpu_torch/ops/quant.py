"""Int8 quantisation of the frozen towers, serving only (counterpart of
``sprc_tpu/ops/quant.py``).

Per-output-channel symmetric scales for weights, dynamic per-token or
calibrated per-tensor symmetric scales for activations, an exact s8 x s8 ->
s32 product and an fp32 rescale. Weights are ``[out, in]`` (torch Linear),
so a weight's per-channel amax is over dim 1.

These are the plain PyTorch functions: the unfused dynamic-int8 ViT block
(``quant="int8"`` / ``"int8_calib"``, XLA ops in the JAX package) runs on
them, and the tests hold them bit-equal to the JAX functions. The served
int8 path runs the kernels of :mod:`.primitives` instead.

Each function divides or multiplies where its JAX counterpart does
(``x / scale`` against ``x * (1 / scale)``): the two round to different
codes at half steps. ``torch.round`` rounds half to even, as ``jnp.round``.

The int8 state of a module (codes and scales of its dense weights) is
derived, never stored: :func:`register_int8_weights` adds non-persistent
buffers, so the state-dict keys are the same in every mode, and
:func:`load_int8_weights` fills them inside ``load_state_dict`` from the
tensors of the state dict itself, before they are cast to the module's
compute dtype. Codes of a bf16 tower therefore come from the fp32 source,
as the JAX package quantises its fp32 parameters.
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple

import torch
from torch import nn

Tensor = torch.Tensor


def int_matmul_exact(a8: Tensor, w8: Tensor) -> Tensor:
    """a8 [.., K] int8 x w8 [N, K] int8 -> [.., N] int32, exact on any
    device: the sums reach 127 * 127 * K, past fp32's 2^24, and CUDA has no
    int32 matmul, so the product runs in float64 (exact to 2^53)."""
    return torch.matmul(a8.double(), w8.double().t()).to(torch.int32)


def quantize_weight(w: Tensor) -> Tuple[Tensor, Tensor]:
    """Per-output-channel symmetric int8: w [out, in] -> (int8 [out, in], scale [out])."""
    w32 = w.float()
    scale = w32.abs().amax(dim=1).clamp_min(1e-8) / 127.0
    w8 = torch.clamp(torch.round(w32 / scale[:, None]), -127, 127).to(torch.int8)
    return w8, scale


def quantize_act(x: Tensor) -> Tuple[Tensor, Tensor]:
    """Dynamic per-token symmetric int8: x [.., d] -> (int8, scale [.., 1])."""
    x32 = x.float()
    scale = x32.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) / 127.0
    x8 = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return x8, scale


def quantize_rows(x: Tensor) -> Tuple[Tensor, Tensor]:
    """Dynamic per-row int8 as the JAX Q-Former kernel computes it (the
    activation half of ``_mm_i8``): ``sc = max(amax, 1e-8) * (1 / 127)``, not
    :func:`quantize_act`'s ``/ 127``. x [.., d] -> (int8 [.., d], sc [..])."""
    x32 = x.float()
    sc = x32.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) * (1.0 / 127.0)
    x8 = torch.clamp(torch.round(x32 / sc), -127, 127).to(torch.int8)
    return x8, sc.squeeze(-1)


def quantize_static(x: Tensor, act_scale: float) -> Tensor:
    """Static per-tensor int8: clip(rint(x * (1 / act_scale)), -127, 127)
    (``_q8`` of the JAX block kernel and the first step of
    ``int8_dense_static``)."""
    return torch.clamp(torch.round(x.float() * (1.0 / act_scale)), -127, 127).to(torch.int8)


def int8_matmul(x: Tensor, w8: Tensor, w_scale: Tensor, bias: Optional[Tensor] = None,
                out_dtype: torch.dtype = torch.bfloat16) -> Tensor:
    """Quantise x per token, exact s8 x s8 -> s32, fp32 rescale.
    x [.., in]; w8 [out, in] int8; w_scale [out] fp32."""
    x8, x_scale = quantize_act(x)
    y = int_matmul_exact(x8, w8).float() * (x_scale * w_scale)
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype)


def int8_dense_from_fp(x: Tensor, w: Tensor, bias: Optional[Tensor] = None,
                       out_dtype: torch.dtype = torch.bfloat16) -> Tensor:
    """:func:`int8_matmul` quantising the fp weight ``[out, in]`` on the fly."""
    w8, w_scale = quantize_weight(w)
    return int8_matmul(x, w8, w_scale, bias, out_dtype)


def int8_dense_static(x: Tensor, w: Tensor, act_scale: float, bias: Optional[Tensor] = None,
                      out_dtype: torch.dtype = torch.bfloat16) -> Tensor:
    """Int8 matmul with a static per-tensor activation scale."""
    x8 = quantize_static(x, act_scale)
    w8, w_scale = quantize_weight(w)
    y = int_matmul_exact(x8, w8).float() * (act_scale * w_scale)
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype)


# ------------------------------------------------------ derived module state


def register_int8_weights(module: nn.Module, sources: Mapping[str, str]) -> None:
    """Give ``module`` the non-persistent buffers ``<name>_w8`` (int8
    [out, in]) and ``<name>_ws`` (fp32 [out]) for each ``name -> name of the
    weight parameter on the module``."""
    module.int8_sources = dict(sources)
    module.int8_loaded = set()
    for name, key in sources.items():
        w = module.get_parameter(key)
        module.register_buffer(f"{name}_w8", torch.empty(w.shape, dtype=torch.int8,
                                                         device=w.device), persistent=False)
        module.register_buffer(f"{name}_ws", torch.empty(w.shape[0], device=w.device),
                               persistent=False)


@torch.no_grad()
def set_int8_weight(module: nn.Module, name: str, w: Tensor) -> None:
    """Quantise the source tensor ``w`` (fp32 in a reference checkpoint or a
    seeded init) into the buffers of ``name``."""
    w8, ws = quantize_weight(w)
    getattr(module, f"{name}_w8").copy_(w8)
    getattr(module, f"{name}_ws").copy_(ws)
    module.int8_loaded.add(name)


def load_int8_weights(module: nn.Module, state_dict: Mapping[str, Tensor], prefix: str) -> None:
    """Inside ``module._load_from_state_dict``: quantise each source weight
    as the state dict holds it, before ``load_state_dict`` casts it to the
    module's compute dtype. A missing key is left to ``load_state_dict``'s
    own report."""
    for name, key in getattr(module, "int8_sources", {}).items():
        if prefix + key in state_dict:
            set_int8_weight(module, name, state_dict[prefix + key])


def int8_weight(module: nn.Module, name: str) -> Tuple[Tensor, Tensor]:
    """``(codes, scale)`` of one registered weight; raises if the weight did
    not arrive through ``load_state_dict`` or ``loader.init_weights``."""
    if name not in module.int8_loaded:
        raise RuntimeError(
            f"{type(module).__name__}.{module.int8_sources[name]}: the int8 codes are derived "
            "from the fp32 source in load_state_dict and loader.init_weights; this weight "
            "was set another way")
    return getattr(module, f"{name}_w8"), getattr(module, f"{name}_ws")
