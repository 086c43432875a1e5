"""Kernel K1: token-max similarity for retrieval scoring.

``token_max_sim(feats [B, E], targets [N, Q, E]) -> [B, N]``: for every
(query, gallery item) pair the max inner product over the item's Q query
tokens, in fp32 (reference ...cir_align_prompt.py:353-358).

Replaces ``sprc_tpu/ops/pallas_sim.py::token_max_sim_pallas`` and the
dispatch of ``sprc_tpu/ops/sim_kernels.py::token_max_sim``. The kernel
(``csrc/token_max_sim.cu``) is a persistent product on the tensor cores in
3xTF32 whose epilogue takes the max over each item's Q columns, so the
``[B, N, Q]`` product is never written: the query tile stays in registers,
the gallery's items stream once through a ring of shared-memory slots filled
by bulk copies, which bounds it by reading the gallery's ``N Q E`` floats
(``schedules.token_max_sim_plan`` is its plan). On CUDA it runs at every
gallery size, with 64-bit offsets; there is no size threshold and no
fallback. A NaN anywhere in ``feats[b]`` or ``targets[n]`` gives a NaN
score, as ``amax`` does.
"""

from __future__ import annotations

import torch

from sprc_tpu_torch.ops import _ext, primitives, schedules

Tensor = torch.Tensor


def token_max_sim_plain(feats: Tensor, targets: Tensor) -> Tensor:
    """The same function in plain PyTorch (fp32 einsum + max)."""
    sims = torch.einsum("be,nqe->bnq", feats.float(), targets.float())
    return sims.amax(dim=-1)


def _check_tensors(feats: Tensor, targets: Tensor) -> None:
    for t in (feats, targets):
        if not t.is_cuda or t.device != feats.device:
            raise ValueError("token_max_sim: feats and targets must be on one CUDA device")
        if t.dtype != torch.float32 or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("token_max_sim: the kernel takes contiguous, 16-byte aligned float32")


def _launch(feats: Tensor, targets: Tensor, out: Tensor) -> None:
    B, E = feats.shape
    N, Q, _ = targets.shape
    _ext.check(_ext.library().sprc_token_max_sim(
        feats.data_ptr(), targets.data_ptr(), out.data_ptr(), B, N, Q, E,
        torch.cuda.current_stream().cuda_stream), "token_max_sim")


def token_max_sim(feats: Tensor, targets: Tensor) -> Tensor:
    """feats [B, E] fp32, targets [N, Q, E] fp32 -> [B, N] fp32. On CUDA
    tensors it launches the kernel (what ``schedules.token_max_sim_plan``
    refuses, or anything but contiguous fp32 on one card, raises); on CPU
    tensors it runs the plain version."""
    primitives.check_no_grad("token_max_sim", feats, targets)
    if primitives.for_device(feats) is primitives.PLAIN:
        return token_max_sim_plain(feats, targets)
    B, E = feats.shape
    N, Q, E2 = targets.shape
    if E2 != E:
        raise ValueError(f"token_max_sim: feats {tuple(feats.shape)} and targets "
                         f"{tuple(targets.shape)} differ in depth")
    schedules.token_max_sim_plan(B, N, Q, E)
    _check_tensors(feats, targets)
    out = torch.empty((B, N), dtype=torch.float32, device=feats.device)
    _launch(feats, targets, out)
    token_max_sim.launches += 1
    return out


token_max_sim.launches = 0
