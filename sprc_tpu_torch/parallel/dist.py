"""Rank helpers (counterpart of ``sprc_tpu/parallel/dist.py``, the
reference's dist_utils: rank helpers, the ``main_process`` decorator :107-114,
download-then-barrier :117-137).

The JAX package's "process" is a host; the port's is a device (one process
per card, as ``torchrun`` starts them), and rank 0 is the main process.
Without a process group every helper behaves as at world 1, as the JAX ones
do at ``process_count() == 1``.
"""

from __future__ import annotations

import functools
from typing import Any, Callable

import torch.distributed as torch_dist


def is_dist_avail_and_initialized() -> bool:
    return torch_dist.is_available() and torch_dist.is_initialized()


def get_rank() -> int:
    return torch_dist.get_rank() if is_dist_avail_and_initialized() else 0


def get_world_size() -> int:
    return torch_dist.get_world_size() if is_dist_avail_and_initialized() else 1


def is_main_process() -> bool:
    return get_rank() == 0


def main_process(func: Callable) -> Callable:
    """Run only on rank 0 (reference :107-114); the others get None."""

    @functools.wraps(func)
    def wrapper(*args: Any, **kwargs: Any):
        if is_main_process():
            return func(*args, **kwargs)
        return None

    return wrapper


def barrier() -> None:
    """Every rank waits for the others (``dist.barrier``)."""
    if is_dist_avail_and_initialized():
        torch_dist.barrier()


def broadcast_from_main(obj):
    """Rank 0's value (any picklable object) on every rank."""
    if not is_dist_avail_and_initialized():
        return obj
    box = [obj]
    torch_dist.broadcast_object_list(box, src=0)
    return box[0]


def main_process_first(func: Callable) -> Callable:
    """Rank 0 runs first (e.g. writes a cache), the others after a barrier."""

    @functools.wraps(func)
    def wrapper(*args: Any, **kwargs: Any):
        if is_main_process():
            result = func(*args, **kwargs)
            barrier()
            return result
        barrier()
        return func(*args, **kwargs)

    return wrapper
