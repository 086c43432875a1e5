"""Determinism checks (counterpart of ``sprc_tpu/utils/determinism.py``).

:func:`tree_fingerprint` hashes a nested structure of tensors and arrays,
order-stable, so that two runs (or two hosts) can be compared by one
string; :func:`assert_deterministic` runs a function several times and
raises where the outputs differ in any bit. A CUDA reduction whose order
depends on the schedule (``index_add_``, some atomics) shows up here.
"""

from __future__ import annotations

import hashlib
from typing import Any, Callable

import numpy as np
import torch


def _walk(tree: Any, h) -> None:
    if isinstance(tree, dict):
        h.update(b"{")
        for key in sorted(tree, key=str):
            h.update(repr(key).encode())
            _walk(tree[key], h)
        h.update(b"}")
    elif isinstance(tree, (list, tuple)):
        h.update(b"[" if isinstance(tree, list) else b"(")
        for leaf in tree:
            _walk(leaf, h)
        h.update(b"]")
    else:
        if torch.is_tensor(tree):
            tree = tree.detach().cpu()
            # bfloat16 has no numpy type: hash its bits as int16
            arr = (tree.view(torch.int16) if tree.dtype == torch.bfloat16 else tree).numpy()
            dtype = str(tree.dtype)
        else:
            arr = np.asarray(tree)
            dtype = str(arr.dtype)
        h.update(dtype.encode())
        h.update(str(tuple(arr.shape)).encode())
        h.update(np.ascontiguousarray(arr).tobytes())


def tree_fingerprint(tree: Any) -> str:
    """SHA-256 over a nested structure of dicts (keys sorted), lists, tuples
    and leaves (tensors, arrays, scalars): each leaf's dtype, shape and
    bytes."""
    h = hashlib.sha256()
    _walk(tree, h)
    return h.hexdigest()


def assert_deterministic(fn: Callable, *args: Any, runs: int = 2, **kwargs: Any) -> str:
    """Run ``fn`` ``runs`` times; raise if the outputs differ in any bit.
    Returns the common fingerprint."""
    prints = [tree_fingerprint(fn(*args, **kwargs)) for _ in range(runs)]
    if len(set(prints)) != 1:
        raise AssertionError(f"non-deterministic outputs: fingerprints {prints}")
    return prints[0]
