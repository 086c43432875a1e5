"""Offline BERT vocab resolution (counterpart of ``sprc_tpu/utils/artifacts.py``).

Resolution order:

1. an explicit ``--vocab-path`` / argument,
2. the local cache (``$SPRC_CACHE or ~/.cache/sprc_tpu``, shared with
   ``sprc_tpu``).

The port never downloads: place bert-base-uncased's vocab.txt in the cache
or pass its path. :func:`write_synthetic_bert_vocab` writes a mechanically
valid WordPiece vocab (specials + ascii chars + ##suffixes) for smoke runs;
it is NOT the real bert-base-uncased vocab, never for real checkpoints.
:func:`synthetic_calibration_images` is the same kind of stand-in for the
int8 tower's calibration set.
"""

from __future__ import annotations

import os
import string
from typing import Optional


def cache_dir() -> str:
    root = os.environ.get(
        "SPRC_CACHE", os.path.join(os.path.expanduser("~"), ".cache", "sprc_tpu")
    )
    os.makedirs(root, exist_ok=True)
    return root


def write_synthetic_bert_vocab(path: str, *, size: int = 30522) -> str:
    """A structurally valid WordPiece vocab: specials, printable chars,
    ##-continuations, and numbered filler pieces up to ``size`` (the real
    bert-base-uncased layout: PAD=0, UNK=100, CLS=101, SEP=102, MASK=103)."""
    rows = ["[PAD]"]
    rows += [f"[unused{i}]" for i in range(99)]
    rows += ["[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    chars = list(string.ascii_lowercase + string.digits + string.punctuation)
    rows += chars
    rows += [f"##{c}" for c in chars]
    i = 0
    while len(rows) < size:
        rows.append(f"tok{i}")
        i += 1
    with open(path, "w") as f:
        f.write("\n".join(rows[:size]) + "\n")
    return path


def synthetic_calibration_images(seed: int, n: int = 16, size: int = 224):
    """The seeded stand-in for a calibration set: ``n`` images of normalised
    pixels [n, size, size, 3] float32, for smoke and profiling runs on random
    weights (one definition, so that every tool calibrates the same scales)."""
    import numpy as np

    return np.random.default_rng(seed).standard_normal((n, size, size, 3), dtype=np.float32)


def ensure_bert_vocab(path: Optional[str] = None) -> str:
    """Resolve a BERT vocab.txt per the module docstring's order."""
    if path:
        if os.path.exists(path):
            return path
        # an explicitly requested vocab must not silently fall through to a
        # cached one — wrong tokenization with no error
        raise FileNotFoundError(f"--vocab-path {path} does not exist")
    cached = os.path.join(cache_dir(), "bert-base-uncased-vocab.txt")
    if os.path.exists(cached):
        return cached
    raise FileNotFoundError(
        "No BERT vocab found. Pass --vocab-path, or copy bert-base-uncased's "
        f"vocab.txt into {cached}"
    )
