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
int8 tower's calibration set, :func:`synthetic_raw_batches` for the raw
(uint8) gallery encode, and :func:`encode_png` makes PNG bytes without
Pillow.
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


# true sizes (h, w) of the synthetic raw gallery, in turn: wide and tall
# images that targetpad pads, near-square ones that it does not, and images
# under 224 px that upsample
RAW_SIZE_KINDS = ("wide", "tall", "square", "small")


def synthetic_raw_batches(seed: int, n: int, batch: int, buffer: int = 320):
    """Seeded raw gallery batches ``(names, images_u8 [b, buffer, buffer, 3],
    sizes [b, 2] int32)``, the input of ``RetrievalEngine.build_index_raw``:
    image ``i`` is of kind ``RAW_SIZE_KINDS[i % 4]``, its true ``(h, w)``
    drawn inside the buffer (for a 320 buffer: the short side of wide and
    tall images 96 to 199, near-square sides 230 to 320 within a ratio of
    1.2, small images 40 to 199), its pixels seeded, the buffer zero beyond
    it (as a decoder fills a uniform buffer). The last batch is short when ``batch``
    does not divide ``n``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    for s in range(0, n, batch):
        b = min(batch, n - s)
        images = rng.integers(0, 256, (b, buffer, buffer, 3), dtype=np.uint8)
        sizes = np.empty((b, 2), np.int32)
        for j in range(b):
            kind = RAW_SIZE_KINDS[(s + j) % len(RAW_SIZE_KINDS)]
            if kind in ("wide", "tall"):
                short = int(rng.integers(buffer * 3 // 10, buffer * 5 // 8))
                long = int(rng.integers(int(short * 1.3) + 1, buffer + 1))
                h, w = (short, long) if kind == "wide" else (long, short)
            elif kind == "square":
                h = int(rng.integers(buffer * 18 // 25, buffer + 1))
                w = int(rng.integers(int(h / 1.2), min(buffer, int(h * 1.2)) + 1))
            else:
                h, w = (int(v) for v in rng.integers(buffer // 8, buffer * 5 // 8, 2))
            sizes[j] = (h, w)
            images[j, h:] = 0
            images[j, :, w:] = 0
        yield [f"raw{i:05d}" for i in range(s, s + b)], images, sizes


def encode_png(pixels) -> bytes:
    """uint8 RGB ``[H, W, 3]`` -> PNG bytes (8-bit truecolour, no filter),
    with zlib and struct only: a machine without Pillow can still make the
    native decoder's inputs."""
    import struct
    import zlib

    import numpy as np

    pixels = np.ascontiguousarray(pixels, dtype=np.uint8)
    h, w, c = pixels.shape
    if c != 3:
        raise ValueError(f"encode_png takes [H, W, 3] RGB, got {pixels.shape}")

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    rows = np.concatenate([np.zeros((h, 1), np.uint8), pixels.reshape(h, w * 3)], axis=1)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + chunk(b"IEND", b""))


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
