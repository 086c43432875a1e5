"""ctypes binding of the port's native data-plane (decode + preprocess).

The counterpart of ``sprc_tpu/data/native.py``, with the same functions and
signatures. :class:`NativeTransform` is the native equivalent of the PIL
``HostTransform``: it takes *file paths or encoded bytes* and decodes and
preprocesses them in C++ (libjpeg / libpng and PIL-compatible bicubic, see
``sprc_tpu_torch/native/dataplane.cpp``). The library is built at first use
(``sprc_tpu_torch/native/build.py``); a failed build raises, there is no
fallback to PIL.
"""

from __future__ import annotations

import ctypes
import os
from typing import List, Optional, Sequence, Union

import numpy as np

_LIB = None


def load_library():
    global _LIB
    if _LIB is None:
        from sprc_tpu_torch.native.build import build

        lib = ctypes.CDLL(str(build()))
        u8p, size_t, i32p = ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t, ctypes.POINTER(ctypes.c_int)
        lib.sprc_decode_dims.argtypes = [u8p, size_t, i32p, i32p]
        lib.sprc_decode.argtypes = [u8p, size_t, u8p, size_t]
        lib.sprc_preprocess.argtypes = [u8p, size_t, ctypes.c_int, ctypes.c_double, ctypes.c_int,
                                        ctypes.POINTER(ctypes.c_float)]
        lib.sprc_preprocess_batch.argtypes = [
            u8p, ctypes.POINTER(ctypes.c_size_t), ctypes.c_int, ctypes.c_int, ctypes.c_double,
            ctypes.c_int, ctypes.POINTER(ctypes.c_float), u8p, ctypes.c_int]
        for fn in (lib.sprc_decode_dims, lib.sprc_decode, lib.sprc_preprocess,
                   lib.sprc_preprocess_batch):
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def decode(data: bytes) -> np.ndarray:
    """Encoded JPEG/PNG bytes -> uint8 RGB [H, W, 3]."""
    lib = load_library()
    w = ctypes.c_int()
    h = ctypes.c_int()
    buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
    if lib.sprc_decode_dims(buf, len(data), ctypes.byref(w), ctypes.byref(h)) != 0:
        raise ValueError("undecodable image")
    out = np.empty((h.value, w.value, 3), np.uint8)
    rc = lib.sprc_decode(
        buf, len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), out.size
    )
    if rc < 0:
        raise ValueError(f"decode failed ({rc})")
    return out


class NativeTransform:
    """Native equivalent of targetpad/squarepad_transform over encoded bytes."""

    def __init__(self, dim: int, pad: str = "target", target_ratio: float = 1.25,
                 num_threads: Optional[int] = None):
        self.dim = dim
        self.pad = pad
        self.target_ratio = target_ratio
        self.num_threads = num_threads or max(1, (os.cpu_count() or 1))
        load_library()

    def __call__(self, source: Union[str, bytes]) -> np.ndarray:
        data = _read(source)
        lib = load_library()
        out = np.empty((self.dim, self.dim, 3), np.float32)
        buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
        rc = lib.sprc_preprocess(
            buf, len(data), self.dim, ctypes.c_double(self.target_ratio),
            1 if self.pad == "target" else 0,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        if rc != 0:
            raise ValueError(f"preprocess failed ({rc})")
        return out

    def batch(self, sources: Sequence[Union[str, bytes]]) -> tuple[np.ndarray, np.ndarray]:
        """-> (images [N, dim, dim, 3] float32, ok [N] bool); an undecodable
        input gives a zero image and ``ok`` False."""
        lib = load_library()
        blobs: List[bytes] = [_read(s) for s in sources]
        offsets = np.zeros(len(blobs) + 1, np.uintp)
        for i, b in enumerate(blobs):
            offsets[i + 1] = offsets[i] + len(b)
        blob = b"".join(blobs)
        out = np.empty((len(blobs), self.dim, self.dim, 3), np.float32)
        ok = np.zeros(len(blobs), np.uint8)
        buf = (ctypes.c_uint8 * len(blob)).from_buffer_copy(blob)
        lib.sprc_preprocess_batch(
            buf,
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_size_t)),
            len(blobs),
            self.dim,
            ctypes.c_double(self.target_ratio),
            1 if self.pad == "target" else 0,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ok.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            self.num_threads,
        )
        return out, ok.astype(bool)


def _read(source: Union[str, bytes]) -> bytes:
    if isinstance(source, (bytes, bytearray)):
        return bytes(source)
    with open(source, "rb") as f:
        return f.read()
