"""Frozen-tower feature cache (counterpart of ``sprc_tpu/train/feature_cache.py``).

The recipe's train transform is deterministic (targetpad, no augmentation)
and the tower is frozen and in eval mode, so ``encode_tower(image)`` is the
same every epoch. One pass over the split's unique images (kernel K2 on the
card) then replaces both tower calls of every step: the step becomes the
Q-Former's forward and backward (``model.forward_cached``), with the same
losses. The rows are the tower's output before ``ln_vision``, which trains.

Files are the JAX package's: ``<path>.npz`` holding ``rows`` (bf16 stored as
its uint16 bits) and ``<path>.names.json`` with the names and the dtype, so
either package reads what the other wrote.
"""

from __future__ import annotations

import json
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np
import torch

Tensor = torch.Tensor


class FeatureCache:
    """name -> tower-feature row ``[S, D]``, kept on the host."""

    def __init__(self, names: Sequence[str], rows: Tensor):
        if len(names) != rows.shape[0]:
            raise ValueError(f"{len(names)} names vs {rows.shape[0]} rows")
        self.names: List[str] = list(names)
        self.rows = rows  # [N, S, D] bf16 or fp32, CPU
        self._index: Dict[str, int] = {n: i for i, n in enumerate(self.names)}

    def __len__(self) -> int:
        return len(self.names)

    def gather(self, names: Sequence[str]) -> Tensor:
        """Rows of ``names`` -> ``[B, S, D]`` (KeyError on a name not held)."""
        return self.rows[torch.as_tensor([self._index[n] for n in names], dtype=torch.long)]

    def save(self, path: str) -> None:
        """Write ``<path>.npz`` and ``<path>.names.json``."""
        if self.rows.dtype == torch.bfloat16:
            payload, stored = self.rows.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        else:
            payload = self.rows.numpy()
            stored = str(payload.dtype)
        np.savez(path, rows=payload)
        with open(path + ".names.json", "w") as f:
            json.dump({"names": self.names, "dtype": stored}, f)

    @classmethod
    def load(cls, path: str, mmap: bool = False) -> "FeatureCache":
        """Read a :meth:`save` file; with ``mmap`` the rows stay in the file
        (copy-on-write pages, which processes reading one file share)."""
        with open(path + ".names.json") as f:
            meta = json.load(f)
        npz = path if path.endswith(".npz") else path + ".npz"
        rows = npz_memmap(npz, "rows") if mmap else np.load(npz)["rows"]
        if meta["dtype"] == "bfloat16":
            return cls(meta["names"], torch.from_numpy(rows.view(np.int16)).view(torch.bfloat16))
        return cls(meta["names"], torch.from_numpy(rows))


def npz_memmap(path: str, key: str, mode: str = "c") -> np.ndarray:
    """Array ``key`` of an uncompressed ``.npz`` (``np.savez``'s) mapped from
    the file, without reading it: the member's offset from its zip header,
    the array's from its ``.npy`` header."""
    import zipfile

    with zipfile.ZipFile(path) as zf:
        info = zf.getinfo(key + ".npy")
        if info.compress_type != zipfile.ZIP_STORED:
            raise ValueError(f"{path}: {key} is compressed; it cannot be mapped")
        with zf.open(info) as member:
            version = np.lib.format.read_magic(member)
            read = {(1, 0): np.lib.format.read_array_header_1_0,
                    (2, 0): np.lib.format.read_array_header_2_0}[version]
            shape, fortran, dtype = read(member)
            header = member.tell()
    with open(path, "rb") as f:
        f.seek(info.header_offset)
        local = f.read(30)
    start = (info.header_offset + 30 + int.from_bytes(local[26:28], "little")
             + int.from_bytes(local[28:30], "little"))
    return np.memmap(path, dtype=dtype, mode=mode, offset=start + header, shape=shape,
                     order="F" if fortran else "C")


def build_feature_cache(model, batches: Iterable[Tuple[Sequence[str], np.ndarray]]
                        ) -> FeatureCache:
    """One ``encode_tower`` pass over ``(names, images [B, H, W, 3])`` batches
    (float32 arrays or tensors), on the model's device; a name seen before keeps its first row.
    Rows go to the host in bf16 (the JAX build's default)."""
    device = next(model.parameters()).device
    names: List[str] = []
    seen = set()
    chunks: List[Tensor] = []
    with torch.no_grad():
        for batch_names, images in batches:
            imgs = torch.as_tensor(images, dtype=torch.float32, device=device)
            rows = model.encode_tower(imgs).to(torch.bfloat16).cpu()
            keep = [i for i, n in enumerate(batch_names) if n not in seen]
            for i in keep:
                seen.add(batch_names[i])
                names.append(batch_names[i])
            if keep:
                chunks.append(rows[keep])
    if not chunks:
        raise ValueError("empty feature-cache build stream")
    return FeatureCache(names, torch.cat(chunks))
