"""Failure panels of a composed-retrieval evaluation (counterpart of
``sprc_tpu/retrieval/visualize.py``; reference src/validate_blip.py:59-147,
validate_blip_rerank.py:250-276): for each query a predicate selects, one
PNG of ``[reference | top-k retrieved | target]`` with the target's rank and
the caption written under it. numpy and PIL only.
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Sequence

import numpy as np


def _load(path: str, size: int):
    import PIL.Image

    return PIL.Image.open(path).convert("RGB").resize((size, size))


def save_failure_panels(output_dir: str, sorted_names: np.ndarray,
                        reference_names: Sequence[str], target_names: Sequence[str],
                        captions: Sequence[str], name_to_path: Callable[[str], str], *,
                        top_k: int = 5, panel_size: int = 224,
                        predicate: Optional[Callable[[int, np.ndarray], bool]] = None,
                        max_panels: int = 50) -> int:
    """Write a panel for each query ``predicate(i, row_labels)`` selects
    (default: the target outside the top 10, the reference's
    vis_fiq_failure2 criterion), at most ``max_panels``; returns how many."""
    import PIL.Image
    import PIL.ImageDraw

    os.makedirs(output_dir, exist_ok=True)
    labels = np.asarray(sorted_names) == np.asarray(target_names)[:, None]
    if predicate is None:
        predicate = lambda i, row: row[:10].sum() < 1  # noqa: E731
    written = 0
    for i in range(len(captions)):
        if written >= max_panels or not predicate(i, labels[i]):
            continue
        names = [reference_names[i], *sorted_names[i][:top_k], target_names[i]]
        tiles = [_load(name_to_path(n), panel_size) for n in names]
        panel = PIL.Image.new("RGB", (panel_size * len(tiles), panel_size + 28), (255, 255, 255))
        for j, tile in enumerate(tiles):
            panel.paste(tile, (j * panel_size, 0))
        rank = int(np.argmax(labels[i])) + 1 if labels[i].any() else -1
        PIL.ImageDraw.Draw(panel).text((4, panel_size + 6), f"rank={rank}  {captions[i][:180]}",
                                       fill=(0, 0, 0))
        panel.save(os.path.join(output_dir, f"{written:04d}_q{i}.png"))
        written += 1
    return written
