"""Flat, one-vector-an-image CLIP gallery helpers (counterpart of
``sprc_tpu/retrieval/clip_index.py``; reference src/utils.py:20-43
``extract_index_features`` and :107-114 ``element_wise_sum``, the CLIP4Cir
combiner baseline's).

A CLIP index holds one feature an image, where the BLIP-2 index holds 32
token features and the frozen tower rows; a query is fused by
:func:`element_wise_sum` and scored by one product with the gallery.
"""

from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

import numpy as np
import torch

from sprc_tpu_torch.ops.layers import l2_normalize


def element_wise_sum(image_features: torch.Tensor, text_features: torch.Tensor) -> torch.Tensor:
    """The L2-normalised sum of two (unnormalised) features
    (``F.normalize(image + text, dim=-1)``)."""
    return l2_normalize(image_features + text_features)


def extract_clip_index_features(batches: Iterable[Tuple[Sequence[str], np.ndarray]], model, *,
                                encode_batch: int = 32, normalize: bool = False
                                ) -> Tuple[np.ndarray, List[str]]:
    """A gallery stream of ``(names, images [b, H, W, 3] float32)`` (the
    stream ``RetrievalEngine.build_index`` takes) -> ``(features [N, D]
    float32, names)``: ``model.encode_image`` over ``encode_batch`` images a
    call (a larger batch is split, a smaller one goes as it is; the JAX
    function pads it to one compiled shape, which changes no row). The
    features stay unnormalised (``element_wise_sum`` normalises once) unless
    ``normalize``."""
    device = next(model.parameters()).device
    names: List[str] = []
    parts: List[np.ndarray] = []
    with torch.inference_mode():
        for batch_names, images in batches:
            for s in range(0, images.shape[0], encode_batch):
                chunk = torch.from_numpy(np.ascontiguousarray(
                    images[s: s + encode_batch], np.float32)).to(device)
                feats = model.encode_image(chunk).float()
                if normalize:
                    feats = l2_normalize(feats)
                parts.append(feats.cpu().numpy())
            names.extend(batch_names)
    if not parts:
        return np.zeros((0, getattr(model.cfg, "embed_dim", 0)), np.float32), names
    return np.concatenate(parts, axis=0), names
