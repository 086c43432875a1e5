"""ALPRO's video processors (counterpart of ``sprc_tpu/data/video_processors.py``;
reference lavis/processors/alpro_processors.py).

Clips are numpy ``[T, H, W, 3]`` float32 end to end, the layout
:class:`sprc_tpu_torch.models.timesformer.TimeSformer` takes (batched to
``[B, T, H, W, 3]``):

- ``alpro_video_train`` (alpro_processors.py:81-167): one RandomResizedCrop
  window for the whole clip (bicubic), one horizontal flip for the whole
  clip, and VideoRandomAugment(2, 5): one sequence of two ops of BLIP's
  RandAugment list and their draws for the clip, replayed on every frame;
  then the CLIP normalisation. Its ``RandomState`` is consumed in the JAX
  processor's order (the crop, the flip, the ops, their draws), so a
  processor seeded alike gives the JAX package's clips;
- ``alpro_video_eval`` (alpro_processors.py:170-219): a bilinear resize to
  (size, size) and the normalisation.

Frames are sampled ("uniform") when a clip is loaded
(:func:`sprc_tpu_torch.data.builders._load_video`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from sprc_tpu_torch.data.processors import (
    BLIP_AUGS,
    CLIP_MEAN,
    CLIP_STD,
    _apply_aug,
    _pil,
)
from sprc_tpu_torch.registry import registry


def _to_frames(clip) -> np.ndarray:
    """Accept [T,H,W,3] float [0,1] / uint8 arrays (builders' output) or a
    list of PIL images; return uint8 [T,H,W,3]."""
    if isinstance(clip, (list, tuple)):
        clip = np.stack([np.asarray(f.convert("RGB")) for f in clip])
    clip = np.asarray(clip)
    if clip.dtype != np.uint8:
        clip = (np.clip(clip, 0.0, 1.0) * 255).round().astype(np.uint8)
    if clip.ndim != 4 or clip.shape[-1] != 3:
        raise ValueError(f"expected [T,H,W,3] clip, got {clip.shape}")
    return clip


def _normalize_clip(frames: np.ndarray, mean, std) -> np.ndarray:
    arr = frames.astype(np.float32) / 255.0
    return (arr - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


@dataclasses.dataclass
class AlproVideoTrainProcessor:
    """RandomResizedCrop(clip-consistent) + flip + VideoRandAugment + norm."""

    image_size: int = 256
    min_scale: float = 0.5
    max_scale: float = 1.0
    n_frms: int = 8
    mean: Sequence[float] = CLIP_MEAN
    std: Sequence[float] = CLIP_STD
    seed: Optional[int] = None

    def __post_init__(self):
        self.rng = np.random.RandomState(self.seed)

    def _crop_window(self, w: int, h: int):
        """torchvision RandomResizedCrop sampling, shared by all frames."""
        area = w * h
        for _ in range(10):
            target_area = area * self.rng.uniform(self.min_scale, self.max_scale)
            log_ratio = np.log(np.asarray((3 / 4, 4 / 3)))
            aspect = np.exp(self.rng.uniform(log_ratio[0], log_ratio[1]))
            cw = int(round(np.sqrt(target_area * aspect)))
            ch = int(round(np.sqrt(target_area / aspect)))
            if 0 < cw <= w and 0 < ch <= h:
                left = self.rng.randint(0, w - cw + 1)
                top = self.rng.randint(0, h - ch + 1)
                return left, top, cw, ch
        side = min(w, h)
        return (w - side) // 2, (h - side) // 2, side, side

    def __call__(self, clip) -> np.ndarray:
        Image = _pil()
        frames = _to_frames(clip)
        T, H, W, _ = frames.shape
        left, top, cw, ch = self._crop_window(W, H)
        flip = self.rng.rand() < 0.5
        # ONE op sequence per clip (VideoRandomAugment): ops AND their random
        # draws (magnitude signs) are fixed per clip, identical across frames
        ops = [str(o) for o in self.rng.choice(list(BLIP_AUGS), size=2, replace=True)]
        draws = [float(self.rng.rand()) for _ in ops]

        class _Fixed:  # replays the per-op draw for every frame
            def __init__(self, val):
                self.val = val

            def rand(self):
                return self.val

        op_rngs = [_Fixed(d) for d in draws]
        out = np.empty((T, self.image_size, self.image_size, 3), np.float32)
        for t in range(T):
            img = Image.fromarray(frames[t])
            img = img.crop((left, top, left + cw, top + ch)).resize(
                (self.image_size, self.image_size), Image.BICUBIC
            )
            if flip:
                img = img.transpose(Image.FLIP_LEFT_RIGHT)
            for op, op_rng in zip(ops, op_rngs):
                img = _apply_aug(img, op, 5.0, op_rng)
            out[t] = _normalize_clip(np.asarray(img.convert("RGB")), self.mean, self.std)
        return out


@dataclasses.dataclass
class AlproVideoEvalProcessor:
    """Resize (size, size) + normalize (alpro_processors.py:170-219)."""

    image_size: int = 256
    n_frms: int = 8
    mean: Sequence[float] = CLIP_MEAN
    std: Sequence[float] = CLIP_STD

    def __call__(self, clip) -> np.ndarray:
        Image = _pil()
        frames = _to_frames(clip)
        T = frames.shape[0]
        out = np.empty((T, self.image_size, self.image_size, 3), np.float32)
        for t in range(T):
            img = Image.fromarray(frames[t]).resize(
                (self.image_size, self.image_size), Image.BILINEAR
            )
            out[t] = _normalize_clip(np.asarray(img.convert("RGB")), self.mean, self.std)
        return out


registry.register_processor("alpro_video_train")(AlproVideoTrainProcessor)
registry.register_processor("alpro_video_eval")(AlproVideoEvalProcessor)
