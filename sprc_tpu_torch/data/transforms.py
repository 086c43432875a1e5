"""Host image preprocessing: TargetPad or SquarePad -> bicubic resize ->
center crop -> normalize (CLIP statistics).

The PIL-exact host path of ``sprc_tpu/data/transforms.py`` (reference
src/data_utils.py:49-105), framework-free and copied so that the port
imports nothing of ``sprc_tpu``; tests/test_torch_inputs.py pins its pixels
equal to the original's. PIL is imported only when a transform runs. Output
is NHWC float32, as the port's models take it. The device path
(``device_preprocess``) is not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def _pil():
    import PIL.Image

    return PIL.Image


def _target_pad(image, target_ratio: float):
    """Pad to the target aspect ratio if the image is too elongated
    (reference data_utils.py:49-72)."""
    w, h = image.size
    actual_ratio = max(w, h) / min(w, h)
    if actual_ratio < target_ratio:
        return image
    scaled_max_wh = max(w, h) / target_ratio
    hp = max(int((scaled_max_wh - w) / 2), 0)
    vp = max(int((scaled_max_wh - h) / 2), 0)
    return _pad_pil(image, hp, vp)


def _square_pad(image):
    w, h = image.size
    max_wh = max(w, h)
    hp = int((max_wh - w) / 2)
    vp = int((max_wh - h) / 2)
    return _pad_pil(image, hp, vp)


def _pad_pil(image, hp: int, vp: int):
    """Zero-pad left/right by hp and top/bottom by vp (F.pad semantics)."""
    PIL = _pil()
    if hp == 0 and vp == 0:
        return image
    mode = image.mode
    new = PIL.new(mode, (image.size[0] + 2 * hp, image.size[1] + 2 * vp), 0)
    new.paste(image, (hp, vp))
    return new


def _resize_shorter(image, dim: int):
    """torchvision Resize(dim) semantics: shorter side -> dim, keep aspect."""
    PIL = _pil()
    w, h = image.size
    if w <= h:
        nw, nh = dim, max(1, round(h * dim / w))
    else:
        nw, nh = max(1, round(w * dim / h)), dim
    return image.resize((nw, nh), PIL.BICUBIC)


def _center_crop(image, dim: int):
    w, h = image.size
    left = int(round((w - dim) / 2.0))
    top = int(round((h - dim) / 2.0))
    return image.crop((left, top, left + dim, top + dim))


def _finalize(image, dim: int) -> np.ndarray:
    image = image.convert("RGB")
    arr = np.asarray(image, dtype=np.float32) / 255.0  # HWC
    arr = (arr - np.asarray(CLIP_MEAN, np.float32)) / np.asarray(CLIP_STD, np.float32)
    return arr


@dataclasses.dataclass
class HostTransform:
    """Picklable host-side preprocess: PIL image -> float32 [H, W, 3]."""

    dim: int
    pad: str = "target"  # "target" | "square" | "none"
    target_ratio: float = 1.25

    def __call__(self, image) -> np.ndarray:
        if self.pad == "target":
            image = _target_pad(image, self.target_ratio)
        elif self.pad == "square":
            image = _square_pad(image)
        image = _resize_shorter(image, self.dim)
        image = _center_crop(image, self.dim)
        return _finalize(image, self.dim)


def targetpad_transform(target_ratio: float, dim: int) -> HostTransform:
    return HostTransform(dim=dim, pad="target", target_ratio=target_ratio)


def squarepad_transform(dim: int) -> HostTransform:
    return HostTransform(dim=dim, pad="square")
