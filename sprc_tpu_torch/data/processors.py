"""Registry-keyed image processors of the BLIP family (counterpart of
``sprc_tpu/data/processors.py:38-197``; reference
src/lavis/processors/blip_processors.py).

- ``blip_image_train`` (:104-163): RandomResizedCrop (scale 0.5-1.0,
  bicubic) + horizontal flip + RandAugment (2 ops, magnitude 5, the BLIP op
  list) + normalize;
- ``blip2_image_train`` (:197-239): the same without RandAugment;
- ``blip_image_eval`` (:166-194): resize to (dim, dim) bicubic + normalize;
- ``blip_caption``: the port's :class:`~sprc_tpu_torch.text.processors.CaptionProcessor`;
- ``blip_question``: its :class:`~sprc_tpu_torch.text.processors.QuestionProcessor`;
- ``clip_image_train`` / ``clip_image_eval`` (:class:`ClipImageProcessor`):
  the shorter side resized, a centre crop, the normalisation.

Host-side (PIL + numpy), float32 HWC arrays out. Every random draw comes
from the processor's ``numpy.random.RandomState`` in the JAX package's order,
so a train processor seeded alike gives equal arrays in both packages
(``tests/test_torch_framework.py``). ALPRO's video processors
(``alpro_video_train``, ``alpro_video_eval``) live in :mod:`.video_processors`
and the GPT dialogue's (``gpt_dialogue``, ``gpt_video_ft``) in
:mod:`.gpt_processors`; both register when this module is imported.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from sprc_tpu_torch.registry import registry
from sprc_tpu_torch.text.processors import CaptionProcessor, QuestionProcessor

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def _pil():
    import PIL.Image

    return PIL.Image


def _normalize(image, mean=CLIP_MEAN, std=CLIP_STD) -> np.ndarray:
    arr = np.asarray(image.convert("RGB"), np.float32) / 255.0
    return (arr - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


def random_resized_crop(image, dim: int, rng, scale=(0.5, 1.0), ratio=(3 / 4, 4 / 3)):
    """torchvision RandomResizedCrop semantics (10 tries then center)."""
    PIL = _pil()
    w, h = image.size
    area = w * h
    for _ in range(10):
        target_area = area * rng.uniform(*scale)
        log_ratio = np.log(np.asarray(ratio))
        aspect = np.exp(rng.uniform(log_ratio[0], log_ratio[1]))
        cw = int(round(np.sqrt(target_area * aspect)))
        ch = int(round(np.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            left = rng.randint(0, w - cw + 1)
            top = rng.randint(0, h - ch + 1)
            crop = image.crop((left, top, left + cw, top + ch))
            return crop.resize((dim, dim), PIL.BICUBIC)
    # fallback: center crop of the constrained aspect
    in_ratio = w / h
    if in_ratio < ratio[0]:
        cw, ch = w, int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        cw, ch = int(round(h * ratio[1])), h
    else:
        cw, ch = w, h
    left, top = (w - cw) // 2, (h - ch) // 2
    return image.crop((left, top, left + cw, top + ch)).resize((dim, dim), PIL.BICUBIC)


# ------------------------------------------------------------- RandAugment

# the BLIP op list (blip_processors.py:130-142)
BLIP_AUGS = (
    "Identity", "AutoContrast", "Brightness", "Sharpness", "Equalize",
    "ShearX", "ShearY", "TranslateX", "TranslateY", "Rotate",
)


def _apply_aug(image, op: str, magnitude: float, rng):
    import PIL.Image
    import PIL.ImageEnhance
    import PIL.ImageOps

    level = magnitude / 10.0
    sign = 1 if rng.rand() < 0.5 else -1
    if op == "Identity":
        return image
    if op == "AutoContrast":
        return PIL.ImageOps.autocontrast(image)
    if op == "Equalize":
        return PIL.ImageOps.equalize(image)
    if op == "Brightness":
        return PIL.ImageEnhance.Brightness(image).enhance(1.0 + sign * 0.9 * level)
    if op == "Sharpness":
        return PIL.ImageEnhance.Sharpness(image).enhance(1.0 + sign * 0.9 * level)
    if op == "ShearX":
        return image.transform(
            image.size, PIL.Image.AFFINE, (1, sign * 0.3 * level, 0, 0, 1, 0)
        )
    if op == "ShearY":
        return image.transform(
            image.size, PIL.Image.AFFINE, (1, 0, 0, sign * 0.3 * level, 1, 0)
        )
    if op == "TranslateX":
        return image.transform(
            image.size, PIL.Image.AFFINE,
            (1, 0, sign * 0.3 * level * image.size[0], 0, 1, 0),
        )
    if op == "TranslateY":
        return image.transform(
            image.size, PIL.Image.AFFINE,
            (1, 0, 0, 0, 1, sign * 0.3 * level * image.size[1]),
        )
    if op == "Rotate":
        return image.rotate(sign * 30.0 * level)
    raise ValueError(f"unknown aug op {op}")


def rand_augment(image, rng, n_ops: int = 2, magnitude: float = 5.0,
                 ops: Sequence[str] = BLIP_AUGS):
    for op in rng.choice(list(ops), size=n_ops, replace=True):
        image = _apply_aug(image, str(op), magnitude, rng)
    return image


# ------------------------------------------------------------- processors


@dataclasses.dataclass
class BlipImageTrainProcessor:
    """RandomResizedCrop + flip + RandAugment + normalize (:104-163)."""

    image_size: int = 224
    min_scale: float = 0.5
    max_scale: float = 1.0
    use_randaug: bool = True
    seed: int = 0

    def __post_init__(self):
        self.rng = np.random.RandomState(self.seed)

    def __call__(self, image) -> np.ndarray:
        import PIL.Image

        image = image.convert("RGB")
        image = random_resized_crop(
            image, self.image_size, self.rng, scale=(self.min_scale, self.max_scale)
        )
        if self.rng.rand() < 0.5:
            image = image.transpose(PIL.Image.FLIP_LEFT_RIGHT)
        if self.use_randaug:
            image = rand_augment(image, self.rng)
        return _normalize(image)


@dataclasses.dataclass
class BlipImageEvalProcessor:
    """Resize to (dim, dim) bicubic + normalize (:166-194)."""

    image_size: int = 224

    def __call__(self, image) -> np.ndarray:
        PIL = _pil()
        image = image.convert("RGB").resize(
            (self.image_size, self.image_size), PIL.BICUBIC
        )
        return _normalize(image)


@dataclasses.dataclass
class ClipImageProcessor:
    """CLIP's shorter side resized to ``image_size`` (bicubic), a centre
    crop and the normalisation (``sprc_tpu/data/processors.py:170-182``): the
    same for training and evaluation, as in the JAX package."""

    image_size: int = 224

    def __call__(self, image) -> np.ndarray:
        from sprc_tpu_torch.data.transforms import _center_crop, _resize_shorter

        image = _resize_shorter(image.convert("RGB"), self.image_size)
        return _normalize(_center_crop(image, self.image_size))


registry.register_processor("blip_image_train")(BlipImageTrainProcessor)
registry.register_processor("blip_image_eval")(BlipImageEvalProcessor)
registry.register_processor("blip2_image_train")(
    lambda image_size=224, **kw: BlipImageTrainProcessor(
        image_size=image_size, use_randaug=False, **kw
    )
)
registry.register_processor("clip_image_train")(ClipImageProcessor)
registry.register_processor("clip_image_eval")(ClipImageProcessor)
registry.register_processor("blip_caption")(CaptionProcessor)
registry.register_processor("blip_question")(QuestionProcessor)


# the sibling families register on import (video: ALPRO; the GPT dialogue)
from sprc_tpu_torch.data import gpt_processors as _gpt_processors  # noqa: E402,F401
from sprc_tpu_torch.data import video_processors as _video_processors  # noqa: E402,F401
