"""Host image preprocessing: TargetPad or SquarePad -> bicubic resize ->
center crop -> normalize (CLIP statistics).

The PIL-exact host path of ``sprc_tpu/data/transforms.py`` (reference
src/data_utils.py:49-105), framework-free and copied so that the port
imports nothing of ``sprc_tpu``; tests/test_torch_inputs.py pins its pixels
equal to the original's. PIL is imported only when a transform runs. Output
is NHWC float32, as the port's models take it.

The device path, :func:`device_preprocess`, is the counterpart of the JAX
package's: uint8 batches of a uniform buffer plus each image's true size in,
the targetpad geometry and ``jax.image.scale_and_translate``'s antialiased
Keys cubic resampling as two batched products, then the CLIP normalisation;
it runs on whatever device its inputs lie on. tests/test_torch_device_preprocess.py
holds it against the JAX function.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

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


# ---------------------------------------------------------------- device path


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """The Keys cubic with a = -0.5 on |x|, as jax.image's
    ``_fill_keys_cubic_kernel``."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def resample_weights(in_size: int, out_size: int, scale: torch.Tensor,
                     translation: torch.Tensor) -> torch.Tensor:
    """Per image, the ``[out_size, in_size]`` matrix that
    ``jax.image.scale_and_translate(method="cubic", antialias=True)`` applies
    along one axis (``compute_weight_mat``, transposed): the Keys cubic
    stretched by ``max(1/scale, 1)``, each output's weights divided by their
    sum where that sum exceeds ``1000 eps``, and outputs whose sample lies
    outside ``[-0.5, in_size - 0.5]`` zeroed. ``scale`` and ``translation``
    are float32 ``[B]``; the arithmetic is float32 in JAX's order."""
    dev = scale.device
    inv_scale = 1.0 / scale[:, None]
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample_f = ((torch.arange(out_size, dtype=torch.float32, device=dev) + 0.5) * inv_scale
                - translation[:, None] * inv_scale - 0.5)  # [B, out]
    x = (sample_f[:, :, None] - torch.arange(in_size, dtype=torch.float32, device=dev)).abs()
    weights = _keys_cubic(x / kernel_scale[:, :, None])  # [B, out, in]
    total = weights.sum(dim=2, keepdim=True)
    eps = float(np.finfo(np.float32).eps)
    weights = torch.where(total.abs() > 1000.0 * eps,
                          weights / torch.where(total != 0, total, torch.ones_like(total)),
                          torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[:, :, None], weights, torch.zeros_like(weights))


def device_preprocess(dim: int = 224, target_ratio: float = 1.25) -> Callable:
    """Device preprocess over fixed-size uint8 batches.

    The returned function takes ``images [B, H, W, 3] uint8`` (decoded, of
    a uniform buffer size) and their true ``sizes [B, 2]`` (h, w), on any
    one device, and gives the normalized ``[B, dim, dim, 3]`` float32 batch.
    Padding, resize and crop follow the host path's geometry, computed in
    float32 as ``jnp`` does (``floor`` for the pads, ``round`` half to even
    for the resized size and the crop offsets); the interpolation is JAX's
    antialiased Keys cubic (:func:`resample_weights`), not PIL's. Buffer
    pixels beyond an image's true size are samples like any other (zeros of
    the buffer), as in JAX.
    """
    f32 = torch.float32
    consts: dict = {}  # device -> (target_ratio, dim, mean, std), made once a device

    def preprocess(images: torch.Tensor, sizes: torch.Tensor) -> torch.Tensor:
        dev = images.device
        H, W = images.shape[1:3]
        if dev not in consts:  # torch.tensor(..., device=cuda) waits for the stream
            consts[dev] = tuple(torch.tensor(v, dtype=f32).to(dev) for v in (
                target_ratio, dim, CLIP_MEAN, CLIP_STD))
        ratio_t, dim_t, mean, std = consts[dev]
        sizes = sizes.to(device=dev, dtype=f32)
        h, w = sizes[:, 0], sizes[:, 1]
        long_side, short_side = torch.maximum(w, h), torch.minimum(w, h)
        scaled = long_side / ratio_t
        do_pad = long_side / short_side >= ratio_t
        zero = torch.zeros_like(h)
        hp = torch.floor(torch.where(do_pad, torch.clamp((scaled - w) / 2.0, min=0.0), zero))
        vp = torch.floor(torch.where(do_pad, torch.clamp((scaled - h) / 2.0, min=0.0), zero))
        padded_h, padded_w = h + 2.0 * vp, w + 2.0 * hp
        scale = dim_t / torch.minimum(padded_h, padded_w)  # (Tensor.__rtruediv__ multiplies)
        out_h, out_w = torch.round(padded_h * scale), torch.round(padded_w * scale)
        left, top = torch.round((out_w - dim) / 2.0), torch.round((out_h - dim) / 2.0)
        src_x0, src_y0 = left / scale - hp, top / scale - vp
        # the channel axis's scale 1 and translation 0 give the identity
        # (tests/test_torch_device_preprocess.py pins it): not applied
        wy = resample_weights(H, dim, scale, -src_y0 * scale)  # [B, dim, H]
        wx = resample_weights(W, dim, scale, -src_x0 * scale)  # [B, dim, W]
        planes = images.permute(0, 3, 1, 2).to(f32)  # [B, 3, H, W]
        out = torch.matmul(torch.matmul(wy[:, None], planes), wx[:, None].transpose(-1, -2))
        out = out.permute(0, 2, 3, 1) / 255.0
        return (out - mean) / std

    return preprocess
