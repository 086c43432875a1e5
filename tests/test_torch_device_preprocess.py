"""``sprc_tpu_torch.data.transforms.device_preprocess`` against the JAX
package's ``device_preprocess`` on the CPU, from seeded uint8 images.

Both sides compute the targetpad geometry in float32 and resample with the
antialiased Keys cubic of ``jax.image.scale_and_translate``; the JAX function
runs as its own tests run it (called, not jitted: under ``jit`` XLA fuses the
sample positions' arithmetic, which moves them by an ulp or two). Tolerance
1e-5 max abs in fp32 (normalised pixels of magnitude up to about 2.2); the
reading was 1.13e-6 at dim 224 and 112, the products' summation order.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax._src.image.scale import _fill_keys_cubic_kernel, compute_weight_mat  # noqa: E402

from sprc_tpu.data.transforms import device_preprocess as jax_device_preprocess  # noqa: E402

from sprc_tpu_torch.data.transforms import device_preprocess, resample_weights  # noqa: E402
from test_torch_threads import one_torch_thread  # noqa: E402,F401  (one thread a module)

ATOL = 1e-5
BUFFER = (320, 320)
# (h, w) true sizes inside the buffer: padded wide; padded tall; unpadded
# near-square; an upsample from 40 x 56; an antialiased downsample from
# 900 x 600 (a buffer of its own below); the whole buffer; geometries whose
# crop offset lands on .5 (at dim 224: 250 x 280 13.5, 40 x 56 30.5, 200 x
# 222 12.5, 150 x 197 29.5; at 112: 6.5, 15.5, 14.5), which round half to
# even; the (1, 1) of a padding row
SIZES = [(120, 300), (300, 110), (250, 280), (40, 56), (320, 320), (200, 222), (150, 197),
         (1, 1)]


def _geometry(h, w, dim, ratio=1.25):
    """The float32 crop offset (left, top) both functions compute."""
    f = np.float32
    h, w = f(h), f(w)
    long, short = max(h, w), min(h, w)
    scaled = long / f(ratio)
    pad = long / short >= f(ratio)
    hp = np.floor(max((scaled - w) / f(2), f(0))) if pad else f(0)
    vp = np.floor(max((scaled - h) / f(2), f(0))) if pad else f(0)
    scale = f(dim) / min(h + f(2) * vp, w + f(2) * hp)
    out_h, out_w = np.round((h + f(2) * vp) * scale), np.round((w + f(2) * hp) * scale)
    return (out_w - f(dim)) / f(2), (out_h - f(dim)) / f(2)


def _images(seed, sizes, buffer=BUFFER):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (len(sizes),) + buffer + (3,), dtype=np.uint8)
    for img, (h, w) in zip(images, sizes):
        img[h:], img[:, w:] = 0, 0
    return images, np.asarray(sizes, np.int32)


def _both(images, sizes, dim):
    want = np.asarray(jax_device_preprocess(dim=dim)(jnp.asarray(images), jnp.asarray(sizes)))
    got = device_preprocess(dim=dim)(torch.from_numpy(images), torch.from_numpy(sizes)).numpy()
    return got, want


@pytest.mark.parametrize("dim", [224, 112])
def test_matches_jax(dim):
    assert 0.5 in {abs(v) % 1 for s in SIZES for v in _geometry(*s, dim)}, "no .5 crop"
    images, sizes = _images(dim, SIZES)
    got, want = _both(images, sizes, dim)
    assert got.shape == want.shape == (len(SIZES), dim, dim, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_antialiased_downsample_matches_jax():
    """900 x 600 in a 900 x 640 buffer to 224: a kernel stretched by 1/scale."""
    images, sizes = _images(3, [(900, 600), (600, 640)], buffer=(900, 640))
    got, want = _both(images, sizes, 224)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_weights_match_jax_weight_matrix():
    """``resample_weights`` against ``compute_weight_mat`` (called eagerly) on
    upsampling, downsampling and translated geometries: the normalisation
    guard and the range mask (rows whose sample lies outside the input are
    zero, the targetpad border)."""
    for in_size, out_size, scale, translation in [
            (56, 28, 0.5, 0.0), (40, 112, 2.8, -10.0), (320, 224, 0.7466667, 37.33),
            (320, 224, 1.12, -11.0), (30, 64, 1.5, 40.0), (900, 224, 0.2488889, 0.0)]:
        s, t = np.float32(scale), np.float32(translation)
        want = np.asarray(compute_weight_mat(in_size, out_size, jnp.float32(s), jnp.float32(t),
                                             _fill_keys_cubic_kernel, True)).T
        got = resample_weights(in_size, out_size, torch.tensor([s]), torch.tensor([t]))[0].numpy()
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
        # the zeroed rows are the same rows
        np.testing.assert_array_equal(got.any(axis=1), want.any(axis=1))


def test_channel_axis_is_identity():
    """The JAX call puts the channel axis through scale 1 and translation 0:
    the identity, which the port does not apply."""
    want = np.asarray(compute_weight_mat(3, 3, jnp.float32(1.0), jnp.float32(0.0),
                                         _fill_keys_cubic_kernel, True))
    np.testing.assert_array_equal(want, np.eye(3, dtype=np.float32))
    got = resample_weights(3, 3, torch.ones(1), torch.zeros(1))[0].numpy()
    np.testing.assert_array_equal(got, np.eye(3, dtype=np.float32))


def test_per_image_and_border():
    """A batch gives each image what it alone gives (the JAX ``vmap``), and
    the targetpad border of a wide image is the normalised zero."""
    images, sizes = _images(5, SIZES[:3])
    pre = device_preprocess(dim=112)
    batch = pre(torch.from_numpy(images), torch.from_numpy(sizes)).numpy()
    for i in range(3):
        one = pre(torch.from_numpy(images[i: i + 1]), torch.from_numpy(sizes[i: i + 1])).numpy()
        np.testing.assert_allclose(batch[i: i + 1], one, atol=1e-6, rtol=0)
    mean = np.asarray([0.48145466, 0.4578275, 0.40821073], np.float32)
    std = np.asarray([0.26862954, 0.26130258, 0.27577711], np.float32)
    np.testing.assert_allclose(batch[0, 0], np.broadcast_to(-mean / std, (112, 3)), atol=1e-6)
