"""The port's copies of the validate path's host code equal sprc_tpu's on
the fixtures of tests/test_data.py: the caption processors, the squarepad
transform, and the FashionIQ and CIRCO datasets (items and pixels exactly
equal; CIRR is in test_torch_data.py).
"""

import numpy as np
import pytest

from sprc_tpu.data.datasets import CIRCODataset as JCIRCO
from sprc_tpu.data.datasets import FashionIQDataset as JFashionIQ
from sprc_tpu.data.transforms import squarepad_transform as jax_squarepad
from sprc_tpu.text import processors as jproc
from test_data import circo_root, fiq_root  # noqa: F401  (fixtures)

from sprc_tpu_torch.cli.validate import circo_queries, fiq_queries, index_batches
from sprc_tpu_torch.data.datasets import CIRCODataset, FashionIQDataset
from sprc_tpu_torch.data.transforms import squarepad_transform
from sprc_tpu_torch.text import processors as pproc
from test_torch_threads import one_torch_thread  # noqa: E402,F401  (one thread a module)


def _same(a, b):
    assert a.keys() == b.keys()
    for key in a:
        if isinstance(a[key], np.ndarray):
            np.testing.assert_array_equal(a[key], b[key])
        else:
            assert a[key] == b[key], key


def test_caption_processors_identical():
    captions = ["Is RED, and has (long) sleeves!", "a  b\n", "x " * 70, "", 'say "hi": ok; ~done*#']
    for kw in ({}, {"prompt": "a photo of ", "max_words": 5}):
        for c in captions:
            assert pproc.CaptionProcessor(**kw)(c) == jproc.CaptionProcessor(**kw)(c)
    flat = ["is red.", "has long sleeves?", " is shorter, ", "is blue"]
    assert pproc.combine_fiq_captions(flat) == jproc.combine_fiq_captions(flat)
    assert pproc.combine_fiq_captions(flat)[0] == "Is red and has long sleeves"


@pytest.mark.parametrize("size", [(40, 30), (30, 90), (64, 64)])
def test_squarepad_pixels_identical(size):
    import PIL.Image

    rng = np.random.RandomState(sum(size))
    img = PIL.Image.fromarray((rng.rand(size[1], size[0], 3) * 255).astype(np.uint8))
    got = squarepad_transform(32)(img)
    assert got.shape == (32, 32, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, jax_squarepad(32)(img))


def test_fashioniq_dataset_identical(fiq_root):  # noqa: F811
    tfm = squarepad_transform(32)
    for split, mode in (("val", "classic"), ("val", "relative"), ("train", "relative"),
                        ("test", "relative")):
        port = FashionIQDataset(fiq_root, split, ["dress"], mode, tfm)
        ref = JFashionIQ(fiq_root, split, ["dress"], mode, jax_squarepad(32))
        assert len(port) == len(ref) > 0
        for i in range(len(port)):
            _same(port[i], ref[i])
    names = [n for b, _ in index_batches(FashionIQDataset(fiq_root, "val", ["dress"], "classic",
                                                          tfm), 3, 2) for n in b]
    assert names == FashionIQDataset(fiq_root, "val", ["dress"], "classic").image_names
    queries = fiq_queries(fiq_root, "dress")  # JSON only: no transform, no decoding
    assert queries["captions"][0] == "is red and is long" and len(queries["refs"]) == 3
    with pytest.raises(ValueError, match="dress_type"):
        FashionIQDataset(fiq_root, "val", ["hat"], "classic")


def test_circo_dataset_identical(circo_root):  # noqa: F811
    tfm = squarepad_transform(32)
    for mode, kw in (("classic", {}), ("relative", {}), ("relative", {"load_images": False})):
        port = CIRCODataset(circo_root, "val", mode, tfm, **kw)
        ref = JCIRCO(circo_root, "val", mode, jax_squarepad(32), **kw)
        assert len(port) == len(ref) > 0
        for i in range(len(port)):
            _same(port[i], ref[i])
    batches = list(index_batches(CIRCODataset(circo_root, "val", "classic", tfm), 4, 2,
                                 name_key="img_id"))
    assert [n for b, _ in batches for n in b] == [str(1000 + i) for i in range(6)]
    queries = circo_queries(circo_root)
    assert queries["refs"] == ["1000", "1001", "1002"] and len(queries["gts"][0]) == 23
    with pytest.raises(ValueError, match="split"):
        CIRCODataset(circo_root, "train", "classic")
