"""The port's native data-plane (``sprc_tpu_torch/native/dataplane.cpp``,
``sprc_tpu_torch/data/native.py``) against the JAX package's
(``sprc_tpu/data/native.py``) on the same PNG and JPEG bytes.

The two libraries are compiled from the same decode and resampling source,
so decode and preprocess are bit-equal, with one repaired difference: the
port rounds the resized size and the crop offsets half to even, as the PIL
path (Python's ``round``) does, where the JAX copy rounds half away from zero
and shifts the crop by a pixel (``test_crop_rounds_half_to_even``). The JPEG
fixtures (``tests/fixtures/dataplane``, written by
``python -m sprc_tpu_torch.data.dataplane_fixtures``) hold the decoder against
Pillow's stored arrays. The JAX source is compiled into a temporary
directory for these tests (never by the JAX ``build.py``, which writes
beside its source); the port's library lands in ``sprc_tpu_torch/_build/``.
"""

import ctypes
import glob
import io
import os
import subprocess
from pathlib import Path

import numpy as np
import pytest

from sprc_tpu_torch.data import native
from sprc_tpu_torch.native import build as port_build
from sprc_tpu_torch.utils.artifacts import encode_png
from test_torch_threads import one_torch_thread  # noqa: E402,F401  (one thread a module)

ROOT = Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "tests" / "fixtures" / "dataplane"
# the JAX test's preprocess bound (tests/test_native_dataplane.py): uint8
# resample rounding differs by at most 1 step / 0.26 std
PREPROCESS_BOUND = (2.0 / 255.0) / 0.26 + 1e-5


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """``sprc_tpu.data.native`` over the JAX source compiled here into a
    temporary directory with the port's flags (the JAX ``build.py`` would
    write beside its source)."""
    from sprc_tpu.data import native as jn

    out = tmp_path_factory.mktemp("jax_dataplane") / "libsprc_dataplane.so"
    subprocess.run(["g++", *port_build.FLAGS, str(ROOT / "sprc_tpu/native/dataplane.cpp"), "-o",
                    str(out), *port_build.LIBS], check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    for fn in (lib.sprc_decode_dims, lib.sprc_decode, lib.sprc_preprocess,
               lib.sprc_preprocess_batch):
        fn.restype = ctypes.c_int
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jn, "_LIB", lib)
        yield jn


def _jpeg(arr, quality):
    import PIL.Image

    buf = io.BytesIO()
    PIL.Image.fromarray(arr).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def _crop_half(h, w, dim, ratio=1.25):
    """Whether targetpad's resize or crop of an h x w image to ``dim`` meets
    an exact .5 (where the two copies round differently)."""
    if max(h, w) / min(h, w) >= ratio:
        scaled = max(h, w) / ratio
        w, h = w + 2 * max(int((scaled - w) / 2), 0), h + 2 * max(int((scaled - h) / 2), 0)
    long = (max(h, w) * dim / min(h, w))
    return long % 1 == 0.5 or ((round(long) - dim) / 2) % 1 == 0.5


def test_decode_equals_jax(jax_native):
    rng = np.random.default_rng(0)
    for h, w in [(37, 53), (64, 48), (1, 7), (300, 211)]:
        arr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        png = encode_png(arr)
        np.testing.assert_array_equal(native.decode(png), arr)
        np.testing.assert_array_equal(jax_native.decode(png), arr)
        for quality in (75, 95):
            data = _jpeg(arr, quality)
            np.testing.assert_array_equal(native.decode(data), jax_native.decode(data))


def test_transform_and_batch_equal_jax(jax_native):
    """``__call__`` and ``.batch`` bit-equal to the JAX package's where no
    rounding meets a .5 (every such geometry is checked here to have none)."""
    rng = np.random.default_rng(1)
    shapes = [(224, 224), (640, 480), (100, 300), (50, 40), (120, 96)]
    for dim in (224, 32):
        sources = []
        for h, w in shapes:
            assert not _crop_half(h, w, dim), (h, w, dim)
            arr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            sources += [encode_png(arr), _jpeg(arr, 90)]
        ours = native.NativeTransform(dim=dim, num_threads=3)
        theirs = jax_native.NativeTransform(dim=dim, num_threads=3)
        for src in sources:
            np.testing.assert_array_equal(ours(src), theirs(src))
        got, got_ok = ours.batch(sources)
        want, want_ok = theirs.batch(sources)
        np.testing.assert_array_equal(got, want)
        assert got_ok.all() and want_ok.all()


def test_crop_rounds_half_to_even(jax_native):
    """The repaired fault: 48 x 64 targetpads to 50 x 64, resizes to 32 x
    40.96 -> 41, and crops at (41 - 32) / 2 = 4.5. PIL's path takes 4; the JAX
    copy takes 5, one pixel off, far outside the preprocess bound; the port
    takes 4."""
    import PIL.Image

    from sprc_tpu_torch.data.transforms import targetpad_transform

    assert _crop_half(48, 64, 32)
    arr = np.random.default_rng(2).integers(0, 256, (48, 64, 3), dtype=np.uint8)
    png = encode_png(arr)
    want = targetpad_transform(1.25, 32)(PIL.Image.fromarray(arr))
    port = np.abs(native.NativeTransform(dim=32)(png) - want).max()
    jax = np.abs(jax_native.NativeTransform(dim=32)(png) - want).max()
    assert port <= PREPROCESS_BOUND < jax, (port, jax)


def test_jpeg_fixtures_against_pil():
    """Decoded bit for bit against Pillow's stored decode (same libjpeg ABI
    here), preprocessed within the JAX test's bound of Pillow's targetpad."""
    paths = sorted(glob.glob(str(FIXTURES / "*.jpg")))
    assert len(paths) == 5 and sum(os.path.getsize(p) for p in glob.glob(str(FIXTURES / "*"))) < 300_000
    tfm = native.NativeTransform(dim=32)
    for path in paths:
        stem = path[: -len(".jpg")]
        decoded = native.decode(Path(path).read_bytes())
        np.testing.assert_array_equal(decoded, np.load(stem + ".decode.npy"))
        diff = np.abs(tfm(path) - np.load(stem + ".targetpad32.npy"))
        assert diff.max() <= PREPROCESS_BOUND, (path, diff.max())


def test_ok_flags_and_zero_rows():
    rng = np.random.default_rng(3)
    good = [encode_png(rng.integers(0, 256, (50, 40, 3), dtype=np.uint8)) for _ in range(2)]
    truncated = good[0][: len(good[0]) // 2]
    tfm = native.NativeTransform(dim=32, num_threads=2)
    out, ok = tfm.batch([good[0], b"not an image", truncated, good[1], b""])
    assert out.shape == (5, 32, 32, 3) and ok.tolist() == [True, False, False, True, False]
    assert not out[[1, 2, 4]].any()
    np.testing.assert_array_equal(out[3], tfm(good[1]))
    with pytest.raises(ValueError, match="undecodable"):
        native.decode(b"\xff\xd8 not a jpeg")
    with pytest.raises(ValueError, match="preprocess failed"):
        tfm(b"not an image")


def test_copy_pins_abi_and_resampling_to_jax_source():
    """The C ABI (``extern "C"``) and the decode and resampling code are the
    JAX file's text; only the header comment and the rounding of the resized
    size and crop offsets (``preprocess_one``) differ."""
    port = (ROOT / "sprc_tpu_torch/native/dataplane.cpp").read_text()
    ref = (ROOT / "sprc_tpu/native/dataplane.cpp").read_text()

    def part(text, start, end):
        return text[text.index(start): text.index(end, text.index(start))]

    for start, end in [('extern "C" {', '}  // extern "C"'),
                       ("#include <algorithm>", "// -------------------------------------------------------------- preprocess")]:
        assert part(port, start, end) == part(ref, start, end), start
    assert port.count("std::nearbyint(") == 4 and "std::lround" not in port


def test_builds_into_the_port_and_nowhere_else(tmp_path, monkeypatch):
    """The library lands in ``sprc_tpu_torch/_build/``; building it adds no
    file under ``sprc_tpu/``; a second call reuses it; a source newer than it
    rebuilds it."""
    assert port_build.OUT == ROOT / "sprc_tpu_torch" / "_build" / "libsprc_dataplane.so"
    before = sorted(p for p in (ROOT / "sprc_tpu").rglob("*") if "__pycache__" not in p.parts)
    src = tmp_path / "dataplane.cpp"
    src.write_text(port_build.SRC.read_text())
    monkeypatch.setattr(port_build, "SRC", src)
    monkeypatch.setattr(port_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(port_build, "OUT", tmp_path / "_build" / "libsprc_dataplane.so")
    out = port_build.build()
    assert out == tmp_path / "_build" / "libsprc_dataplane.so" and out.exists()
    built = out.stat().st_mtime_ns
    assert port_build.build().stat().st_mtime_ns == built  # reused
    os.utime(src, ns=(built + 10**9, built + 10**9))
    assert port_build.build().stat().st_mtime_ns != built  # the source is newer: rebuilt
    after = sorted(p for p in (ROOT / "sprc_tpu").rglob("*") if "__pycache__" not in p.parts)
    assert after == before


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    src = tmp_path / "dataplane.cpp"
    src.write_text('#include "no_such_header_here.h"\n')
    monkeypatch.setattr(port_build, "SRC", src)
    monkeypatch.setattr(port_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(port_build, "OUT", tmp_path / "_build" / "libsprc_dataplane.so")
    with pytest.raises(RuntimeError, match="no_such_header_here.h"):
        port_build.build()
    assert not list((tmp_path / "_build").iterdir())
