"""The engine's feed: ``build_index`` and ``build_index_raw`` through the
pipelined encode (``_prefetch_iter``, ``_pipelined_encode``,
``_assemble_index``) against the JAX engine on the tiny shared-weight model
of test_torch_model.py (the weights through the bridge), on the CPU.

Target features within 1e-4 (test_torch_model's ATOL, fp32 on both sides;
the JAX raw path jits ``device_preprocess`` with the encoder, where XLA fuses
the sample positions' arithmetic); the reading was 1.5e-7 on both paths. The
frozen embeds come back in bf16: within one bf16 step (relative 2^-7; the
reading was 0 on pixels, 1.2e-4 on raw). Names and n equal; each package
reads the other's index file. The pinned ring (CUDA only) is held by
tests/test_torch_kernels_feed_cuda.py.
"""

import threading
import time

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sprc_tpu.retrieval.engine import RetrievalEngine as JRetrievalEngine  # noqa: E402

from sprc_tpu_torch.interop.jax_params import state_dict_from_jax  # noqa: E402
from sprc_tpu_torch.retrieval.engine import RetrievalEngine, _prefetch_iter  # noqa: E402
from sprc_tpu_torch.utils.artifacts import synthetic_raw_batches  # noqa: E402

from test_torch_model import IMG, jax_model, jax_params, port_model  # noqa: E402
from test_torch_threads import one_torch_thread  # noqa: E402,F401  (one thread a module)

ATOL = 1e-4
N, BATCH, BUFFER = 11, 4, 48  # 3 batches, the last one short


def _pixels(seed=0):
    images = np.random.RandomState(seed).rand(N, IMG, IMG, 3).astype(np.float32)
    return [([f"p{i}" for i in range(s, min(s + BATCH, N))], images[s: s + BATCH])
            for s in range(0, N, BATCH)]


def _raw():
    return list(synthetic_raw_batches(7, N, BATCH, BUFFER))


@pytest.fixture(scope="module")
def models():
    jm = jax_model()
    params = jax_params(jm)
    return jm, params, port_model(state_dict_from_jax(params))


@pytest.fixture(scope="module")
def built(models):
    jm, params, pm = models
    jengine = JRetrievalEngine(jm, params, encode_batch=BATCH, frozen_host_dtype=jnp.bfloat16)
    pengine = RetrievalEngine(pm, device="cpu", encode_batch=BATCH, frozen_host_dtype=torch.bfloat16)
    return {"jax": {"pixels": jengine.build_index(iter(_pixels())),
                    "raw": jengine.build_index_raw(iter(_raw()), decode_size=BUFFER)},
            "port": {"pixels": pengine.build_index(iter(_pixels())),
                     "raw": pengine.build_index_raw(iter(_raw()), decode_size=BUFFER)},
            "jengine": jengine, "pengine": pengine}


@pytest.mark.parametrize("path", ["pixels", "raw"])
def test_index_matches_jax(built, path):
    want, got = built["jax"][path], built["port"][path]
    assert got.names == want.names and got.n == want.n == N
    assert got.target_feats.shape == (N,) + tuple(np.asarray(want.target_feats).shape[1:])
    np.testing.assert_allclose(got.target_feats.numpy(), np.asarray(want.target_feats)[:N],
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.frozen_embeds.float().numpy(),
                               np.asarray(want.frozen_embeds, np.float32), atol=1e-6, rtol=2**-7)


def test_short_last_batch_pads_without_leaking(models):
    """The short last batch (3 of 4) gives what those images give in a full
    batch, on both paths (pad rows: zero images; raw: zero images of size 1 x 1)."""
    _, _, pm = models
    engine = RetrievalEngine(pm, device="cpu", encode_batch=BATCH)
    names, images = _pixels()[-1]
    assert len(names) == 3
    full = engine.build_index(iter([(names + ["x"], np.concatenate([images, images[:1]]))]))
    short = engine.build_index(iter([(names, images)]))
    assert short.n == 3 and short.frozen_embeds.shape[0] == 3
    torch.testing.assert_close(short.target_feats, full.target_feats[:3], atol=1e-6, rtol=0)
    names, raw, sizes = _raw()[-1]
    full = engine.build_index_raw(iter([(names + ["x"], np.concatenate([raw, raw[:1]]),
                                         np.concatenate([sizes, sizes[:1]]))]))
    short = engine.build_index_raw(iter([(names, raw, sizes)]))
    torch.testing.assert_close(short.target_feats, full.target_feats[:3], atol=1e-6, rtol=0)


def test_batch_larger_than_encode_batch_is_encoded_in_slices(models):
    """A batch of encode_batch + 1 images gives the index of the same images
    sent as two batches (4, then 1 padded), bit for bit, on both paths; and
    the JAX engine's index of that batch (which it encodes whole) within
    ATOL."""
    jm, params, pm = models
    engine = RetrievalEngine(pm, device="cpu", encode_batch=BATCH)
    n = BATCH + 1
    images = np.random.RandomState(3).rand(n, IMG, IMG, 3).astype(np.float32)
    names = [f"o{i}" for i in range(n)]
    whole = engine.build_index(iter([(names, images)]))
    split = engine.build_index(iter([(names[:BATCH], images[:BATCH]),
                                     (names[BATCH:], images[BATCH:])]))
    assert whole.names == split.names == names and whole.n == n
    assert torch.equal(whole.target_feats, split.target_feats)
    assert torch.equal(whole.frozen_embeds, split.frozen_embeds)
    jindex = JRetrievalEngine(jm, params, encode_batch=BATCH).build_index(
        iter([(names, images)]))
    np.testing.assert_allclose(whole.target_feats.numpy(), np.asarray(jindex.target_feats)[:n],
                               atol=ATOL, rtol=0)

    _, raw, sizes = next(iter(synthetic_raw_batches(9, n, n, BUFFER)))
    whole = engine.build_index_raw(iter([(names, raw, sizes)]), decode_size=BUFFER)
    split = engine.build_index_raw(iter([(names[:BATCH], raw[:BATCH], sizes[:BATCH]),
                                         (names[BATCH:], raw[BATCH:], sizes[BATCH:])]),
                                   decode_size=BUFFER)
    assert whole.names == split.names == names
    assert torch.equal(whole.target_feats, split.target_feats)
    assert torch.equal(whole.frozen_embeds, split.frozen_embeds)


def test_index_files_cross_load(built, tmp_path):
    jindex, pindex = built["jax"]["raw"], built["port"]["raw"]
    jpath, ppath = str(tmp_path / "jax_raw"), str(tmp_path / "port_raw")
    jindex.save(jpath)
    pindex.save(ppath)
    from_jax = built["pengine"].load_index(jpath)
    from_port = built["jengine"].load_index(ppath)
    assert from_jax.names == from_port.names == pindex.names and from_jax.n == from_port.n == N
    np.testing.assert_array_equal(np.asarray(from_port.target_feats)[:N],
                                  pindex.target_feats.numpy())
    np.testing.assert_array_equal(np.asarray(from_port.frozen_embeds, np.float32),
                                  pindex.frozen_embeds.float().numpy())
    np.testing.assert_array_equal(from_jax.target_feats.numpy(),
                                  np.asarray(jindex.target_feats)[:N])
    assert from_jax.frozen_embeds.dtype == torch.bfloat16


def test_prefetch_keeps_order_and_raises_the_producers_error():
    assert list(_prefetch_iter(iter(range(50)), depth=2)) == list(range(50))

    def failing():
        yield from range(3)
        raise KeyError("bad sample")

    got = []
    with pytest.raises(KeyError, match="bad sample"):
        for item in _prefetch_iter(failing(), depth=2):
            got.append(item)
    assert got == [0, 1, 2]


def test_abandoned_consumer_stops_the_producer():
    """A consumer that stops early (an encode error) leaves no producer
    blocked on the full queue: the thread ends within its own time limit."""
    started = threading.Event()
    produced = []

    def endless():
        started.set()
        for i in range(10**9):
            produced.append(i)
            yield i

    before = set(threading.enumerate())
    it = _prefetch_iter(endless(), depth=2)
    assert next(it) == 0 and started.wait(5)
    time.sleep(0.3)  # the producer fills the queue and blocks on it
    it.close()
    producers = set(threading.enumerate()) - before
    for t in producers:
        t.join(timeout=5)
    assert producers and not any(t.is_alive() for t in producers)
    assert len(produced) <= 5  # the queue's 2, one in hand, one in the consumer


def test_engine_error_stops_the_producer(models):
    _, _, pm = models
    engine = RetrievalEngine(pm, device="cpu", encode_batch=BATCH)
    before = set(threading.enumerate())

    def batches():
        for s in range(10**6):
            yield [f"e{s}"], np.zeros((1, IMG, IMG, 4), np.float32)  # the tower refuses it

    t0 = time.perf_counter()
    with pytest.raises(RuntimeError):
        engine.build_index(batches())
    assert time.perf_counter() - t0 < 30
    producers = set(threading.enumerate()) - before
    for t in producers:
        t.join(timeout=5)
    assert not any(t.is_alive() for t in producers)
