"""The port's training data path against sprc_tpu's.

- ``DataLoader``: the shuffled order (``RandomState(seed + epoch)``) for two
  epochs, with and without ``drop_last``, equal to the JAX loader's batch
  for batch; ``skip_errors`` datasets drop the same samples and count them
  alike.
- The feature cache: files written by either package load in the other bit
  for bit (bf16 as uint16 bits, and fp32); the port's build over the tiny
  model of test_torch_train_losses.py equals the JAX build within one bf16
  step (both round fp32 tower rows that agree to about 1e-6).
- ``randomize_fiq_captions`` and ``MetricsLogger`` equal their originals.
"""

import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sprc_tpu.data import datasets as jdatasets  # noqa: E402
from sprc_tpu.data.loader import DataLoader as JDataLoader  # noqa: E402
from sprc_tpu.data.transforms import targetpad_transform as jtargetpad  # noqa: E402
from sprc_tpu.text.processors import randomize_fiq_captions as jrandomize  # noqa: E402
from sprc_tpu.train import feature_cache as jcache  # noqa: E402
from sprc_tpu.utils.logging import MetricsLogger as JMetricsLogger  # noqa: E402
from test_data import cirr_root, fiq_root  # noqa: E402,F401  (fixtures)
from test_torch_train_losses import IMG, jax_model, jax_params, port_model  # noqa: E402

from sprc_tpu_torch.data import datasets  # noqa: E402
from sprc_tpu_torch.data.loader import DataLoader  # noqa: E402
from sprc_tpu_torch.data.transforms import targetpad_transform  # noqa: E402
from sprc_tpu_torch.text.processors import randomize_fiq_captions  # noqa: E402
from sprc_tpu_torch.train.feature_cache import FeatureCache, build_feature_cache  # noqa: E402
from sprc_tpu_torch.utils.logging import MetricsLogger  # noqa: E402
from test_torch_threads import one_torch_thread  # noqa: E402,F401  (one thread a module)


class _Items:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"i": i}


@pytest.mark.parametrize("drop_last", [True, False])
def test_shuffled_order_equals_jax(drop_last, cirr_root):
    for n, bs in ((10, 4), (11, 3)):
        port = DataLoader(_Items(n), batch_size=bs, shuffle=True, drop_last=drop_last, seed=7,
                          num_workers=2)
        jloader = JDataLoader(_Items(n), batch_size=bs, shuffle=True, drop_last=drop_last,
                              seed=7, num_workers=2)
        assert len(port) == len(jloader)
        for epoch in (0, 1):
            port.set_epoch(epoch)
            jloader.set_epoch(epoch)
            got, want = [b["i"] for b in port], [b["i"] for b in jloader]
            assert got == want, (n, bs, epoch)
            if drop_last:
                assert all(len(b) == bs for b in got)
    # the CIRR train split, names only, as the fine-tune CLI reads it
    port = DataLoader(datasets.CIRRDataset(cirr_root, "train", "relative"), batch_size=3,
                      shuffle=True, drop_last=drop_last, seed=42)
    jloader = JDataLoader(jdatasets.CIRRDataset(cirr_root, "train", "relative"), batch_size=3,
                          shuffle=True, drop_last=drop_last, seed=42)
    for epoch in (0, 1):
        port.set_epoch(epoch)
        jloader.set_epoch(epoch)
        assert [b["caption"] for b in port] == [b["caption"] for b in jloader]


def test_skip_errors_drops_and_counts_as_jax(cirr_root, fiq_root, caplog):
    tfm, jtfm = targetpad_transform(1.25, 32), jtargetpad(1.25, 32)
    pairs = [(datasets.CIRRDataset(cirr_root, "train", "relative", tfm, skip_errors=True),
              jdatasets.CIRRDataset(cirr_root, "train", "relative", jtfm, skip_errors=True)),
             (datasets.FashionIQDataset(fiq_root, "train", ["dress"], "relative", tfm,
                                        skip_errors=True),
              jdatasets.FashionIQDataset(fiq_root, "train", ["dress"], "relative", jtfm,
                                         skip_errors=True))]
    for port_ds, jax_ds in pairs:
        for ds in (port_ds, jax_ds):  # break one image of the split
            if hasattr(ds, "name_to_relpath"):
                ds.name_to_relpath["im2"] = "img/missing.png"
            else:  # FashionIQ: a candidate image that does not exist
                ds.triplets[1] = dict(ds.triplets[1], candidate="nothere")
        assert port_ds[1] is None and jax_ds[1] is None
        port = DataLoader(port_ds, batch_size=2, num_workers=1)
        jloader = JDataLoader(jax_ds, batch_size=2, num_workers=1)
        got, want = list(port), list(jloader)
        assert [b["reference_name"] for b in got] == [b["reference_name"] for b in want]
        assert [b["reference_image"].shape for b in got] == [b["reference_image"].shape
                                                              for b in want]
        assert port.dropped_total == jloader.dropped_total > 0
    strict = datasets.CIRRDataset(cirr_root, "train", "relative", tfm)
    strict.name_to_relpath["im2"] = "img/missing.png"
    with pytest.raises(FileNotFoundError):
        list(DataLoader(strict, batch_size=2, num_workers=1))
    assert "unreadable" in caplog.text


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_feature_cache_files_cross_load(dtype, tmp_path):
    rng = np.random.RandomState(2)
    rows = rng.standard_normal((5, 7, 6)).astype(np.float32)
    names = [f"img{i}" for i in range(5)]
    jrows = rows.astype(jnp.bfloat16) if dtype == "bfloat16" else rows
    jcache.FeatureCache(names, jrows).save(str(tmp_path / "jax"))
    got = FeatureCache.load(str(tmp_path / "jax"))
    assert got.names == names and str(got.rows.dtype) == f"torch.{dtype}"
    bits = (lambda t: t.view(torch.int16).numpy()) if dtype == "bfloat16" else (
        lambda t: t.numpy())
    jbits = (lambda a: a.view(np.int16)) if dtype == "bfloat16" else (lambda a: a)
    assert np.array_equal(bits(got.rows), jbits(np.asarray(jrows)))
    got.save(str(tmp_path / "port"))
    back = jcache.FeatureCache.load(str(tmp_path / "port"))
    assert back.names == names and back.rows.dtype == jrows.dtype
    assert np.array_equal(jbits(back.rows), jbits(np.asarray(jrows)))
    assert np.array_equal(bits(got.gather(["img3", "img0"])),
                          jbits(np.asarray(back.gather(["img3", "img0"]))))
    with pytest.raises(KeyError):
        got.gather(["nope"])


def test_build_feature_cache_equals_jax():
    jm = jax_model()
    params = jax_params(jm)
    rng = np.random.RandomState(3)
    images = rng.rand(5, IMG, IMG, 3).astype(np.float32)
    batches = [(["a", "b", "c"], images[:3]), (["c", "d", "e"], images[2:])]  # "c" twice
    want = jcache.build_feature_cache(jm, params, iter(batches))
    got = build_feature_cache(port_model(params).eval(), iter(batches))
    assert got.names == want.names == ["a", "b", "c", "d", "e"]
    assert got.rows.dtype == torch.bfloat16 and got.rows.shape == want.rows.shape
    diff = np.abs(got.rows.float().numpy() - np.asarray(want.rows, np.float32))
    step = np.abs(np.asarray(want.rows, np.float32)) * 2.0 ** -7
    assert (diff <= step + 1e-6).all(), diff.max()


def test_randomize_fiq_captions_equals_jax():
    flat = ["is red.", "has long sleeves?", "Is blue, ", "shorter", "a b", "c d"] * 4
    for seed in range(3):
        assert randomize_fiq_captions(flat, np.random.RandomState(seed)) == jrandomize(
            flat, np.random.RandomState(seed))


def test_metrics_logger_writes_what_jax_writes(tmp_path):
    rows = [{"loss": 1.5, "epoch": 0}, {"loss": 1.25, "epoch": 1}]
    for cls, sub in ((MetricsLogger, "port"), (JMetricsLogger, "jax")):
        logger = cls(str(tmp_path / sub))
        for row in rows:
            logger.log_train(row)
        logger.log_validation({"recall_at1": 10.0, "epoch": 1})
    for name in ("train_metrics.csv", "validation_metrics.csv", "log.jsonl"):
        assert (tmp_path / "port" / name).read_text() == (tmp_path / "jax" / name).read_text()
    lines = (tmp_path / "port" / "log.jsonl").read_text().splitlines()
    assert json.loads(lines[-1]) == {"kind": "val", "recall_at1": 10.0, "epoch": 1}
