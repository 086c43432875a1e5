"""The port's CIRR dataset items and gallery batch stream equal sprc_tpu's,
on the tests/test_data.py fixtures (targetpad to 32 px).
"""

import numpy as np
import pytest

from sprc_tpu.cli.validate import index_batches as jax_index_batches
from sprc_tpu.data.datasets import CIRRDataset as JCIRRDataset
from sprc_tpu.data.transforms import targetpad_transform as jax_targetpad

from sprc_tpu_torch.cli.validate import index_batches
from sprc_tpu_torch.data.datasets import CIRRDataset
from sprc_tpu_torch.data.transforms import targetpad_transform

from test_data import cirr_root  # noqa: F401  (fixture)
from test_torch_threads import one_torch_thread  # noqa: E402,F401  (one thread a module)


@pytest.mark.parametrize("split,mode", [("val", "classic"), ("val", "relative"),
                                        ("train", "relative"), ("test1", "relative")])
def test_cirr_items_identical(cirr_root, split, mode):  # noqa: F811
    tfm = targetpad_transform(1.25, 32)
    port = CIRRDataset(cirr_root, split, mode, tfm)
    ref = JCIRRDataset(cirr_root, split, mode, jax_targetpad(1.25, 32))
    assert len(port) == len(ref)
    for i in range(len(ref)):
        a, b = port[i], ref[i]
        assert sorted(a) == sorted(b)
        for k in b:
            if isinstance(b[k], np.ndarray):
                np.testing.assert_array_equal(a[k], b[k])
            else:
                assert a[k] == b[k]


def test_index_batches_identical(cirr_root):  # noqa: F811
    port = list(index_batches(CIRRDataset(cirr_root, "val", "classic",
                                          targetpad_transform(1.25, 32)), 4, 2))
    ref = list(jax_index_batches(JCIRRDataset(cirr_root, "val", "classic",
                                              jax_targetpad(1.25, 32)), 4, 2))
    assert [list(n) for n, _ in port] == [list(n) for n, _ in ref]
    for (_, a), (_, b) in zip(port, ref):
        np.testing.assert_array_equal(a, b)
