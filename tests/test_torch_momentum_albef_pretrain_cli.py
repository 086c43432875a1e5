"""``cli/train.py`` on configs/runs/pretrain_albef.yaml (``albef_pretrain``)
against sprc_tpu's ``run_generic``, as test_torch_momentum_pretrain_cli.py
holds pretrain_14m.yaml: the host MLM masks from one ``RandomState(0)`` in
both collates (their state saved with the port's trainer), the momentum
model's MLM logits through the live head; each step's four losses, the
parameters and the aux state agree.
"""

import pytest

pytest.importorskip("jax")
pytest.importorskip("yaml")

from test_torch_momentum_cli import pairs  # noqa: E402,F401
from test_torch_momentum_pretrain_cli import check_pretrain  # noqa: E402
from test_torch_threads import one_torch_thread  # noqa: E402,F401  (one thread a module)


def test_cli_albef_pretrain_equals_jax(pairs, tmp_path, monkeypatch):  # noqa: F811
    check_pretrain("pretrain_albef.yaml", pairs, tmp_path, monkeypatch)
