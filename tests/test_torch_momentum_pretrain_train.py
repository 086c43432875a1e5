"""The pretrainers' train steps with the trainer's aux state against
sprc_tpu's jitted generic step, as test_torch_momentum_train.py holds the
retrieval models': ``blip_pretrain`` (its ``[DEC]``-prefixed decoder and LM
loss) and ``albef_pretrain`` (its host-masked MLM distilled from the
momentum model's logits), 3 AdamW steps at the YAMLs' 3e-4 on JAX's own hard
negatives; parameters, momentum copies and queues within 1e-5, ``ptr`` and
``idx_queue`` equal.
"""

import pytest

pytest.importorskip("jax")

from test_torch_momentum import jax_draws  # noqa: E402,F401
from test_torch_momentum_train import check_train_steps  # noqa: E402
from test_torch_threads import one_torch_thread  # noqa: E402,F401  (one thread a module)


@pytest.mark.parametrize("name", ["blip_pretrain", "albef_pretrain"])
def test_pretrain_steps_equal_jax(name, jax_draws, monkeypatch):  # noqa: F811
    check_train_steps(name, jax_draws, monkeypatch)
