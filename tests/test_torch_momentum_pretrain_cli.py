"""``cli/train.py`` on configs/runs/pretrain_14m.yaml (``blip_pretrain``; and
pretrain_albef.yaml, ``albef_pretrain``, in
test_torch_momentum_albef_pretrain_cli.py) against sprc_tpu's ``run_generic``,
as test_torch_momentum_cli.py holds the retrieval YAMLs: the tiny towers,
one LAVIS-layout file of the port's weights (momentum modules and queues
beside them), both samplers patched to the argmax. The pretrainers' collate
adds the ``[DEC]``-prefixed decoder ids (``[DEC]`` the tokenizer's
``bos_id``, 30,522) and the host MLM
masks of one ``RandomState(0)``; each step's four losses, the parameters
and the aux state agree. The learning rate is 1e-4 (the YAMLs' 3e-4 at
batch 64): Adam's first updates are about ``lr x g / |g|``, so an element
whose gradient is tiny moves by a share of lr that the fp32 rounding of g
shifts (at 3e-4, one of 8,192 elements of a med-BERT weight differed by
1.13e-5 after the three steps).
"""

import pytest

pytest.importorskip("jax")
pytest.importorskip("yaml")

from test_torch_momentum_cli import check_equal, pairs, run_both  # noqa: E402,F401
from test_torch_threads import one_torch_thread  # noqa: E402,F401  (one thread a module)


def test_cli_blip_pretrain_equals_jax(pairs, tmp_path, monkeypatch):  # noqa: F811
    check_pretrain("pretrain_14m.yaml", pairs, tmp_path, monkeypatch)


def check_pretrain(name, pairs, tmp_path, monkeypatch):
    model, jstate, state = run_both(name, pairs, tmp_path, monkeypatch, learning_rate=1e-4)
    check_equal(name, model, jstate, state, tmp_path)
    # the MLM masks' RandomState is the only adapter state
    assert ("adapter" in state) == (name == "pretrain_albef.yaml")
