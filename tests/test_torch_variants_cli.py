"""The port's fine-tune and validate CLIs on the CIR variant zoo, on the CPU,
over the synthetic CIRR tree of tests/test_data.py.

The tiny EVA-style model of test_torch_finetune_cli.py (its ``load_model``
patch, dropout 0.1, random weights from the CLI's seed) trains a loss
variant for an epoch of 2-triplet batches and validates; the rerank model
trains live and from the feature cache (``--cache-features``), whose epoch
losses equal the live run's within 1e-5 relative (the cache encodes the
images in other batches than the live steps: fp32 sums in another order);
the two variants whose forward returns tensors are refused before a model
is built; and the validate CLI scores every variant by ``--model-name``.
"""

import json
import os

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import sprc_tpu_torch.cli.finetune as pcli  # noqa: E402
import sprc_tpu_torch.cli.validate as pvalidate  # noqa: E402
from sprc_tpu_torch.loader import CIR_MODELS, load_model  # noqa: E402
from test_data import cirr_root  # noqa: E402,F401  (fixture)
from test_torch_finetune_cli import OVERRIDES, TINY, _argv, tiny_cli_model, vocab  # noqa: E402,F401
from test_torch_threads import one_torch_thread  # noqa: E402,F401  (one thread a module)


def _logs(out):
    return [json.loads(line) for line in (out / "log.jsonl").read_text().splitlines()]


def test_finetune_cli_trains_a_loss_variant_and_validate_reads_it(cirr_root, vocab,  # noqa: F811
                                                                  tmp_path, capsys):
    """``--model-name blip2_cir_neg``: an epoch (ITC and the hard-negative
    ITM, weighted 1 and 1), its validation, the best weights; the validate
    CLI scores that checkpoint with the same ``--model-name``."""
    out = tmp_path / "neg"
    pcli.main(_argv(cirr_root, out, vocab, "--model-name", "blip2_cir_neg"))
    train, val = _logs(out)
    assert {"loss_itc", "loss_itm", "loss"} <= set(train) and "loss_rtc" not in train
    assert abs(train["loss"] - train["loss_itc"] - train["loss_itm"]) <= 1e-5 * train["loss"]
    assert val["kind"] == "val" and 0.0 <= val["arithmetic_mean"] <= 100.0
    best = str(out / "best_arithmetic_mean.pt")
    model = load_model("blip2_cir_neg", "pretrain", best, device="cpu", **TINY)
    assert type(model).__name__ == "CirNeg"
    capsys.readouterr()
    pvalidate.main(["--dataset", "CIRR", "--data-path", str(cirr_root), "--model-path", best,
                    "--model-name", "blip2_cir_neg", "--vocab-path", vocab, "--device", "cpu",
                    "--encode-batch", "4", "--query-batch", "2", "--workers", "1", "--no-bf16",
                    "--model-overrides", *OVERRIDES])
    metrics = json.loads(capsys.readouterr().out)
    assert metrics["arithmetic_mean"] == pytest.approx(val["arithmetic_mean"], abs=1e-6)


def test_finetune_cli_rerank_cached_equals_live(cirr_root, vocab, tmp_path):  # noqa: F811
    """``blip2_cir_rerank`` from pixels and with ``--cache-features``: the
    same epoch losses; the frozen twin is not in the trained state."""
    runs = {}
    for mode, extra in (("live", ()), ("cached", ("--cache-features",))):
        out = tmp_path / mode
        pcli.main(_argv(cirr_root, out, vocab, "--model-name", "blip2_cir_rerank",
                        "--validate-every", "0", *extra))
        (runs[mode],) = _logs(out)
        state = torch.load(out / "last_state.pt", weights_only=True)
        assert state["step"] == 2
        assert not any(k.startswith(("Fformer", "query_tokens_f", "vision_proj_f",
                                     "text_proj_f", "visual_encoder"))
                       for k in state["trainable"])
        assert "Qformer.bert.embeddings.LayerNorm.weight" in state["trainable"]
    assert os.path.exists(tmp_path / "cached" / "feature_cache.npz")
    live, cached = runs["live"], runs["cached"]
    assert set(live) == set(cached) and "loss_itm" in live
    for key in ("loss_itm", "loss"):
        assert np.isfinite(live[key])
        assert abs(live[key] - cached[key]) <= 1e-5 * abs(live[key]), (key, live, cached)


@pytest.mark.parametrize("name", ["blip2_cir_slt", "blip2_cir_prompt"])
def test_finetune_cli_refuses_a_forward_without_losses(
        name, cirr_root, vocab, tmp_path, monkeypatch):  # noqa: F811
    built = []
    monkeypatch.setattr("sprc_tpu_torch.loader.load_model", lambda *a, **kw: built.append(a))
    with pytest.raises(SystemExit, match="returns tensors"):
        pcli.main(_argv(cirr_root, tmp_path / "out", vocab, "--model-name", name))
    assert not built


def test_validate_cli_reaches_every_variant(cirr_root, vocab, capsys):  # noqa: F811
    """Every CIR name through ``--model-name`` (random weights): the
    engine's stage 1 scores each through ``fusion_feature``."""
    for name in CIR_MODELS:
        pvalidate.main(["--dataset", "CIRR", "--data-path", str(cirr_root), "--model-name", name,
                        "--vocab-path", vocab, "--device", "cpu", "--encode-batch", "4",
                        "--query-batch", "2", "--workers", "1", "--no-bf16",
                        "--model-overrides", *OVERRIDES])
        metrics = json.loads(capsys.readouterr().out)
        assert "arithmetic_mean" in metrics, name
        assert all(np.isfinite(v) and 0.0 <= v <= 100.0 for v in metrics.values()), name
