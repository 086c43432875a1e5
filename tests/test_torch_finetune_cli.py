"""The port's fine-tune CLI (``python -m sprc_tpu_torch.cli.finetune``) end to
end on the CPU, over the synthetic trees of tests/test_data.py.

A tiny EVA-style model (ViT width 128 / depth 2, Q-Former hidden 128 / 2
layers, Q=4, dropout 0.1, random weights from the CLI's seed; the CLI's
``load_model`` is patched to build it) trains for an epoch of 2-triplet
batches, validates, and writes its outputs. The best
checkpoint, in the released ``{epoch, ClassName: state_dict}`` layout, loads
into the port's ``load_model`` and into the JAX package
(``load_checkpoint_auto`` -> ``cir_align_prompt_params_from_torch``), whose
target features and scores agree within 1e-4 (fp32 sums in another order,
as tests/test_torch_validate.py). A run resumed from ``last_state.pt``
ends in the state of the run it continues, exactly (the same fp32 ops in
the same order on one CPU).
"""

import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import sprc_tpu.cli.finetune as jcli  # noqa: E402
from sprc_tpu.cli.validate import parse_model_overrides as jparse  # noqa: E402
from test_data import cirr_root, fiq_root  # noqa: E402,F401  (fixtures)
from test_golden_rehearsal import VOCAB  # noqa: E402

import sprc_tpu_torch.cli.finetune as pcli  # noqa: E402
import sprc_tpu_torch.loader as port_loader  # noqa: E402
from sprc_tpu_torch.cli.validate import parse_model_overrides  # noqa: E402
from sprc_tpu_torch.loader import load_model  # noqa: E402
from test_torch_threads import one_torch_thread  # noqa: E402,F401  (one thread a module)

ATOL = 1e-4
OVERRIDES = [
    "image_size=28", "num_query_token=4", "max_txt_len=8", "embed_dim=64", "vit_dtype=fp32",
    "qformer_dtype=fp32",
    ("vit_config_override={image_size: 28, patch_size: 14, width: 128, depth: 2, "
     "num_heads: 2, mlp_hidden: 256, qkv_fused_no_kbias: true, dtype: fp32}"),
    ("qformer_config_override={vocab_size: 60, hidden_size: 128, num_layers: 2, num_heads: 2, "
     "intermediate_size: 256, encoder_width: 128, query_length: 4, dropout_rate: 0.1, "
     "dtype: fp32}"),
]
TINY = parse_model_overrides(OVERRIDES)


@pytest.fixture(scope="module", autouse=True)
def tiny_cli_model():
    """The CLI's ``load_model`` builds the tiny model: TINY beneath the
    CLI's own arguments (its ``vit_dtype`` from ``--no-bf16``)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_loader, "load_model", lambda *a, **kw: load_model(*a, **{**TINY, **kw}))
        yield


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    path = tmp_path_factory.mktemp("vocab") / "vocab.txt"
    path.write_text("\n".join(VOCAB) + "\n")
    return str(path)


def _argv(data, out, vocab, *extra, dataset="CIRR"):
    return ["--dataset", dataset, "--data-path", str(data), "--vocab-path", vocab,
            "--output-dir", str(out), "--device", "cpu", "--batch-size", "2",
            "--num-epochs", "1", "--encode-batch", "4", "--query-batch", "2", "--workers", "1",
            "--seed", "0", "--no-bf16", *extra]


@pytest.fixture(scope="module")
def cirr_run(cirr_root, vocab, tmp_path_factory):  # noqa: F811
    out = tmp_path_factory.mktemp("finetune_cirr")
    pcli.main(_argv(cirr_root, out, vocab))
    return out


def test_cirr_epoch_validates_and_keeps_the_best(cirr_run):
    names = set(os.listdir(cirr_run))
    assert {"training_hyperparameters.json", "train_metrics.csv", "validation_metrics.csv",
            "log.jsonl", "best_arithmetic_mean.pt", "best_arithmetic_mean.txt",
            "last_state.pt"} <= names
    logs = [json.loads(line) for line in (cirr_run / "log.jsonl").read_text().splitlines()]
    train, val = logs
    assert train["kind"] == "train" and train["epoch"] == 0
    for key in ("loss_itc", "loss_rtc", "loss_align", "loss"):
        assert np.isfinite(train[key]) and train[key] > 0, key
    assert train["skipped_nonfinite"] == 0.0
    assert val["kind"] == "val" and 0.0 <= val["arithmetic_mean"] <= 100.0
    ckpt = torch.load(cirr_run / "best_arithmetic_mean.pt", weights_only=True)
    assert set(ckpt) == {"epoch", "Blip2QformerCirAlignPrompt"} and ckpt["epoch"] == 0
    state = torch.load(cirr_run / "last_state.pt", weights_only=True)
    assert (state["step"], state["updates"], state["epoch"]) == (2, 2, 0)  # 4 triplets / 2


def test_best_checkpoint_scores_alike_in_both_packages(cirr_run):
    from sprc_tpu.interop.torch_import import load_checkpoint_auto
    from sprc_tpu.loader import build_model as jbuild

    path = str(cirr_run / "best_arithmetic_mean.pt")
    port = load_model("blip2_cir_align_prompt", "pretrain", path, device="cpu",
                      **TINY)
    jm = jbuild("blip2_cir_align_prompt", "pretrain", **jparse(OVERRIDES))
    params = load_checkpoint_auto(path, jm)
    rng = np.random.RandomState(6)
    images = rng.rand(3, 28, 28, 3).astype(np.float32)
    ids = rng.randint(1, len(VOCAB), (2, 8)).astype(np.int32)
    mask = np.ones((2, 8), np.int32)
    mask[1, -2:] = 0
    jfeats, jfrozen = jax.jit(lambda p, x: jm.apply({"params": p}, x,
                                                    method=jm.extract_target_features))(
        params, jnp.asarray(images))
    jscores = jm.apply({"params": params}, jfrozen[:2], jfeats, ids, mask, method=jm.inference)
    with torch.no_grad():
        feats, frozen = port.extract_target_features(torch.from_numpy(images))
        scores = port.inference(frozen[:2], feats, torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(feats.numpy(), np.asarray(jfeats), atol=ATOL)
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores), atol=ATOL)
    trained = torch.load(path, weights_only=True)["Blip2QformerCirAlignPrompt"]
    fresh = load_model("blip2_cir_align_prompt", "pretrain", device="cpu", seed=0,
                       **TINY).state_dict()
    assert not torch.equal(trained["query_tokens"], fresh["query_tokens"])  # it trained
    assert torch.equal(trained["visual_encoder.pos_embed"], fresh["visual_encoder.pos_embed"])


def test_resume_restores_step_optimizer_and_generator(cirr_root, vocab, tmp_path):  # noqa: F811
    """Two epochs in one run against one epoch, then a resumed second."""
    once, twice = tmp_path / "once", tmp_path / "twice"
    no_val = ("--validate-every", "0")
    pcli.main(_argv(cirr_root, once, vocab, *no_val, "--num-epochs", "2"))
    pcli.main(_argv(cirr_root, twice, vocab, *no_val))
    half = torch.load(twice / "last_state.pt", weights_only=True)
    assert (half["step"], half["epoch"]) == (2, 0)
    pcli.main(_argv(cirr_root, twice, vocab, *no_val, "--num-epochs", "2",
                    "--resume", str(twice / "last_state.pt")))
    a = torch.load(once / "last_state.pt", weights_only=True)
    b = torch.load(twice / "last_state.pt", weights_only=True)
    assert (a["step"], a["updates"], a["epoch"]) == (b["step"], b["updates"], b["epoch"]) == (
        4, 4, 1)
    assert torch.equal(a["generator"], b["generator"])
    assert not torch.equal(a["generator"], half["generator"])
    for name, value in a["trainable"].items():
        assert torch.equal(value, b["trainable"][name]), name
    for i, slot in a["optimizer"]["state"].items():
        for key, value in slot.items():
            assert torch.equal(torch.as_tensor(value),
                               torch.as_tensor(b["optimizer"]["state"][i][key])), (i, key)

    def epoch_1(out):
        logs = [json.loads(line) for line in (out / "log.jsonl").read_text().splitlines()]
        (row,) = [r for r in logs if r["epoch"] == 1]
        return {k: v for k, v in row.items() if k.startswith("loss")}

    assert epoch_1(once) == epoch_1(twice)


def test_fashioniq_epoch(fiq_root, vocab, tmp_path):  # noqa: F811
    pcli.main(_argv(fiq_root, tmp_path, vocab, "--dress-types", "dress",
                    "--selection-metric", "average_recall", dataset="fashionIQ"))
    logs = [json.loads(line) for line in (tmp_path / "log.jsonl").read_text().splitlines()]
    train, val = logs
    assert np.isfinite(train["loss"]) and train["epoch"] == 0
    assert {"dress_recall_at10", "dress_recall_at50", "average_recall"} <= set(val)
    assert os.path.exists(tmp_path / "best_average_recall.pt")
    state = torch.load(tmp_path / "last_state.pt", weights_only=True)
    assert state["step"] == 1  # 3 triplets, batches of 2, the last dropped


def test_cached_features_build_then_load(cirr_root, vocab, tmp_path, capsys):  # noqa: F811
    """--cache-features: one encode pass writes the cache files (the JAX
    package's format); a second run loads them; both train finite losses."""
    argv = _argv(cirr_root, tmp_path, vocab, "--cache-features", "--validate-every", "0")
    pcli.main(argv)
    first = capsys.readouterr().out
    assert "built feature cache: 6 images" in first
    assert os.path.exists(tmp_path / "feature_cache.npz")
    pcli.main(argv)
    assert "loaded feature cache (6 images)" in capsys.readouterr().out
    from sprc_tpu.train.feature_cache import FeatureCache as JFeatureCache

    cache = JFeatureCache.load(str(tmp_path / "feature_cache"))
    assert cache.rows.shape == (6, 5, 128) and str(cache.rows.dtype) == "bfloat16"
    for line in (tmp_path / "log.jsonl").read_text().splitlines():
        assert np.isfinite(json.loads(line)["loss"])


def test_flags_are_the_jax_clis_with_mesh_and_remat():
    def flags(parser):
        return {a.dest: a.default for a in parser._actions if a.dest != "help"}

    jax_flags, port_flags = flags(jcli.make_parser()), flags(pcli.make_parser())
    assert set(jax_flags) - set(port_flags) == set()  # --remat and --mesh included
    assert set(port_flags) - set(jax_flags) == {"device"}
    assert all(port_flags[k] == v for k, v in jax_flags.items())
    assert port_flags["device"] == "cuda"
    parser = pcli.make_parser()
    assert parser.parse_args(["--dataset", "CIRR", "--data-path", "x", "--mesh"]).mesh
    assert parser.parse_args(["--dataset", "CIRR", "--data-path", "x", "--remat"]).remat
    if torch.cuda.is_available():
        return
    with pytest.raises(SystemExit, match="no CUDA device"):
        pcli.main(["--dataset", "CIRR", "--data-path", "x"])
