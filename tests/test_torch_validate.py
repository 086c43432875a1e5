"""The slice as a whole: ``sprc_tpu_torch.cli.validate`` against
``sprc_tpu.cli.validate`` on the same synthetic trees and the same weights.

A tiny fp32 model is initialised in JAX, exported with ``torch_export`` into
a checkpoint of the released layout (``{epoch, ClassName: state_dict}`` with
the extras a real file carries, as tests/test_golden_rehearsal.py fabricates
it), and both CLIs read that file with the same ``--model-overrides``:
EVA-style under ``--model-type pretrain`` and CLIP-style under
``pretrain_vitL``. The sims of both engines agree within 1e-4 absolute (fp32
sums in another order through 2 ViT blocks and two Q-Former passes of 2
layers) and the printed JSON is equal as text (``indent=4``, the same keys
in the same order).
"""

import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import sprc_tpu.cli.validate as jcli  # noqa: E402
import sprc_tpu.retrieval.engine as jengine  # noqa: E402
from test_data import circo_root, cirr_root, fiq_root  # noqa: E402,F401  (fixtures)
from test_golden_rehearsal import VOCAB, _wrap  # noqa: E402

import sprc_tpu_torch.cli.validate as pcli  # noqa: E402
import sprc_tpu_torch.retrieval.engine as pengine  # noqa: E402
from test_torch_threads import one_torch_thread  # noqa: E402,F401  (one thread a module)

COMMON = ["image_size=28", "num_query_token=4", "max_txt_len=8", "embed_dim=16", "vit_dtype=fp32",
          "qformer_dtype=fp32",
          ("qformer_config_override={vocab_size: 60, hidden_size: 32, num_layers: 2, "
           "num_heads: 2, intermediate_size: 64, encoder_width: 32, query_length: 4, "
           "dropout_rate: 0.0, attention_dropout_rate: 0.0, dtype: fp32}")]
VIT = "image_size: 28, patch_size: 14, width: 32, depth: 2, num_heads: 2, mlp_hidden: 64"
STYLES = {
    "eva": ("pretrain", COMMON + [
        "vit_config_override={" + VIT + ", qkv_fused_no_kbias: true, dtype: fp32}"]),
    "clip": ("pretrain_vitL", COMMON + [
        "vit_config_override={" + VIT + ", layer_norm_eps: 1.0e-5, use_ln_pre: true, "
        "quick_gelu: true, patch_bias: false, dtype: fp32}"]),
}
ATOL = 1e-4


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    from sprc_tpu.interop.torch_export import params_to_torch_state_dict
    from sprc_tpu.loader import build_model, init_params

    root = tmp_path_factory.mktemp("validate")
    vocab = root / "vocab.txt"
    vocab.write_text("\n".join(VOCAB) + "\n")
    out = {"vocab": str(vocab)}
    for style, (model_type, overrides) in STYLES.items():
        model = build_model("blip2_cir_align_prompt", model_type,
                            **jcli.parse_model_overrides(overrides))
        params = init_params(model, rng=jax.random.PRNGKey(3))
        rng = np.random.RandomState(5)  # zero-initialised biases made non-zero

        def noisy(a, rng=rng):
            a = np.asarray(a)
            return a if a.ndim == 0 else a + (rng.standard_normal(a.shape) * 0.02).astype(a.dtype)

        params = jax.tree_util.tree_map(noisy, params)
        sd = params_to_torch_state_dict(params, model)
        out[style] = str(root / f"{style}.pt")
        torch.save(_wrap(torch, "Blip2QformerCirAlignPrompt", sd), out[style])
    return out


def _run_both(monkeypatch, capsys, argv):
    """Both CLIs on ``argv`` -> (JAX sims, port sims, JAX text, port text)."""
    sims = {"jax": [], "port": []}

    def recording(cls, key):
        inner = cls.score_queries

        def score_queries(self, *a, **kw):
            out = inner(self, *a, **kw)
            sims[key].append(np.asarray(out))
            return out

        monkeypatch.setattr(cls, "score_queries", score_queries)

    recording(jengine.RetrievalEngine, "jax")
    recording(pengine.RetrievalEngine, "port")
    jcli.main(argv)
    jtext = capsys.readouterr().out
    pcli.main(argv + ["--device", "cpu"])
    ptext = capsys.readouterr().out
    return sims["jax"], sims["port"], jtext, ptext


@pytest.mark.parametrize("style", ["eva", "clip"])
@pytest.mark.parametrize("dataset", ["CIRR", "fashionIQ", "CIRCO"])
def test_validate_cli_matches_jax(dataset, style, checkpoints, cirr_root, fiq_root,  # noqa: F811
                                  circo_root, monkeypatch, capsys):  # noqa: F811
    model_type, overrides = STYLES[style]
    data = {"CIRR": cirr_root, "fashionIQ": fiq_root, "CIRCO": circo_root}[dataset]
    argv = ["--dataset", dataset, "--data-path", str(data), "--model-path", checkpoints[style],
            "--model-type", model_type, "--vocab-path", checkpoints["vocab"],
            "--encode-batch", "4", "--query-batch", "2", "--workers", "2", "--no-bf16",
            "--dress-types", "dress", "--model-overrides", *overrides]
    jsims, psims, jtext, ptext = _run_both(monkeypatch, capsys, argv)
    assert len(jsims) == len(psims) == 1
    np.testing.assert_allclose(psims[0], jsims[0], atol=ATOL)
    assert np.ptp(jsims[0]) > 10 * ATOL  # the scores tell the gallery apart
    assert ptext == jtext
    assert json.loads(ptext)


def test_small_parser_equals_yaml_on_the_values_the_repo_uses():
    import yaml

    values = ["28", "fp32", "bf16", "0.0", "1.0e-5", "1e-5", "true", "false", "null", "-3",
              "int8_static", "'a b'", "{}"]
    values += [pair.partition("=")[2] for _, ovr in STYLES.values() for pair in ovr]
    from test_golden_rehearsal import OVERRIDES

    values += [pair.partition("=")[2] for pair in OVERRIDES]
    for value in values:
        want, got = yaml.safe_load(value), pcli._yaml_value(value)
        assert got == want and type(got) is type(want), value
    pairs = STYLES["eva"][1]
    assert pcli.parse_model_overrides(pairs, use_yaml=False) == jcli.parse_model_overrides(pairs)
    for bad in ("[1, 2]", "{a: {b: 1}}", "010", "0x1f"):
        with pytest.raises(ValueError, match="PyYAML"):
            pcli._yaml_value(bad)


def test_cli_needs_a_gpu_unless_asked_for_the_cpu(checkpoints, cirr_root):  # noqa: F811
    parser = pcli.make_parser()
    assert parser.get_default("device") == "cuda" and parser.get_default("model_type") == "pretrain"
    assert parser.parse_args(["--dataset", "CIRR", "--data-path", "x", "--mesh"]).mesh
    assert not parser.get_default("mesh")  # the JAX CLI's flag, off by default
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit) as exc:
        pcli.main(["--dataset", "CIRR", "--data-path", str(cirr_root), "--vocab-path",
                   checkpoints["vocab"], "--model-overrides", *STYLES["eva"][1]])
    assert exc.value.code not in (0, None)
