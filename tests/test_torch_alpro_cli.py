"""``cli/train.py`` and ``cli/evaluate.py`` on ALPRO's run YAMLs against
sprc_tpu's ``run_generic`` and evaluate CLI.

Each of configs/runs/{msrvtt_retrieval_ft, msrvtt_qa_ft}.yaml and
configs/runs/eval/{msrvtt_ret_eval, msvd_qa_eval}.yaml is read as it is, with
the tiny towers of test_torch_alpro.py cut to one block and two layers (the
med-BERT at the synthetic BERT vocabulary's 30,522 rows, fusion from layer
1, dropout 0), 4 sampled frames a clip (the QA
models' TimeSformer with 8 time rows, as the YAMLs build 16 for 8 frames),
its dataset over seeded uint8 ``.npy`` clips through the YAML's ALPRO
processor at 32 px (the train one seeded). Both runs start from one
LAVIS-layout file of the port's weights (the trunk under
``visual_encoder.model.``, a ``token_type_embeddings`` table): the port
reads it through ``--model-path``, the JAX evaluate CLI through its LAVIS
reader, and the JAX training run's init is handed what that reader gives
(its orbax write replaced by a no-op). The hard negatives are the argmax in
both packages (``jax.random.categorical``, ``alpro.sample_negatives``
patched in this process). Training: each step's losses within 1e-5 and the
trained parameters within 1e-5; evaluation: the printed metrics equal.
"""

import argparse
import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
yaml = pytest.importorskip("yaml")
import jax.numpy as jnp  # noqa: E402

from sprc_tpu_torch import loader  # noqa: E402
from sprc_tpu_torch.interop.jax_params import alpro_from_jax  # noqa: E402
from test_torch_alpro import TEXT, VIDEO  # noqa: E402
from test_torch_threads import one_torch_thread  # noqa: E402,F401  (one thread a module)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
FRAMES, SIZE = 4, 32
# run YAML -> (arch, its dataset builder, the tower's time rows, extra model fields)
RUNS = {"msrvtt_retrieval_ft.yaml": ("alpro_retrieval", "msrvtt_retrieval", FRAMES, {}),
        "msrvtt_qa_ft.yaml": ("alpro_qa", "msrvtt_qa", 2 * FRAMES, {"num_classes": 3}),
        "eval/msrvtt_ret_eval.yaml": ("alpro_retrieval", "msrvtt_retrieval", FRAMES, {}),
        "eval/msvd_qa_eval.yaml": ("alpro_qa", "msvd_qa", 2 * FRAMES, {"num_classes": 4})}
WORDS = ["a", "dog", "runs", "on", "the", "grass", "red", "car", "two", "cats", "sky"]
ANSWERS = ["dog", "car", "sky", "cats", "grass"]


def model_section(name):
    """The tiny towers cut to one TimeSformer block and a 2-layer med-BERT
    (fusion from layer 1): the JAX train step compiles in half the time."""
    _, _, rows, extra = RUNS[name]
    return {"image_size": SIZE, "num_frames": rows, "embed_dim": 8, "fusion_layer": 1,
            "video_config_override": dict(VIDEO, num_frames=rows, depth=1),
            "text_config_override": dict(TEXT, vocab_size=30522, num_layers=2), **extra}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """8 seeded clips of 6 frames, the train, retrieval-test and QA
    annotations over them, a synthetic BERT vocabulary."""
    from sprc_tpu_torch.utils.artifacts import write_synthetic_bert_vocab

    root = tmp_path_factory.mktemp("clips")
    rng = np.random.RandomState(23)
    names = []
    for i in range(8):
        names.append(f"c{i}.npy")
        np.save(root / names[-1], (rng.rand(6, 36 + i, 40, 3) * 255).astype(np.uint8))
    ann = {"ret_train": [{"video": n, "caption": " ".join(rng.choice(WORDS, 6)),
                          "image_id": f"v{i}"} for i, n in enumerate(names)],
           "ret_test": [{"video": n, "caption": [" ".join(rng.choice(WORDS, 5))
                                                 for _ in range(2)]} for n in names[:6]],
           "qa_train": [{"video": n, "question": f"what is the {rng.choice(WORDS)}",
                         "answer": [str(a) for a in rng.choice(ANSWERS, 2)]}
                        for n in names],
           "qa_test": [{"video": n, "question": f"what is {rng.choice(WORDS)} doing",
                        "answer": str(rng.choice(ANSWERS))} for n in names[:6]]}
    for key, rows in ann.items():
        (root / f"{key}.json").write_text(json.dumps(rows))
    return {"root": str(root), "vocab": write_synthetic_bert_vocab(str(root / "vocab.txt"))}


def lavis_file(name, path, seed):
    """The port's tiny model of ``name`` as a LAVIS ALPRO checkpoint: the
    trunk under ``visual_encoder.model.``, a token-type table beside the
    position rows (folded in by both readers), no ``position_ids``."""
    arch = RUNS[name][0]
    model = loader.load_model(arch, "pretrain", device="cpu", seed=seed,
                              **model_section(name))
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in model.state_dict().items():
        if not k.endswith("position_ids"):
            sd[k.replace("visual_encoder.", "visual_encoder.model.", 1)] = (
                v + torch.randn(v.shape, generator=gen) * 0.05)
    sd["text_encoder.embeddings.token_type_embeddings.weight"] = torch.randn(
        2, TEXT["hidden_size"], generator=gen) * 0.05
    torch.save({"model": sd}, path)
    return {k: v.numpy() for k, v in sd.items()}


def run_config(name, data, split, ann, **run):
    with open(os.path.join(ROOT, "configs", "runs", name)) as f:
        cfg = yaml.safe_load(f)
    _, builder, _, _ = RUNS[name]
    cfg["run"].update(run)
    cfg["model"].update(model_section(name))
    ds = cfg["datasets"][builder]
    ds["build_info"] = {"annotations": {split: [os.path.join(data["root"], ann)]},
                        "videos": data["root"], "n_frms": FRAMES}
    (proc,) = ds["vis_processor"].values()
    proc.update(image_size=SIZE, **({"seed": 5} if split == "train" else {}))
    return cfg


def _argmax_negatives(monkeypatch):
    from sprc_tpu_torch.models import alpro

    monkeypatch.setattr(jax.random, "categorical",
                        lambda key, logits, axis=-1, **kw: jnp.argmax(logits, axis=axis))
    monkeypatch.setattr(alpro, "sample_negatives", lambda weights, generator: weights.argmax(1))


def _rows(out):
    with open(os.path.join(out, "log.jsonl")) as f:
        return [r for r in map(json.loads, f) if r["kind"] == "step"]


@pytest.mark.parametrize("name,ann", [("msrvtt_retrieval_ft.yaml", "ret_train.json"),
                                      ("msrvtt_qa_ft.yaml", "qa_train.json")])
def test_cli_train_equals_jax(name, ann, data, tmp_path, monkeypatch):
    """Two steps at batch 4 (the QA vocabulary the 3 most frequent train
    answers, so that some targets are -1): the losses of each step and the
    parameters after the run equal JAX's."""
    from sprc_tpu.config import Config as JConfig
    from sprc_tpu.interop.lavis_import import lavis_params_from_torch
    from sprc_tpu.train import checkpoint as jcheckpoint
    from sprc_tpu.train import generic as jgeneric
    from sprc_tpu.train import runner as jrunner

    from sprc_tpu_torch.cli import train as train_cli
    from sprc_tpu_torch.config import Config

    ckpt = str(tmp_path / "alpro.pth")
    sd = lavis_file(name, ckpt, seed=11)
    cfg = run_config(name, data, "train", ann, batch_size=4, max_epochs=1, log_freq=1)
    captured = {}
    train = jrunner.EpochRunner.train

    def keep_state(self):
        best = train(self)
        captured["params"] = jax.tree_util.tree_map(np.asarray, self.state.params)
        return best

    monkeypatch.setattr(jrunner.EpochRunner, "train", keep_state)
    monkeypatch.setattr(jcheckpoint, "save_state", lambda path, state: None)
    adapter = {"msrvtt_retrieval_ft.yaml": jgeneric.AlproRetrievalAdapter,
               "msrvtt_qa_ft.yaml": jgeneric.AlproQAAdapter}[name]
    monkeypatch.setattr(adapter, "init_params",
                        lambda self, jm, rng, size: lavis_params_from_torch(sd, jm))
    _argmax_negatives(monkeypatch)

    def args(side):
        return argparse.Namespace(output_dir=str(tmp_path / side), vocab_path=data["vocab"],
                                  model_path=ckpt, device="cpu", data_path=None)

    jgeneric.run_generic(JConfig(defaults=cfg), args("jax"))
    train_cli.train(Config(defaults=cfg), args("port"))
    want, got = _rows(tmp_path / "jax"), _rows(tmp_path / "port")
    assert [r["step"] for r in got] == [r["step"] for r in want] == [0, 1]
    for g, w in zip(got, want):
        assert not w["skipped_nonfinite"] and not g["skipped_nonfinite"]
        for key in [k for k in w if k.startswith("loss")]:
            assert abs(g[key] - w[key]) <= TOL * max(1.0, abs(w[key])), (g["step"], key)
    state = torch.load(tmp_path / "port" / "last_state.pt", weights_only=True)
    assert state["updates"] == 2
    want_params = alpro_from_jax(captured["params"])
    assert set(state["trainable"]) == {k for k in want_params if not k.endswith("position_ids")}
    for n, value in state["trainable"].items():
        np.testing.assert_allclose(value.numpy(), want_params[n].numpy(), atol=TOL, err_msg=n)


@pytest.mark.parametrize("name,ann", [("eval/msrvtt_ret_eval.yaml", "ret_test.json"),
                                      ("eval/msvd_qa_eval.yaml", "qa_test.json")])
def test_cli_evaluate_equals_jax(name, ann, data, tmp_path, capsys):
    """6 clips (retrieval: 2 captions each, k_test 4; QA: over a 4-answer
    list that leaves one answer out, so that its targets are -1): the JSON
    line each CLI prints is the same; the QA result files are the same."""
    from sprc_tpu.cli import evaluate as jevaluate

    from sprc_tpu_torch.cli import evaluate

    ckpt = str(tmp_path / "alpro.pth")
    lavis_file(name, ckpt, seed=12)
    run = {"k_test": 4} if "ret" in name else {"answer_list": ANSWERS[:4], "batch_size_eval": 6}
    cfg = run_config(name, data, "test", ann, **run)
    path = tmp_path / "run.yaml"
    path.write_text(yaml.safe_dump(cfg))
    lines = {}
    for side, main in (("jax", jevaluate.main), ("port", evaluate.main)):
        argv = ["--cfg-path", str(path), "--model-path", ckpt, "--vocab-path", data["vocab"],
                "--output-dir", str(tmp_path / side)]
        main(argv + (["--device", "cpu"] if side == "port" else []))
        lines[side] = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert lines["port"] == lines["jax"] and "agg_metrics" in lines["port"]
    if "qa" in name:
        rows = [json.loads((tmp_path / side / "result" / "test_epochx.json").read_text())
                for side in ("jax", "port")]
        assert rows[0] == rows[1] and len(rows[0]) == 6
        assert any(r["target"] == -1 for r in rows[1])
    else:
        assert set(lines["port"]) >= {"txt_r1", "img_r10", "r_mean"}
