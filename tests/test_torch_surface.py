"""The rest of the port's surface against sprc_tpu's: ``cli/convert.py``
(with ``interop/torch_export.py`` and ``interop/torch_import.py``),
``train/tasks.CirTask``, ``utils/{determinism,profiling,cache}.py``,
``retrieval/visualize.py``, and the package's exports and model zoo.

The converted file is held against sprc_tpu's ``params_to_torch_state_dict``
on test_torch_model.py's tiny CIR model, written as the JAX convert CLI
writes it: the same class name, keys and values, bit for bit.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from test_torch_threads import one_torch_thread  # noqa: E402,F401  (one thread a module)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the tiny CIR model of test_torch_model.py as --model-overrides pairs
TINY = ["image_size=28", "num_query_token=4", "max_txt_len=8", "vocab_size=60", "embed_dim=64",
        "vit_config_override={image_size: 28, patch_size: 14, width: 128, depth: 2, "
        "num_heads: 2, mlp_hidden: 256, layer_norm_eps: 1.0e-5, use_ln_pre: true, "
        "quick_gelu: true, patch_bias: false, dtype: fp32}",
        "qformer_config_override={vocab_size: 60, hidden_size: 128, num_layers: 2, "
        "num_heads: 2, intermediate_size: 256, encoder_width: 128, query_length: 4}"]
CONVERT = ["--model-name", "blip2_cir_align_prompt", "--model-type", "pretrain_vitL",
           "--device", "cpu", "--model-overrides", *TINY]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The JAX params of the tiny CIR model, its JAX export as the JAX
    convert CLI writes it, and the port's state-dict file of the same
    weights."""
    from sprc_tpu.interop.torch_export import params_to_torch_state_dict

    from sprc_tpu_torch.interop.jax_params import state_dict_from_jax
    from test_torch_model import jax_model, jax_params

    root = tmp_path_factory.mktemp("convert")
    jmodel = jax_model()
    params = jax_params(jmodel)
    sd = params_to_torch_state_dict(params, jmodel)
    want = {jmodel.__class__.__name__: {k: torch.from_numpy(np.array(v, np.float32))
                                        for k, v in sd.items()}}
    src = str(root / "port_state.pth")
    torch.save(state_dict_from_jax(params), src)
    return {"root": root, "want": want, "src": src}


def test_convert_writes_the_jax_export(tiny):
    from sprc_tpu_torch.cli import convert

    out = str(tiny["root"] / "export.pt")
    convert.main(CONVERT + ["--input", tiny["src"], "--output", out])
    got = torch.load(out, weights_only=True)
    (name, want), = tiny["want"].items()
    assert list(got) == [name] == ["CirAlignPrompt"]
    assert set(got[name]) == set(want)
    for key, value in want.items():
        assert got[name][key].dtype == value.dtype == torch.float32, key
        assert torch.equal(got[name][key], value), key
    # the port reads its own export back, strictly
    from sprc_tpu_torch.interop.torch_import import load_checkpoint_auto
    from sprc_tpu_torch.loader import build_model
    from sprc_tpu_torch.cli.validate import parse_model_overrides

    model = build_model("blip2_cir_align_prompt", "pretrain_vitL", device="cpu",
                        **parse_model_overrides(TINY))
    load_checkpoint_auto(out, model)
    assert torch.equal(model.query_tokens, want["query_tokens"])


def test_convert_reads_a_training_state_and_refuses_orbax(tiny):
    """A ``last_state.pt`` of a run over the frozen tower: its trained
    tensors over the start checkpoint's; without the start checkpoint it
    names what is missing; ``--to orbax`` exits."""
    from sprc_tpu_torch.cli import convert
    from sprc_tpu_torch.cli.validate import parse_model_overrides
    from sprc_tpu_torch.loader import build_model
    from sprc_tpu_torch.train.checkpoint import save_state
    from sprc_tpu_torch.train.loop import TrainConfig, Trainer

    def model():
        m = build_model("blip2_cir_align_prompt", "pretrain_vitL", device="cpu",
                        **parse_model_overrides(TINY))
        m.load_state_dict(torch.load(tiny["src"], weights_only=True), strict=True)
        return m

    trained = model()
    trainer = Trainer(trained, TrainConfig())
    with torch.no_grad():  # stands for the updates of a run
        for p in trainer.updated:
            p.add_(0.01)
    state = str(tiny["root"] / "last_state.pt")
    save_state(state, trainer)
    out = str(tiny["root"] / "from_state.pt")
    convert.main(CONVERT + ["--input", state, "--base-path", tiny["src"], "--output", out])
    got = torch.load(out, weights_only=True)["CirAlignPrompt"]
    fresh = model()
    fresh.load_state_dict(got, strict=True)
    for name, value in trained.state_dict().items():
        assert torch.equal(fresh.state_dict()[name], value), name
    assert any(n.startswith("visual_encoder") for n in got)
    assert not any(n.startswith("visual_encoder") for n in trainer.names)
    with pytest.raises(ValueError, match="training state.*give the checkpoint the run started"):
        convert.main(CONVERT + ["--input", state, "--output", out])
    with pytest.raises(SystemExit, match="torch files only"):
        convert.main(CONVERT + ["--input", state, "--output", str(tiny["root"] / "dir")])
    assert convert.make_parser().parse_args(["--input", state, "--output", out]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA"):
            convert.main(["--input", state, "--output", out])


def test_cir_task_prepare_batch_equals_jax(tmp_path):
    """FashionIQ's caption pairs (randomized from one RandomState(seed)
    over the run) and CIRR's captions, two batches each."""
    from sprc_tpu.text.tokenizer import BertWordPieceTokenizer as JTokenizer
    from sprc_tpu.train.tasks import CirTask as JCirTask

    from sprc_tpu_torch.registry import registry
    from sprc_tpu_torch.text.tokenizer import BertWordPieceTokenizer
    from sprc_tpu_torch.train.tasks import CirTask
    from sprc_tpu_torch.utils.artifacts import write_synthetic_bert_vocab

    vocab = write_synthetic_bert_vocab(str(tmp_path / "vocab.txt"))
    rng = np.random.RandomState(9)
    words = ["is", "red", "shorter", "has", "stripes", "and", "longer", "sleeves", "darker"]

    def say():
        return " ".join(rng.choice(words, int(rng.randint(3, 7))))

    data = [{"reference_image": rng.rand(8, 8, 3).astype(np.float32),
             "target_image": rng.rand(8, 8, 3).astype(np.float32), "caption": say(),
             "captions": [say(), say()]} for _ in range(8)]

    class Model:
        class cfg:
            max_txt_len = 12

    assert registry.get("task", "composed_retrieval") is CirTask
    for key in ("captions", "caption"):
        port = CirTask(Model, BertWordPieceTokenizer.from_vocab_file(vocab), data, batch_size=4,
                       workers=1, seed=3, caption_key=key, device="cpu")
        jtask = JCirTask(Model, JTokenizer.from_vocab_file(vocab), data, batch_size=4,
                         workers=1, seed=3, caption_key=key)
        batches = list(port.train_loader(0))
        assert [len(b["caption"]) for b in batches] == [4, 4]
        for batch in batches:
            got, want = port.prepare_batch(batch), jtask.prepare_batch(batch)
            assert set(got) == set(want) == {"reference", "target", "input_ids", "text_mask"}
            for name in got:
                np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]),
                                              err_msg=f"{key} {name}")
    assert port.selection_metric({"arithmetic_mean": 3.0}) == 3.0 and port.evaluation(None) == {}


def test_determinism_fingerprint():
    from sprc_tpu_torch.utils.determinism import assert_deterministic, tree_fingerprint

    tree = {"b": [torch.arange(6, dtype=torch.float32), np.ones((2, 3), np.int32)],
            "a": {"x": torch.zeros(3, dtype=torch.bfloat16), "y": 2.5}}
    fp = tree_fingerprint(tree)
    assert fp == tree_fingerprint(dict(reversed(list(tree.items()))))  # key order
    flipped = tree["b"][0].clone()
    flipped.view(torch.int32)[3] ^= 1  # one bit of one element
    assert tree_fingerprint({**tree, "b": [flipped, tree["b"][1]]}) != fp
    assert tree_fingerprint({**tree, "b": [tree["b"][0].double(), tree["b"][1]]}) != fp
    assert assert_deterministic(lambda: tree) == fp
    draws = iter(range(10))
    with pytest.raises(AssertionError, match="non-deterministic"):
        assert_deterministic(lambda: torch.tensor(next(draws)))


def test_profiling_on_the_cpu(tmp_path):
    from sprc_tpu_torch.utils.profiling import StepTimer, annotate, trace

    timer = StepTimer(discard_first=1, device="cpu")
    with trace(str(tmp_path / "prof")):
        for _ in range(3):
            with timer, annotate("matmul_step"):
                torch.randn(32, 32) @ torch.randn(32, 32)
    summary = timer.summary()
    assert summary["steps"] == 2 and summary["max_s"] >= summary["p50_s"] > 0
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "matmul_step" for e in events)
    assert StepTimer().summary() == {}


def test_visualize_and_cache(tmp_path, monkeypatch):
    import PIL.Image

    from sprc_tpu_torch.retrieval.visualize import save_failure_panels
    from sprc_tpu_torch.utils import cache

    names = [f"img{i}" for i in range(12)]
    for i, n in enumerate(names):
        PIL.Image.new("RGB", (20, 16), (i * 20, 0, 0)).save(tmp_path / f"{n}.png")
    sorted_names = np.array([names[1:12], names[:11]])  # query 0's target img0 is not there
    written = save_failure_panels(str(tmp_path / "panels"), sorted_names, ["img5", "img6"],
                                  ["img0", "img3"], ["is red", "is blue"],
                                  lambda n: str(tmp_path / f"{n}.png"), top_k=3, panel_size=32)
    assert written == 1
    (panel,) = os.listdir(tmp_path / "panels")
    assert panel == "0000_q0.png"
    assert PIL.Image.open(tmp_path / "panels" / panel).size == (5 * 32, 32 + 28)

    monkeypatch.setenv("SPRC_CACHE", str(tmp_path / "cache"))
    url = "https://example.com/weights/model.pth"
    assert cache.is_url(url) and not cache.is_url("/local/model.pth")
    assert cache.cached_path("/local/model.pth") == "/local/model.pth"
    target = cache.cached_path(url)
    assert target.startswith(str(tmp_path / "cache")) and target.endswith("_model.pth")
    with pytest.raises(FileNotFoundError, match="downloads nothing"):
        cache.download_cached_file(url)
    open(target, "wb").close()
    assert cache.download_cached_file(url) == target


def test_package_exports_resolve_lazily():
    script = (
        "import sys\n"
        "import sprc_tpu_torch.ops.primitives\n"
        "assert not [m for m in sys.modules if m.startswith('sprc_tpu_torch.models')]\n"
        "import sprc_tpu_torch as s\n"
        "assert s.__version__ == '0.1.0'\n"
        "assert type(s.registry).__name__ == 'Registry'\n"
        "assert not [m for m in sys.modules if m.startswith('sprc_tpu_torch.models')]\n"
        "from sprc_tpu_torch import load_model, load_model_and_preprocess, model_zoo\n"
        "from sprc_tpu_torch import extract_features\n"
        "assert 'gpt_dialogue' in s.registry.list('model') and len(model_zoo) > 0\n"
        "assert sorted(s.__all__) == sorted(['__version__', 'registry', 'extract_features',"
        " 'load_model', 'load_model_and_preprocess', 'model_zoo'])\n")
    done = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-2000:]


def test_model_zoo_equals_jax_and_every_architecture_builds():
    """Every (architecture, type) of the zoo builds in the port, on the meta
    device (the shapes without storage: the 13B LLaMA rows take no memory);
    a pipeline's three sub-model rows build alike. load_model_and_preprocess
    returns JAX's processors for the dialogue (BLIP's at 224 px)."""
    import sprc_tpu

    from sprc_tpu_torch import loader
    from sprc_tpu_torch.models.llm_presets import LLM_KEYS

    assert dict(loader.model_zoo) == dict(sprc_tpu.model_zoo)
    assert str(loader.model_zoo) == str(sprc_tpu.model_zoo)
    for arch, types in loader.model_zoo:
        for model_type in types:
            row = loader.PIPELINE_CONFIGS.get((arch, model_type))
            subs = ([(s["arch"], s.get("model_type", "pretrain"),
                      {k: v for k, v in s.items() if k not in ("arch", "model_type")})
                     for s in row.values() if isinstance(s, dict)] if row
                    else [(arch, model_type, {})])
            for name, sub_type, kw in subs:
                if name == "t5":  # Img2Prompt's question generator: a T5 preset, no registry row
                    assert LLM_KEYS["t5_model"][1](kw["t5_model"]).d_model > 0
                    continue
                model = loader.build_model(name, sub_type, device="meta", **kw)
                assert sum(p.numel() for p in model.parameters()) > 0, (arch, model_type)
    model, vis, txt = loader.load_model_and_preprocess(
        "gpt_dialogue", gpt={"vocab_size": 64, "n_embd": 32, "n_layer": 1, "n_head": 2,
                             "n_positions": 32}, len_video_ft=8, device="cpu", seed=1)
    assert type(model).__name__ == "GPTDialogue" and not model.training
    assert type(vis["eval"]).__name__ == "BlipImageEvalProcessor"
    assert vis["eval"].image_size == 224 and type(txt["train"]).__name__ == "CaptionProcessor"
    assert type(loader.preprocessors("blip2_cir_align_prompt", "pretrain")[0]["eval"]
                ).__name__ == "HostTransform"
