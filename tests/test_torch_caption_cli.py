"""The port's caption evaluation CLI (cli/evaluate.py, task captioning) and
instruct CLI (cli/instruct.py) against sprc_tpu's.

Both evaluate CLIs run one run config shaped as
configs/runs/eval/caption_coco_{opt2.7b,flant5xl}_eval.yaml over a
synthetic ``coco_caption`` test split (5 PNG images of mixed sizes, 5
captions each, ``batch_size_eval`` 2: the last batch padded) with the
instruct CLI's tiny model (its LLM stirred as test_torch_opt.py does) on
the same weights: the JAX CLI's ``load_checkpoint_auto`` is handed the
tree that the port's ``--model-path`` file was made from, as
test_torch_retrieval_eval.py does for stage 1. They print the same metric
JSON and write the same result file. The BERT tokenizer tokenizes the
prompt and decodes the ids (the JAX default); the heads keep their own eos /
pad.
"""

import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
yaml = pytest.importorskip("yaml")
import jax.numpy as jnp  # noqa: E402

from sprc_tpu_torch.interop.jax_params import state_dict_from_jax  # noqa: E402
from test_torch_opt import jnp_tree, stir  # noqa: E402
from test_torch_threads import one_torch_thread  # noqa: E402,F401  (one thread a module)

IMG, Q, VOCAB = 28, 4, 60
VIT = dict(image_size=IMG, patch_size=14, width=32, depth=2, num_heads=2, mlp_hidden=64,
           qkv_fused_no_kbias=True, dtype="fp32")
QF = dict(vocab_size=VOCAB, hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
          encoder_width=32, query_length=Q, dropout_rate=0.0)
LLM = {"blip2_opt": ("caption_coco_opt2.7b", "opt_config",
                     dict(vocab_size=80, hidden_size=48, ffn_dim=96, num_layers=2, num_heads=4)),
       "blip2_t5": ("caption_coco_flant5xl", "t5_config",
                    dict(vocab_size=80, d_model=32, d_kv=8, d_ff=64, num_heads=4, num_layers=2,
                         num_decoder_layers=2))}
WORDS = ["red", "blue", "cat", "dog", "tree", "car", "sky", "sea", "two", "a", "on", "the",
         "photo", "of"]


def _write_split(root):
    from PIL import Image

    rng = np.random.RandomState(16)
    (root / "imgs").mkdir()
    ann = []
    for i in range(5):
        name = f"im{i:02d}.png"
        h, w = 24 + 9 * (i % 3), 40 - 6 * (i % 2)
        Image.fromarray((rng.rand(h, w, 3) * 255).astype(np.uint8)).save(root / "imgs" / name)
        ann.append({"image": name, "image_id": 100 + i,
                    "caption": [" ".join(rng.choice(WORDS, 5)) for _ in range(5)]})
    (root / "test.json").write_text(json.dumps(ann))
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + WORDS + [".", ","]
    (root / "vocab.txt").write_text("\n".join(vocab))
    return str(root / "test.json"), str(root / "imgs"), str(root / "vocab.txt")


def _run_config(arch, ann, images):
    model_type, field, llm = LLM[arch]
    return {"run": {"task": "captioning", "evaluate": True, "batch_size_eval": 2, "num_beams": 1,
                    "max_len": 30, "min_len": 8, "prompt": "a photo of",
                    "test_splits": ["test"]},
            "model": {"arch": arch, "model_type": model_type, "image_size": IMG,
                      "num_query_token": Q, "max_txt_len": 6, "vocab_size": VOCAB,
                      "embed_dim": 16, "vit_dtype": "fp32", "vit_config_override": VIT,
                      "qformer_config_override": QF, field: llm},
            "datasets": {"coco_caption": {
                "build_info": {"annotations": {"test": [ann]}, "images": images},
                "vis_processor": {"eval": {"name": "blip_image_eval", "image_size": IMG}},
                "text_processor": {"eval": {"name": "blip_caption"}}}}}


def _jax_params(cfg):
    """The JAX CLI's model and an init as its random-weight path makes it,
    the LLM stirred."""
    from sprc_tpu.loader import build_model

    model_cfg = dict(cfg["model"])
    arch, model_type = model_cfg.pop("arch"), model_cfg.pop("model_type")
    jm = build_model(arch, model_type, **model_cfg)
    img = jnp.zeros((1, IMG, IMG, 3), jnp.float32)
    ids, ones = jnp.zeros((1, 4), jnp.int32), jnp.ones((1, 4), jnp.int32)
    extra = (ids, ones) if arch == "blip2_t5" else ()
    params = jnp_tree(jm.init(jax.random.PRNGKey(0), img, ids, ones, *extra)["params"])
    llm = "opt" if arch == "blip2_opt" else "t5"
    params[llm] = stir(params[llm])
    return params


@pytest.mark.parametrize("arch", ["blip2_opt", "blip2_t5"])
def test_evaluate_cli_captions_equal_jax(arch, tmp_path, monkeypatch, capsys):
    from sprc_tpu.cli import evaluate as jevaluate
    from sprc_tpu.interop import torch_import

    from sprc_tpu_torch.cli import evaluate

    ann, images, vocab = _write_split(tmp_path)
    cfg = _run_config(arch, ann, images)
    cfg_path = tmp_path / "caption_eval.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    params = _jax_params(cfg)
    ckpt = tmp_path / f"{arch}.pth"
    torch.save({"model": state_dict_from_jax(params, vit="eva_clip_g")}, ckpt)
    monkeypatch.setattr(torch_import, "load_checkpoint_auto", lambda path, model: params)
    argv = ["--cfg-path", str(cfg_path), "--vocab-path", vocab, "--model-path", str(ckpt),
            "--options", "run.max_len=6"]
    jevaluate.main(argv + ["--output-dir", str(tmp_path / "jax")])
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    evaluate.main(argv + ["--output-dir", str(tmp_path / "port"), "--device", "cpu"])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got == want
    assert set(got) == {"Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "CIDEr", "agg_metrics"}
    rows = [json.loads((tmp_path / side / "result" / "test_epochx.json").read_text())
            for side in ("jax", "port")]
    assert rows[0] == rows[1]
    assert [r["image_id"] for r in rows[1]] == [100, 101, 102, 103, 104]
    assert any(r["caption"] for r in rows[1])
    assert (tmp_path / "port" / "evaluate.txt").read_text() == \
        (tmp_path / "jax" / "evaluate.txt").read_text()


def test_evaluate_captioning_refusals(tmp_path):
    """A missing tokenizer.json is an error naming it (no other tokenizer is
    taken in its place), the LLaMA tokenizer names ROADMAP A8, and without
    a GPU the default device exits nonzero."""
    import argparse

    from sprc_tpu_torch.cli import evaluate
    from sprc_tpu_torch.config import Config

    ann, images, vocab = _write_split(tmp_path)
    cfg = _run_config("blip2_opt", ann, images)
    args = argparse.Namespace(device="cpu", model_path=None, vocab_path=vocab, split=None,
                              output_dir=str(tmp_path / "out"))
    cfg["run"]["tokenizer"] = {"opt": str(tmp_path / "missing" / "tokenizer.json")}
    with pytest.raises(FileNotFoundError, match="missing/tokenizer.json"):
        evaluate.evaluate(Config(defaults=cfg), args)
    cfg["run"]["tokenizer"] = {"llama": str(tmp_path / "missing" / "llama.json")}
    with pytest.raises(FileNotFoundError, match="missing/llama.json"):
        evaluate.evaluate(Config(defaults=cfg), args)
    with pytest.raises(SystemExit, match="no evaluation glue fits its signature"):
        evaluate.evaluate(Config(defaults=dict(cfg, model={"arch": "blip2_instruct_cir",
                                                           "model_type": "vicuna7b"})), args)
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA"):
            evaluate.evaluate(Config(defaults=cfg), argparse.Namespace(device="cuda",
                                                                        model_path=None))


def test_instruct_cli_generates_with_both_heads_and_refuses_llama(capsys):
    """Each head generates; the LLaMA names run too (the retrieval branch
    for blip2_vicuna_instruct, generation for blip2_instruct_cir; their
    outputs are held in test_torch_instruct_cir.py); without --synthetic
    the CLI refuses, and its default device is the card."""
    from sprc_tpu_torch.cli import instruct

    for name in ("blip2_opt", "blip2_t5", "blip2_instruct_cir"):
        instruct.main(["--model-name", name, "--synthetic", "--device", "cpu", "--batch", "3",
                       "--max-new-tokens", "5"])
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert out["model"] == name and out["task"] == "generate" and out["n_outputs"] == 3
        assert all(len(t.split()) <= 5 for t in out["outputs"])
    instruct.main(["--model-name", "blip2_vicuna_instruct", "--synthetic", "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["task"] == "retrieval" and out["sims_shape"] == [2, 8] and out["finite"]
    with pytest.raises(SystemExit, match="non-synthetic"):
        instruct.main(["--model-name", "blip2_opt", "--device", "cpu"])
    assert instruct.make_parser().parse_args(["--model-name", "blip2_t5"]).device == "cuda"
