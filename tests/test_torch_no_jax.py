"""sprc_tpu_torch imports neither JAX, Flax nor any sprc_tpu module.

In a fresh interpreter, ``jax``, ``flax``, ``sprc_tpu`` and PyYAML are made
unimportable (``sys.modules[name] = None``) and every module of the port is
imported (the native data-plane's ``native/`` and ``data/native.py`` among
them); importing builds no kernel and no data-plane library.
"""

import subprocess
import sys
from pathlib import Path
from test_torch_threads import one_torch_thread  # noqa: E402,F401  (one thread a module)

ROOT = Path(__file__).resolve().parent.parent

SCRIPT = r"""
import importlib, pkgutil, sys
for name in ("jax", "flax", "sprc_tpu", "yaml"):
    sys.modules[name] = None
import sprc_tpu_torch
mods = ["sprc_tpu_torch"]
for info in pkgutil.walk_packages(sprc_tpu_torch.__path__, "sprc_tpu_torch."):
    importlib.import_module(info.name)
    mods.append(info.name)
from sprc_tpu_torch.ops import _ext
assert _ext._lib is None, "importing built the kernels"
from sprc_tpu_torch.data import native
assert native._LIB is None, "importing built the data-plane"
assert {"sprc_tpu_torch.native", "sprc_tpu_torch.native.build", "sprc_tpu_torch.data.native"} <= set(mods)
# the YAML run layer and BLIP-2 stage 1, which import PyYAML only to parse
assert {"sprc_tpu_torch.config", "sprc_tpu_torch.registry", "sprc_tpu_torch.data.builders",
        "sprc_tpu_torch.data.processors", "sprc_tpu_torch.models.blip2_stage1",
        "sprc_tpu_torch.models.lm", "sprc_tpu_torch.retrieval.sim_matrix",
        "sprc_tpu_torch.train.tasks", "sprc_tpu_torch.train.runner",
        "sprc_tpu_torch.train.generic", "sprc_tpu_torch.cli.train",
        "sprc_tpu_torch.cli.evaluate", "sprc_tpu_torch.utils.preempt"} <= set(mods)
from sprc_tpu_torch.registry import registry
assert {"blip2", "blip2_feature_extractor", "blip2_image_text_matching"} <= set(registry.list("model"))
assert "coco_retrieval" in registry.list("dataset") and "blip_image_eval" in registry.list("processor")
# the trainable tower: the kernels' autograd Functions and what routes to them
from sprc_tpu_torch.ops import attention, fused_block, layers, primitives
for fn in (fused_block.FusedViTBlock, fused_block.FusedAttnBlock, fused_block.FusedMlpBlock,
           attention.FlashAttention):
    assert issubclass(fn, primitives.RecomputedVJP)
assert callable(primitives.dispatch) and callable(layers.recompute)
from sprc_tpu_torch.train import loop
assert callable(loop.layer_decay_scales)
# BLIP-2 stage 2: the LLM caption heads, their decode and the caption evaluation
assert {"sprc_tpu_torch.models.opt", "sprc_tpu_torch.models.t5",
        "sprc_tpu_torch.models.llm_presets", "sprc_tpu_torch.models.generation",
        "sprc_tpu_torch.models.blip2_opt", "sprc_tpu_torch.models.blip2_t5",
        "sprc_tpu_torch.text.llm_tokenizers", "sprc_tpu_torch.retrieval.caption_eval",
        "sprc_tpu_torch.train.eval_tasks", "sprc_tpu_torch.train.eval_glue",
        "sprc_tpu_torch.cli.instruct"} <= set(mods)
assert {"blip2_opt", "blip2_t5"} <= set(registry.list("model"))
assert "captioning" in registry.list("task") and "coco_caption" in registry.list("dataset")
# their zero-shot VQA: the official accuracy, the tasks, the question processor, the builders
assert "sprc_tpu_torch.retrieval.vqa_eval" in mods
assert {"vqa", "gqa", "aok_vqa"} <= set(registry.list("task"))
assert {"coco_vqa", "ok_vqa", "aok_vqa", "gqa", "vg_vqa"} <= set(registry.list("dataset"))
assert "blip_question" in registry.list("processor")
# the LLaMA heads: the decoder, the two InstructBLIP-style CIR models, blip2_t5_instruct
assert {"sprc_tpu_torch.models.llama", "sprc_tpu_torch.models.instruct_cir"} <= set(mods)
assert {"blip2_vicuna_instruct", "blip2_instruct_cir",
        "blip2_t5_instruct"} <= set(registry.list("model"))
from sprc_tpu_torch.text import llm_tokenizers
assert callable(llm_tokenizers.llama_tokenizer)
assert "tokenizers" not in sys.modules, "importing read the tokenizers package"
assert "yaml" not in sys.modules or sys.modules["yaml"] is None, "importing read PyYAML"
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "sprc_tpu")
                and sys.modules[m] is not None)
assert not leaked, leaked
print(len(mods))
"""


CHIP_SMOKE = r"""
import sys
for name in ("jax", "flax", "sprc_tpu", "yaml"):
    sys.modules[name] = None
import chip_smoke
from sprc_tpu_torch.cli import evaluate, train
from sprc_tpu_torch.config import Config
cfg = Config(defaults=chip_smoke.RUN_CONFIGS["pretrain_stage1.yaml"])
assert cfg.run["batch_size"] == 100 and cfg.model["arch"] == "blip2"
cfg = Config(defaults=chip_smoke.RUN_CONFIGS["retrieval_coco_blip2_ft.yaml"])
assert cfg.run["batch_size"] == 32 and cfg.model["model_type"] == "coco"
from sprc_tpu_torch import loader
assert loader.model_config("blip2", "coco").freeze_vit is False
for name, arch in (("eval/caption_coco_opt2.7b_eval.yaml", "blip2_opt"),
                   ("eval/caption_coco_flant5xl_eval.yaml", "blip2_t5")):
    cfg = Config(defaults=chip_smoke.RUN_CONFIGS[name])
    assert cfg.run["task"] == "captioning" and cfg.model["arch"] == arch
assert loader.llm_config("blip2_t5", "caption_coco_flant5xl")["t5_config"].d_model == 2048
assert loader.llm_config("blip2_vicuna_instruct", "vicuna7b")["llama_config"].hidden_size == 4096
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "sprc_tpu")
                and sys.modules[m] is not None)
assert not leaked, leaked
"""


def test_chip_smoke_and_the_run_layer_need_no_jax_nor_yaml():
    """chip_smoke.py imports no JAX, and its PyYAML-free route (a Config
    from its dict mirrors) builds without PyYAML."""
    proc = subprocess.run([sys.executable, "-c", CHIP_SMOKE], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_port_imports_without_jax():
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip().splitlines()[-1]) >= 30
