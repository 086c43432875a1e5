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
# PNP-VQA: BLIP-1's ITM and captioner, the med-BERT, GradCAM, the pipeline and its reader
assert {"sprc_tpu_torch.models.blip1", "sprc_tpu_torch.models.albef",
        "sprc_tpu_torch.models.pnp_vqa", "sprc_tpu_torch.utils.gradcam"} <= set(mods)
assert {"blip_image_text_matching", "blip_caption", "pnp_unifiedqav2_fid",
        "pnp_vqa"} <= set(registry.list("model"))
# Img2Prompt-VQA: the tagger, the beam search, the pipeline; the checkpoint readers
assert "sprc_tpu_torch.text.pos" in mods and "img2prompt_vqa" in registry.list("model")
from sprc_tpu_torch.models import generation, pnp_vqa
assert callable(generation.cached_beam_loop) and callable(pnp_vqa.qg_beam_search)
assert issubclass(pnp_vqa.Img2PromptVqaPipeline, pnp_vqa.PnpVqaPipeline)
from sprc_tpu_torch import loader
assert ("img2prompt_vqa", "base") in loader.PIPELINE_CONFIGS
# the momentum-queue families: the four models, their state, step functions,
# adapters, evaluation and bridges
assert {"blip_retrieval", "blip_pretrain", "albef_retrieval", "albef_pretrain",
        "albef_feature_extractor"} <= set(registry.list("model"))
from sprc_tpu_torch.models import albef, blip1
assert all(callable(f) for f in (
    albef.init_albef_state, albef.momentum_update, albef.enqueue, albef.mlm_mask,
    albef.rampup_alpha, albef.momentum_weights, albef.albef_train_step,
    albef.albef_pretrain_train_step, blip1.blip_retrieval_train_step,
    blip1.blip_pretrain_train_step))
from sprc_tpu_torch.train import generic, tasks
assert generic.TASK_ADAPTERS["retrieval"] is generic.RetrievalAdapter
assert callable(tasks.rescore_topk) and callable(loader.preprocessors)
from sprc_tpu_torch.interop import jax_params
assert callable(jax_params.momentum_state_from_jax) and callable(jax_params.albef_retrieval_from_jax)
# BLIP-1 / ALBEF's VQA, SNLI-VE classification and NLVR2: the models, their
# steps, the adapters, the glue, the tasks, the builders and the bridges
assert {"sprc_tpu_torch.models.vqa", "sprc_tpu_torch.models.classification",
        "sprc_tpu_torch.models.nlvr"} <= set(mods)
assert {"blip_vqa", "albef_vqa", "blip_classification", "albef_classification", "blip_nlvr",
        "albef_nlvr"} <= set(registry.list("model"))
from sprc_tpu_torch.models import classification, nlvr, vqa
assert all(callable(f) for f in (
    vqa.vqa_train_step, vqa.init_vqa_state, vqa.VQAModel.rank_answers,
    vqa.VQAModel.generate_answers, classification.classifier_train_step,
    classification.classifier_rampup_alpha, nlvr.nlvr_train_step, nlvr.nlvr_rampup_alpha))
assert generic.TASK_ADAPTERS["vqa"] is generic.VQAAdapter
assert generic.TASK_ADAPTERS["multimodal_classification"] is generic.ClassificationAdapter
from sprc_tpu_torch.train import eval_glue
assert callable(eval_glue.make_vqa_predict_fn) and callable(eval_glue.make_classification_predict_fn)
assert "multimodal_classification" in registry.list("task")
assert {"snli_ve", "nlvr"} <= set(registry.list("dataset"))
assert all(callable(f) for f in (jax_params.vqa_from_jax, jax_params.classifier_from_jax,
                                 jax_params.nlvr_from_jax, jax_params.momentum_copies_from_jax))
# BLIP-1's captioning and CIR extractor, CLIP (ViT and RN50) and its zero-shot
# classifier, the flat CLIP index and the feature-extraction entry
assert {"sprc_tpu_torch.models.clip", "sprc_tpu_torch.models.resnet_clip",
        "sprc_tpu_torch.models.clip_zero_shot", "sprc_tpu_torch.retrieval.clip_index",
        "sprc_tpu_torch.features"} <= set(mods)
assert {"clip", "clip_feature_extractor", "blip_cir_base",
        "blip_feature_extractor"} <= set(registry.list("model"))
assert callable(blip1.BlipCaption.generate_ids) and "imagenet" in registry.list("dataset")
assert {"clip_image_train", "clip_image_eval"} <= set(registry.list("processor"))
assert callable(llm_tokenizers.clip_tokenize)
assert callable(tasks.ImageTextRetrievalTask.evaluate_pairs_clip)
# the video families: TimeSformer, ALPRO, their processors, builders, adapters,
# evaluation and bridges; OpenCV is read only when a container is decoded
assert {"sprc_tpu_torch.models.timesformer", "sprc_tpu_torch.models.alpro",
        "sprc_tpu_torch.data.video_processors"} <= set(mods)
assert {"alpro_retrieval", "alpro_qa", "timesformer"} <= set(registry.list("model"))
assert {"alpro_video_train", "alpro_video_eval"} <= set(registry.list("processor"))
assert {"msrvtt_retrieval", "didemo_retrieval", "msrvtt_qa", "msvd_qa", "msrvtt_caption",
        "msvd_caption", "vatex_caption"} <= set(registry.list("dataset"))
assert all(callable(f) for f in (
    generic.AlproRetrievalAdapter.forward, generic.AlproQAAdapter.attach,
    tasks.ImageTextRetrievalTask.evaluate_pairs_video, jax_params.timesformer_from_jax,
    jax_params.alpro_from_jax))
# the GPT-2 video dialogue, the Q-Former LM's decodes, the remaining tasks,
# convert and its interop, the utilities and the package surface
assert {"sprc_tpu_torch.models.gpt_dialogue", "sprc_tpu_torch.data.gpt_processors",
        "sprc_tpu_torch.cli.convert", "sprc_tpu_torch.interop.torch_export",
        "sprc_tpu_torch.interop.torch_import", "sprc_tpu_torch.utils.cache",
        "sprc_tpu_torch.utils.determinism", "sprc_tpu_torch.utils.profiling",
        "sprc_tpu_torch.retrieval.visualize"} <= set(mods)
assert "gpt_dialogue" in registry.list("model") and "avsd_dialogue" in registry.list("dataset")
assert {"gpt_dialogue", "gpt_video_ft"} <= set(registry.list("processor"))
assert {"dialogue", "image_text_pretrain", "vqa_reading_comprehension",
        "gqa_reading_comprehension", "composed_retrieval"} <= set(registry.list("task"))
assert generic.TASK_ADAPTERS["dialogue"] is generic.DialogueAdapter
from sprc_tpu_torch.models import lm
assert all(callable(f) for f in (
    lm.greedy_generate, lm.beam_generate, lm.cached_greedy_generate, lm.cached_beam_generate,
    lm.generate_captions, lm.qformer_lm_state_from_torch, jax_params.gpt_dialogue_from_jax,
    jax_params.qformer_lm_from_jax, loader.load_model_and_preprocess, loader.load_gpt2_trunk))
assert ("gpt_dialogue", "base") in loader.FAMILY_CONFIGS and len(loader.model_zoo) > 0
assert {"registry", "extract_features", "load_model", "load_model_and_preprocess",
        "model_zoo", "__version__"} <= set(sprc_tpu_torch.__all__)
assert "cv2" not in sys.modules, "importing read OpenCV"
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
cfg = Config(defaults=chip_smoke.RUN_CONFIGS["eval/pnp_vqa_vqav2_eval.yaml"])
assert cfg.model["arch"] == "pnp_vqa" and cfg.run["num_captions"] == 50
assert loader.family_config("blip_caption", "large_coco").vit_config().seq_len == 577
cut = chip_smoke._cut_depth("blip2", "coco", vit_depth=chip_smoke.UNFROZEN_DEPTH,
                            qformer_layers=chip_smoke.VARIANT_QFORMER_LAYERS)
cfg = loader.model_config("blip2", "coco", **cut)
assert (cfg.vit_config().depth, cfg.vit_config().width, cfg.qformer_config().num_layers) == (
    chip_smoke.UNFROZEN_DEPTH, 1408, chip_smoke.VARIANT_QFORMER_LAYERS)
assert loader.PIPELINE_CONFIGS[("img2prompt_vqa", "base")]["question_answering_model"]["arch"] == "t5"
for name, (run_yaml, _) in chip_smoke.MOMENTUM_TRAIN.items():
    cfg = Config(defaults=chip_smoke.RUN_CONFIGS[run_yaml])
    assert cfg.model["arch"] == name
assert loader.family_config("blip_retrieval", "pretrain").vit_config().seq_len == 577
assert loader.family_config("albef_pretrain", "base").vit_config().seq_len == 197
assert loader.family_config("albef_retrieval", "coco").queue_size == 65536
for arch, (run_yaml, _, _) in chip_smoke.HEAD_TRAIN.items():
    assert Config(defaults=chip_smoke.RUN_CONFIGS[run_yaml]).model["arch"] == arch
for which, run_yaml in chip_smoke.HEAD_EVAL.items():
    assert Config(defaults=chip_smoke.RUN_CONFIGS[run_yaml]).run["evaluate"] is True
assert loader.family_config("blip_vqa", "vqav2").vit_config().seq_len == 901
for which, (run_yaml, _, k2) in chip_smoke.CAPTION_TRAIN.items():
    cfg = Config(defaults=chip_smoke.RUN_CONFIGS[run_yaml])
    assert cfg.model["arch"] == "blip_caption" and cfg.run["batch_size"] == 32
    assert loader.family_config("blip_caption", cfg.model.get("model_type", "pretrain")
                                ).vit_config().depth == k2
for run_yaml in (chip_smoke.CAPTION_EVAL, chip_smoke.CLIP_RET, chip_smoke.CLIP_ZS):
    assert Config(defaults=chip_smoke.RUN_CONFIGS[run_yaml]).run["evaluate"] is True
assert loader.family_config("clip", "vit_large14_336").vision_config().seq_len == 577
assert loader.family_config("clip", "vit_base32").vision_config().seq_len == 50
assert loader.family_config("blip_feature_extractor", "base").vit_config().seq_len == 197
assert (chip_smoke.STAGE1_CAPTIONS, chip_smoke.INSTRUCT_NEW_TOKENS) == (2, 15)  # the time cuts
for run_yaml in list(chip_smoke.VIDEO_TRAIN.values()) + list(chip_smoke.VIDEO_EVAL.values()):
    cfg = Config(defaults=chip_smoke.RUN_CONFIGS[run_yaml])
    assert cfg.model["arch"] in ("alpro_retrieval", "alpro_qa")
    assert loader.family_config(cfg.model["arch"], cfg.model["model_type"]).video_config(
        ).num_patches + 1 == 197
assert loader.family_config("alpro_qa", "msrvtt").video_config().num_frames == 16
for run_yaml in (chip_smoke.DIALOGUE_TRAIN, chip_smoke.DIALOGUE_EVAL):
    cfg = Config(defaults=chip_smoke.RUN_CONFIGS[run_yaml])
    gpt = loader.family_config("gpt_dialogue", "pretrain", **{k: v for k, v in cfg.model.items()
                                                              if k != "arch"})
    assert (gpt.gpt.vocab_size, gpt.gpt.n_layer, gpt.len_video_ft) == (50264, 12, 4224)
    assert gpt.gpt.vocab_size == chip_smoke.GPT2_BASE_VOCAB + 7
assert sum(chip_smoke.DIALOGUE_STREAMS.values()) == 4224
leaked =sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "sprc_tpu")
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
