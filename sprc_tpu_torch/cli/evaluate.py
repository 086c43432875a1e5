"""Evaluate-only entry over YAML run configs (counterpart of
``sprc_tpu/cli/evaluate.py``, the LAVIS ``evaluate.py``).

Usage:
  python -m sprc_tpu_torch.cli.evaluate --cfg-path configs/runs/eval/ret_coco_blip2_eval.yaml \
      [--model-path ckpt.pth] [--vocab-path vocab.txt] [--split test] \
      [--options key=value ...] [--device cuda]

Ported: the ``retrieval`` task for the BLIP-2 stage-1 models (``blip2``,
``blip2_feature_extractor``, ``blip2_image_text_matching``): the split's
images stream through ``extract_target_features`` 64 at a time, the
captions through ``encode_text_cls``, then the two-stage
``compute_sim_matrix`` (K1, then the ITM head over each query's top
``k_test``) and the recalls, ``agg_metrics`` = ``r_mean``; and for the
momentum-queue families (``blip_retrieval``, ``albef_retrieval``,
``albef_feature_extractor``, ``blip_pretrain``, ``albef_pretrain``;
configs/runs/eval/ret_{coco,flickr}{,_albef}_eval.yaml) through
``ImageTextRetrievalTask.evaluate_pairs_itc``: the images 16 a call through
the tower, the CLS-projection cosines over every pair, each query's top
``k_test`` rescored by the ITM head (BLIP-1 over ``[ENC]`` ids, ALBEF over
the fusion layers), as the JAX CLI dispatches it. And the
``captioning`` task for the BLIP-2 stage-2 heads (``blip2_opt``,
``blip2_t5``, and ``blip2_t5_instruct``, its class under the InstructBLIP
name; configs/runs/eval/caption_coco_{opt2.7b,flant5xl}_eval.yaml):
batches of ``run.batch_size_eval`` through the head's KV-cached greedy
decode of ``run.max_len`` tokens after ``run.prompt``, the prompt tokenized
and the ids decoded by the BERT tokenizer unless ``run.tokenizer`` names an
LLM ``tokenizer.json`` (``opt``, ``t5`` or ``llama``, as in the JAX CLI),
the result file ``--output-dir/result/<split>_epochx.json`` and CIDEr / BLEU against the
annotations' captions. And the zero-shot VQA tasks of the same two heads
(``vqa``, ``gqa``, ``aok_vqa``; configs/runs/eval/vqav2_zeroshot_opt_eval.yaml,
{vqav2,okvqa,gqa}_zeroshot_flant5xl_eval.yaml): batches of
``run.batch_size_eval`` through the head's greedy decode of ``run.max_len``
tokens after each question rendered through ``run.prompt``, the result file
``--output-dir/result/<split>_{vqa,gqa,aokvqa}_result.json`` and the task's
accuracy against the split's own answers (``agg_metrics``; none on a split
without them); ``run.inference_method`` must be ``generate``. And the same
VQA tasks through the ``pnp_vqa`` pipeline
(configs/runs/eval/pnp_vqa_{vqav2,okvqa,gqa}_eval{,_large,_3b}.yaml): every
batch through ``PnpVqaPipeline.predict_answers`` with the run's
``num_captions``, ``num_captions_fid``, ``num_patches``, ``block_num``,
``max_len`` and ``min_len`` (``inference_method`` is not read, as in the JAX
CLI), the same result file and accuracy; its three models take their
weights from each sub-section's ``finetuned:`` path, so ``--model-path``
exits. ``img2prompt_vqa`` takes the same branch, as in the JAX CLI:
its ``predict_answers`` is PNP-VQA's over the ITM-filtered captions, read by
its question-generation T5 (``t5-large``) through ``forward_qa``; its LLM
prompts come from ``predict_prompts``, which no task calls. And the same
VQA tasks for BLIP-1 / ALBEF's VQA models (``blip_vqa``, ``albef_vqa``;
configs/runs/eval/{vqav2,okvqa,gqa,aokvqa}_eval.yaml): ``run.inference_method``
``rank`` (the default: the probe and rescoring of ``VQAModel.rank_answers``
over ``run.answer_list`` with ``run.num_ans_candidates``) or ``generate``
(greedy, ``run.max_len``). And the ``multimodal_classification`` task for
the SNLI-VE classifiers and the NLVR2 pair models (``*_classification``,
``*_nlvr``; configs/runs/eval/{snli_ve,nlvr,nlvr_albef}_eval.yaml): the
sentences at ``run.max_txt_len``, the argmax accuracy, the result file
``--output-dir/result/<split>_epochx.json``. For these two families an
evaluation whose eval images (the dataset's ``vis_processor.eval``) are not
the tower's size exits before building: the JAX CLI fails at the first
batch there (``vqa_val_albef_eval.yaml`` gives 480 px images to ALBEF's
384 px tower). The LLaMA
models (``blip2_vicuna_instruct``, ``blip2_instruct_cir``) exit: no task's
glue fits their signatures (the JAX CLI builds them and fails at the call);
``cli/instruct.py`` runs them. Each prints as the JAX CLI prints: one JSON line of the
scalar metrics. And BLIP-1's ``captioning`` (``blip_caption``;
configs/runs/eval/caption_coco{,_large}_eval.yaml, nocaps_eval.yaml):
batches of ``run.batch_size_eval`` through ``BlipCaption.generate_ids``, the
greedy decode of ``run.max_len`` tokens after the ``[DEC]``-prefixed
``run.prompt`` (``num_beams`` and ``min_len`` are not read, as in the JAX
glue), the result file and CIDEr / BLEU as the stage-2 heads'. And CLIP
(``clip``, ``clip_feature_extractor``): ``retrieval``
(configs/runs/eval/exp_{coco,flickr}_ret_eval.yaml) by the cosine of the two
towers' features alone (``evaluate_pairs_clip``: 64 images a tower call, the
captions through ``run.clip_tokenizer_json`` when set, else the BERT
WordPiece fallback at ``run.max_txt_len``), and zero-shot
``multimodal_classification`` (configs/runs/eval/imnet_zs_eval.yaml): the
classifier from ``run.classnames`` / ``run.classnames_path`` (else the
labels, which must be 0..C-1, as class names) through the 80 OpenAI
templates, then ``100 * image features @ classifier`` and the argmax
accuracy. And ALPRO (configs/runs/eval/{msrvtt,didemo}_ret_eval.yaml,
{msrvtt,msvd}_qa_eval.yaml): ``alpro_retrieval``'s ``retrieval`` through
``evaluate_pairs_video`` (the clips 4 a tower call, the captions 256 a
call, the VTC cosines, each query's top ``k_test`` rescored by the VTM
logit), and ``alpro_qa``'s ``multimodal_classification`` over the closed
answer vocabulary: each item's target is its first answer's index in
``run.answer_list`` (-1, always wrong, where it is not there), the argmax
accuracy of ``AlproQA.predict``. ``alpro_qa`` under a VQA task and
``timesformer`` (a feature extractor) exit: no glue fits them, in either
package. And the ``dialogue`` task of the GPT-2 video dialogue
(``gpt_dialogue``; configs/runs/eval/dialogue_avsd_eval.yaml): batches of
``run.batch_size_eval`` collated as in training
(:class:`~sprc_tpu_torch.train.generic.DialogueAdapter`), each batch's loss
(text CE + video MSE), ``agg_metrics`` their mean; the last partial batch
feeds only its real items, as the metric is a per-batch scalar
(``sprc_tpu/cli/evaluate.py:331-338``); feature streams that are not
``len_video_ft`` wide exit before the model is built. CIR datasets keep their
CLIs (``cli/validate.py``, ``cli/validate_rerank.py``,
``cli/submission.py``).

The flags are the JAX CLI's plus ``--device`` (default ``cuda``; without a
GPU the command exits nonzero). Without ``--model-path`` the weights are
random from ``run.seed``. :func:`evaluate` takes a built
:class:`~sprc_tpu_torch.config.Config`, so a caller without PyYAML passes
``Config(defaults=<the YAML as a dict>)``.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, Optional

import numpy as np
import torch

from sprc_tpu_torch.models.pnp_vqa import PnpVqaPipeline
from sprc_tpu_torch.train.generic import llm_tokenizer

VQA_TASKS = ("vqa", "gqa", "aok_vqa")
CLASSIFICATION = "multimodal_classification"


def _image_stream(ds, chunk: int = 64):
    """The split's pixels, ``chunk`` images a batch (a COCO test split would
    be about 8 GB held at once)."""
    for s in range(0, len(ds), chunk):
        yield np.stack([np.asarray(ds[i]["image"], np.float32)
                        for i in range(s, min(s + chunk, len(ds)))])


def _caption_ground_truth(ds) -> Dict[int, list]:
    """image_id -> its captions, from the annotations that carry them."""
    gt: Dict[int, list] = {}
    for ann in getattr(ds, "annotation", []):
        if "caption" in ann and "image_id" in ann:
            caps = ann["caption"]
            gt.setdefault(int(ann["image_id"]), []).extend(
                [caps] if isinstance(caps, str) else list(caps))
    return gt


def evaluate(cfg, args, stats: Optional[Dict[str, float]] = None) -> dict:
    """The metrics of ``cfg`` (a Config); ``stats`` receives the seconds by
    stage (retrieval: ``ImageTextRetrievalTask.evaluate_pairs``'s; captioning
    and VQA: the head's ``generate_ids``', summed over the batches)."""
    from sprc_tpu_torch import loader
    from sprc_tpu_torch.data import builders as _builders  # noqa: F401  (registers them)
    from sprc_tpu_torch.text.tokenizer import BertWordPieceTokenizer
    from sprc_tpu_torch.utils.artifacts import ensure_bert_vocab

    run = dict(cfg.run)
    task_name = run.get("task")
    model_cfg = dict(cfg.model)
    arch = model_cfg.pop("arch")
    model_type = model_cfg.pop("model_type", "pretrain")
    if task_name not in ("retrieval", "captioning", CLASSIFICATION, "dialogue") + VQA_TASKS:
        raise SystemExit(f"task {task_name!r} has no evaluate-only path (CIR -> "
                         "cli/validate.py)")
    if (task_name == "dialogue") != (arch in loader.DIALOGUE_MODELS):
        raise SystemExit(f"model {arch!r}: no {task_name} glue fits it, in either package (the "
                         "dialogue task: gpt_dialogue)")
    if arch in loader.INSTRUCT_MODELS:
        raise SystemExit(f"model {arch!r}: no evaluation glue fits its signature (the "
                         "instruction and LLaMA token batches), in either package; "
                         "cli/instruct.py runs it")
    if arch == "timesformer":
        raise SystemExit(f"model {arch!r}: no evaluation glue fits it (a video feature "
                         "extractor), in either package")
    if arch == "alpro_qa" and task_name != CLASSIFICATION:
        raise SystemExit(f"model {arch!r}: no {task_name} glue fits ALPRO's video QA, in either "
                         "package: it is evaluated as multimodal_classification over "
                         "run.answer_list")
    if task_name == "retrieval" and arch not in (loader.STAGE1_MODELS + loader.MOMENTUM_MODELS
                                                 + loader.CLIP_MODELS + ("alpro_retrieval",)):
        raise SystemExit(f"model {arch!r}: no retrieval evaluation fits it, in either package")
    if task_name == "captioning" and arch not in loader.LLM_HEADS + ("blip_caption",):
        raise SystemExit(f"model {arch!r}: no captioning glue fits it, in either package (the "
                         f"captioners: blip_caption, {', '.join(loader.LLM_HEADS)})")
    if task_name == CLASSIFICATION and arch not in (loader.CLASSIFICATION_MODELS
                                                    + loader.CLIP_MODELS + ("alpro_qa",)):
        raise SystemExit(f"model {arch!r}: no multimodal_classification glue fits it, in either "
                         f"package (its models: {', '.join(loader.CLASSIFICATION_MODELS)}, "
                         "alpro_qa and CLIP's zero-shot)")
    if arch == "alpro_qa" and not run.get("answer_list"):
        raise SystemExit("ALPRO's video QA evaluation needs run.answer_list (the closed answer "
                         "vocabulary, 1500 answers for MSRVTT-QA, 2423 for MSVD-QA)")
    pnp = arch in ("pnp_vqa", "img2prompt_vqa")
    if pnp and args.model_path:
        raise SystemExit("pnp pipelines load per-submodel checkpoints: put `finetuned: <path>` "
                         "inside each model sub-section of the YAML instead of --model-path")
    if task_name in VQA_TASKS and arch not in loader.LLM_HEADS + loader.VQA_MODELS and not pnp:
        raise SystemExit(f"model {arch!r}: no {task_name} glue fits it, in either package (its "
                         f"models: the generative {', '.join(loader.LLM_HEADS)}, pnp_vqa, "
                         f"img2prompt_vqa, {', '.join(loader.VQA_MODELS)})")
    if (task_name in VQA_TASKS and arch in loader.LLM_HEADS
            and run.get("inference_method", "rank") != "generate"):
        raise SystemExit(f"run.inference_method {run.get('inference_method', 'rank')!r}: the "
                         "BLIP-2 heads answer generatively ('generate'; ranking "
                         "run.answer_list is blip_vqa / albef_vqa's)")
    if task_name == "dialogue":
        return _evaluate_dialogue(cfg, args, arch, model_type, model_cfg, run, stats)
    own_config = (arch, model_type) in loader.FAMILY_CONFIGS
    if arch in loader.VQA_MODELS + loader.CLASSIFICATION_MODELS:
        _check_eval_size(cfg, arch, model_type, model_cfg)
    device = _device(args)
    if pnp:  # three models from their sub-sections, the BERT tokenizer from --vocab-path
        model_cfg.setdefault("vocab_path", args.vocab_path)
    elif not own_config:  # (those configs have no freeze_vit)
        model_cfg["freeze_vit"] = True  # evaluation trains nothing: the tower is built frozen
    model = loader.load_model(arch, model_type, checkpoint_path=args.model_path, device=device,
                              seed=int(run.get("seed", 42)), **model_cfg)

    ds, split = _split(cfg, args, run)
    tokenizer = BertWordPieceTokenizer.from_vocab_file(ensure_bert_vocab(args.vocab_path))
    if task_name == "captioning":
        return _evaluate_captions(model, ds, split, run, tokenizer, args, stats)
    if task_name in VQA_TASKS:
        return _evaluate_vqa(model, ds, split, run, tokenizer, args, stats)
    if task_name == CLASSIFICATION and arch in loader.CLIP_MODELS:
        return _evaluate_zero_shot(model, ds, split, run, tokenizer, args, stats)
    if task_name == CLASSIFICATION:
        return _evaluate_classification(model, ds, split, run, tokenizer, args, stats)
    from sprc_tpu_torch.train.tasks import ImageTextRetrievalTask

    task = ImageTextRetrievalTask(tokenizer, k_test=int(run.get("k_test", 128)),
                                  max_txt_len=int(run.get("max_txt_len", 35)))
    if arch in loader.CLIP_MODELS:  # the cosine alone, no rescoring
        metrics = task.evaluate_pairs_clip(model, _image_stream(ds), ds.text, ds.img2txt,
                                           ds.txt2img, tokenize=_clip_tokenize(model, run),
                                           stats=stats)
    elif arch == "alpro_retrieval":  # 4 clips a tower call
        metrics = task.evaluate_pairs_video(model, _image_stream(ds, 4), ds.text, ds.img2txt,
                                            ds.txt2img, stats=stats)
    elif arch in loader.MOMENTUM_MODELS:  # 16 images a tower call
        metrics = task.evaluate_pairs_itc(model, _image_stream(ds, 16), ds.text, ds.img2txt,
                                          ds.txt2img, stats=stats)
    else:
        metrics = task.evaluate_pairs(model, _image_stream(ds), ds.text, ds.img2txt,
                                      ds.txt2img, stats=stats)
    metrics["agg_metrics"] = metrics["r_mean"]
    return metrics


def _device(args) -> torch.device:
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit(f"--device {args.device}: no CUDA device is available")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device


def _split(cfg, args, run):
    """(the evaluated split's dataset, its name) from the config's one builder."""
    from sprc_tpu_torch.registry import registry

    datasets_cfg = dict(cfg.datasets or {})
    assert len(datasets_cfg) == 1, "one dataset builder per eval config"
    (ds_name, ds_cfg), = datasets_cfg.items()
    datasets = registry.get("dataset", ds_name)(dict(ds_cfg)).build()
    splits = run.get("test_splits") or run.get("valid_splits") or ["val"]
    split = args.split or splits[0]
    assert split in datasets, (f"builder '{ds_name}' produced splits {sorted(datasets)}; "
                               f"'{split}' not among them")
    return datasets[split], split


def _evaluate_dialogue(cfg, args, arch, model_type, model_cfg, run, stats) -> dict:
    """The ``dialogue`` task (``sprc_tpu/cli/evaluate.py:311-338``): the
    mean of the batches' losses, every batch of real items only.
    ``stats``: ``loss_s``, the seconds of the model's passes."""
    import time

    from sprc_tpu_torch import loader
    from sprc_tpu_torch.train.eval_glue import eval_loader
    from sprc_tpu_torch.train.eval_tasks import DialogueTask
    from sprc_tpu_torch.train.generic import DialogueAdapter, check_dialogue_width

    ds, split = _split(cfg, args, run)
    check_dialogue_width(ds, arch, model_type, model_cfg)
    device = _device(args)
    model = loader.load_model(arch, model_type, checkpoint_path=args.model_path, device=device,
                              seed=int(run.get("seed", 42)), **model_cfg)
    adapter = DialogueAdapter().specialize(model)
    adapter.attach(ds)
    task = DialogueTask()

    def loss_fn(samples):
        t0 = time.perf_counter()
        batch = {k: torch.as_tensor(v).to(device) for k, v in samples.items()}
        with torch.inference_mode():
            loss = adapter.forward(model, batch)["loss"].item()
        if stats is not None:
            stats["loss_s"] = stats.get("loss_s", 0.0) + time.perf_counter() - t0
        return loss

    results = []
    for idx, items in eval_loader(ds, int(run.get("batch_size_eval", run.get("batch_size", 8)))):
        results.extend(task.valid_step(loss_fn, adapter.collate(items[:len(idx)])))
    return task.after_evaluation(results, split)


def _check_eval_size(cfg, arch, model_type, model_cfg) -> None:
    """Exit where the dataset's eval images give the tower another number of
    patches than its own size: its positions are its own size's, and the JAX
    CLI fails at the first batch there (``vqa_val_albef_eval.yaml``: 480 px
    images, ALBEF's 384 px tower)."""
    from sprc_tpu_torch import loader

    vit = loader.family_config(arch, model_type, **model_cfg).vit_config()
    tower = vit.image_size
    for ds_name, ds_cfg in dict(cfg.datasets or {}).items():
        proc = ((ds_cfg or {}).get("vis_processor") or {}).get("eval") or {}
        size = proc.get("image_size")
        if size is not None and int(size) // vit.patch_size != tower // vit.patch_size:
            raise SystemExit(f"{ds_name}: its eval images are {size} px, the {arch} / "
                             f"{model_type} tower's {tower} px (its positions are {tower} px's; "
                             "the JAX CLI fails at the first batch): set "
                             f"datasets.{ds_name}.vis_processor.eval.image_size={tower}")


def _evaluate_captions(model, ds, split, run, tokenizer, args, stats) -> dict:
    """The ``captioning`` task (``sprc_tpu/cli/evaluate.py:239-257,327-``):
    batches of ``batch_size_eval`` through the head's greedy decode, the
    result file under ``--output-dir``/result, CIDEr / BLEU against the
    annotations' captions."""
    from sprc_tpu_torch.train.eval_glue import make_caption_generate_fn
    from sprc_tpu_torch.train.eval_tasks import CaptionTask

    task = CaptionTask(num_beams=int(run.get("num_beams", 3)), max_len=int(run.get("max_len", 30)),
                       min_len=int(run.get("min_len", 10)),
                       report_metric=bool(run.get("report_metric", True)),
                       output_dir=args.output_dir)
    glue = make_caption_generate_fn(model, llm_tokenizer(run, lambda: tokenizer),
                                    prompt=run.get("prompt", "a picture of "), stats=stats)
    results = _valid_steps(task, glue, ds, run)
    return task.after_evaluation(results, split, ground_truth=_caption_ground_truth(ds) or None)


def _valid_steps(task, glue, ds, run) -> list:
    """``task.valid_step`` over the split in batches of ``batch_size_eval``,
    the last one padded and its padding's rows dropped; items without an
    ``instance_id`` get their index, as the JAX CLI gives them. A
    classification batch of answers without labels (ALPRO's video QA) gets
    each item's first answer's index in ``run.answer_list`` as its label, -1
    where it is not there (``sprc_tpu/cli/evaluate.py:343-351``)."""
    from sprc_tpu_torch.train.eval_glue import collate_eval, eval_loader

    batch_size = int(run.get("batch_size_eval", run.get("batch_size", 8)))
    answers = run.get("answer_list") or []
    index = {a: i for i, a in reversed(list(enumerate(answers)))}  # the first one's
    results = []
    for idx, items in eval_loader(ds, batch_size):
        samples = collate_eval(items)
        if "instance_id" not in samples:
            samples["instance_id"] = [str(i) for i in range(idx[0], idx[0] + len(items))]
        if run.get("task") == CLASSIFICATION and "label" not in samples and "answers" in samples:
            samples["label"] = [index.get(a[0], -1) if a else -1 for a in samples["answers"]]
        results.extend(task.valid_step(glue, samples)[: len(idx)])
    return results


def _evaluate_vqa(model, ds, split, run, tokenizer, args, stats) -> dict:
    """The ``vqa`` / ``gqa`` / ``aok_vqa`` tasks of the BLIP-2 heads
    (``sprc_tpu/cli/evaluate.py:219-266``): the annotations' answers by
    question id, the generative glue, the task's result file and accuracy."""
    from sprc_tpu_torch.models.vqa import VQAModel
    from sprc_tpu_torch.train import eval_tasks
    from sprc_tpu_torch.train.eval_glue import make_blip2_vqa_predict_fn, make_vqa_predict_fn

    cls = {"vqa": eval_tasks.VQATask, "gqa": eval_tasks.GQATask,
           "aok_vqa": eval_tasks.AOKVQATask}[run["task"]]
    annotations = {
        ann.get("question_id", ann.get("instance_id")): {
            "answers": ann.get("answers", ann.get("answer", [])),
            "question_type": ann.get("question_type", ""),
            "answer_type": ann.get("answer_type", "")}
        for ann in getattr(ds, "annotation", []) if "answers" in ann or "answer" in ann}
    task = cls(num_beams=int(run.get("num_beams", 3)), max_len=int(run.get("max_len", 10)),
               min_len=int(run.get("min_len", 1)),
               num_ans_candidates=int(run.get("num_ans_candidates", 128)),
               inference_method=run.get("inference_method", "rank"),
               prompt=run.get("prompt", ""), answer_list=run.get("answer_list"),
               annotations=annotations, output_dir=args.output_dir)
    if isinstance(model, PnpVqaPipeline):
        glue = _pnp_predict_fn(model, run, stats)
    elif isinstance(model, VQAModel):
        glue = make_vqa_predict_fn(model, tokenizer, stats=stats)
    else:
        glue = make_blip2_vqa_predict_fn(model, llm_tokenizer(run, lambda: tokenizer),
                                         stats=stats)
    return task.after_evaluation(_valid_steps(task, glue, ds, run), split)


def _evaluate_classification(model, ds, split, run, tokenizer, args, stats) -> dict:
    """The ``multimodal_classification`` task (``sprc_tpu/cli/evaluate.py:
    267-310``, its ``predict`` branch): the classifier's, the NLVR pair
    model's or ALPRO QA's logits, the argmax accuracy and the result file."""
    from sprc_tpu_torch.train.eval_glue import make_classification_predict_fn
    from sprc_tpu_torch.train.eval_tasks import MultimodalClassificationTask

    task = MultimodalClassificationTask(output_dir=args.output_dir)
    glue = make_classification_predict_fn(model, tokenizer,
                                          max_txt_len=int(run.get("max_txt_len", 35)),
                                          stats=stats)
    return task.after_evaluation(_valid_steps(task, glue, ds, run), split)


def _clip_tokenize(model, run, default=None):
    """``run.clip_tokenizer_json``'s BPE at the text tower's context length
    as ``tokenize(texts) -> (ids, eot_positions)``; without it ``default``
    (None: the task's WordPiece fallback), as the JAX CLI."""
    from sprc_tpu_torch.text.llm_tokenizers import clip_tokenize, clip_tokenizer

    tok = clip_tokenizer(run["clip_tokenizer_json"]) if run.get("clip_tokenizer_json") else default
    if tok is None:
        return None
    ctx = int(model.cfg.text.context_length)
    return lambda texts: clip_tokenize(tok, texts, ctx)


def _class_names(run, ds) -> list:
    """``run.classnames``, the lines of ``run.classnames_path``, or the
    labels as names where they are exactly 0..C-1 (their column order),
    as the JAX CLI derives them."""
    names = run.get("classnames")
    if names is None and run.get("classnames_path"):
        with open(run["classnames_path"]) as f:
            names = [line.strip() for line in f if line.strip()]
    if names is None:
        labels = sorted({ann["label"] for ann in getattr(ds, "annotation", [])})
        if labels != list(range(len(labels))):
            raise SystemExit("zero-shot eval needs run.classnames or run.classnames_path (the "
                             "labels are not a dense 0..C-1 integer range, so the column order "
                             "cannot be derived)")
        names = [str(label) for label in labels]
    if not names:
        raise SystemExit("zero-shot eval needs run.classnames[_path]")
    return names


def _evaluate_zero_shot(model, ds, split, run, tokenizer, args, stats) -> dict:
    """CLIP's zero-shot ``multimodal_classification``
    (``sprc_tpu/cli/evaluate.py:267-306``): the classifier over the class
    names and the 80 templates (``run.clip_tokenizer_json``'s BPE, else the
    WordPiece fallback, at the text tower's context length), then batches of
    ``batch_size_eval`` through the image tower; the argmax accuracy and the
    result file. ``stats``: ``classifier`` and ``tower`` seconds."""
    import time

    from sprc_tpu_torch.models.clip_zero_shot import (make_zero_shot_predict_fn,
                                                      zero_shot_classifier)
    from sprc_tpu_torch.train.eval_tasks import MultimodalClassificationTask

    task = MultimodalClassificationTask(output_dir=args.output_dir)
    t0 = time.perf_counter()
    clf = zero_shot_classifier(model, _class_names(run, ds),
                               _clip_tokenize(model, run, default=tokenizer))
    if stats is not None:
        stats["classifier"] = time.perf_counter() - t0
    glue = make_zero_shot_predict_fn(model, clf, stats=stats)
    return task.after_evaluation(_valid_steps(task, glue, ds, run), split)


def _pnp_predict_fn(model, run, stats):
    """PNP-VQA's glue (``sprc_tpu/cli/evaluate.py:242-256``): every batch
    through ``predict_answers`` with the run's ``num_captions``,
    ``num_captions_fid``, ``num_patches`` and ``block_num``, and the task's
    ``max_len`` / ``min_len``; the method, beams and prompt are not read.
    Every batch draws from ``predict_answers``' default seed 0, as in the
    JAX glue."""
    def predict_fn(samples, *, max_len=10, min_len=1, **_):
        answers, _, _ = model.predict_answers(
            np.asarray(samples["image"]), list(samples["text_input"]),
            num_captions=int(run.get("num_captions", 50)),
            num_captions_fid=int(run.get("num_captions_fid", 1)),
            num_patches=int(run.get("num_patches", 20)), block_num=int(run.get("block_num", 7)),
            max_len=max_len, min_len=min_len, stats=stats)
        return answers

    return predict_fn


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--cfg-path", required=True)
    p.add_argument("--model-path", default=None)
    p.add_argument("--vocab-path", default=None)
    p.add_argument("--output-dir", default="./output")
    p.add_argument("--split", default=None, help="dataset split (default: run.test_splits[0])")
    p.add_argument("--options", nargs="*", default=[], help="dotlist overrides key=value")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; exits nonzero without a GPU) or cpu")
    return p


def main(argv: Optional[list] = None) -> None:
    from sprc_tpu_torch.config import Config

    args = make_parser().parse_args(argv)
    metrics = evaluate(Config(args.cfg_path, overrides=args.options), args)
    print(json.dumps({k: v for k, v in metrics.items() if isinstance(v, (int, float, str))}))


if __name__ == "__main__":
    main()
