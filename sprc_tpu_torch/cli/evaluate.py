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
``k_test``) and the recalls, ``agg_metrics`` = ``r_mean``. And the
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
without them); ``run.inference_method`` must be ``generate``. The LLaMA
models (``blip2_vicuna_instruct``, ``blip2_instruct_cir``) exit: no task's
glue fits their signatures (the JAX CLI builds them and fails at the call);
``cli/instruct.py`` runs them. Each prints as the JAX CLI prints: one JSON line of the
scalar metrics. Every other task or family exits with a message naming its
ROADMAP entry (BLIP-1 / ALBEF's ranked VQA: A8.6; ``pnp_vqa``: A8.4); CIR
datasets keep their CLIs (``cli/validate.py``, ``cli/validate_rerank.py``,
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

from sprc_tpu_torch.train.generic import llm_tokenizer

VQA_TASKS = ("vqa", "gqa", "aok_vqa")


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
    from sprc_tpu_torch.registry import registry
    from sprc_tpu_torch.text.tokenizer import BertWordPieceTokenizer
    from sprc_tpu_torch.utils.artifacts import ensure_bert_vocab

    run = dict(cfg.run)
    task_name = run.get("task")
    model_cfg = dict(cfg.model)
    arch = model_cfg.pop("arch")
    model_type = model_cfg.pop("model_type", "pretrain")
    if task_name not in ("retrieval", "captioning") + VQA_TASKS:
        raise SystemExit(f"task {task_name!r}: not ported to cli/evaluate.py "
                         "(classification and dialogue come with their families, ROADMAP "
                         "A8.6; CIR -> cli/validate.py)")
    if arch in loader.INSTRUCT_MODELS:
        raise SystemExit(f"model {arch!r}: no evaluation glue fits its signature (the "
                         "instruction and LLaMA token batches), in either package; "
                         "cli/instruct.py runs it")
    if task_name == "retrieval" and arch not in loader.STAGE1_MODELS:
        raise SystemExit(f"model {arch!r}: its retrieval evaluation is not ported (BLIP-1, "
                         "ALBEF, CLIP, ALPRO: ROADMAP A8.6)")
    if task_name == "captioning" and arch not in loader.LLM_HEADS:
        raise SystemExit(f"model {arch!r}: its captioning is not ported (ported: "
                         f"{', '.join(loader.LLM_HEADS)}; BLIP-1's blip_caption and the "
                         "other families: ROADMAP A8.6)")
    if task_name in VQA_TASKS and arch not in loader.LLM_HEADS:
        raise SystemExit(f"model {arch!r}: its {task_name} evaluation is not ported (ported: "
                         f"the generative {', '.join(loader.LLM_HEADS)}; "
                         + ("pnp_vqa and img2prompt_vqa: ROADMAP A8.4)"
                            if arch in ("pnp_vqa", "img2prompt_vqa") else
                            "BLIP-1 / ALBEF's ranked VQA: ROADMAP A8.6)"))
    if task_name in VQA_TASKS and run.get("inference_method", "rank") != "generate":
        raise SystemExit(f"run.inference_method {run.get('inference_method', 'rank')!r}: the "
                         "BLIP-2 heads answer generatively ('generate'; ranked VQA over "
                         "run.answer_list: ROADMAP A8.6)")
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit(f"--device {args.device}: no CUDA device is available")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    model_cfg["freeze_vit"] = True  # evaluation trains nothing: the tower is built frozen
    model = loader.load_model(arch, model_type, checkpoint_path=args.model_path, device=device,
                              seed=int(run.get("seed", 42)), **model_cfg)

    datasets_cfg = dict(cfg.datasets or {})
    assert len(datasets_cfg) == 1, "one dataset builder per eval config"
    (ds_name, ds_cfg), = datasets_cfg.items()
    datasets = registry.get("dataset", ds_name)(dict(ds_cfg)).build()
    splits = run.get("test_splits") or run.get("valid_splits") or ["val"]
    split = args.split or splits[0]
    assert split in datasets, (f"builder '{ds_name}' produced splits {sorted(datasets)}; "
                               f"'{split}' not among them")
    ds = datasets[split]
    tokenizer = BertWordPieceTokenizer.from_vocab_file(ensure_bert_vocab(args.vocab_path))
    if task_name == "captioning":
        return _evaluate_captions(model, ds, split, run, tokenizer, args, stats)
    if task_name in VQA_TASKS:
        return _evaluate_vqa(model, ds, split, run, tokenizer, args, stats)
    from sprc_tpu_torch.train.tasks import ImageTextRetrievalTask

    task = ImageTextRetrievalTask(tokenizer, k_test=int(run.get("k_test", 128)),
                                  max_txt_len=int(run.get("max_txt_len", 35)))
    metrics = task.evaluate_pairs(model, _image_stream(ds), ds.text, ds.img2txt, ds.txt2img,
                                  stats=stats)
    metrics["agg_metrics"] = metrics["r_mean"]
    return metrics


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
    ``instance_id`` get their index, as the JAX CLI gives them."""
    from sprc_tpu_torch.train.eval_glue import collate_eval, eval_loader

    batch_size = int(run.get("batch_size_eval", run.get("batch_size", 8)))
    results = []
    for idx, items in eval_loader(ds, batch_size):
        samples = collate_eval(items)
        if "instance_id" not in samples:
            samples["instance_id"] = [str(i) for i in range(idx[0], idx[0] + len(items))]
        results.extend(task.valid_step(glue, samples)[: len(idx)])
    return results


def _evaluate_vqa(model, ds, split, run, tokenizer, args, stats) -> dict:
    """The ``vqa`` / ``gqa`` / ``aok_vqa`` tasks of the BLIP-2 heads
    (``sprc_tpu/cli/evaluate.py:219-266``): the annotations' answers by
    question id, the generative glue, the task's result file and accuracy."""
    from sprc_tpu_torch.train import eval_tasks
    from sprc_tpu_torch.train.eval_glue import make_blip2_vqa_predict_fn

    cls = {"vqa": eval_tasks.VQATask, "gqa": eval_tasks.GQATask,
           "aok_vqa": eval_tasks.AOKVQATask}[run["task"]]
    annotations = {
        ann.get("question_id", ann.get("instance_id")): {
            "answers": ann.get("answers", ann.get("answer", [])),
            "question_type": ann.get("question_type", ""),
            "answer_type": ann.get("answer_type", "")}
        for ann in getattr(ds, "annotation", []) if "answers" in ann or "answer" in ann}
    task = cls(num_beams=int(run.get("num_beams", 3)), max_len=int(run.get("max_len", 10)),
               min_len=int(run.get("min_len", 1)), inference_method=run["inference_method"],
               prompt=run.get("prompt", ""), annotations=annotations, output_dir=args.output_dir)
    glue = make_blip2_vqa_predict_fn(model, llm_tokenizer(run, lambda: tokenizer), stats=stats)
    return task.after_evaluation(_valid_steps(task, glue, ds, run), split)


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
