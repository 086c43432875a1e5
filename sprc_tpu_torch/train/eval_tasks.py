"""Evaluation tasks that turn a model's generated outputs into result
files and metrics (counterpart of ``sprc_tpu/train/eval_tasks.py``; the
reference's tasks/captioning.py).

Ported: :class:`CaptionTask`, registered as ``captioning``, with
:func:`save_result` and the ``evaluate.txt`` log. ``valid_step`` calls the
caption glue (``train/eval_glue.py``) on a batch and pairs each caption
with its ``image_id``; ``after_evaluation`` writes the result file, dropping
repeated image ids, and scores the captions against the annotations with
:mod:`sprc_tpu_torch.retrieval.caption_eval` (``agg_metrics`` = CIDEr +
Bleu_4). And the VQA tasks (reference tasks/vqa.py), registered as ``vqa``,
``gqa`` and ``aok_vqa``: :class:`VQATask` (the official VQA accuracy,
:mod:`sprc_tpu_torch.retrieval.vqa_eval`), :class:`GQATask` (exact match
after the VQA normalisation) and :class:`AOKVQATask` (min(matches / 3, 1)
over the direct answers); each writes ``<split>_{vqa,gqa,aokvqa}_result``
with one row a question id, and a leaderboard split without ground truth
gets its result file and no metric. As in the JAX package,
``AOKVQATask.valid_step`` hands the glue no ``prompt``; the tasks hand it
``answer_list`` and ``num_ans_candidates``, which BLIP-1 / ALBEF's ranked
glue reads and the BLIP-2 heads' generative glue takes and ignores. And
:class:`MultimodalClassificationTask` (``multimodal_classification``:
argmax accuracy, reference tasks/multimodal_classification.py). And
:class:`DialogueTask` (``dialogue``: the mean of per-batch LM losses,
reference tasks/dialogue.py), :class:`ImageTextPretrainTask`
(``image_text_pretrain``: no evaluation phase), and the reading-comprehension
tasks that drive the PNP-VQA pipeline, :class:`VQARCTask`
(``vqa_reading_comprehension``) and :class:`GQARCTask`
(``gqa_reading_comprehension``), scored as VQA and GQA.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from sprc_tpu_torch.registry import registry
from sprc_tpu_torch.train.runner import BaseTask


def save_result(result: List[dict], result_dir: str, filename: str,
                remove_duplicate: Optional[str] = None) -> str:
    """Write ``result`` to ``result_dir/filename.json``, keeping the first
    row of each ``remove_duplicate`` value (reference base_task.py:249-287)."""
    os.makedirs(result_dir, exist_ok=True)
    if remove_duplicate:
        seen, deduped = set(), []
        for row in result:
            key = row[remove_duplicate]
            if key not in seen:
                seen.add(key)
                deduped.append(row)
        result = deduped
    path = os.path.join(result_dir, f"{filename}.json")
    with open(path, "w") as f:
        json.dump(result, f)
    return path


def _append_eval_log(output_dir: str, payload: dict) -> None:
    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, "evaluate.txt"), "a") as f:
        f.write(json.dumps(payload) + "\n")


@registry.register("task", "captioning")
class CaptionTask(BaseTask):
    """valid_step -> [{"caption", "image_id"}]; metric CIDEr + Bleu_4
    (reference tasks/captioning.py:16-117). ``num_beams`` and ``min_len``
    are handed to the glue, whose BLIP-2 LLM heads decode greedily and read
    neither, as in the JAX package."""

    def __init__(self, *, num_beams: int = 3, max_len: int = 30, min_len: int = 10,
                 report_metric: bool = True, output_dir: str = "./output"):
        self.num_beams = num_beams
        self.max_len = max_len
        self.min_len = min_len
        self.report_metric = report_metric
        self.output_dir = output_dir

    def valid_step(self, generate_fn: Callable, samples: dict) -> List[dict]:
        captions = generate_fn(samples, num_beams=self.num_beams, max_length=self.max_len,
                               min_length=self.min_len)
        return [{"caption": c, "image_id": int(i)} for c, i in zip(captions, samples["image_id"])]

    def after_evaluation(self, val_result: List[dict], split_name: str, epoch: Any = "x",
                         ground_truth: Optional[Dict[int, Sequence[str]]] = None
                         ) -> Dict[str, float]:
        path = save_result(val_result, os.path.join(self.output_dir, "result"),
                           f"{split_name}_epoch{epoch}", remove_duplicate="image_id")
        if not (self.report_metric and ground_truth):
            return {"agg_metrics": 0.0}
        from sprc_tpu_torch.retrieval.caption_eval import caption_metrics

        with open(path) as f:
            rows = json.load(f)
        cands = [r["caption"] for r in rows if r["image_id"] in ground_truth]
        refs = [list(ground_truth[r["image_id"]]) for r in rows if r["image_id"] in ground_truth]
        metrics = caption_metrics(cands, refs)
        _append_eval_log(self.output_dir, {split_name: metrics})
        return metrics


@registry.register("task", "vqa")
class VQATask(BaseTask):
    """valid_step -> [{"question_id", "answer"}]; the official VQA accuracy
    (reference tasks/vqa.py:19-167)."""

    def __init__(self, *, num_beams: int = 3, max_len: int = 10, min_len: int = 1,
                 num_ans_candidates: int = 128, inference_method: str = "rank",
                 prompt: str = "", answer_list: Optional[Sequence[str]] = None,
                 annotations: Optional[dict] = None, output_dir: str = "./output"):
        self.num_beams = num_beams
        self.max_len = max_len
        self.min_len = min_len
        self.num_ans_candidates = num_ans_candidates
        self.inference_method = inference_method
        self.prompt = prompt
        self.answer_list = answer_list
        # {question_id: {"answers": [...], "question_type", "answer_type"}}
        self.annotations = annotations or {}
        self.output_dir = output_dir

    def _predict(self, predict_fn: Callable, samples: dict, **prompt) -> List[str]:
        return predict_fn(samples, answer_list=self.answer_list,
                          inference_method=self.inference_method, num_beams=self.num_beams,
                          max_len=self.max_len, min_len=self.min_len,
                          num_ans_candidates=self.num_ans_candidates, **prompt)

    def valid_step(self, predict_fn: Callable, samples: dict) -> List[dict]:
        answers = self._predict(predict_fn, samples, prompt=self.prompt)
        return [{"question_id": int(q), "answer": a}
                for a, q in zip(answers, samples["question_id"])]

    def after_evaluation(self, val_result: List[dict], split_name: str,
                         **kw) -> Dict[str, float]:
        path = save_result(val_result, os.path.join(self.output_dir, "result"),
                           f"{split_name}_vqa_result", remove_duplicate="question_id")
        if not self.annotations:
            return {}
        from sprc_tpu_torch.retrieval.vqa_eval import VQAEval

        with open(path) as f:
            rows = json.load(f)
        results = {r["question_id"]: r["answer"] for r in rows
                   if r["question_id"] in self.annotations}
        anns = [{"question_id": qid, **self.annotations[qid]} for qid in results]
        acc = VQAEval().evaluate(results, anns)
        metrics = {"agg_metrics": acc["overall"], **acc.get("perAnswerType", {})}
        _append_eval_log(self.output_dir, metrics)
        return metrics


def _exact_accuracy(rows: List[dict], score: Callable) -> Dict[str, float]:
    accuracy = 100.0 * sum(score(r) for r in rows) / max(len(rows), 1)
    return {"agg_metrics": accuracy, "acc": accuracy}


@registry.register("task", "gqa")
class GQATask(VQATask):
    """Exact-match accuracy after the VQA normalisation (vqa.py:169-230)."""

    def valid_step(self, predict_fn: Callable, samples: dict) -> List[dict]:
        answers = self._predict(predict_fn, samples, prompt=self.prompt)
        return [{"question_id": int(q), "pred_ans": a, "gt_ans": g}
                for a, q, g in zip(answers, samples["question_id"], samples["answer"])]

    def after_evaluation(self, val_result: List[dict], split_name: str,
                         **kw) -> Dict[str, float]:
        path = save_result(val_result, os.path.join(self.output_dir, "result"),
                           f"{split_name}_gqa_result", remove_duplicate="question_id")
        from sprc_tpu_torch.retrieval.vqa_eval import (process_digit_article,
                                                       process_punctuation)

        with open(path) as f:
            rows = json.load(f)
        if any(r["gt_ans"] is None for r in rows):
            return {}  # a leaderboard split: predictions saved, no ground truth
        metrics = _exact_accuracy(rows, lambda r: 1.0 if process_digit_article(
            process_punctuation(r["pred_ans"])) == r["gt_ans"] else 0.0)
        _append_eval_log(self.output_dir, metrics)
        return metrics


@registry.register("task", "aok_vqa")
class AOKVQATask(VQATask):
    """Direct-answer accuracy min(matches / 3, 1) (vqa.py:233-296); the glue
    gets no ``prompt``, as in the JAX package."""

    def valid_step(self, predict_fn: Callable, samples: dict) -> List[dict]:
        answers = self._predict(predict_fn, samples)
        return [{"question_id": q, "pred_ans": a, "gt_ans": list(g) if g is not None else None}
                for a, q, g in zip(answers, samples["question_id"], samples["direct_answers"])]

    def after_evaluation(self, val_result: List[dict], split_name: str,
                         **kw) -> Dict[str, float]:
        path = save_result(val_result, os.path.join(self.output_dir, "result"),
                           f"{split_name}_aokvqa_result", remove_duplicate="question_id")
        with open(path) as f:
            rows = json.load(f)
        if any(r["gt_ans"] is None for r in rows):
            return {}
        metrics = _exact_accuracy(rows, lambda r: min(
            1.0, sum(r["pred_ans"] == gt for gt in r["gt_ans"]) / 3.0))
        _append_eval_log(self.output_dir, metrics)
        return metrics


@registry.register("task", "multimodal_classification")
class MultimodalClassificationTask(BaseTask):
    """Argmax accuracy (reference multimodal_classification.py:19-85):
    ``valid_step`` pairs each row's argmax with its target under
    ``inst_id_key``; ``after_evaluation`` writes ``<split>_epoch<epoch>``
    (one row an id) and returns ``agg_metrics`` = ``acc``, a fraction."""

    def __init__(self, *, inst_id_key: str = "instance_id", output_dir: str = "./output"):
        self.inst_id_key = inst_id_key
        self.output_dir = output_dir

    def valid_step(self, predict_fn: Callable, samples: dict) -> List[dict]:
        out = predict_fn(samples)
        preds = np.asarray(out["predictions"]).argmax(axis=1)
        targets = np.asarray(out["targets"])
        return [{self.inst_id_key: str(i), "prediction": int(p), "target": int(t)}
                for p, t, i in zip(preds, targets, samples[self.inst_id_key])]

    def after_evaluation(self, val_result: List[dict], split_name: str, epoch: Any = "x",
                         **kw) -> Dict[str, float]:
        path = save_result(val_result, os.path.join(self.output_dir, "result"),
                           f"{split_name}_epoch{epoch}", remove_duplicate=self.inst_id_key)
        with open(path) as f:
            rows = json.load(f)
        preds = np.asarray([r["prediction"] for r in rows])
        targets = np.asarray([r["target"] for r in rows])
        accuracy = float((preds == targets).sum() / max(targets.shape[0], 1))
        metrics = {"agg_metrics": accuracy, "acc": accuracy}
        _append_eval_log(self.output_dir, {split_name: metrics})
        return metrics


@registry.register("task", "dialogue")
class DialogueTask(BaseTask):
    """``valid_step`` -> the batch's LM loss; ``agg_metrics`` is their mean
    (reference tasks/dialogue.py:20-66; ``sprc_tpu/train/eval_tasks.py:277``).
    The metric is a per-batch scalar, so a partial last batch must feed its
    real items only."""

    def valid_step(self, loss_fn: Callable, samples: dict) -> List[float]:
        return [float(loss_fn(samples))]

    def after_evaluation(self, val_result: List[float], split_name: str,
                         **kw) -> Dict[str, float]:
        return {"agg_metrics": float(np.mean(val_result))}


@registry.register("task", "image_text_pretrain")
class ImageTextPretrainTask(BaseTask):
    """Pretraining has no evaluation phase (reference image_text_pretrain.py:12-18)."""

    def evaluation(self, *a, **kw) -> Dict[str, float]:
        return {}


@registry.register("task", "vqa_reading_comprehension")
class VQARCTask(VQATask):
    """The PNP-VQA pipeline's task: ``predict_answers`` with the task's
    caption and patch counts, scored by the VQA protocol (reference
    vqa_reading_comprehension.py:22-155)."""

    def __init__(self, *, num_captions: int = 50, num_captions_fid: int = 1,
                 num_patches: int = 50, block_num: int = 7, **kw):
        super().__init__(**kw)
        self.pipeline_kwargs = dict(num_captions=num_captions, num_captions_fid=num_captions_fid,
                                    num_patches=num_patches, block_num=block_num)

    def _answers(self, pipeline, samples: dict) -> List[str]:
        answers, _, _ = pipeline.predict_answers(np.asarray(samples["image"]),
                                                 list(samples["text_input"]),
                                                 **self.pipeline_kwargs)
        return answers

    def valid_step(self, pipeline, samples: dict) -> List[dict]:
        return [{"question_id": int(q), "answer": a}
                for a, q in zip(self._answers(pipeline, samples), samples["question_id"])]


@registry.register("task", "gqa_reading_comprehension")
class GQARCTask(VQARCTask, GQATask):
    """GQA scored through the reading-comprehension pipeline
    (vqa_reading_comprehension.py:156-200)."""

    def valid_step(self, pipeline, samples: dict) -> List[dict]:
        return [{"question_id": int(q), "pred_ans": a, "gt_ans": g}
                for a, q, g in zip(self._answers(pipeline, samples), samples["question_id"],
                                   samples["answer"])]

    after_evaluation = GQATask.after_evaluation
