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
``AOKVQATask.valid_step`` hands the glue no ``prompt``. The classification
and dialogue tasks come with their families (ROADMAP A8.6).
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, List, Optional, Sequence

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
    (reference tasks/vqa.py:19-167). The port's only glue is the BLIP-2
    heads' generative one: ranked VQA's ``answer_list`` and
    ``num_ans_candidates`` come with BLIP-1 / ALBEF (ROADMAP A8.6)."""

    def __init__(self, *, num_beams: int = 3, max_len: int = 10, min_len: int = 1,
                 inference_method: str = "rank", prompt: str = "",
                 annotations: Optional[dict] = None, output_dir: str = "./output"):
        self.num_beams = num_beams
        self.max_len = max_len
        self.min_len = min_len
        self.inference_method = inference_method
        self.prompt = prompt
        # {question_id: {"answers": [...], "question_type", "answer_type"}}
        self.annotations = annotations or {}
        self.output_dir = output_dir

    def _predict(self, predict_fn: Callable, samples: dict, **prompt) -> List[str]:
        return predict_fn(samples, inference_method=self.inference_method,
                          num_beams=self.num_beams, max_len=self.max_len, min_len=self.min_len,
                          **prompt)

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
