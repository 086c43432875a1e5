"""Evaluation tasks that turn a model's generated outputs into result
files and metrics (counterpart of ``sprc_tpu/train/eval_tasks.py``; the
reference's tasks/captioning.py).

Ported: :class:`CaptionTask`, registered as ``captioning``, with
:func:`save_result` and the ``evaluate.txt`` log. ``valid_step`` calls the
caption glue (``train/eval_glue.py``) on a batch and pairs each caption
with its ``image_id``; ``after_evaluation`` writes the result file, dropping
repeated image ids, and scores the captions against the annotations with
:mod:`sprc_tpu_torch.retrieval.caption_eval` (``agg_metrics`` = CIDEr +
Bleu_4). The VQA, GQA, classification and dialogue tasks come with their
families (ROADMAP A8).
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
