"""Epoch logs (the port's copy of ``sprc_tpu/utils/logging.py::MetricsLogger``):
``train_metrics.csv``, ``validation_metrics.csv`` and ``log.jsonl`` under the
output directory, the reference's file outputs."""

from __future__ import annotations

import json
import os
from typing import Dict


class MetricsLogger:
    def __init__(self, output_dir: str):
        self.output_dir = output_dir
        os.makedirs(output_dir, exist_ok=True)

    def _append_csv(self, path: str, row: Dict) -> None:
        new = not os.path.exists(path)
        with open(path, "a") as f:
            if new:
                f.write(",".join(map(str, row.keys())) + "\n")
            f.write(",".join(str(v) for v in row.values()) + "\n")

    def _append_jsonl(self, row: Dict) -> None:
        with open(os.path.join(self.output_dir, "log.jsonl"), "a") as f:
            f.write(json.dumps(row) + "\n")

    def log_train(self, metrics: Dict) -> None:
        self._append_csv(os.path.join(self.output_dir, "train_metrics.csv"), metrics)
        self._append_jsonl({"kind": "train", **metrics})

    def log_validation(self, metrics: Dict) -> None:
        self._append_csv(os.path.join(self.output_dir, "validation_metrics.csv"), metrics)
        self._append_jsonl({"kind": "val", **metrics})
