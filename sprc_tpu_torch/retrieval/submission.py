"""CIRR and CIRCO test-server submission writers (counterpart of
``sprc_tpu/retrieval/submission.py``; a test pins the files equal, byte for
byte).

CIRR (reference src/cirr_test_submission.py:16-132): rank the test1
gallery, optionally rerank the top 50 (before the reference is dropped, as
the reference's test path does; the val path drops it first), drop the
reference image and write ``recall_submission_<name>.json`` (top 50 per
pair id) and ``recall_subset_submission_<name>.json`` (top 3 within the
query's group), each with ``"version": "rc2"`` and its metric.

CIRCO: ``circo_submission_<name>.json``, ``{query_id: top-50 image ids}``
with the ids as strings and the reference not dropped. The JAX CLI writes it
under its default ``--output-dir submission/CIRR``; both quirks are kept.
Every file is written with ``sort_keys=True``.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence

import numpy as np

from sprc_tpu_torch.retrieval.metrics import drop_reference, sort_gallery


def build_submission_dicts(
    sims: np.ndarray,
    index_names: Sequence[str],
    reference_names: Sequence[str],
    group_members: Sequence[Sequence[str]],
    pair_ids: Sequence[int],
    rerank_fn=None,
) -> tuple[Dict[str, List[str]], Dict[str, List[str]]]:
    """sims [B, N] -> (pairid -> top-50 names, pairid -> top-3 group names).

    ``rerank_fn``, if given, maps the [B, M] sorted-name matrix to a
    rewritten one (applied BEFORE the reference drop, matching the test-path
    order in cirr_test_submission.py:87-113).
    """
    sorted_names = sort_gallery(sims, index_names)
    if rerank_fn is not None:
        sorted_names = rerank_fn(sorted_names)
    sorted_names = drop_reference(sorted_names, reference_names)

    groups = np.asarray(group_members)
    group_mask = (sorted_names[..., None] == groups[:, None, :]).sum(-1).astype(bool)
    sorted_group = sorted_names[group_mask].reshape(sorted_names.shape[0], -1)

    predictions = {
        str(int(pid)): row[:50].tolist()
        for pid, row in zip(pair_ids, sorted_names)
    }
    group_predictions = {
        str(int(pid)): row[:3].tolist()
        for pid, row in zip(pair_ids, sorted_group)
    }
    return predictions, group_predictions


def build_circo_submission(
    sims: np.ndarray,
    index_ids: Sequence[str],
    query_ids: Sequence[str],
    top_k: int = 50,
    rerank_fn=None,
) -> Dict[str, List[str]]:
    """sims [B, N] -> {query_id: top-``top_k`` retrieved COCO img ids}.

    The reference image is NOT dropped (CIRCO ground truths never equal the
    reference; the protocol ranks the raw gallery, as
    ``compute_circo_metrics`` does). ``rerank_fn``, if given, rewrites the
    sorted-id matrix before the top-k cut."""
    sorted_ids = sort_gallery(sims, index_ids)
    if rerank_fn is not None:
        sorted_ids = rerank_fn(sorted_ids)
    return {
        str(qid): row[:top_k].tolist()
        for qid, row in zip(query_ids, sorted_ids)
    }


def write_circo_submission(
    output_dir: str,
    file_name: str,
    predictions: Dict[str, List[str]],
) -> str:
    os.makedirs(output_dir, exist_ok=True)
    path = os.path.join(output_dir, f"circo_submission_{file_name}.json")
    with open(path, "w") as f:
        json.dump(predictions, f, sort_keys=True)
    return path


def write_submission_files(
    output_dir: str,
    file_name: str,
    predictions: Dict[str, List[str]],
    group_predictions: Dict[str, List[str]],
) -> tuple[str, str]:
    os.makedirs(output_dir, exist_ok=True)
    submission = {"version": "rc2", "metric": "recall", **predictions}
    group_submission = {"version": "rc2", "metric": "recall_subset", **group_predictions}
    p1 = os.path.join(output_dir, f"recall_submission_{file_name}.json")
    p2 = os.path.join(output_dir, f"recall_subset_submission_{file_name}.json")
    with open(p1, "w") as f:
        json.dump(submission, f, sort_keys=True)
    with open(p2, "w") as f:
        json.dump(group_submission, f, sort_keys=True)
    return p1, p2
