"""Retrieval metrics: Recall@K and CIRR subset (group) recall.

Formula-level re-implementation of the reference metric library
(reference: src/validate_blip.py:24-57, :232-285, :326-356):

- distances = 1 - sim; stable argsort (matching torch.argsort's stable
  tie behavior so duplicate gallery images rank identically),
- drop the reference image row-wise (CIRR),
- Recall@K = fraction of rows whose target lands in the top K,
- subset recall over each query's 6-member group.

Everything here is numpy on the host; the sim matrix comes from
:mod:`sprc_tpu_torch.retrieval.engine`. The port's own copy of
``sprc_tpu/retrieval/metrics.py`` (it imports nothing of ``sprc_tpu``);
tests/test_torch_metrics.py pins the two equal, ties included.
"""

from __future__ import annotations

from statistics import geometric_mean, harmonic_mean, mean
from typing import Dict, List, Sequence, Tuple

import numpy as np


def sort_gallery(sims: np.ndarray, index_names: Sequence[str]) -> np.ndarray:
    """[B, N] sims -> [B, N] gallery names sorted by descending similarity.

    Uses distances = 1 - sim with a stable sort, matching
    ``torch.argsort(1 - sims)`` in the reference (validate_blip.py:253-255).
    """
    distances = 1.0 - np.asarray(sims, np.float32)
    order = np.argsort(distances, axis=-1, kind="stable")
    return np.asarray(index_names)[order]


def drop_reference(
    sorted_names: np.ndarray, reference_names: Sequence[str]
) -> np.ndarray:
    """Remove each row's reference image from its ranking (:258-261)."""
    refs = np.asarray(reference_names)[:, None]
    mask = sorted_names != refs
    kept = sorted_names[mask].reshape(sorted_names.shape[0], sorted_names.shape[1] - 1)
    return kept


def recall_at(labels: np.ndarray, k: int) -> float:
    return float(labels[:, :k].sum() / len(labels)) * 100.0


def compute_cirr_metrics(
    sims: np.ndarray,
    index_names: Sequence[str],
    reference_names: Sequence[str],
    target_names: Sequence[str],
    group_members: Sequence[Sequence[str]],
) -> Dict[str, float]:
    """CIRR val metrics (validate_blip.py:232-285). Returns the full suite."""
    sorted_names = sort_gallery(sims, index_names)
    sorted_names = drop_reference(sorted_names, reference_names)

    targets = np.asarray(target_names)[:, None]
    labels = sorted_names == targets
    if not np.array_equal(labels.sum(-1), np.ones(len(targets), dtype=np.int64)):
        raise AssertionError("each query must have exactly one target in the gallery")

    groups = np.asarray(group_members)
    group_mask = (sorted_names[..., None] == groups[:, None, :]).sum(-1).astype(bool)
    group_labels = labels[group_mask].reshape(labels.shape[0], -1)
    if not np.array_equal(group_labels.sum(-1), np.ones(len(targets), dtype=np.int64)):
        raise AssertionError("each query's target must be inside its group")

    results = {
        "group_recall_at1": recall_at(group_labels, 1),
        "group_recall_at2": recall_at(group_labels, 2),
        "group_recall_at3": recall_at(group_labels, 3),
        "recall_at1": recall_at(labels, 1),
        "recall_at5": recall_at(labels, 5),
        "recall_at10": recall_at(labels, 10),
        "recall_at50": recall_at(labels, 50),
    }
    vals = list(results.values())
    results["mean(R@5+R_s@1)"] = (results["group_recall_at1"] + results["recall_at5"]) / 2
    results["arithmetic_mean"] = mean(vals)
    # DELIBERATE deviation: the reference's statistics calls raise on zero
    # recalls (possible early in training); we return 0.0 but warn so a
    # degenerate epoch is visible if either mean is the selection key
    # (the trainer's selection key)
    if all(v > 0 for v in vals):
        results["harmonic_mean"] = harmonic_mean(vals)
        results["geometric_mean"] = geometric_mean(vals)
    else:
        import logging

        logging.getLogger(__name__).warning(
            "a recall component is 0; harmonic/geometric means forced to 0.0 "
            "(reference would raise StatisticsError)"
        )
        results["harmonic_mean"] = 0.0
        results["geometric_mean"] = 0.0
    return results


def compute_fiq_metrics(
    sims: np.ndarray,
    index_names: Sequence[str],
    target_names: Sequence[str],
) -> Tuple[float, float]:
    """FashionIQ (recall@10, recall@50) (validate_blip.py:24-57)."""
    sorted_names = sort_gallery(sims, index_names)
    targets = np.asarray(target_names)[:, None]
    labels = sorted_names == targets
    if not np.array_equal(labels.sum(-1), np.ones(len(targets), dtype=np.int64)):
        raise AssertionError("each query must have exactly one target in the gallery")
    return recall_at(labels, 10), recall_at(labels, 50)


def compute_circo_metrics(
    sims: np.ndarray,
    index_ids: Sequence[str],
    gt_img_ids: Sequence[Sequence[str]],
    ks: Sequence[int] = (5, 10, 25, 50),
) -> Dict[str, float]:
    """CIRCO mAP@K over multi-ground-truth queries.

    The reference defines the CIRCO dataset (data_utils.py:289-426) but never
    wires its eval; the dataset's standard protocol is mAP@K with up to 23
    ground truths per query (padded with '' which are ignored here).
    AP@K = sum_r [precision@r * rel(r)] / min(K, #GT).
    """
    sorted_ids = sort_gallery(sims, index_ids)
    out: Dict[str, float] = {}
    for k in ks:
        aps = []
        for row, gts in zip(sorted_ids, gt_img_ids):
            gts_set = {g for g in gts if g}
            if not gts_set:
                continue
            hits = 0
            precision_sum = 0.0
            for r, name in enumerate(row[:k], start=1):
                if name in gts_set:
                    hits += 1
                    precision_sum += hits / r
            aps.append(precision_sum / min(k, len(gts_set)))
        out[f"map_at{k}"] = float(np.mean(aps)) * 100.0 if aps else 0.0
    return out


def cirr_topk_lists(
    sims: np.ndarray,
    index_names: Sequence[str],
    reference_names: Sequence[str],
    group_members: Sequence[Sequence[str]],
    k_global: int = 50,
    k_subset: int = 3,
) -> Tuple[List[List[str]], List[List[str]]]:
    """Top-50 global and top-3 subset rankings for the CIRR test server
    (reference: src/cirr_test_submission.py:34-58,115-124)."""
    sorted_names = sort_gallery(sims, index_names)
    sorted_names = drop_reference(sorted_names, reference_names)
    groups = np.asarray(group_members)
    group_mask = (sorted_names[..., None] == groups[:, None, :]).sum(-1).astype(bool)
    subset = sorted_names[group_mask].reshape(sorted_names.shape[0], -1)
    return (
        sorted_names[:, :k_global].tolist(),
        subset[:, :k_subset].tolist(),
    )
