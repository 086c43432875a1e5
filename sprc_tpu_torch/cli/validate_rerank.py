"""Two-stage retrieve -> rerank validation CLI (counterpart of
``sprc_tpu/cli/validate_rerank.py``, which mirrors the reference
``validate_blip_rerank.py``).

Usage:
  python -m sprc_tpu_torch.cli.validate_rerank --dataset CIRR --data-path /data/cirr_dataset \\
      --model-path sprc_cirr.pt --rerank-model-path rerank.pt --vocab-path vocab.txt \\
      [--device cuda]

Stage 1 ranks the gallery with the retrieval model (``--model-name``);
stage 2 scores each query's top ``--rerank-top`` candidates again with the
ITM reranker (``--rerank-model-name``, weights from ``--rerank-model-path``;
without that path, the retrieval model itself) in tiles of
``--rerank-step`` queries, and the metrics are computed on the rewritten
ranking. Defaults: CIRR top 200 / step 15, FashionIQ top 40 / step 40
(reference :48-71, :197-221). The CIRR val path drops the reference before
reranking. The JSON printed has the JAX CLI's keys, order and indent. The
flags are the JAX CLI's, plus ``--device`` (default ``cuda``; without a GPU
the command exits nonzero). ``--mesh`` (``cli/validate.py``'s) runs stage 1
sharded; stage 2's tiles are split over the ranks by query, each query's
rows fetched from the ranks that hold them, and the scores gathered in query
order (``retrieval/rerank.py``); rank 0 computes the metrics and prints.

As in :mod:`.validate`, each path has a part that takes the engine and a
stream of ``(names, pixel batch)`` (``evaluate_rerank_cirr`` /
``evaluate_rerank_fiq``), so that a caller without image files (or without
Pillow) drives it; the CLI streams the split's images. Both, like the JAX
CLI, load the images with ``targetpad`` whatever ``--transform`` says.
"""

from __future__ import annotations

import json
from typing import Callable, Dict, Optional, Sequence

import numpy as np

from sprc_tpu_torch.cli.validate import Batches


def _ranked_labels(sorted_names: np.ndarray, targets: Sequence[str]) -> np.ndarray:
    return sorted_names == np.asarray(targets)[:, None]


def evaluate_rerank_cirr(engine, batches: Batches, queries: Dict[str, list], scorer) -> dict:
    """CIRR val metrics of the reranked ranking: ``queries`` as
    :func:`sprc_tpu_torch.cli.validate.cirr_queries` gives them, ``scorer``
    an :class:`~sprc_tpu_torch.retrieval.rerank.ItmRerankScorer`."""
    from sprc_tpu_torch.cli.validate import metrics_once
    from sprc_tpu_torch.retrieval.metrics import drop_reference, recall_at, sort_gallery
    from sprc_tpu_torch.retrieval.rerank import rerank_rankings

    index = engine.build_index(batches)
    refs, captions = queries["refs"], queries["captions"]
    sims = engine.score_queries(index, refs, captions)
    # the val path drops the reference BEFORE reranking (validate_blip_rerank.py:189-196)
    sorted_names = drop_reference(sort_gallery(sims, index.names), refs)
    sorted_names = rerank_rankings(sorted_names, refs, captions, scorer, index.reference_embeds,
                                   top=scorer.top, step=scorer.step)

    def compute() -> dict:
        labels = _ranked_labels(sorted_names, queries["targets"])
        groups = np.asarray(queries["groups"])
        group_mask = (sorted_names[..., None] == groups[:, None, :]).sum(-1).astype(bool)
        group_labels = labels[group_mask].reshape(labels.shape[0], -1)
        return {
            "group_recall_at1": recall_at(group_labels, 1),
            "group_recall_at2": recall_at(group_labels, 2),
            "group_recall_at3": recall_at(group_labels, 3),
            "recall_at1": recall_at(labels, 1),
            "recall_at5": recall_at(labels, 5),
            "recall_at10": recall_at(labels, 10),
            "recall_at50": recall_at(labels, 50),
        }

    return metrics_once(engine, compute)


def evaluate_rerank_fiq(engine, dress_types: Sequence[str],
                        batches_for: Callable[[str], Batches],
                        queries_for: Callable[[str], Dict[str, list]], scorer) -> dict:
    """FashionIQ val recall per dress type of the reranked ranking, and their
    mean as ``average_recall`` (the JAX CLI's keys)."""
    from sprc_tpu_torch.retrieval.metrics import recall_at, sort_gallery
    from sprc_tpu_torch.retrieval.rerank import rerank_rankings

    out: Dict[str, float] = {}
    for dress_type in dress_types:
        index = engine.build_index(batches_for(dress_type))
        queries = queries_for(dress_type)
        refs, captions = queries["refs"], queries["captions"]
        sims = engine.score_queries(index, refs, captions)
        sorted_names = rerank_rankings(sort_gallery(sims, index.names), refs, captions, scorer,
                                       index.reference_embeds, top=scorer.top, step=scorer.step)
        labels = _ranked_labels(sorted_names, queries["targets"])
        out[f"{dress_type}_recall_at10"] = recall_at(labels, 10)
        out[f"{dress_type}_recall_at50"] = recall_at(labels, 50)
    out["average_recall"] = float(np.mean(list(out.values())))
    return out  # every rank reranked the same rankings


def make_scorer(args, engine):
    """The rerank stage: the reranker of :func:`load_rerank_model` over the
    engine's tokenizer."""
    from sprc_tpu_torch.retrieval.rerank import ItmRerankScorer

    return ItmRerankScorer(load_rerank_model(args, engine.model, engine.device),
                           engine.tokenizer, top=args.rerank_top, step=args.rerank_step,
                           mesh=engine.mesh)


def load_rerank_model(args, retrieval_model, device=None):
    """The rerank stage's model: ``--rerank-model-name`` with the weights of
    ``--rerank-model-path`` (on ``device``, default ``--device``), or without
    that path the retrieval model itself, as the JAX CLI's
    ``_load_rerank_model`` does (it builds the same model again from the
    same flags)."""
    import torch

    from sprc_tpu_torch.cli.validate import parse_model_overrides
    from sprc_tpu_torch.loader import load_model

    if not args.rerank_model_path:
        return retrieval_model
    overrides = parse_model_overrides(getattr(args, "model_overrides", []))
    overrides.setdefault("vit_dtype", torch.bfloat16 if args.bf16 else torch.float32)
    return load_model(args.rerank_model_name, args.model_type,
                      checkpoint_path=args.rerank_model_path,
                      device=args.device if device is None else device, **overrides)


def validate_rerank_cirr(args) -> dict:
    from sprc_tpu_torch.cli.validate import build_engine, cirr_queries, index_batches
    from sprc_tpu_torch.data.datasets import CIRRDataset
    from sprc_tpu_torch.data.transforms import targetpad_transform

    model, engine = build_engine(args)
    classic = CIRRDataset(args.data_path, "val", "classic",
                          targetpad_transform(args.target_ratio, model.cfg.image_size))
    return evaluate_rerank_cirr(engine, index_batches(classic, args.encode_batch, args.workers,
                                                      mesh=engine.mesh),
                                cirr_queries(args.data_path), make_scorer(args, engine))


def validate_rerank_fiq(args) -> dict:
    from sprc_tpu_torch.cli.validate import build_engine, fiq_queries, index_batches
    from sprc_tpu_torch.data.datasets import FashionIQDataset
    from sprc_tpu_torch.data.transforms import targetpad_transform

    model, engine = build_engine(args)
    tfm = targetpad_transform(args.target_ratio, model.cfg.image_size)
    scorer = make_scorer(args, engine)

    def batches_for(dress_type):
        classic = FashionIQDataset(args.data_path, "val", [dress_type], "classic", tfm)
        return index_batches(classic, args.encode_batch, args.workers, mesh=engine.mesh)

    return evaluate_rerank_fiq(engine, args.dress_types, batches_for,
                               lambda dress_type: fiq_queries(args.data_path, dress_type), scorer)


def add_rerank_flags(p, top=None, step=None):
    p.add_argument("--rerank-model-name", default="blip2_cir_rerank")
    p.add_argument("--rerank-model-path", default=None)
    p.add_argument("--rerank-top", type=int, default=top)
    p.add_argument("--rerank-step", type=int, default=step)
    return p


def make_parser():
    from sprc_tpu_torch.cli.validate import make_parser as base_parser

    # reference defaults: CIRR top 200 / step 15 (:199-200); FashionIQ 40 / 40 (:50-51)
    return add_rerank_flags(base_parser())


def parse_args(argv: Optional[list] = None):
    args = make_parser().parse_args(argv)
    if args.rerank_top is None:
        args.rerank_top = 200 if args.dataset == "CIRR" else 40
    if args.rerank_step is None:
        args.rerank_step = 15 if args.dataset == "CIRR" else 40
    return args


def main(argv: Optional[list] = None) -> None:
    from sprc_tpu_torch.cli.validate import join_mesh

    args = parse_args(argv)
    prints = join_mesh(args, "sprc_tpu_torch.cli.validate_rerank", argv)
    if args.dataset == "CIRR":
        results = validate_rerank_cirr(args)
    else:
        results = validate_rerank_fiq(args)
    if prints:
        print(json.dumps(results, indent=4))


if __name__ == "__main__":
    main()
