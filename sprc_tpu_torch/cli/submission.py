"""CIRR / CIRCO test-server submission CLI (counterpart of
``sprc_tpu/cli/submission.py``, which mirrors the reference
``cirr_test_submission.py``).

Usage:
  python -m sprc_tpu_torch.cli.submission --dataset CIRR --data-path /data/cirr_dataset \\
      --model-path sprc_cirr.pt --vocab-path vocab.txt --submission-name sprc \\
      [--rerank] [--rerank-model-path rerank.pt] [--device cuda]
  python -m sprc_tpu_torch.cli.submission --dataset CIRCO --data-path /data/circo ...

``--dataset CIRR`` ranks the test1 gallery for every (reference, caption)
query and writes ``recall_submission_<name>.json`` and
``recall_subset_submission_<name>.json``; ``--dataset CIRCO`` ranks the
COCO-unlabeled gallery for the test queries and writes
``circo_submission_<name>.json`` (under the same default ``--output-dir
submission/CIRR``, as the JAX CLI does). ``--rerank`` rewrites each query's
top ``--rerank-top`` (50) in tiles of ``--rerank-step`` (50) with the
reranker of :func:`sprc_tpu_torch.cli.validate_rerank.load_rerank_model`
(without ``--rerank-model-path``, the retrieval model itself, which must then
have an ``inference_rerank``). The files are the JAX writers' (a test pins
them equal, byte for byte). The flags are the JAX CLI's, plus ``--device``
(default ``cuda``). ``--mesh`` runs stage 1 and the rerank as
``cli/validate_rerank.py`` does; rank 0 writes the files.
"""

from __future__ import annotations

from typing import Optional


def _rerank_fn(args, engine, index, refs, captions):
    """The ``rerank_fn`` that ``build_submission_dicts`` and
    ``build_circo_submission`` take, or None without ``--rerank``."""
    if not args.rerank:
        return None
    from sprc_tpu_torch.cli.validate_rerank import make_scorer
    from sprc_tpu_torch.retrieval.rerank import rerank_rankings

    scorer = make_scorer(args, engine)

    def rerank_fn(sorted_names):
        return rerank_rankings(sorted_names, refs, captions, scorer, index.reference_embeds,
                               top=args.rerank_top, step=args.rerank_step)

    return rerank_fn


def generate_submission(args) -> tuple[str, str]:
    from sprc_tpu_torch.cli.validate import build_engine, index_batches
    from sprc_tpu_torch.data.datasets import CIRRDataset
    from sprc_tpu_torch.data.transforms import targetpad_transform
    from sprc_tpu_torch.retrieval.submission import (build_submission_dicts,
                                                     write_submission_files)
    from sprc_tpu_torch.text.processors import CaptionProcessor

    model, engine = build_engine(args)
    tfm = targetpad_transform(args.target_ratio, model.cfg.image_size)
    classic = CIRRDataset(args.data_path, "test1", "classic", tfm)
    index = engine.build_index(index_batches(classic, args.encode_batch, args.workers,
                                             mesh=engine.mesh))

    relative = CIRRDataset(args.data_path, "test1", "relative")
    proc = CaptionProcessor()
    pair_ids, refs, captions, groups = [], [], [], []
    for i in range(len(relative)):
        item = relative[i]
        pair_ids.append(item["pair_id"])
        refs.append(item["reference_name"])
        captions.append(proc(item["caption"]))
        groups.append(item["group_members"])

    sims = engine.score_queries(index, refs, captions)
    predictions, group_predictions = build_submission_dicts(
        sims, index.names, refs, groups, pair_ids,
        rerank_fn=_rerank_fn(args, engine, index, refs, captions))
    if engine.mesh is not None and not engine.mesh.is_main:
        return None, None
    return write_submission_files(args.output_dir, args.submission_name, predictions,
                                  group_predictions)


def generate_circo_submission(args) -> str:
    """CIRCO test split: ``{query_id: top-50 img ids}``, the CIRCO server's
    format (the reference defines CIRCO but never wires it)."""
    from sprc_tpu_torch.cli.validate import build_engine, index_batches
    from sprc_tpu_torch.data.datasets import CIRCODataset
    from sprc_tpu_torch.data.transforms import targetpad_transform
    from sprc_tpu_torch.retrieval.submission import (build_circo_submission,
                                                     write_circo_submission)
    from sprc_tpu_torch.text.processors import CaptionProcessor

    model, engine = build_engine(args)
    tfm = targetpad_transform(args.target_ratio, model.cfg.image_size)
    classic = CIRCODataset(args.data_path, "test", "classic", tfm)
    index = engine.build_index(index_batches(classic, args.encode_batch, args.workers,
                                             name_key="img_id", mesh=engine.mesh))

    relative = CIRCODataset(args.data_path, "test", "relative", load_images=False)
    proc = CaptionProcessor()
    query_ids, refs, captions = [], [], []
    for i in range(len(relative)):
        item = relative[i]
        query_ids.append(item["query_id"])
        refs.append(item["reference_img_id"])
        captions.append(proc(item["relative_caption"]))

    sims = engine.score_queries(index, refs, captions)
    predictions = build_circo_submission(
        sims, index.names, query_ids, rerank_fn=_rerank_fn(args, engine, index, refs, captions))
    if engine.mesh is not None and not engine.mesh.is_main:
        return None
    return write_circo_submission(args.output_dir, args.submission_name, predictions)


def make_parser():
    from sprc_tpu_torch.cli.validate import make_parser as base_parser
    from sprc_tpu_torch.cli.validate_rerank import add_rerank_flags

    p = base_parser()
    p.set_defaults(dataset="CIRR")
    p.add_argument("--submission-name", required=True)
    p.add_argument("--output-dir", default="submission/CIRR")
    p.add_argument("--rerank", action="store_true")
    return add_rerank_flags(p, top=50, step=50)


def main(argv: Optional[list] = None) -> None:
    from sprc_tpu_torch.cli.validate import join_mesh

    args = make_parser().parse_args(argv)
    prints = join_mesh(args, "sprc_tpu_torch.cli.submission", argv)
    if args.dataset == "CIRCO":
        path = generate_circo_submission(args)
        if prints:
            print(f"wrote {path}")
        return
    p1, p2 = generate_submission(args)
    if prints:
        print(f"wrote {p1}\nwrote {p2}")


if __name__ == "__main__":
    main()
