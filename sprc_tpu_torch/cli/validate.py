"""Checkpoint validation CLI (counterpart of ``sprc_tpu/cli/validate.py``,
which mirrors the reference ``blip_validate.py``).

Usage:
  python -m sprc_tpu_torch.cli.validate --dataset CIRR --data-path /data/cirr_dataset \
      --model-path sprc_cirr.pt --vocab-path vocab.txt [--model-type pretrain] [--device cuda]

Loads a checkpoint (torch ``.pt``; random weights from seed 0 without one),
builds the gallery index with the retrieval engine, scores all validation
queries, and prints the metric suite as JSON with the JAX CLI's keys, order
and indent. The flags and defaults are the JAX CLI's, plus ``--device``
(default ``cuda``; without a GPU the command exits nonzero).

``--mesh`` shards the gallery over the process group (``torchrun``'s, or
one process per visible CUDA device started here; ``parallel/mesh.py``):
each rank decodes and encodes its contiguous shard (:func:`index_batches`
with the mesh), the engine scores every query against every shard and
gathers the rows (``retrieval/engine.py``), the metrics are computed on
rank 0 and broadcast, and rank 0 prints the same JSON.

Each ``validate_*`` has two parts, because the machine with the card may
hold no Pillow: ``*_queries`` reads a split's relative items (JSON only) and
``evaluate_*`` takes the engine, a stream of ``(names, pixel batch)`` and
those items and returns the metric dict. Only the classic-mode stream of
``validate_*`` decodes images.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

Batches = Iterable[Tuple[Sequence[str], np.ndarray]]


# ------------------------------------------------------- --model-overrides

_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?)$")
_BOOLS = {"true": True, "false": False, "yes": True, "no": False, "on": True, "off": False}


def _yaml_scalar(text: str):
    """One plain or quoted YAML 1.1 scalar, as ``yaml.safe_load`` resolves
    it: null, booleans, integers, floats (which need a dot: ``1e-5`` is a
    string), else the string itself."""
    t = text.strip()
    if len(t) >= 2 and t[0] == t[-1] and t[0] in "'\"":
        return t[1:-1]
    if t in ("", "~", "null", "Null", "NULL"):
        return None
    if t in ("true", "True", "TRUE", "false", "False", "FALSE", "yes", "Yes", "YES", "no", "No",
             "NO", "on", "On", "ON", "off", "Off", "OFF"):
        return _BOOLS[t.lower()]
    if re.match(r"[-+]?(?:0[0-9_xXbBoO]|[0-9][0-9_]*:)", t):
        raise ValueError(f"--model-overrides value {text!r}: install PyYAML for octal, hex, "
                         "binary or sexagesimal numbers")
    if _INT.match(t):
        return int(t.replace("_", ""))
    if _FLOAT.match(t):
        return float(t.replace("_", ""))
    return t


def _yaml_value(text: str):
    """The values ``--model-overrides`` takes in this repository: a scalar or
    one inline ``{key: value, ...}`` dict of scalars."""
    t = text.strip()
    if not t.startswith("{"):
        if t[:1] in "[&*!|>%@`":
            raise ValueError(f"--model-overrides value {text!r}: install PyYAML for values "
                             "beyond scalars and inline dicts")
        return _yaml_scalar(t)
    if not t.endswith("}") or "{" in t[1:] or "[" in t:
        raise ValueError(f"--model-overrides value {text!r}: install PyYAML for nested values")
    out = {}
    for item in t[1:-1].split(","):
        if not item.strip():
            continue
        key, sep, value = item.partition(":")
        if not sep or (value and not value.startswith(" ")):
            raise ValueError(f"--model-overrides value {text!r}: expected 'key: value' in "
                             f"{item.strip()!r}")
        out[_yaml_scalar(key)] = _yaml_scalar(value)
    return out


def parse_model_overrides(pairs, use_yaml: bool = True) -> dict:
    """``key=value`` config overrides with YAML-parsed values, the
    reference's OmegaConf dotlist (common/config.py:27-41,114-126). Nested
    dataclass fields take inline-YAML dicts, e.g.
    ``'vit_config_override={width: 32, depth: 2, ...}'``. Values go through
    ``yaml.safe_load`` where PyYAML imports, else (or with ``use_yaml``
    false) through the small parser above, which a test pins to
    ``yaml.safe_load`` on the values this repository uses."""
    load = _yaml_value
    if use_yaml:
        try:
            import yaml

            load = yaml.safe_load
        except ImportError:
            pass
    out = {}
    for pair in pairs or []:
        key, sep, value = pair.partition("=")
        if not sep or not key:
            raise ValueError(f"--model-overrides entry {pair!r} is not key=value")
        out[key] = load(value)
    return out


# ------------------------------------------------------------------ engine


def build_engine(args):
    """The model and its engine; under ``--mesh`` on this rank's device, the
    engine sharded over the mesh."""
    import torch

    from sprc_tpu_torch.loader import load_model
    from sprc_tpu_torch.retrieval.engine import RetrievalEngine
    from sprc_tpu_torch.text.tokenizer import BertWordPieceTokenizer
    from sprc_tpu_torch.utils.artifacts import ensure_bert_vocab

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is available")
    mesh = None
    if getattr(args, "mesh", False):
        from sprc_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(device=device)
        device = mesh.device
    overrides = parse_model_overrides(getattr(args, "model_overrides", []))
    overrides.setdefault("vit_dtype", torch.bfloat16 if args.bf16 else torch.float32)
    model = load_model(args.model_name, args.model_type, checkpoint_path=args.model_path,
                       device=device, **overrides)
    tokenizer = BertWordPieceTokenizer.from_vocab_file(ensure_bert_vocab(args.vocab_path))
    engine = RetrievalEngine(model, tokenizer, device=device, encode_batch=args.encode_batch,
                             query_batch=args.query_batch, mesh=mesh)
    return model, engine


def index_batches(dataset, batch_size: int, num_workers: int = 4, name_key: str = "image_name",
                  mesh=None):
    """Stream (names, images) batches from a classic-mode dataset; with a
    mesh only this rank's contiguous shard of it (``mesh.shard``)."""
    from sprc_tpu_torch.data.loader import DataLoader

    if mesh is not None:
        from torch.utils.data import Subset

        dataset = Subset(dataset, mesh.shard(len(dataset)))
    loader = DataLoader(dataset, batch_size=batch_size, num_workers=num_workers)
    for batch in loader:
        yield batch[name_key], batch["image"].astype(np.float32)


def metrics_once(engine, compute: Callable[[], dict]) -> dict:
    """``compute()`` once: under the engine's mesh on rank 0, broadcast to
    every rank (so every rank keeps the same best epoch)."""
    if engine.mesh is None:
        return compute()
    from sprc_tpu_torch.parallel.dist import broadcast_from_main

    return broadcast_from_main(compute() if engine.mesh.is_main else None)


def _transform(args, model):
    from sprc_tpu_torch.data.transforms import squarepad_transform, targetpad_transform

    if args.transform == "targetpad":
        return targetpad_transform(args.target_ratio, model.cfg.image_size)
    return squarepad_transform(model.cfg.image_size)


# -------------------------------------------------------------------- CIRR


def cirr_queries(data_path) -> Dict[str, list]:
    """The CIRR val split's relative items (JSON only)."""
    from sprc_tpu_torch.data.datasets import CIRRDataset
    from sprc_tpu_torch.text.processors import CaptionProcessor

    relative = CIRRDataset(data_path, "val", "relative")
    proc = CaptionProcessor()
    out: Dict[str, list] = {"refs": [], "targets": [], "captions": [], "groups": []}
    for i in range(len(relative)):
        item = relative[i]
        out["refs"].append(item["reference_name"])
        out["targets"].append(item["target_name"])
        out["captions"].append(proc(item["caption"]))
        out["groups"].append(item["group_members"])
    return out


def evaluate_cirr(engine, batches: Batches, queries: Dict[str, list]) -> dict:
    from sprc_tpu_torch.retrieval.metrics import compute_cirr_metrics

    index = engine.build_index(batches)
    sims = engine.score_queries(index, queries["refs"], queries["captions"])
    return metrics_once(engine, lambda: compute_cirr_metrics(
        sims, index.names, queries["refs"], queries["targets"], queries["groups"]))


def validate_cirr(args) -> dict:
    from sprc_tpu_torch.data.datasets import CIRRDataset

    model, engine = build_engine(args)
    classic = CIRRDataset(args.data_path, "val", "classic", _transform(args, model))
    return evaluate_cirr(engine, index_batches(classic, args.encode_batch, args.workers,
                                               mesh=engine.mesh),
                         cirr_queries(args.data_path))


# --------------------------------------------------------------- FashionIQ


def fiq_queries(data_path, dress_type: str) -> Dict[str, list]:
    """One dress type's val relative items (JSON only), captions paired."""
    from sprc_tpu_torch.data.datasets import FashionIQDataset
    from sprc_tpu_torch.text.processors import CaptionProcessor, combine_fiq_captions

    relative = FashionIQDataset(data_path, "val", [dress_type], "relative")
    proc = CaptionProcessor()
    out: Dict[str, list] = {"refs": [], "targets": [], "captions": []}
    for i in range(len(relative)):
        item = relative[i]
        out["refs"].append(item["reference_name"])
        out["targets"].append(item["target_name"])
        out["captions"].append(proc(combine_fiq_captions(list(item["captions"]))[0]))
    return out


def evaluate_fiq(engine, dress_types: Sequence[str], batches_for: Callable[[str], Batches],
                 queries_for: Callable[[str], Dict[str, list]]) -> dict:
    from sprc_tpu_torch.retrieval.metrics import compute_fiq_metrics

    results: Dict[str, float] = {}
    recalls: List[float] = []
    for dress_type in dress_types:
        index = engine.build_index(batches_for(dress_type))
        queries = queries_for(dress_type)
        sims = engine.score_queries(index, queries["refs"], queries["captions"])
        r10, r50 = metrics_once(engine, lambda: compute_fiq_metrics(sims, index.names,
                                                                    queries["targets"]))
        results[f"{dress_type}_recall_at10"] = r10
        results[f"{dress_type}_recall_at50"] = r50
        recalls.extend([r10, r50])
    results["average_recall_at10"] = float(
        np.mean([v for k, v in results.items() if "at10" in k]))
    results["average_recall_at50"] = float(
        np.mean([v for k, v in results.items() if "at50" in k]))
    results["average_recall"] = float(np.mean(recalls))
    return results


def validate_fiq(args) -> dict:
    from sprc_tpu_torch.data.datasets import FashionIQDataset

    model, engine = build_engine(args)
    tfm = _transform(args, model)

    def batches_for(dress_type):
        classic = FashionIQDataset(args.data_path, "val", [dress_type], "classic", tfm)
        return index_batches(classic, args.encode_batch, args.workers, mesh=engine.mesh)

    return evaluate_fiq(engine, args.dress_types, batches_for,
                        lambda dress_type: fiq_queries(args.data_path, dress_type))


# ------------------------------------------------------------------- CIRCO


def circo_queries(data_path) -> Dict[str, list]:
    """The CIRCO val split's relative items (JSON only)."""
    from sprc_tpu_torch.data.datasets import CIRCODataset
    from sprc_tpu_torch.text.processors import CaptionProcessor

    relative = CIRCODataset(data_path, "val", "relative", load_images=False)
    proc = CaptionProcessor()
    out: Dict[str, list] = {"refs": [], "captions": [], "gts": []}
    for i in range(len(relative)):
        item = relative[i]
        out["refs"].append(item["reference_img_id"])
        out["captions"].append(proc(item["relative_caption"]))
        out["gts"].append(item["gt_img_ids"])
    return out


def evaluate_circo(engine, batches: Batches, queries: Dict[str, list]) -> dict:
    from sprc_tpu_torch.retrieval.metrics import compute_circo_metrics

    index = engine.build_index(batches)
    sims = engine.score_queries(index, queries["refs"], queries["captions"])
    return metrics_once(engine, lambda: compute_circo_metrics(sims, index.names, queries["gts"]))


def validate_circo(args) -> dict:
    """CIRCO val mAP@K (the eval the reference leaves unwired)."""
    from sprc_tpu_torch.data.datasets import CIRCODataset

    model, engine = build_engine(args)
    classic = CIRCODataset(args.data_path, "val", "classic", _transform(args, model))
    batches = index_batches(classic, args.encode_batch, args.workers, name_key="img_id",
                            mesh=engine.mesh)
    return evaluate_circo(engine, batches, circo_queries(args.data_path))


# --------------------------------------------------------------------- CLI


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dataset", required=True, choices=["CIRR", "fashionIQ", "CIRCO"])
    p.add_argument("--data-path", required=True)
    p.add_argument("--model-path", default=None)
    p.add_argument("--model-name", default="blip2_cir_align_prompt")
    p.add_argument("--model-type", default="pretrain")
    p.add_argument("--vocab-path", default=None,
                   help="bert vocab.txt; defaults to the sprc_tpu cache (see utils/artifacts.py)")
    p.add_argument("--transform", default="targetpad", choices=["targetpad", "squarepad"])
    p.add_argument("--target-ratio", type=float, default=1.25)
    p.add_argument("--encode-batch", type=int, default=64)
    p.add_argument("--query-batch", type=int, default=32)
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--bf16", action="store_true", default=True)
    p.add_argument("--no-bf16", dest="bf16", action="store_false")
    p.add_argument("--dress-types", nargs="+", default=["dress", "shirt", "toptee"])
    p.add_argument("--mesh", action="store_true", help="shard gallery over all devices")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; exits nonzero without a GPU) or cpu")
    p.add_argument(
        "--model-overrides", nargs="*", default=[], metavar="KEY=YAML",
        help="model-config overrides as key=value with YAML-parsed values "
             "(the reference's OmegaConf dotlist)",
    )
    return p


def join_mesh(args, module: str, argv: Optional[list]) -> bool:
    """A CLI's ``--mesh``: start the ranks where no launcher did (this
    process then exits with theirs), else go on as one; returns whether this
    process prints (rank 0, or no mesh)."""
    if not args.mesh:
        return True
    from sprc_tpu_torch.parallel import dist, mesh

    mesh.launch_or_join(module, sys.argv[1:] if argv is None else argv, args.device)
    rank = dist.get_rank() if dist.is_dist_avail_and_initialized() else int(os.environ["RANK"])
    return rank == 0


def main(argv: Optional[list] = None) -> None:
    args = make_parser().parse_args(argv)
    prints = join_mesh(args, "sprc_tpu_torch.cli.validate", argv)
    if args.dataset == "CIRR":
        results = validate_cirr(args)
    elif args.dataset == "CIRCO":
        results = validate_circo(args)
    else:
        results = validate_fiq(args)
    if prints:
        print(json.dumps(results, indent=4))


if __name__ == "__main__":
    main()
