"""Fine-tune CLI (counterpart of ``sprc_tpu/cli/finetune.py``, which mirrors
the reference ``blip_fine_tune_2.py``).

Usage:
  python -m sprc_tpu_torch.cli.finetune --dataset CIRR --data-path /data/cirr_dataset \
      --vocab-path vocab.txt --batch-size 128 --num-epochs 50 --learning-rate 1e-5 \
      [--model-type pretrain] [--cache-features] [--device cuda]

The reference recipe (blip_fine_tune_2.py:196-354): AdamW (0.9, 0.98, eps
1e-7, wd 0.05), OneCycle over 80 scheduled epochs with pct_start 1/50, loss
= itc + 0.4 rtc + 0.4 align (the variants' ``loss_itm`` and ``loss_p2p`` at
1), targetpad 1.25, per-epoch validation keeping
the best checkpoint by the selection metric (CIRR ``arithmetic_mean``,
FashionIQ ``average_recall``). The flags are the JAX CLI's, plus
``--device`` (default ``cuda``; without a GPU the command exits nonzero).
``--remat`` keeps only each tower block's and
Q-Former layer's input for the backward (``vit_remat`` and
``qformer_remat``, as in JAX; the same step bit for bit, dropout
included). On the card TF32 is off: the Q-Former trains in true fp32.

Outputs under ``--output-dir``: ``training_hyperparameters.json``, the
epoch logs (``train_metrics.csv``, ``validation_metrics.csv``,
``log.jsonl``), ``best_<metric>.pt`` in the released layout and
``last_state.pt`` (resume it with ``--resume``). With ``--cache-features``
the train split's tower rows are computed once (``feature_cache.npz``) and
every step trains from them (``forward_cached``, which every model has),
and the val gallery's tower rows are computed once too (at the first
validation, held in memory as the JAX CLI's ``_index_stream`` holds them):
each later validation runs only ``ln_vision``, the queries-only Q-Former
pass and the projection on them (``RetrievalEngine.build_index_from_tower``).

``--mesh`` (``parallel/mesh.py``) trains data-parallel, one process per
device: under ``torchrun`` each process joins the group it describes; run
alone, the CLI starts one process per visible CUDA device itself. Each rank
takes its ``batch-size / W`` rows of the global batch one device would get
(a batch size W does not divide is refused before the model is built), the
step is the global batch's (``train/loop.py``), and the validation encodes
and scores the gallery sharded (``retrieval/engine.py``). With
``--cache-features`` rank 0 builds and saves the train cache and every rank
then maps the file (the ranks share one copy in the page cache); each rank
caches its own shard of the val gallery. Rank 0 alone writes the outputs;
``--resume`` loads on every rank.

``--model-name`` takes every CIR model whose training forward returns a loss
dict (``LOSSES``): the flagship and the eight variants of
``models/cir_variants.py`` (``blip2_cir_cat``, ``_rel``,
``_z_learn_pos_align``, ``_neg``, ``_neg_rel``, ``_full``, ``_rerank``,
``_cls``). ``blip2_cir_slt`` and ``blip2_cir_prompt`` return tensors and are
refused before the model is built.

As in ``cli/validate.py``, what reads the split (JSON only:
:func:`train_triplets`) is apart from what trains:
:func:`finetune_epochs` takes the trainer and a stream of device batches
(pixels or cached rows), so a caller without Pillow feeds its own pixels.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

MAX_NONFINITE = 10  # consecutive skipped steps before the run aborts


def train_triplets(data_path, dataset: str, dress_types=()) -> List[dict]:
    """The train split's relative items, names only (JSON only)."""
    from sprc_tpu_torch.data.datasets import CIRRDataset, FashionIQDataset

    if dataset == "CIRR":
        ds = CIRRDataset(data_path, "train", "relative")
    else:
        ds = FashionIQDataset(data_path, "train", list(dress_types), "relative")
    return [ds[i] for i in range(len(ds))]


def tokenize_captions(batch: dict, tokenizer, processor, max_txt_len: int,
                      fiq_rng: Optional[np.random.RandomState] = None) -> dict:
    """A collated batch's captions -> ``{"input_ids", "text_mask"}`` (numpy).
    CIRR has one caption a triplet; FashionIQ's two are randomised 4 ways
    (reference utils.py:117-138) from ``fiq_rng``."""
    from sprc_tpu_torch.text.processors import randomize_fiq_captions

    if "caption" in batch:
        captions = [processor(c) for c in batch["caption"]]
    else:
        flat = [c for pair in batch["captions"] for c in pair]
        captions = [processor(c) for c in randomize_fiq_captions(flat, fiq_rng)]
    tok = tokenizer(captions, max_length=max_txt_len)
    return {"input_ids": tok["input_ids"], "text_mask": tok["attention_mask"]}


def to_device(batch: Dict[str, object], device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def finetune_epochs(trainer, epoch_batches: Callable[[int], Iterable[Dict[str, torch.Tensor]]], *,
                    num_epochs: int, start_epoch: int = 0,
                    validate: Optional[Callable[[], dict]] = None, validate_every: int = 1,
                    selection_metric: str = "arithmetic_mean", keeper=None, logger=None,
                    state_path: Optional[str] = None,
                    log: Callable[[str], None] = print) -> List[dict]:
    """Epochs ``start_epoch .. num_epochs - 1`` of ``trainer.train_step``
    over ``epoch_batches(epoch)``; after every ``validate_every``-th epoch
    ``validate()`` runs with the model in eval mode (and the best weights go
    to ``keeper``); the state goes to ``state_path`` after every epoch and
    before an abort on ``MAX_NONFINITE`` skipped steps in a row. Returns
    the epochs' mean metrics."""
    from sprc_tpu_torch.train.checkpoint import save_state

    model, history, consec_skips = trainer.model, [], 0
    for epoch in range(start_epoch, num_epochs):
        trainer.epoch = epoch
        model.train()
        t0 = time.perf_counter()
        running: Dict[str, float] = {}
        n_seen = 0
        for batch in epoch_batches(epoch):
            metrics = trainer.train_step(batch)
            bs = batch["input_ids"].shape[0]
            n_seen += bs
            for k, v in metrics.items():
                running[k] = running.get(k, 0.0) + v * bs
            if metrics.get("skipped_nonfinite", 0.0) > 0.0:
                consec_skips += 1
                log(f"non-finite step skipped ({consec_skips} in a row)")
                if consec_skips >= MAX_NONFINITE:
                    if state_path:
                        save_state(state_path, trainer)
                    raise RuntimeError(f"training diverged: {MAX_NONFINITE} consecutive "
                                       "non-finite steps; last-finite state saved")
            else:
                consec_skips = 0
        epoch_metrics = {k: v / max(1, n_seen) for k, v in running.items()}
        epoch_metrics.update(epoch=epoch, seconds=round(time.perf_counter() - t0, 1))
        history.append(epoch_metrics)
        if logger is not None:
            logger.log_train(epoch_metrics)
        log(json.dumps(epoch_metrics))
        if validate is not None and validate_every and (epoch + 1) % validate_every == 0:
            model.eval()
            results = validate()
            model.train()
            if logger is not None:
                logger.log_validation({**results, "epoch": epoch})
            log(json.dumps(results, indent=2))
            metric = results.get(selection_metric)
            if keeper is not None and metric is not None and keeper.maybe_save(metric, model,
                                                                                epoch):
                log(f"new best {selection_metric}={metric:.3f}")
        if state_path:
            save_state(state_path, trainer)
    return history


def _feature_cache(args, model, tfm, mesh=None):
    """Load ``--feature-cache-path`` (default ``<output-dir>/feature_cache``)
    or build it with one ``encode_tower`` pass over the train split's
    images, and save it there. Under a mesh rank 0 loads or builds it first
    and every rank then maps the file."""
    if mesh is not None:
        from sprc_tpu_torch.parallel import dist
        from sprc_tpu_torch.train.feature_cache import FeatureCache

        path = args.feature_cache_path or os.path.join(args.output_dir, "feature_cache")
        if mesh.is_main:
            _feature_cache(args, model, tfm)
        dist.barrier()
        return FeatureCache.load(path, mmap=True)
    from sprc_tpu_torch.cli.validate import index_batches
    from sprc_tpu_torch.data.datasets import CIRRDataset, FashionIQDataset
    from sprc_tpu_torch.train.feature_cache import FeatureCache, build_feature_cache

    path = args.feature_cache_path or os.path.join(args.output_dir, "feature_cache")
    if os.path.exists(path + ".npz") and os.path.exists(path + ".names.json"):
        cache = FeatureCache.load(path)
        print(f"loaded feature cache ({len(cache)} images) from {path}.npz")
        return cache
    if args.dataset == "CIRR":
        classic = CIRRDataset(args.data_path, "train", "classic", tfm)
    else:
        classic = FashionIQDataset(args.data_path, "train", args.dress_types, "classic", tfm)
    t0 = time.perf_counter()
    cache = build_feature_cache(model, index_batches(classic, args.encode_batch, args.workers))
    print(f"built feature cache: {len(cache)} images in {time.perf_counter() - t0:.1f}s")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)  # before the run's first output
    cache.save(path)
    return cache


def index_stream(model, batches, encode_batch: int, val_caches: Optional[dict], key: str):
    """The gallery's input stream (JAX's ``_index_stream``): ``batches`` of
    pixels as they are, or with ``val_caches`` (a dict; ``--cache-features``)
    that stream's tower rows, computed at the first call under ``key`` and
    streamed again in ``encode_batch`` slices from then on."""
    if val_caches is None:
        return batches
    from sprc_tpu_torch.train.feature_cache import build_feature_cache

    if key not in val_caches:
        val_caches[key] = build_feature_cache(model, batches)
    cache = val_caches[key]
    return ((cache.names[s: s + encode_batch], cache.rows[s: s + encode_batch])
            for s in range(0, len(cache), encode_batch))


def _validate_fn(args, model, tokenizer, device, mesh=None,
                 val_caches: Optional[dict] = None) -> Callable[[], dict]:
    """The per-epoch validation: the validate CLI's ``evaluate_*`` over the
    val split, through a fresh ``RetrievalEngine`` (sharded under a mesh);
    with ``val_caches`` from cached tower rows (:func:`index_stream`)."""
    from sprc_tpu_torch.cli import validate as v
    from sprc_tpu_torch.data.datasets import CIRRDataset, FashionIQDataset
    from sprc_tpu_torch.data.transforms import targetpad_transform
    from sprc_tpu_torch.retrieval.engine import RetrievalEngine

    tfm = targetpad_transform(args.target_ratio, model.cfg.image_size)

    def gallery(dataset, key):
        return index_stream(model, v.index_batches(dataset, args.encode_batch, args.workers,
                                                   mesh=mesh),
                            args.encode_batch, val_caches, key)

    def run() -> dict:
        engine = RetrievalEngine(model, tokenizer, device=device, encode_batch=args.encode_batch,
                                 query_batch=args.query_batch, mesh=mesh)
        if args.dataset == "CIRR":
            classic = CIRRDataset(args.data_path, "val", "classic", tfm)
            return v.evaluate_cirr(engine, gallery(classic, "cirr_val"),
                                   v.cirr_queries(args.data_path))

        def batches_for(dress_type):
            classic = FashionIQDataset(args.data_path, "val", [dress_type], "classic", tfm)
            return gallery(classic, f"fiq_{dress_type}")

        return v.evaluate_fiq(engine, args.dress_types, batches_for,
                              lambda dress_type: v.fiq_queries(args.data_path, dress_type))

    return run


def finetune(args) -> List[dict]:
    from sprc_tpu_torch.data.datasets import CIRRDataset, FashionIQDataset
    from sprc_tpu_torch.data.loader import DataLoader
    from sprc_tpu_torch.data.transforms import targetpad_transform
    from sprc_tpu_torch.loader import load_model
    from sprc_tpu_torch.text.processors import CaptionProcessor
    from sprc_tpu_torch.text.tokenizer import BertWordPieceTokenizer
    from sprc_tpu_torch.train.checkpoint import BestCheckpointKeeper, restore_state
    from sprc_tpu_torch.train.loop import TrainConfig, Trainer
    from sprc_tpu_torch.utils.artifacts import ensure_bert_vocab
    from sprc_tpu_torch.utils.logging import MetricsLogger

    from sprc_tpu_torch.loader import CIR_MODELS
    from sprc_tpu_torch.registry import registry

    if args.model_name not in CIR_MODELS:
        raise SystemExit(f"--model-name {args.model_name}: not a CIR model; BLIP-2 stage 1 "
                         "trains through cli/train.py (configs/runs/pretrain_stage1.yaml)")
    if not registry.get_model_class(args.model_name).LOSSES:
        raise SystemExit(f"--model-name {args.model_name}: its forward returns tensors, not "
                         "losses, so there is nothing to train (the JAX step fails on it at "
                         "losses.items()); train one of the CIR models whose forward returns "
                         "a loss dict")
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit(f"--device {args.device}: no CUDA device is available")
        torch.backends.cuda.matmul.allow_tf32 = False  # the Q-Former trains in true fp32
        torch.backends.cudnn.allow_tf32 = False
    mesh = None
    if getattr(args, "mesh", False):
        from sprc_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(device=device)
        if args.batch_size % mesh.world:
            raise SystemExit(f"--batch-size {args.batch_size} does not divide over the "
                             f"{mesh.world} ranks of --mesh")
        device = mesh.device
    main = mesh is None or mesh.is_main
    model = load_model(args.model_name, args.model_type, checkpoint_path=args.model_path,
                       device=device, seed=args.seed,
                       vit_dtype=torch.bfloat16 if args.bf16 else torch.float32,
                       vit_remat=args.remat, qformer_remat=args.remat)
    tokenizer = BertWordPieceTokenizer.from_vocab_file(ensure_bert_vocab(args.vocab_path))
    processor = CaptionProcessor()
    tfm = targetpad_transform(args.target_ratio, model.cfg.image_size)

    train_tfm = None if args.cache_features else tfm  # names only: rows come from the cache
    if args.dataset == "CIRR":
        train_ds = CIRRDataset(args.data_path, "train", "relative", train_tfm, skip_errors=True)
    else:
        train_ds = FashionIQDataset(args.data_path, "train", args.dress_types, "relative",
                                    train_tfm, skip_errors=True)
    cache = _feature_cache(args, model, tfm, mesh) if args.cache_features else None
    loader = DataLoader(train_ds, batch_size=args.batch_size, shuffle=True, drop_last=True,
                        num_workers=1 if cache is not None else args.workers, seed=args.seed,
                        rank=0 if mesh is None else mesh.rank,
                        world=1 if mesh is None else mesh.world)
    steps_per_epoch = len(loader)

    # the reference schedules OneCycle over 80 epochs whatever it trains (:261)
    tcfg = TrainConfig(learning_rate=args.learning_rate,
                       total_steps=steps_per_epoch * args.schedule_epochs,
                       loss_weights={"loss_rtc": args.loss_rtc, "loss_align": args.loss_align},
                       grad_accum_steps=args.grad_accum)
    trainer = Trainer(model, tcfg, seed=args.seed, from_embeds=cache is not None,
                      skip_nonfinite=args.skip_nonfinite, mesh=mesh)
    if args.resume and os.path.isfile(args.resume):  # every rank
        restore_state(args.resume, trainer)
        if main:
            print(f"resumed from {args.resume} at step {trainer.step}")

    os.makedirs(args.output_dir, exist_ok=True)
    if main:
        with open(os.path.join(args.output_dir, "training_hyperparameters.json"), "w") as f:
            json.dump(vars(args), f, indent=2, default=str)
    fiq_rng = np.random.RandomState(args.seed)

    def epoch_batches(epoch: int):
        loader.set_epoch(epoch)
        for batch in loader:
            out = tokenize_captions(batch, tokenizer, processor, model.cfg.max_txt_len, fiq_rng)
            if cache is not None:
                out["reference_embeds"] = cache.gather(batch["reference_name"])
                out["target_embeds"] = cache.gather(batch["target_name"])
            else:
                out["reference"] = batch["reference_image"].astype(np.float32)
                out["target"] = batch["target_image"].astype(np.float32)
            yield to_device(out, device)

    return finetune_epochs(
        trainer, epoch_batches, num_epochs=args.num_epochs,
        start_epoch=trainer.step // max(1, steps_per_epoch),
        validate=_validate_fn(args, model, tokenizer, device, mesh,
                              {} if args.cache_features else None),
        validate_every=args.validate_every, selection_metric=args.selection_metric,
        keeper=BestCheckpointKeeper(args.output_dir, args.selection_metric) if main else None,
        logger=MetricsLogger(args.output_dir) if main else None,
        state_path=os.path.join(args.output_dir, "last_state.pt"),
        log=print if main else (lambda message: None))


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dataset", required=True, choices=["CIRR", "fashionIQ"])
    p.add_argument("--data-path", required=True)
    p.add_argument("--vocab-path", default=None,
                   help="bert vocab.txt; defaults to the sprc_tpu cache (see utils/artifacts.py)")
    p.add_argument("--output-dir", default="./output")
    p.add_argument("--model-name", default="blip2_cir_align_prompt")
    p.add_argument("--model-type", default="pretrain")
    p.add_argument("--model-path", default=None,
                   help="initial weights (.pt); random from --seed without one")
    p.add_argument("--resume", default=None, help="a last_state.pt to resume")
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--num-epochs", type=int, default=50)
    p.add_argument("--schedule-epochs", type=int, default=80)
    p.add_argument("--learning-rate", type=float, default=1e-5)
    p.add_argument("--loss-rtc", type=float, default=0.4)
    p.add_argument("--loss-align", type=float, default=0.4)
    p.add_argument("--grad-accum", type=int, default=1)
    p.add_argument("--target-ratio", type=float, default=1.25)
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--bf16", action="store_true", default=True)
    p.add_argument("--no-bf16", dest="bf16", action="store_false")
    p.add_argument("--remat", action="store_true",
                   help="keep only each ViT block's and Q-Former layer's input for the backward "
                        "and recompute the rest there (fewer activations, more time)")
    p.add_argument("--cache-features", action="store_true",
                   help="compute the frozen tower's outputs once (one encode pass over the "
                        "split's unique images) and train the Q-Former from them: the same "
                        "losses as live steps for the reference recipe")
    p.add_argument("--feature-cache-path", default=None,
                   help="save/load the feature cache here (default <output-dir>/feature_cache)")
    p.add_argument("--skip-nonfinite", action="store_true", default=True,
                   help="skip the update of a step with a non-finite loss or gradient, "
                        f"aborting after {MAX_NONFINITE} in a row")
    p.add_argument("--no-skip-nonfinite", dest="skip_nonfinite", action="store_false")
    p.add_argument("--mesh", action="store_true",
                   help="data-parallel over the process group (torchrun's, or one process "
                        "per visible CUDA device started here)")
    p.add_argument("--validate-every", type=int, default=1)
    p.add_argument("--encode-batch", type=int, default=64)
    p.add_argument("--query-batch", type=int, default=32)
    p.add_argument("--selection-metric", default="arithmetic_mean")
    p.add_argument("--dress-types", nargs="+", default=["dress", "shirt", "toptee"])
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; exits nonzero without a GPU) or cpu")
    return p


def main(argv: Optional[list] = None) -> None:
    args = make_parser().parse_args(argv)
    if args.mesh:
        from sprc_tpu_torch.parallel.mesh import launch_or_join

        launch_or_join("sprc_tpu_torch.cli.finetune", sys.argv[1:] if argv is None else argv,
                       args.device)
    finetune(args)


if __name__ == "__main__":
    main()
