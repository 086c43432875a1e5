"""A dry run of every sharded path at tiny widths over W processes (the
port's counterpart of ``__graft_entry__.py:289-428``, ``_dryrun_impl``).

    python -m sprc_tpu_torch.parallel.dryrun --world 2 --device cpu    # gloo
    python -m sprc_tpu_torch.parallel.dryrun --world 1 --device cuda   # NCCL, a process a card

Each rank runs, on its part of the work: a live and a cached train step of
the flagship over a global batch of ``2 W`` rows; the gallery sharded with
``n = 2 W + 1`` images (so that the padding is forced) and every query
scored against it; and a rerank tile of ``W + 1`` queries, each with ``W +
1`` candidates, split over the ranks. Rank 0 runs the same work on one
device in its own process and holds the ranks' results against it (the
losses within 1e-5 relative, the updated tensors within 1e-6, the scores
within 1e-5, the top-k indices equal). The command prints rank 0's summary
(with the K1, K2 and K3 launches of its sharded work: on the CPU the plain
versions run and nothing launches) as JSON and exits nonzero if a rank
fails or a result disagrees.

The case functions take the mesh first (None: one device, the whole batch),
so that :func:`~sprc_tpu_torch.parallel.mesh.spawn` runs them on each rank,
and a model spec: ``{"name", "overrides", "state" (a state dict), or
"checkpoint" (a file), or neither for the random weights of "seed"}``. The
tests run them against JAX's mesh step and mesh engine.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import zlib
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

IMG, Q, TXT, VOCAB, EMBED, WIDTH = 28, 4, 8, 60, 64, 128
TOLERANCE = {"loss": 1e-5, "param": 1e-6, "score": 1e-5}


def tiny_overrides(dropout: float = 0.0, vit_dtype=torch.float32) -> dict:
    """``load_model`` overrides of a tiny EVA-layout CIR model (ViT width
    128, depth 2, 2 heads on 28 px; Q-Former hidden 128, 2 layers, Q 4; text
    8, vocabulary 60, embed 64): the tests' model."""
    from sprc_tpu_torch.models.qformer import QFormerConfig
    from sprc_tpu_torch.models.vit import ViTConfig

    return dict(image_size=IMG, num_query_token=Q, max_txt_len=TXT, vocab_size=VOCAB,
                embed_dim=EMBED, vit_dtype=vit_dtype,
                vit_config_override=ViTConfig(image_size=IMG, patch_size=14, width=WIDTH,
                                              depth=2, num_heads=2, mlp_hidden=256,
                                              qkv_fused_no_kbias=True, dtype=vit_dtype),
                qformer_config_override=QFormerConfig(
                    vocab_size=VOCAB, hidden_size=WIDTH, num_layers=2, num_heads=2,
                    intermediate_size=256, encoder_width=WIDTH, query_length=Q,
                    dropout_rate=dropout))


def build(spec: dict, device) -> torch.nn.Module:
    """The spec's model on ``device``, in eval mode (``model_type`` default
    ``pretrain``; weights from ``state``, a ``checkpoint`` file, or ``seed``)."""
    from sprc_tpu_torch.loader import build_model, load_model

    kind = spec.get("model_type", "pretrain")
    if spec.get("state") is None:
        return load_model(spec["name"], kind, spec.get("checkpoint"), device=device,
                          seed=spec.get("seed", 0), **spec["overrides"])
    model = build_model(spec["name"], kind, device=device, **spec["overrides"])
    model.load_state_dict(spec["state"], strict=True)
    return model.eval()


class WordTokenizer:
    """Words to ids by CRC-32 (the same in every process), ``[CLS]`` 1 first,
    padded with 0 to ``max_length``: the engine's tokenizer interface."""

    def __init__(self, vocab: int = VOCAB):
        self.vocab = vocab

    def __call__(self, texts: Sequence[str], max_length: int) -> Dict[str, np.ndarray]:
        ids = np.zeros((len(texts), max_length), np.int32)
        mask = np.zeros((len(texts), max_length), np.int32)
        for i, text in enumerate(texts):
            row = [1] + [2 + zlib.crc32(w.encode()) % (self.vocab - 2) for w in text.split()]
            row = row[:max_length]
            ids[i, :len(row)], mask[i, :len(row)] = row, 1
        return {"input_ids": ids, "attention_mask": mask}


def _device(mesh, device):
    return mesh.device if mesh is not None else torch.device(device or "cpu")


# ------------------------------------------------------------------ cases


def train_case(mesh, spec: dict, batches: Sequence[Dict[str, np.ndarray]], *,
               from_embeds: bool = False, grad_accum: int = 1, skip_nonfinite: bool = False,
               poison: Optional[tuple] = None, seed: int = 0, device=None) -> dict:
    """One step a global batch (numpy, every rank the same) through the
    Trainer on this rank's rows. ``poison``: (step, rank) whose reference
    side turns NaN. Returns the metrics of each step and the trainable
    tensors after the last."""
    from sprc_tpu_torch.parallel.mesh import shard_batch
    from sprc_tpu_torch.train.loop import TrainConfig, Trainer

    dev = _device(mesh, device)
    model = build(spec, dev)
    trainer = Trainer(model, TrainConfig(total_steps=100, grad_accum_steps=grad_accum), seed=seed,
                      from_embeds=from_embeds, skip_nonfinite=skip_nonfinite, mesh=mesh)
    metrics = []
    for step, batch in enumerate(batches):
        local = shard_batch(mesh, batch) if mesh is not None else batch
        local = {k: torch.as_tensor(np.ascontiguousarray(v), device=dev) for k, v in local.items()}
        if poison == (step, 0 if mesh is None else mesh.rank):
            key = "reference_embeds" if from_embeds else "reference"
            local[key] = torch.full_like(local[key], float("nan"))
        metrics.append(trainer.train_step(local))
    values = trainer.param_values()
    return {"metrics": metrics, "updates": trainer.updates,
            "params": {n: values[n].detach().float().cpu().numpy() for n in trainer.names}}


def variants_case(mesh, names: Sequence[str], overrides: dict, batch, seed: int = 0) -> dict:
    """:func:`train_case` for each model of ``names`` (random weights from
    ``seed``), one step on ``batch``."""
    return {name: train_case(mesh, {"name": name, "overrides": overrides, "seed": seed}, [batch])
            for name in names}


def _engine(mesh, spec, device, encode_batch, query_batch):
    from sprc_tpu_torch.retrieval.engine import RetrievalEngine

    dev = _device(mesh, device)
    model = build(spec, dev)
    return RetrievalEngine(model, WordTokenizer(), device=dev, encode_batch=encode_batch,
                           query_batch=query_batch, mesh=mesh)


def _shard_batches(mesh, names, images, size):
    part = range(len(names)) if mesh is None else mesh.shard(len(names))
    return [(list(names[s: min(s + size, part.stop)]), images[s: min(s + size, part.stop)])
            for s in range(part.start, part.stop, size)]


def gallery_case(mesh, spec: dict, images: np.ndarray, names: Sequence[str],
                 refs: Sequence[str], captions: Sequence[str], *, k: int = 3,
                 encode_batch: int = 2, query_batch: int = 3, save_path: Optional[str] = None,
                 device=None) -> dict:
    """The gallery encoded on this rank's shard and every query scored
    against it: the [B, n] sims, the top-k, the index's padded row count;
    with ``save_path`` the index saved (rank 0 writes) and loaded again, and
    the loaded index's sims."""
    engine = _engine(mesh, spec, device, encode_batch, query_batch)
    index = engine.build_index(_shard_batches(mesh, names, images, encode_batch))
    sims = engine.score_queries(index, refs, captions)
    vals, idx = engine.topk(index, torch.as_tensor(sims), k)
    out = {"sims": sims, "top_vals": vals, "top_idx": idx, "rows": index.target_feats.shape[0],
           "n": index.n, "names": index.names,
           "refs": index.reference_embeds(refs).float().cpu().numpy()}
    if save_path is not None:
        index.save(save_path)
        loaded = engine.load_index(save_path)
        out["loaded_sims"] = engine.score_queries(loaded, refs, captions)
    return out


def rerank_case(mesh, spec: dict, images: np.ndarray, names: Sequence[str],
                refs: Sequence[str], captions: Sequence[str], candidates: Sequence[Sequence[str]],
                *, encode_batch: int = 2, device=None) -> np.ndarray:
    """One rerank tile (every query with its candidates) through
    ``ItmRerankScorer``: over a mesh split over the ranks by query, the rows
    fetched from the ranks that hold them."""
    from sprc_tpu_torch.retrieval.rerank import ItmRerankScorer

    engine = _engine(mesh, spec, device, encode_batch, 4)
    index = engine.build_index(_shard_batches(mesh, names, images, encode_batch))
    top = len(candidates[0])
    scorer = ItmRerankScorer(engine.model, engine.tokenizer, top=top, step=len(refs), mesh=mesh)
    flat = [c for row in candidates for c in row]
    return scorer(index.reference_embeds(refs), index.reference_embeds(flat), captions)


def service_case(mesh, spec: dict, images: np.ndarray, names: Sequence[str],
                 requests: Sequence[Sequence[tuple]], *, k: int = 3, device=None):
    """``RetrievalService.query`` for each request: rank 0 asks, the other
    ranks follow; returns rank 0's answers (None elsewhere)."""
    from sprc_tpu_torch.cli.serve import RetrievalService

    engine = _engine(mesh, spec, device, 2, 3)
    service = RetrievalService(engine, engine.build_index(
        _shard_batches(mesh, names, images, 2)))
    if mesh is not None and not mesh.is_main:
        service.follow()
        return None
    answers = [service.query(list(pairs), k=k) for pairs in requests]
    service.stop()
    return answers


def post(port: int, body: bytes):
    """(status, parsed JSON body) of one ``POST /query`` on localhost."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}/query", data=body,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def http_case(mesh, spec: dict, images: np.ndarray, names: Sequence[str],
              bodies: Sequence[bytes], *, device=None):
    """``cli/serve.py``'s HTTP front end over a service without a rerank
    stage: rank 0 serves and posts each body in order, the other ranks
    follow; returns rank 0's ``[(status, body)]`` (None elsewhere)."""
    import threading

    from sprc_tpu_torch.cli.serve import RetrievalService, make_server

    engine = _engine(mesh, spec, device, 2, 3)
    service = RetrievalService(engine, engine.build_index(
        _shard_batches(mesh, names, images, 2)))
    if mesh is not None and not mesh.is_main:
        service.follow()
        return None
    server = make_server(service, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        return [post(server.server_address[1], body) for body in bodies]
    finally:
        server.shutdown()
        thread.join(timeout=30)
        server.server_close()
        service.stop()


def cli_case(mesh, module: str, argv: Sequence[str]) -> str:
    """``module.main(argv)`` on this rank; its standard output."""
    import importlib

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        importlib.import_module(module).main(list(argv))
    return out.getvalue()


def resume_case(mesh, spec: dict, batch, path: str, seed: int = 0) -> dict:
    """Two steps with dropout, the state saved after the first (rank 0
    writes), a new trainer restored from it on every rank: each rank's
    dropout generator state after the save and after the restore, and both
    runs' second-step losses."""
    from sprc_tpu_torch.parallel.mesh import shard_batch
    from sprc_tpu_torch.train.checkpoint import restore_state, save_state
    from sprc_tpu_torch.train.loop import TrainConfig, Trainer

    dev = _device(mesh, None)
    local = shard_batch(mesh, batch) if mesh is not None else batch
    local = {k: torch.as_tensor(np.ascontiguousarray(v), device=dev) for k, v in local.items()}
    trainer = Trainer(build(spec, dev), TrainConfig(total_steps=100), seed=seed, mesh=mesh)
    trainer.train_step(local)
    save_state(path, trainer)
    if mesh is not None:
        torch.distributed.barrier()
    saved = trainer.generator.get_state().clone()
    again = Trainer(build(spec, dev), TrainConfig(total_steps=100), seed=seed + 1, mesh=mesh)
    restore_state(path, again)
    return {"saved": saved, "restored": again.generator.get_state().clone(),
            "next": trainer.train_step(local)["loss"],
            "next_restored": again.train_step(local)["loss"]}


def validation_case(mesh, args: dict, spec: dict, vocab_path: str, epochs: int = 2) -> dict:
    """The fine-tune CLI's per-epoch validation (``cli/finetune.py``): live
    once, then ``epochs`` times with the validation cache (the first builds
    it), on this rank's shard under a mesh; the metric dicts and the tower
    calls of each cached epoch."""
    from argparse import Namespace

    from sprc_tpu_torch.cli import finetune
    from sprc_tpu_torch.text.tokenizer import BertWordPieceTokenizer

    dev = _device(mesh, None)
    model = build(spec, dev)
    tokenizer = BertWordPieceTokenizer.from_vocab_file(vocab_path)
    ns = Namespace(**args)
    out = {"live": finetune._validate_fn(ns, model, tokenizer, dev, mesh)(), "cached": [],
           "tower_calls": []}
    caches: dict = {}
    run = finetune._validate_fn(ns, model, tokenizer, dev, mesh, caches)
    inner = model.encode_tower
    calls = []
    model.encode_tower = lambda images: calls.append(len(images)) or inner(images)
    try:
        for _ in range(epochs):
            calls.clear()
            out["cached"].append(run())
            out["tower_calls"].append(len(calls))
    finally:
        del model.encode_tower
    out["cached_rows"] = {k: len(c) for k, c in caches.items()}
    return out


def finetune_cli_case(mesh, argv: Sequence[str], overrides: dict) -> str:
    """``cli/finetune.py``'s ``main(argv)`` on this rank with every model it
    loads built with ``overrides`` over its own arguments (a tiny width);
    its standard output."""
    from sprc_tpu_torch import loader

    inner = loader.load_model
    loader.load_model = lambda *a, **kw: inner(*a, **{**kw, **overrides})
    try:
        return cli_case(mesh, "sprc_tpu_torch.cli.finetune", argv)
    finally:
        loader.load_model = inner


def run_cases(mesh, cases: Sequence[tuple]) -> list:
    """Each ``(case name of this module, args, kwargs)`` on this rank, in
    order: one spawn for many cases."""
    return [globals()[name](mesh, *args, **kwargs) for name, args, kwargs in cases]


# ---------------------------------------------------------------- the run


def sample_inputs(world: int, seed: int = 0) -> dict:
    """The dry run's seeded inputs: a global batch of ``2 W`` pairs, a
    gallery of ``2 W + 1`` images with a query each, a tile of ``W + 1``
    queries with ``W + 1`` candidates each."""
    rng = np.random.RandomState(seed)
    b, n = 2 * world, 2 * world + 1
    mask = np.ones((b, TXT), np.int32)
    mask[0, -3:] = 0
    batch = {"reference": rng.rand(b, IMG, IMG, 3).astype(np.float32),
             "target": rng.rand(b, IMG, IMG, 3).astype(np.float32),
             "input_ids": rng.randint(1, VOCAB, (b, TXT)).astype(np.int32), "text_mask": mask}
    names = [f"img{i}" for i in range(n)]
    words = ["red", "dress", "with", "long", "sleeves", "blue", "shirt", "dog"]
    captions = [" ".join(rng.choice(words, rng.randint(2, 6))) for _ in range(n)]
    refs = [names[j] for j in rng.randint(0, n, n)]
    cands = [[names[j] for j in rng.choice(n, world + 1, replace=False)]
             for _ in range(world + 1)]
    return {"batch": batch, "images": rng.rand(n, IMG, IMG, 3).astype(np.float32),
            "names": names, "refs": refs, "captions": captions, "candidates": cands}


def _tower_rows(spec, device, batch) -> dict:
    """``batch`` with the tower's rows in place of its pixels (the cache)."""
    model = build(spec, device)
    with torch.no_grad():
        rows = {side: model.encode_tower(torch.as_tensor(batch[side], device=device))
                .float().cpu().numpy() for side in ("reference", "target")}
    return {"reference_embeds": rows["reference"], "target_embeds": rows["target"],
            "input_ids": batch["input_ids"], "text_mask": batch["text_mask"]}


def _check(what: str, ok: bool, detail) -> None:
    if not ok:
        raise RuntimeError(f"dry run: {what} disagrees with one device: {detail}")


def _same_step(what, got, want) -> dict:
    loss = max(abs(g["loss"] - w["loss"]) / max(abs(w["loss"]), 1e-12)
               for g, w in zip(got["metrics"], want["metrics"]))
    param = max(float(np.abs(got["params"][n] - want["params"][n]).max()) for n in want["params"])
    _check(f"{what} step", loss <= TOLERANCE["loss"] and param <= TOLERANCE["param"],
           {"loss": loss, "param": param})
    return {"loss_rel": loss, "param_max_abs": param}


def _dryrun(mesh, seed: int = 0) -> dict:
    from sprc_tpu_torch.ops.fused_block import fused_vit_block
    from sprc_tpu_torch.ops.fused_qformer import fused_qformer_layer
    from sprc_tpu_torch.ops.sim_kernels import token_max_sim

    kernels = {"token_max_sim": token_max_sim, "fused_vit_block": fused_vit_block,
               "fused_qformer_layer": fused_qformer_layer}
    before = {k: fn.launches for k, fn in kernels.items()}
    world, dev = mesh.world, mesh.device
    spec = {"name": "blip2_cir_align_prompt", "overrides": tiny_overrides(), "seed": seed}
    rerank = {"name": "blip2_cir_rerank", "overrides": tiny_overrides(), "seed": seed}
    data = sample_inputs(world, seed)
    cached = _tower_rows(spec, dev, data["batch"])
    live = train_case(mesh, spec, [data["batch"]])
    cache = train_case(mesh, spec, [cached], from_embeds=True)
    gallery = gallery_case(mesh, spec, data["images"], data["names"], data["refs"],
                           data["captions"])
    tile = rerank_case(mesh, rerank, data["images"], data["names"], data["refs"][: world + 1],
                       data["captions"][: world + 1], data["candidates"])
    summary = {"world": world, "backend": mesh.backend, "device": str(dev),
               "launches": {k: fn.launches - before[k] for k, fn in kernels.items()}}
    if mesh.is_main:  # the same work on one device, in this process
        summary["live"] = _same_step("live", live,
                                     train_case(None, spec, [data["batch"]], device=dev))
        summary["cached"] = _same_step("cached", cache, train_case(
            None, spec, [cached], from_embeds=True, device=dev))
        one = gallery_case(None, spec, data["images"], data["names"], data["refs"],
                           data["captions"], device=dev)
        err = float(np.abs(gallery["sims"] - one["sims"]).max())
        _check("gallery", err <= TOLERANCE["score"] and np.array_equal(
            gallery["top_idx"], one["top_idx"]), {"sims": err})
        summary["gallery"] = {"n": gallery["n"], "rows_a_rank": gallery["rows"],
                              "padding": world * gallery["rows"] - gallery["n"],
                              "sims_max_abs": err}
        want = rerank_case(None, rerank, data["images"], data["names"],
                           data["refs"][: world + 1], data["captions"][: world + 1],
                           data["candidates"], device=dev)
        err = float(np.abs(tile - want).max())
        _check("rerank tile", err <= TOLERANCE["score"], {"scores": err})
        summary["rerank"] = {"queries": world + 1, "candidates": world + 1,
                             "scores_max_abs": err}
    return summary


def main(argv: Optional[List[str]] = None) -> None:
    from sprc_tpu_torch.parallel.mesh import spawn

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--world", type=int, default=2)
    p.add_argument("--device", choices=["cpu", "cuda"], default="cpu")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("--device cuda: no CUDA device is available")
        if args.world > torch.cuda.device_count():
            raise SystemExit(f"--world {args.world}: {torch.cuda.device_count()} CUDA devices "
                             "(one process a card)")
    summary = spawn(_dryrun, args.world, args.seed, device=args.device)[0]
    print(json.dumps(summary))


if __name__ == "__main__":
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    main(sys.argv[1:])
