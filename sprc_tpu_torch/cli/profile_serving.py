"""Where the serving path's time goes on one GPU.

    python -m sprc_tpu_torch.cli.profile_serving [--model-type pretrain|pretrain_vitL]
        [--fused-block block|attn|none] [--fused-mlp] [--int8] [--gallery N]
        [--train [--model-name NAME ...]]
        [--rerank [--rerank-top N --rerank-step N]] [--out DIR]

Builds ``blip2_cir_align_prompt`` / ``--model-type`` (``pretrain_vitL``: CLIP
ViT-L, the default; ``pretrain``: EVA ViT-g) at full width with random
weights from seed 0, the tower on the route that ``--fused-block`` and
``--fused-mlp`` name (``ViTConfig.fused_block`` / ``fused_mlp``; the default
is the whole-block kernel), and takes one encode batch (64 images, 224 px,
as the engine's ``encode_batch``) and one query batch (32 composed queries,
the engine's ``query_batch``, scored against ``--gallery`` random unit
target features, 512 by default; 123,403 is CIRCO's gallery). For each it
reports:

- wall ms (CUDA-synchronised, median of 5 runs) of the kernel path
  and of the all-plain path (``primitives.plain_reference``), and for the
  encode the split into the ViT tower (with ``ln_vision``) and the Q-Former
  queries pass (with ``vision_proj``);
- from one ``torch.profiler`` run of the kernel path: device time by kernel
  group, the device busy share (device time over the profiled wall time; one
  stream, so the times do not overlap), the encode's images per second (the
  batch over its median wall time), the bf16 GEMM rate of the tower (its
  dense FLOPs, 2 R (4 W^2 + 2 W M) per block with R = batch x 257 rows and M
  the MLP width, over the bf16 GEMM time) and the fp32 GEMM rate of the
  queries pass (its dense FLOPs over the fp32 GEMM time), and the query
  batch's share of device time in K1 (``token_max_sim_share``).

``encode.feed`` takes the engine over a 512-image gallery (8 batches of 64):
``RetrievalEngine.build_index`` over seeded fp32 pixel batches and
``build_index_raw`` over seeded uint8 batches in a 320 x 320 buffer (true
sizes mixed: ``utils.artifacts.synthetic_raw_batches``), each against the
model alone on the same batches already on the card (for raw, with
``device_preprocess`` before it), medians of 3 wall times; the engine's
host seconds by stage of the median run (``RetrievalEngine.feed_seconds``);
``device_preprocess``'s device ms on one batch (CUDA events over 10 calls);
and the native decoder's rate, ``NativeTransform.batch`` over the committed
JPEG fixtures and seeded PNGs (imgs/s, threads), or why it could not run.
The frozen embeds come back in bf16 for ``pretrain_vitL`` (the serve CLI's)
and in fp32 for ``pretrain`` (the validate CLI's).

With ``--int8`` the model is the int8 serving configuration (the tower's
activation scales calibrated on 16 seeded images, ``vit_quant="int8_static"``,
``qformer_int8=True``); the tower's rate is then its dense integer
operations over the int8 GEMM time. ``other_kernels`` lists every device
kernel that is not one of the port's own, with its launches and time: the
patch convolution and the ``vision_proj`` / ``text_proj`` products are
PyTorch calls, and no other library GEMM may appear there.

With ``--train`` it profiles the fine-tune step instead (``--model-type``,
bf16 tower and fp32 Q-Former, batch 128, the CLI's trainer) of each
``--model-name`` (default the flagship; several names give one result per
model, their traces under ``--out/<name>``): the wall ms of a live step
(pixels; the tower's K2 chain, then the Q-Former's forward and backward) and
of a cached step (tower rows, ``forward_cached``), medians of 5 steps, their
samples/s and peak memory, and from one profiled step of each the device
time by kernel group; the Q-Former's products in training are library GEMMs
(``torch.matmul``), grouped as such, and ``qformer_product_ms`` adds the
fp32 GEMMs of K3 in the no-grad passes of ``blip2_cir_rerank`` and
``blip2_cir_cls``. A BLIP-2 stage-1 name (``--model-name blip2
--model-type pretrain``) profiles the live step of ``cli/train.py``'s
trainer instead (``train/generic.py::GenericTrainer``, the frozen tower
decayed) at pretraining's batch of 100: ITC, hard-negative ITM, LM.

With ``--rerank`` it profiles one tile of the ITM rerank instead, on
``blip2_cir_rerank`` / ``--model-type`` (random weights from seed 0; with
``--int8`` the int8 Q-Former, the tower as it is: the tile runs no tower):
``--rerank-step`` queries times their ``--rerank-top`` candidates (default
15 x 50, bench.py's tile; a CIRR validation tile is 15 x 200), each query's
32 learned queries and 32-token caption cross-attending the [reference;
candidate] memory of 2 x 257 rows. The gallery is 64 seeded images encoded
by the model, its frozen rows on the host as the CLIs keep them (bf16 for
``pretrain_vitL``, the serve CLI's; fp32 for ``pretrain``, the validate
CLI's), and the tile goes through ``rerank_rankings`` and
``ItmRerankScorer`` as serving and validate_rerank run it: the candidates'
rows gathered on the host, uploaded, the references and captions repeated on
the card, ``inference_rerank``. It reports the tile's wall ms (median of 5)
and candidates/s, the host seconds by stage (gather, tokenise, upload, the
model with the scores' readback), the all-plain tile's wall ms, the peak
device memory, and from one profiled tile the device time by kernel group,
the busy share, the launches and the fp32 (or int8) GEMM rate over the
tile's dense operations (:func:`rerank_dense_ops`).

It prints one JSON object and writes it, the profiler's tables and chrome
traces under ``--out`` (default ``sprc_tpu_torch/_build/profile`` with the
options appended). Needs CUDA.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np
import torch

SEED, ENCODE_BATCH, QUERY_BATCH, GALLERY, REPEATS = 0, 64, 32, 512, 5
GROUPS = (("gemm_i8_kernel", "int8 GEMM"), ("quantize_static", "quantize static"),
          ("quantize_rows", "quantize rows"),
          ("gemm_bf16_kernel", "bf16 GEMM"), ("gemm_f32_kernel", "fp32 GEMM"),
          ("attention_bf16", "bf16 attention"), ("attention_f32", "fp32 attention"),
          ("layernorm", "LayerNorm"), ("token_max_sim", "token-max sim"),
          ("Memcpy", "copies"), ("Memset", "copies"))


# the fine-tune step's library products (the Q-Former trains through torch.matmul)
TRAIN_GROUPS = GROUPS + (("gemm", "library GEMM"), ("cutlass", "library GEMM"),
                         ("xmma", "library GEMM"))


def _group(name: str, groups=GROUPS) -> str:
    for key, label in groups:
        if key in name:
            return label
    return "other (torch ops)"


def _wall_ms(fn) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def _profile(fn, name: str, out: str, kinds=GROUPS) -> dict:
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups, launches, others = {}, {}, {}
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA or getattr(
                evt, "is_user_annotation", False):  # a range over kernels, not a kernel
            continue
        label = _group(evt.name, kinds)
        ms = evt.time_range.elapsed_us() / 1e3
        groups[label] = groups.get(label, 0.0) + ms
        launches[label] = launches.get(label, 0) + 1
        if label == "other (torch ops)":
            n, t = others.get(evt.name[:80], (0, 0.0))
            others[evt.name[:80]] = (n + 1, t + ms)
    device_ms = sum(groups.values())
    prof.export_chrome_trace(os.path.join(out, f"{name}_trace.json"))
    with open(os.path.join(out, f"{name}_table.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=40))
    return {"profiled_wall_ms": wall_ms, "device_ms": device_ms,
            "device_busy_share": device_ms / wall_ms,
            "device_ms_by_group": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
            "launches_by_group": launches,
            "other_kernels": {k: {"launches": n, "ms": t} for k, (n, t) in
                              sorted(others.items(), key=lambda kv: -kv[1][1])}}


FEED_GALLERY, FEED_REPEATS, RAW_BUFFER = 512, 3, 320


def _median_run(fn, repeats=FEED_REPEATS):
    """(median wall ms, the result of the median run) of ``fn()`` after one
    warm-up call, each run ended by a synchronize."""
    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        runs.append(((time.perf_counter() - t0) * 1e3, res))
    runs.sort(key=lambda r: r[0])
    return runs[len(runs) // 2]


def decode_rate() -> dict:
    """``NativeTransform.batch`` over the JPEG fixtures and seeded PNGs
    (256 inputs, ``dim`` 224), with every core and with one thread."""
    import glob
    from pathlib import Path

    from sprc_tpu_torch.data.native import NativeTransform
    from sprc_tpu_torch.utils.artifacts import encode_png

    root = os.path.join(os.path.dirname(__file__), "..", "..", "tests", "fixtures", "dataplane")
    try:
        tfm = NativeTransform(dim=224)
    except (RuntimeError, OSError) as e:  # no compiler, headers or libraries here
        lines = str(e).strip().splitlines()
        first = next((line for line in lines if "error" in line), lines[-1])
        return {"error": f"{type(e).__name__}: {first.strip()[:300]}"}
    rng = np.random.default_rng(SEED + 7)
    blobs = [Path(p).read_bytes() for p in sorted(glob.glob(os.path.join(root, "*.jpg")))]
    blobs += [encode_png(rng.integers(0, 256, (int(h), int(w), 3), dtype=np.uint8))
              for h, w in rng.integers(200, 500, (8, 2))]
    sources = [blobs[i % len(blobs)] for i in range(256)]
    result = {"inputs": len(sources), "distinct": len(blobs)}
    for threads in (tfm.num_threads, 1):
        tfm.num_threads = threads
        tfm.batch(sources[:16])
        t0 = time.perf_counter()
        _, ok = tfm.batch(sources)
        dt = time.perf_counter() - t0
        if not ok.all():
            raise RuntimeError(f"decode failed for {int((~ok).sum())} inputs")
        result[f"imgs_per_s_{threads}_threads"] = len(sources) / dt
    return result


def model_alone(model, batches, frozen_dtype, encode, fills=(0,), dev: str = "cuda"):
    """The engine's device work on ``batches`` (``(names, *arrays)``)
    without its feed: each array padded to ``ENCODE_BATCH`` with ``fills``
    and put on the device once; the returned function encodes them all
    (``encode(*tensors)``) and casts the frozen embeds as the engine does."""
    on_card = []
    for _, *arrays in batches:
        tensors = []
        for a, fill in zip(arrays, fills):
            t = torch.from_numpy(a).to(dev)
            pad = ENCODE_BATCH - t.shape[0]
            tensors.append(torch.cat([t, torch.full((pad,) + t.shape[1:], fill, dtype=t.dtype,
                                                    device=dev)]) if pad else t)
        on_card.append(tensors)

    def run():
        for tensors in on_card:
            _, frozen = encode(*tensors)
            if frozen_dtype is not None:
                frozen.to(frozen_dtype)
    return run


def profile_feed(model, dev: str) -> dict:
    """``encode.feed``: the engine's encode over a 512-image gallery against
    the model alone, by stage (the module docstring)."""
    from sprc_tpu_torch.data.transforms import device_preprocess
    from sprc_tpu_torch.retrieval.engine import RetrievalEngine
    from sprc_tpu_torch.utils.artifacts import synthetic_raw_batches

    cfg = model.cfg
    frozen_dtype = torch.bfloat16 if cfg.vit_config().width == 1024 else None
    engine = RetrievalEngine(model, device=dev, encode_batch=ENCODE_BATCH,
                             frozen_host_dtype=frozen_dtype)
    rng = np.random.default_rng(SEED + 100)
    size = cfg.image_size
    pixels = [([f"img{s + i:05d}" for i in range(ENCODE_BATCH)],
               rng.standard_normal((ENCODE_BATCH, size, size, 3), dtype=np.float32))
              for s in range(0, FEED_GALLERY, ENCODE_BATCH)]
    raw = list(synthetic_raw_batches(SEED + 101, FEED_GALLERY, ENCODE_BATCH, RAW_BUFFER))
    pre = device_preprocess(dim=size)

    result = {"gallery": FEED_GALLERY, "encode_batch": ENCODE_BATCH, "repeats": FEED_REPEATS,
              "frozen_host_dtype": str(frozen_dtype or torch.float32)}
    with torch.inference_mode():
        for name, build, batches, encode, fills in (
                ("build_index", engine.build_index, pixels, model.extract_target_features, (0,)),
                ("build_index_raw", engine.build_index_raw, raw,
                 lambda images, sizes: model.extract_target_features(pre(images, sizes)), (0, 1))):
            model_ms, _ = _median_run(model_alone(model, batches, frozen_dtype, encode, fills, dev))
            engine_ms, stages = _median_run(lambda: (build(iter(batches)),
                                                     dict(engine.feed_seconds))[1])
            result[name] = {
                "engine_ms": engine_ms, "model_alone_ms": model_ms,
                "engine_imgs_per_s": FEED_GALLERY / engine_ms * 1e3,
                "model_alone_imgs_per_s": FEED_GALLERY / model_ms * 1e3,
                "engine_over_model": engine_ms / model_ms,
                "host_ms_by_stage": {k: v * 1e3 for k, v in stages.items()}}
        images, sizes = (torch.from_numpy(a).to(dev) for a in raw[0][1:])
        pre(images, sizes)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            pre(images, sizes)
        end.record()
        torch.cuda.synchronize()
    result["device_preprocess_device_ms"] = start.elapsed_time(end) / 10
    result["device_preprocess_shape"] = list(images.shape)
    result["decode"] = decode_rate()
    return result


def profile_train(model_type: str, out: str, model_name: str = "blip2_cir_align_prompt") -> dict:
    """One live and one cached fine-tune step at batch 128 (``--train``);
    for a stage-1 model one live pretraining step at batch 100."""
    from sprc_tpu_torch.kernel_checks import STAGE1_BATCH, TRAIN_BATCH
    from sprc_tpu_torch.loader import STAGE1_MODELS, load_model
    from sprc_tpu_torch.train.generic import GenericTrainer
    from sprc_tpu_torch.train.loop import TrainConfig, Trainer

    dev = "cuda"
    os.makedirs(out, exist_ok=True)
    model = load_model(model_name, model_type, device=dev, seed=SEED)
    cfg = model.cfg
    gen = torch.Generator(device=dev).manual_seed(SEED)
    stage1 = model_name in STAGE1_MODELS
    B, L = STAGE1_BATCH if stage1 else TRAIN_BATCH, cfg.max_txt_len
    pixels = torch.randn((2, B, cfg.image_size, cfg.image_size, 3), generator=gen, device=dev)
    ids = torch.randint(1000, cfg.vocab_size, (B, L), generator=gen, device=dev)
    lengths = torch.randint(4, L + 1, (B,), generator=gen, device=dev)
    mask = (torch.arange(L, device=dev)[None] < lengths[:, None]).long()
    if stage1:
        runs = (("live", {"images": pixels[0], "input_ids": ids, "text_mask": mask}),)
    else:
        with torch.no_grad():
            rows = model.encode_tower(pixels.flatten(0, 1))
        runs = (("live", {"reference": pixels[0], "target": pixels[1], "input_ids": ids,
                          "text_mask": mask}),
                ("cached", {"reference_embeds": rows[:B], "target_embeds": rows[B:],
                            "input_ids": ids, "text_mask": mask}))
    # the flagship's dense operations (qformer_train_flops counts its passes)
    flagship = model_name == "blip2_cir_align_prompt"
    result = {"device": torch.cuda.get_device_name(0), "model_name": model_name,
              "model_type": model_type, "batch": B, "repeats": REPEATS, "wall_ms": {},
              "qformer_dense_tflop": qformer_train_flops(model, B) / 1e12 if flagship else None}
    for name, batch in runs:
        if stage1:
            trainer = GenericTrainer(model, TrainConfig(learning_rate=1e-4, total_steps=1000),
                                     seed=SEED, skip_nonfinite=True, decay_frozen=True)
        else:
            trainer = Trainer(model, TrainConfig(total_steps=1000), seed=SEED,
                              from_embeds=name == "cached", skip_nonfinite=True)
        torch.cuda.reset_peak_memory_stats()
        result["wall_ms"][name] = _wall_ms(lambda: trainer.train_step(batch))
        result[name] = _profile(lambda: trainer.train_step(batch), f"train_{name}", out,
                                TRAIN_GROUPS)
        result[name]["samples_per_s"] = B / (result["wall_ms"][name] * 1e-3)
        result[name]["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        # the Q-Former's products: the training branch's library GEMMs, and
        # the fp32 GEMMs of K3 in the step's no-grad passes (rerank, cls)
        by_group = result[name]["device_ms_by_group"]
        result[name]["qformer_product_ms"] = (by_group.get("library GEMM", 0.0)
                                              + by_group.get("fp32 GEMM", 0.0))
        gemm_ms = by_group.get("library GEMM")
        if gemm_ms and flagship:
            result[name]["library_gemm_tflop_per_s"] = (
                result["qformer_dense_tflop"] / (gemm_ms * 1e-3))
        del trainer
    del model
    torch.cuda.empty_cache()
    return result


def qformer_train_flops(model, batch: int) -> float:
    """The dense products of one step's Q-Former passes, forward and
    backward (twice the forward): the fusion pass (Q queries + L text rows,
    cross-attention for the queries), the text pass of the fused queries,
    the targets' queries pass (cross-attention) and the prompt pass, each
    over every layer; a product of R x K by K x N counts 2 R K N, its
    backward twice that. The projections to the embedding are left out."""
    cfg, q = model.cfg, model.cfg.qformer_config()
    H, M, Wi = q.hidden_size, q.intermediate_size, q.encoder_width
    Q, L, Si = cfg.num_query_token, cfg.max_txt_len, cfg.vit_config().seq_len
    layer = 2 * (4 * H * H + 2 * H * M)  # q, k, v, out and the FFN, a row
    cross = 2 * Q * 2 * H * H + 2 * Si * 2 * Wi * H  # q / out a query row, k / v an image row
    n_cross = len(range(0, q.num_layers, q.cross_attention_freq))
    rows = 3 * (Q + L) + Q  # fusion, text, prompt passes; the queries pass
    forward = batch * (q.num_layers * rows * layer + n_cross * 2 * cross)
    return 3.0 * forward


def rerank_dense_ops(model, candidates: int) -> float:
    """The dense products of a rerank tile of ``candidates`` pairs: every
    pair's Q query rows and L caption rows through every layer (q, k, v, out
    and the FFN), and on the cross layers the query rows' q / out and the
    memory's 2 S rows' k / v. A product of R x K by K x N counts 2 R K N; the
    ``itm_head`` is left out."""
    cfg, q = model.cfg, model.cfg.qformer_config()
    H, M, Wi = q.hidden_size, q.intermediate_size, q.encoder_width
    Q, L, S = cfg.num_query_token, cfg.max_txt_len, cfg.vit_config().seq_len
    layer = 2 * (Q + L) * (4 * H * H + 2 * H * M)
    cross = 2 * Q * 2 * H * H + 2 * (2 * S) * 2 * Wi * H
    n_cross = len(range(0, q.num_layers, q.cross_attention_freq))
    return float(candidates) * (q.num_layers * layer + n_cross * cross)


def rerank_tile(model, step: int, top: int, host_dtype):
    """One rerank tile as the serving path holds it: a gallery of
    ENCODE_BATCH seeded images encoded by ``model`` (the engine's index, its
    frozen rows on the host in ``host_dtype``), ``step`` queries whose
    references are the first ``step`` images and whose captions are seeded
    words, and each query's ``top`` candidates (the gallery cycled from a
    seeded offset, the reference left out). Returns (index, reference names,
    captions, candidate names [step, top])."""
    from sprc_tpu_torch.retrieval.engine import RetrievalEngine

    rng = np.random.default_rng(SEED + 300)
    size = model.cfg.image_size
    images = rng.standard_normal((ENCODE_BATCH, size, size, 3), dtype=np.float32)
    names = [f"img{i:04d}" for i in range(ENCODE_BATCH)]
    engine = RetrievalEngine(model, device="cuda", encode_batch=ENCODE_BATCH,
                             frozen_host_dtype=host_dtype)
    index = engine.build_index(iter([(names, images)]))
    words = ["red", "dress", "with", "long", "sleeves", "and", "a", "blue", "shirt", "dog"]
    refs = names[:step]
    caps = [" ".join(rng.choice(words, rng.integers(3, 9))) for _ in refs]
    cands = []
    for i in range(step):
        others = [n for n in names if n != refs[i]]
        start = int(rng.integers(len(others)))
        cands.append([others[(start + j) % len(others)] for j in range(top)])
    return index, refs, caps, np.asarray(cands)


def profile_rerank(model_type: str, int8: bool, top: int, step: int, out: str) -> dict:
    """One rerank tile (``--rerank``)."""
    from sprc_tpu_torch.loader import load_model
    from sprc_tpu_torch.ops import primitives
    from sprc_tpu_torch.retrieval.rerank import ItmRerankScorer, rerank_rankings
    from sprc_tpu_torch.text.tokenizer import BertWordPieceTokenizer
    from sprc_tpu_torch.utils.artifacts import write_synthetic_bert_vocab

    dev = "cuda"
    model = load_model("blip2_cir_rerank", model_type, device=dev, seed=SEED, qformer_int8=int8)
    host = torch.bfloat16 if model_type == "pretrain_vitL" else None
    index, refs, caps, cands = rerank_tile(model, step, top, host)
    tok = BertWordPieceTokenizer.from_vocab_file(
        write_synthetic_bert_vocab(os.path.join(out, "vocab.txt")))
    scorer = ItmRerankScorer(model, tok, top=top, step=step)

    def tile():
        return rerank_rankings(cands, refs, caps, scorer, index.reference_embeds, top=top,
                               step=step)

    n = step * top
    result = {"device": torch.cuda.get_device_name(0), "model_type": model_type, "int8": int8,
              "step": step, "top": top, "candidates": n, "repeats": REPEATS,
              "memory_rows": 2 * model.cfg.vit_config().seq_len,
              "frozen_host_dtype": str(index.frozen_embeds.dtype),
              "dense_tera_op": rerank_dense_ops(model, n) / 1e12}
    with torch.inference_mode():
        tile()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        scorer.seconds = dict.fromkeys(scorer.seconds, 0.0)
        gather = []
        inner = index.reference_embeds

        def timed_gather(names):
            t0 = time.perf_counter()
            rows = inner(names)
            gather.append(time.perf_counter() - t0)
            return rows

        index.reference_embeds = timed_gather
        result["wall_ms"] = _wall_ms(tile)
        index.reference_embeds = inner
        runs = REPEATS + 1
        result["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        result["peak_memory_above_model_gib"] = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        result["candidates_per_s"] = n / (result["wall_ms"] * 1e-3)
        result["host_ms_per_tile"] = {"gather": 1e3 * sum(gather) / runs,
                                      **{k: 1e3 * v / runs for k, v in scorer.seconds.items()}}
        result["gather_share"] = result["host_ms_per_tile"]["gather"] / result["wall_ms"]
        with primitives.plain_reference():
            t0 = time.perf_counter()
            tile()
            torch.cuda.synchronize()
            result["plain_wall_ms"] = (time.perf_counter() - t0) * 1e3
        result["tile"] = _profile(tile, "rerank", out)
    group = "int8 GEMM" if int8 else "fp32 GEMM"
    gemm_ms = result["tile"]["device_ms_by_group"].get(group)
    if gemm_ms:
        result["tile"][f"{group.split()[0]}_gemm_tera_op_per_s"] = (
            result["dense_tera_op"] / (gemm_ms * 1e-3))
    return result


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None,
                    help="default sprc_tpu_torch/_build/profile, with the options appended")
    ap.add_argument("--model-type", default="pretrain_vitL", choices=["pretrain_vitL", "pretrain"])
    ap.add_argument("--fused-block", default="block", choices=["block", "attn", "none"],
                    help="the tower's route (ViTConfig.fused_block)")
    ap.add_argument("--fused-mlp", action="store_true",
                    help="the MLP half through fused_mlp_block (ViTConfig.fused_mlp)")
    ap.add_argument("--int8", action="store_true", help="the int8 serving configuration")
    ap.add_argument("--gallery", type=int, default=GALLERY,
                    help="items the query batch is scored against (default 512)")
    ap.add_argument("--train", action="store_true",
                    help="profile a live and a cached fine-tune step at batch 128 instead")
    ap.add_argument("--model-name", nargs="+", default=["blip2_cir_align_prompt"],
                    help="with --train: the models to profile, one after another (a CIR "
                         "model whose training forward returns losses, or a stage-1 name)")
    ap.add_argument("--rerank", action="store_true",
                    help="profile one tile of the ITM rerank (blip2_cir_rerank) instead")
    ap.add_argument("--rerank-top", type=int, default=50)
    ap.add_argument("--rerank-step", type=int, default=15)
    args = ap.parse_args(argv)
    suffix = "".join(f"_{part}" for part, on in (
        (args.model_type, args.model_type != "pretrain_vitL"),
        (args.fused_block, args.fused_block != "block"), ("mlp", args.fused_mlp),
        ("int8", args.int8), (f"gallery{args.gallery}", args.gallery != GALLERY),
        ("train", args.train),
        (f"rerank{args.rerank_step}x{args.rerank_top}", args.rerank)) if on)
    args.out = args.out or "sprc_tpu_torch/_build/profile" + suffix
    if not torch.cuda.is_available():
        sys.exit("profile_serving: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.makedirs(args.out, exist_ok=True)
    if args.train or args.rerank:
        if args.rerank:
            result = profile_rerank(args.model_type, args.int8, args.rerank_top,
                                    args.rerank_step, args.out)
        elif len(args.model_name) == 1:
            result = profile_train(args.model_type, args.out, args.model_name[0])
        else:
            result = {name: profile_train(args.model_type, os.path.join(args.out, name), name)
                      for name in args.model_name}
        with open(os.path.join(args.out, "profile.json"), "w") as f:
            json.dump(result, f, indent=1)
        print(json.dumps(result), flush=True)
        return result
    from sprc_tpu_torch.loader import calibrate_vit_act_scales, load_model
    from sprc_tpu_torch.ops import primitives
    from sprc_tpu_torch.ops.layers import l2_normalize
    from sprc_tpu_torch.utils.artifacts import synthetic_calibration_images

    dev = "cuda"
    rng = np.random.default_rng(SEED)
    int8_kwargs = {"vit_quant": "int8_calib", "qformer_int8": True} if args.int8 else {}
    model = load_model("blip2_cir_align_prompt", args.model_type, device=dev, seed=SEED,
                       vit_fused_block=args.fused_block, vit_fused_mlp=args.fused_mlp,
                       **int8_kwargs)
    if args.int8:  # set-up: the tower then serves in "int8_static"
        calibrate_vit_act_scales(model, synthetic_calibration_images(SEED + 99))
    cfg, vcfg = model.cfg, model.cfg.vit_config()
    EB, QB, L = ENCODE_BATCH, QUERY_BATCH, cfg.max_txt_len
    images = torch.from_numpy(rng.standard_normal(
        (EB, cfg.image_size, cfg.image_size, 3), dtype=np.float32)).to(dev)
    with torch.inference_mode():
        frozen = model.encode_image(images)
        refs = frozen[torch.arange(QB, device=dev) % EB].contiguous()
        targets = l2_normalize(torch.from_numpy(rng.standard_normal(
            (args.gallery, cfg.num_query_token, cfg.embed_dim), dtype=np.float32)).to(dev))
    ids = torch.from_numpy(rng.integers(1000, cfg.vocab_size, (QB, L)).astype(np.int64)).to(dev)
    lengths = rng.integers(4, L + 1, QB)
    mask = torch.from_numpy((np.arange(L)[None] < lengths[:, None]).astype(np.int64)).to(dev)

    steps = {
        "encode": lambda: model.extract_target_features(images),
        "encode.tower": lambda: model.encode_image(images),
        "encode.queries_pass": lambda: model.target_features(frozen),
        "query": lambda: model.inference(refs, targets, ids, mask),
    }
    result = {"device": torch.cuda.get_device_name(0), "model_type": args.model_type,
              "fused_block": args.fused_block, "fused_mlp": args.fused_mlp, "int8": args.int8,
              "vit_act_scales": model.cfg.vit_act_scales,
              "encode_batch": EB, "query_batch": QB,
              "gallery": args.gallery, "repeats": REPEATS, "wall_ms": {}}
    for mode, ctx in (("kernels", contextlib.nullcontext), ("plain", primitives.plain_reference)):
        with torch.inference_mode(), ctx():
            result["wall_ms"][mode] = {k: _wall_ms(fn) for k, fn in steps.items()}
    with torch.inference_mode():
        for name in ("encode", "query"):
            result[name] = _profile(steps[name], name, args.out)
    flops = 2 * EB * vcfg.seq_len * (4 * vcfg.width ** 2
                                     + 2 * vcfg.width * vcfg.mlp_hidden) * vcfg.depth
    query = result["query"]
    query["token_max_sim_share"] = (query["device_ms_by_group"].get("token-max sim", 0.0)
                                    / query["device_ms"])
    result["encode"]["tower_dense_tflop"] = flops / 1e12
    result["encode"]["imgs_per_s"] = EB / (result["wall_ms"]["kernels"]["encode"] * 1e-3)
    # the queries pass's dense operations: the int8 GEMM group also holds them,
    # and they are the whole fp32 GEMM group of the bf16/fp32 encode
    q = cfg.qformer_config()
    R, Wq, Mq, Si = EB * cfg.num_query_token, q.hidden_size, q.intermediate_size, vcfg.seq_len
    per_layer, cross = 8 * R * Wq * Wq + 4 * R * Wq * Mq, (
        4 * R * Wq * Wq + 4 * EB * Si * q.encoder_width * Wq)
    n_cross = len(range(0, q.num_layers, q.cross_attention_freq))
    qf_ops = q.num_layers * per_layer + n_cross * cross
    result["encode"]["queries_pass_dense_tera_op"] = qf_ops / 1e12
    by_group = result["encode"]["device_ms_by_group"]
    if args.int8:
        if by_group.get("int8 GEMM"):
            result["encode"]["int8_gemm_tera_op_per_s"] = (
                (flops + qf_ops) / (by_group["int8 GEMM"] * 1e-3) / 1e12)
    else:
        if by_group.get("bf16 GEMM"):
            result["encode"]["bf16_gemm_tflop_per_s"] = flops / (by_group["bf16 GEMM"] * 1e-3) / 1e12
        if by_group.get("fp32 GEMM"):
            result["encode"]["fp32_gemm_tflop_per_s"] = qf_ops / (by_group["fp32 GEMM"] * 1e-3) / 1e12
    result["encode.feed"] = profile_feed(model, dev)
    with open(os.path.join(args.out, "profile.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
