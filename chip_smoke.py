"""Drive the PyTorch/CUDA port (sprc_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits nonzero before the last line):

1. device: a CUDA device is required; TF32 is turned off so that every
   plain fp32 reference is true fp32;
2. build: the Hopper kernels of sprc_tpu_torch/csrc are compiled (nvcc,
   sm_90a) into sprc_tpu_torch/_build/;
3. kernels: K1 (token-max sim), K2 (ViT block) and K3 (Q-Former layer in the
   three serving shapes) against their plain PyTorch versions on the card, at
   the shapes the main path gives them (64 images, 32 queries, 512 items);
   the bf16 GEMM at 4096^3; then the int8 kernels: the s8 GEMM's raw s32
   product at 4096^3 and at every product of the main path (equal to plain),
   each with the epilogue the path runs on it, the quantisers, K5 (int8 ViT
   block) and K4 (int8 Q-Former layer); and every chain of 23 blocks or 12
   layers stage by stage (each kernel launch against its plain version on
   the same inputs);
4. main path: the full-width blip2_cir_align_prompt / pretrain_vitL model
   (random weights from seed 0, synthetic BERT vocab) encodes a 512-image
   synthetic gallery through RetrievalEngine.build_index (encode_batch 64),
   saves the index, and the port's HTTP server (sprc_tpu_torch.cli.serve,
   --index-path) answers GET /health and POST /query with 1 and 32 queries;
   the answers are checked; the first gallery batch is encoded again and
   the 32 queries are scored again, stage by stage: every kernel launch of
   every block and layer against its plain version on the activations the
   kernel run gave it, within kernel_checks.STAGE_BOUNDS; and once more
   through the all-plain path on the card (``primitives.plain_reference``),
   compared with the bounds below;
4b. the int8 main path, the same way: the model is loaded with
   qformer_int8=True and an int8 tower whose activation scales are
   calibrated on 16 seeded images (set-up, plain PyTorch) and which then
   serves in "int8_static"; it encodes the same 512 images, and the server
   runs with --qformer-int8. The stage-by-stage comparison is the gate; the
   free-running all-plain comparison and the int8 answers against phase 4's
   (random weights) are reports;
5. counters: every kernel of each path launched on that path, and no kernel
   of the other configuration moved.

Then it prints one JSON line with each kernel's numbers, the card's name and
power limit, and last {"ok": true, "device": {...}}.
"""

import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"
SEED = 0
GALLERY = 512
ENCODE_BATCH = 64
QUERY_BATCH = 32
K = 10
# main path against its all-plain version on the card (primitives.plain_reference).
# Readings on an H100: frozen embeds 0.125 / 9.96e-3 (max / mean abs), target
# feats 2.83e-4 / 4.91e-5, scores 2.5e-7. The encode bounds are 2-4x those: the
# bf16 tower compounds rounding over 23 blocks. The query side (fp32 Q-Former
# and scoring over the same stored embeds) stays near fp32: 1e-5.
FROZEN_MAX_ABS, FROZEN_MEAN_ABS = 0.25, 0.02
TARGET_MAX_ABS, TARGET_MEAN_ABS = 1e-3, 2e-4
SCORE_MAX_ABS = 1e-5
BOUNDS = {"frozen": (FROZEN_MAX_ABS, FROZEN_MEAN_ABS), "target": (TARGET_MAX_ABS, TARGET_MEAN_ABS),
          "score": SCORE_MAX_ABS, "top1": QUERY_BATCH - 1}
# The int8 main path is held stage by stage (kernel_checks.STAGE_BOUNDS); its
# free-running all-plain version is reported without a bound. The two quantise
# values that differ in the last bits, so codes flip and, over 23 blocks and
# 12 layers, the runs drift as far apart as int8 lies from bf16/fp32: a bound
# on that difference could not tell a wrong kernel from a right one.
CALIB_IMAGES = 16


def log(msg):
    print(msg, flush=True)


def sync():
    torch.cuda.synchronize()


def phase_device():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this script needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    log(f"[device] {name}, count={torch.cuda.device_count()}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    return name


def phase_build():
    from sprc_tpu_torch.ops import _ext

    t0 = time.perf_counter()
    path = _ext.build()
    _ext.library()
    log(f"[build] {path.relative_to(ROOT)} from {len(_ext.sources())} sources in "
        f"{time.perf_counter() - t0:.1f} s (nvcc log: {(_ext.BUILD_DIR / 'nvcc.log').relative_to(ROOT)})")


def phase_kernels():
    from sprc_tpu_torch import kernel_checks

    assert (kernel_checks.ENCODE_BATCH, kernel_checks.QUERY_BATCH, kernel_checks.GALLERY) == (
        ENCODE_BATCH, QUERY_BATCH, GALLERY), "the kernel checks run at the main path's shapes"
    rows = kernel_checks.run_all("cuda")
    sync()
    for row in rows:
        timing = (f" kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms"
                  if "ms" in row else "")
        log(f"[kernels] {row['check']} ({row['shape']}): max_abs {row['max_abs_err']:.3e} "
            f"mean_abs {row['mean_abs_err']:.3e}{timing} -> {'ok' if row['ok'] else 'FAIL'}")
    bad = [r["check"] for r in rows if not r["ok"]]
    if bad:
        raise RuntimeError(f"kernels disagree with their plain versions: {bad}")
    return rows


def _gallery_batches(n, batch, size, seed):
    """Seeded synthetic gallery: normalised (already targetpadded) pixels."""
    rng = np.random.default_rng(seed)
    for s in range(0, n, batch):
        b = min(batch, n - s)
        yield [f"img{i:04d}" for i in range(s, s + b)], rng.standard_normal(
            (b, size, size, 3), dtype=np.float32)


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=300) as resp:
        body = json.loads(resp.read())
    return body, (time.perf_counter() - t0) * 1e3


def _check_answer(results, refs, names):
    assert len(results) == len(refs), (len(results), len(refs))
    for res, ref in zip(results, refs):
        assert len(res) == K, len(res)
        assert all(r["name"] in names and r["name"] != ref for r in res), "reference not masked"
        scores = [r["score"] for r in res]
        assert all(np.isfinite(scores)), scores
        assert scores == sorted(scores, reverse=True), scores


def _counters():
    """name -> (object, attribute) of every wrapper's launch count."""
    from sprc_tpu_torch.ops import primitives
    from sprc_tpu_torch.ops.fused_block import fused_vit_block, fused_vit_block_i8
    from sprc_tpu_torch.ops.fused_qformer import fused_qformer_layer
    from sprc_tpu_torch.ops.sim_kernels import token_max_sim

    return {"token_max_sim": (token_max_sim, "launches"),
            "fused_vit_block": (fused_vit_block, "launches"),
            "fused_qformer_layer": (fused_qformer_layer, "launches"),
            "fused_vit_block_i8": (fused_vit_block_i8, "launches"),
            "fused_qformer_layer_int8": (fused_qformer_layer, "launches_int8"),
            "gemm_i8": (primitives.gemm_i8_cuda, "launches"),
            "gemm": (primitives.gemm_cuda, "launches")}


# the kernels each configuration's main path must launch; the other
# configuration's must not move
PATH_KERNELS = {"bf16": ("token_max_sim", "fused_vit_block", "fused_qformer_layer", "gemm"),
                "int8": ("token_max_sim", "fused_vit_block_i8", "fused_qformer_layer_int8",
                         "gemm_i8")}


def stage_pass(tag, what, counters, fn):
    """``fn()`` once more through the kernels, every stage against its plain
    version on the same inputs. The launches of this comparison are not the
    main path's: the counters are put back."""
    from sprc_tpu_torch import kernel_checks
    from sprc_tpu_torch.ops import primitives

    before = {k: getattr(obj, attr) for k, (obj, attr) in counters.items()}
    stages = kernel_checks.StageRecorder()
    with torch.inference_mode(), primitives.stage_check(stages):
        fn()
    sync()
    for k, (obj, attr) in counters.items():
        setattr(obj, attr, before[k])
    for row in stages.rows():
        log(f"[main {tag}] {what}, stage by stage: {row['kind']}: {row['calls']} calls, worst "
            f"share that differs {row['differ']:.3e}, worst difference {row['err']:.3e} -> "
            f"{'ok' if row['ok'] else 'FAIL'}")
    if not stages.ok():
        raise RuntimeError(f"{tag} {what}: a stage disagrees with its plain version: "
                           f"{[r['kind'] for r in stages.rows() if not r['ok']]}")
    return stages.rows()


def phase_main_path(work, tag, gallery, bounds, model_kwargs=(), serve_flags=(), calibrate=False):
    """One configuration end to end. ``tag`` names it in the log ("bf16":
    bf16 tower and fp32 Q-Former; "int8": the int8 serving configuration).
    ``bounds`` None: the free-running all-plain comparison is a report."""
    from sprc_tpu_torch.cli.serve import build_service, make_parser, make_server
    from sprc_tpu_torch.loader import calibrate_vit_act_scales, load_model
    from sprc_tpu_torch.ops import primitives
    from sprc_tpu_torch.retrieval.engine import RetrievalEngine
    from sprc_tpu_torch.text.tokenizer import BertWordPieceTokenizer
    from sprc_tpu_torch.utils.artifacts import (synthetic_calibration_images,
                                                write_synthetic_bert_vocab)

    os.makedirs(work, exist_ok=True)
    vocab = write_synthetic_bert_vocab(os.path.join(work, "vocab.txt"))
    index_path = os.path.join(work, f"gallery_index_{tag}")
    counters = _counters()

    t0 = time.perf_counter()
    model = load_model("blip2_cir_align_prompt", "pretrain_vitL", device=DEVICE, seed=SEED,
                       **dict(model_kwargs))
    sync()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[main {tag}] model blip2_cir_align_prompt/pretrain_vitL on {DEVICE}: "
        f"{n_params / 1e6:.1f} M params, built in {time.perf_counter() - t0:.1f} s")
    if calibrate:  # set-up, plain PyTorch: the tower then serves in "int8_static"
        t0 = time.perf_counter()
        scales = calibrate_vit_act_scales(
            model, synthetic_calibration_images(SEED + 99, CALIB_IMAGES), batch=CALIB_IMAGES)
        sync()
        log(f"[main {tag}] calibrated on {CALIB_IMAGES} seeded images in "
            f"{time.perf_counter() - t0:.1f} s: " + ", ".join(f"{k} {v:.5f}" for k, v in scales))
        assert all(np.isfinite(v) and v > 0 for _, v in scales), scales
        assert model.visual_encoder.cfg.quant == "int8_static"
    cfg = model.cfg
    size, S, D = cfg.image_size, cfg.vit_config().seq_len, cfg.vit_config().width
    engine = RetrievalEngine(model, BertWordPieceTokenizer.from_vocab_file(vocab), device=DEVICE,
                             encode_batch=ENCODE_BATCH, query_batch=QUERY_BATCH,
                             frozen_host_dtype=torch.bfloat16)
    engine.build_index(_gallery_batches(ENCODE_BATCH, ENCODE_BATCH, size, SEED + 100))  # warm-up
    sync()

    for obj, attr in counters.values():  # count only the main path from here on
        setattr(obj, attr, 0)
    t0 = time.perf_counter()
    index = engine.build_index(iter(gallery))
    sync()
    encode_s = time.perf_counter() - t0
    tf = index.target_feats
    assert tf.shape == (GALLERY, cfg.num_query_token, cfg.embed_dim), tf.shape
    assert bool(torch.isfinite(tf).all())
    norms = tf.norm(dim=-1)
    assert bool(((norms - 1).abs() < 1e-3).all()), "target features are not unit norm"
    assert tuple(index.frozen_embeds.shape) == (GALLERY, S, D)
    log(f"[main {tag}] gallery encode: {GALLERY} images in {encode_s:.3f} s = "
        f"{GALLERY / encode_s:.2f} imgs/s (encode_batch {ENCODE_BATCH})")
    index.save(index_path)

    # the first gallery batch again: stage by stage, then through the
    # all-plain path on the card (plain versions: no kernel launches)
    first = torch.from_numpy(gallery[0][1]).to(DEVICE)
    stage_pass(tag, f"gallery encode, {ENCODE_BATCH} images", counters,
               lambda: model.extract_target_features(first))
    with torch.inference_mode(), primitives.plain_reference():
        plain_tf, plain_frozen = model.extract_target_features(first)
    sync()
    b = ENCODE_BATCH
    err_frozen = (plain_frozen.to(index.frozen_embeds.dtype).float().cpu()
                  - index.frozen_embeds[:b].float()).abs()
    err_tf = (plain_tf.float() - tf[:b]).abs()
    log(f"[main {tag}] all-plain gallery encode on the card, {b} images: frozen embeds (bf16) "
        f"max_abs {err_frozen.max().item():.3e} mean_abs {err_frozen.mean().item():.3e}; "
        f"target feats max_abs {err_tf.max().item():.3e} mean_abs {err_tf.mean().item():.3e}")
    if bounds is not None:
        assert err_frozen.max().item() <= bounds["frozen"][0]
        assert err_frozen.mean().item() <= bounds["frozen"][1]
        assert err_tf.max().item() <= bounds["target"][0]
        assert err_tf.mean().item() <= bounds["target"][1]
    target_feats = tf.cpu()
    del engine, model, index, tf, first
    torch.cuda.empty_cache()

    args = make_parser().parse_args(["--index-path", index_path, "--device", DEVICE,
                                     "--vocab-path", vocab, "--seed", str(SEED),
                                     "--query-batch", str(QUERY_BATCH), "--port", "0",
                                     *serve_flags])
    service = build_service(args)
    service.warm()
    server = make_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    names = set(service.index.names)
    rng = np.random.default_rng(SEED + 1)
    words = ["red", "dress", "with", "long", "sleeves", "and", "a", "blue", "shirt", "dog"]
    refs = [service.index.names[i] for i in rng.choice(GALLERY, QUERY_BATCH, replace=False)]
    caps = [" ".join(rng.choice(words, rng.integers(3, 9))) for _ in refs]
    try:
        with urllib.request.urlopen(f"{base}/health", timeout=60) as resp:
            health = json.loads(resp.read())
        assert health == {"status": "ok", "gallery": GALLERY}, health
        single_ms, batch_ms = [], []
        for _ in range(5):
            out, ms = _post(f"{base}/query", {"reference": refs[0], "caption": caps[0], "k": K})
            _check_answer(out["results"], refs[:1], names)
            single_ms.append(ms)
        for _ in range(3):
            out, ms = _post(f"{base}/query", {"queries": [
                {"reference": r, "caption": c} for r, c in zip(refs, caps)], "k": K})
            _check_answer(out["results"], refs, names)
            batch_ms.append(ms)
        served = out["results"]
    finally:
        server.shutdown()
        thread.join(timeout=30)
        server.server_close()
    assert not thread.is_alive(), "server thread did not stop"
    sync()
    launches = {k: getattr(obj, attr) for k, (obj, attr) in counters.items()}
    log(f"[main {tag}] HTTP /health ok; POST /query 1 query: median {np.median(single_ms):.3f} ms "
        f"(5 runs); {len(refs)} queries: median {np.median(batch_ms):.3f} ms (3 runs)")

    # the same 32 queries (the same stored reference embeds and target feats):
    # stage by stage, then through the all-plain path on the card
    engine, index = service.engine, service.index
    tok = engine.tokenizer(caps, max_length=engine.model.cfg.max_txt_len)
    query = (index.reference_embeds(refs).to(DEVICE), index.target_feats,
             torch.as_tensor(tok["input_ids"], device=DEVICE),
             torch.as_tensor(tok["attention_mask"], device=DEVICE))
    stage_pass(tag, f"{len(refs)} queries", counters, lambda: engine.model.inference(*query))
    with torch.inference_mode(), primitives.plain_reference():
        plain = engine.model.inference(*query).cpu().numpy()
    name_idx = {n: i for i, n in enumerate(index.names)}
    diffs, top1_same = [], 0
    for row, res, ref in zip(plain, served, refs):
        diffs += [abs(row[name_idx[r["name"]]] - r["score"]) for r in res]
        order = [j for j in np.argsort(-row, kind="stable") if index.names[j] != ref]
        top1_same += index.names[order[0]] == res[0]["name"]
    log(f"[main {tag}] all-plain path on the card: max |score diff| {max(diffs):.3e} over the "
        f"served top-{K}; top-1 equal on {top1_same}/{len(refs)}")
    if bounds is not None:
        assert max(diffs) <= bounds["score"], max(diffs)
        assert top1_same >= bounds["top1"], top1_same
    del service, engine, index
    torch.cuda.empty_cache()
    return {"launches": launches, "encode_imgs_per_s": GALLERY / encode_s,
            "query_1_median_ms": float(np.median(single_ms)),
            "query_32_median_ms": float(np.median(batch_ms)),
            "target_feats": target_feats, "served": served}


def report_int8_against_bf16(bf16, int8):
    """Not a gate: how far the int8 configuration's answers lie from the
    bf16/fp32 configuration's, on random weights (near-tied scores)."""
    d = (int8["target_feats"] - bf16["target_feats"]).abs()
    top1 = sum(a[0]["name"] == b[0]["name"] for a, b in zip(int8["served"], bf16["served"]))
    top10 = np.mean([len({r["name"] for r in a} & {r["name"] for r in b}) / K
                     for a, b in zip(int8["served"], bf16["served"])])
    log(f"[int8 vs bf16] random weights, {GALLERY} images, {QUERY_BATCH} queries: target feats "
        f"max_abs {d.max().item():.3e} mean_abs {d.mean().item():.3e}; top-1 equal on "
        f"{top1}/{QUERY_BATCH}; mean top-{K} overlap {top10:.3f}")
    return {"target_max_abs": d.max().item(), "target_mean_abs": d.mean().item(),
            "top1_equal": int(top1), "top10_overlap": float(top10)}


def check_counters(tag, launches):
    log(f"[counters] launches during the {tag} main path: {launches}")
    missing = [k for k in PATH_KERNELS[tag] if launches[k] <= 0]
    if missing:
        raise RuntimeError(f"kernels not launched by the {tag} main path: {missing}")
    moved = [k for k, v in launches.items() if k not in PATH_KERNELS[tag] and v != 0]
    if moved:
        raise RuntimeError(f"the {tag} main path launched another configuration's kernels: {moved}")


def kernel_table(rows, launches):
    """One entry per ported TPU kernel, from this run's checks and counts.
    A chain has no single PyTorch call that computes it: library_ms null."""
    from sprc_tpu_torch.kernel_checks import bound_ms

    by_check = {r["check"]: r for r in rows}

    def entry(name, source, replaces, checks, library_ms=None):
        rs = [by_check[c] for c in checks]
        work = {"bytes": sum(r["bytes"] for r in rs),
                "op_seconds": sum(r["op_seconds"] for r in rs)}
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches[name], "max_abs_err": max(r["max_abs_err"] for r in rs),
                "ms": sum(r["ms"] for r in rs), "plain_ms": sum(r["plain_ms"] for r in rs),
                **bound_ms(work), "library_ms": library_ms}

    shapes = ("queries", "fusion", "prompt")  # K3 / K4: summed over the serving shapes
    return [
        entry("token_max_sim", "sprc_tpu_torch/csrc/token_max_sim.cu",
              "sprc_tpu/ops/pallas_sim.py:40", ["K1 token_max_sim"]),
        entry("fused_vit_block", "sprc_tpu_torch/ops/fused_block.py",
              "sprc_tpu/ops/pallas_block.py:609", ["K2 vit_block"]),
        entry("fused_qformer_layer", "sprc_tpu_torch/ops/fused_qformer.py",
              "sprc_tpu/ops/pallas_qformer.py:360", [f"K3 qformer_layer {s}" for s in shapes]),
        entry("fused_qformer_layer_int8", "sprc_tpu_torch/ops/fused_qformer.py",
              "sprc_tpu/ops/pallas_qformer.py:360",
              [f"K4 qformer_layer_int8 {s}" for s in shapes]),
        entry("fused_vit_block_i8", "sprc_tpu_torch/ops/fused_block.py",
              "sprc_tpu/ops/pallas_block.py:535", ["K5 vit_block_i8"]),
        # the tiled matmul of scripts/ablate_int8.py, at its shape, in both its modes
        entry("gemm_i8", "sprc_tpu_torch/csrc/gemm_i8.cu", "scripts/ablate_int8.py:194",
              ["gemm_i8 ablate 4096^3"],
              library_ms=by_check["gemm_i8 ablate 4096^3"]["library_ms"]),
        entry("gemm", "sprc_tpu_torch/csrc/gemm.cu", "scripts/ablate_int8.py:194",
              ["gemm bf16 ablate 4096^3"],
              library_ms=by_check["gemm bf16 ablate 4096^3"]["library_ms"]),
    ]


def main():
    t_start = time.perf_counter()
    phase_device()
    phase_build()
    rows = phase_kernels()
    work = os.path.join(ROOT, "sprc_tpu_torch", "_build", "smoke")
    gallery = list(_gallery_batches(GALLERY, ENCODE_BATCH, 224, SEED))  # set-up, untimed
    bf16 = phase_main_path(work, "bf16", gallery, BOUNDS)
    check_counters("bf16", bf16["launches"])
    int8 = phase_main_path(
        work, "int8", gallery, None, model_kwargs={"vit_quant": "int8_calib", "qformer_int8": True},
        serve_flags=["--qformer-int8"], calibrate=True)
    check_counters("int8", int8["launches"])
    against = report_int8_against_bf16(bf16, int8)
    log(f"[done] every phase passed in {time.perf_counter() - t_start:.1f} s")

    # each kernel's count comes from the path that is its own (K1: the first)
    launches = {**int8["launches"], **{k: bf16["launches"][k] for k in PATH_KERNELS["bf16"]}}
    keep = ("encode_imgs_per_s", "query_1_median_ms", "query_32_median_ms")
    print(json.dumps({"kernels": kernel_table(rows, launches),
                      "bf16": {k: bf16[k] for k in keep}, "int8": {k: int8[k] for k in keep},
                      "int8_vs_bf16_random_weights": against}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
