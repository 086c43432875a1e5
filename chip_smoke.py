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
   the Q-Former's fp32 GEMM at each of its products and its fp32 attention at
   each of its calls (beside F.linear and SDPA in fp32, with both sides'
   device times); the LayerNorm at each call of kernel_checks.LN_CALLS (the
   towers' bf16 and LN -> int8 calls, the Q-Former's fp32 post-LN, an fp32
   tower's; beside F.layer_norm in the model dtype); the bf16 GEMM at 4096^3; then
   the int8 kernels: the s8 GEMM's raw s32 product at 4096^3 and at every
   product of the main path (equal to plain), each with the epilogue the path
   runs on it, the quantisers (codes and scales equal to plain at every call
   of kernel_checks.QUANT_CALLS, with their device times), K5 (int8 ViT
   block) and K4 (int8 Q-Former layer); every chain of 23 blocks or 12
   layers stage by stage (each kernel launch against its plain version on
   the same inputs); then the validate
   path's kernels: K8 (flash_attention) at head dims 64 and 88, the attention
   kernel at head dim 88 in bf16 and fp32, K6 (attention half) and K7 (MLP
   half) at ViT-L's and EVA ViT-g's shapes, K2 and K5 at EVA's shapes, and
   the towers' bf16 dense products; then the kernels redesigned for Hopper at
   their tile edges: the bf16 and fp32 GEMMs over ragged (M, N, K) with every
   epilogue and both residual modes, the s8 GEMM over ragged (M, N, K) raw
   and with every output mode and epilogue, each GEMM refusing a K it cannot
   take before any launch, the bf16 and fp32 attention over ragged (Sq, Sk)
   at both head dims on strided packed views, BSHD tensors and with a column
   bias that masks a whole row, the LayerNorm over ragged widths and row
   counts in its three modes, both quantisers over ragged rows and widths,
   unaligned views, zero rows, clipped values and exact ties, K1 over ragged
   query batches, galleries, token counts and depths (within 1e-5, a copied
   item tied bit for bit, NaN and infinities where the plain version gives
   them, and one gallery of 262,145 items, past 2^31 elements); and the host
   side of one call of each GEMM (K1's line in the kernels JSON times the
   wrapper, as every other's);
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
   its calibration pass launches flash_attention (23 blocks a batch); the
   quantisers' launches are held per batch, on the main path and in each
   stage-by-stage pass: 23 quantize_static and 61 quantize_rows an encode
   batch (the image rows once a pass), 133 quantize_rows a query batch;
4c. one encode batch of the int8 configuration of blip2_cir_align_prompt /
   pretrain (EVA ViT-g, full width, calibrated as in 4b): its launches (39
   int8 blocks and 39 quantize_static, 12 int8 Q-Former layers and 61
   quantize_rows), its output, and the batch stage by stage;
5. validate on blip2_cir_align_prompt / pretrain at full width (EVA ViT-g:
   39 blocks, W 1408, head dim 88; the Q-Former over 1408-wide embeds;
   random weights from seed 0): a synthetic CIRR val split (512 gallery
   images as the seeded pixel batches of phase 4, 64 queries with 6-member
   groups) is written to a temporary directory and the metric dict comes
   through the port's cli/validate (build_engine, cirr_queries,
   evaluate_cirr), once on each tower route: the whole block (K2); the
   attention half + MLP kernel (K6, K7); unfused with flash_attention (K8).
   Each route's JSON is printed with its encode rate, its launch counters
   are checked (39 launches per image batch of its own kernels, none of the
   other routes'), the first 64 images and 32 queries are held stage by
   stage and against the all-plain path, and the three routes' target
   features are held within a bf16 bound of each other;
6. counters: every kernel of each path launched on that path (the chains'
   own kernels too: the bf16 and fp32 attention, the LayerNorm and its int8
   output, the two quantisers), and no kernel of another configuration moved.

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
# The validate phase (EVA ViT-g, 39 bf16 blocks) against its all-plain version:
# the same kinds of bound as BOUNDS, over a deeper and wider tower. Readings on
# an H100, worst of the three routes: frozen embeds 0.193 / 1.34e-2 (max / mean
# abs), target feats 4.71e-4 / 7.42e-5, scores 4.3e-7; the bounds are about 3x
# those.
EVA_BOUNDS = {"frozen": (0.5, 0.04), "target": (1.5e-3, 2.5e-4), "score": 1e-5,
              "top1": QUERY_BATCH - 1}
# the three routes' target features against the whole-block route's (bf16
# towers that round at other places): max / mean abs; readings 5.21e-4 / 7.56e-5
ROUTE_TARGET_MAX_ABS, ROUTE_TARGET_MEAN_ABS = 1.5e-3, 2.5e-4
VALIDATE_QUERIES = 64
# tower route -> (the --model-overrides that select it, the kernels whose
# count must be 39 per image batch, the other routes' kernels: 0)
ROUTES = {
    "block": ([], ("fused_vit_block",)),
    "attn+mlp": (["vit_fused_block=attn", "vit_fused_mlp=true"],
                 ("fused_attn_block", "fused_mlp_block")),
    "unfused": (["vit_fused_block=none"], ("flash_attention",)),
}
ROUTE_KERNELS = ("fused_vit_block", "fused_attn_block", "fused_mlp_block", "flash_attention")


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
    from sprc_tpu_torch.ops.attention import flash_attention
    from sprc_tpu_torch.ops.fused_block import (fused_attn_block, fused_mlp_block,
                                                fused_vit_block, fused_vit_block_i8)
    from sprc_tpu_torch.ops.fused_qformer import fused_qformer_layer
    from sprc_tpu_torch.ops.sim_kernels import token_max_sim

    return {"token_max_sim": (token_max_sim, "launches"),
            "fused_vit_block": (fused_vit_block, "launches"),
            "fused_attn_block": (fused_attn_block, "launches"),
            "fused_mlp_block": (fused_mlp_block, "launches"),
            "flash_attention": (flash_attention, "launches"),
            "fused_qformer_layer": (fused_qformer_layer, "launches"),
            "fused_vit_block_i8": (fused_vit_block_i8, "launches"),
            "fused_qformer_layer_int8": (fused_qformer_layer, "launches_int8"),
            "gemm_i8": (primitives.gemm_i8_cuda, "launches"),
            "gemm": (primitives.gemm_cuda, "launches_bf16"),
            "gemm_f32": (primitives.gemm_cuda, "launches_f32"),
            "attention_bf16": (primitives.attention_cuda, "launches_bf16"),
            "attention_f32": (primitives.attention_cuda, "launches_f32"),
            "layer_norm": (primitives.layer_norm_cuda, "launches"),
            "layer_norm_q8": (primitives.layer_norm_cuda, "launches_q8"),
            "quantize_static": (primitives.quantize_static_cuda, "launches"),
            "quantize_rows": (primitives.quantize_rows_cuda, "launches")}


# the kernels each configuration's main path must launch; the other
# configuration's must not move
PATH_KERNELS = {"bf16": ("token_max_sim", "fused_vit_block", "fused_qformer_layer", "gemm",
                         "gemm_f32", "attention_bf16", "attention_f32", "layer_norm"),
                "int8": ("token_max_sim", "fused_vit_block_i8", "fused_qformer_layer_int8",
                         "gemm_i8", "attention_bf16", "attention_f32", "layer_norm",
                         "layer_norm_q8", "quantize_static", "quantize_rows")}
# the int8 quantisers' launches per batch: an encode batch of either model
# (the ctx of every block; the Q-Former's rows, ctx and GELU outputs and the
# image rows once a pass) and a query batch (the fusion pass, with the image
# rows once, and the prompt pass)
INT8_QUANTIZE_PER_BATCH = {"encode": {"quantize_static": 23, "quantize_rows": 61},
                           "encode EVA": {"quantize_static": 39, "quantize_rows": 61},
                           "query": {"quantize_static": 0, "quantize_rows": 133}}
QUANTIZERS = ("quantize_static", "quantize_rows")


def stage_pass(tag, what, counters, fn, quantize=None):
    """``fn()`` once more through the kernels, every stage against its plain
    version on the same inputs, with the quantisers' launches of that one
    batch (``quantize``: what they must be). The launches of this comparison
    are not the main path's: the counters are put back."""
    from sprc_tpu_torch import kernel_checks
    from sprc_tpu_torch.ops import primitives

    before = {k: getattr(obj, attr) for k, (obj, attr) in counters.items()}
    stages = kernel_checks.StageRecorder()
    with torch.inference_mode(), primitives.stage_check(stages):
        fn()
    sync()
    batch = {k: getattr(counters[k][0], counters[k][1]) - before[k] for k in QUANTIZERS}
    for k, (obj, attr) in counters.items():
        setattr(obj, attr, before[k])
    log(f"[main {tag}] {what}, stage by stage: quantiser launches of the batch "
        + ", ".join(f"{k} {v}" for k, v in batch.items()))
    want = quantize or dict.fromkeys(QUANTIZERS, 0)
    if batch != want:
        raise RuntimeError(f"{tag} {what}: quantiser launches {batch}, expected {want}")
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
    ``bounds`` None: the free-running all-plain comparison is a report. The
    quantisers' launches are held per encode batch and per query batch
    (:data:`INT8_QUANTIZE_PER_BATCH` on the int8 path, none on the other)."""
    per_batch = INT8_QUANTIZE_PER_BATCH if tag == "int8" else None
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
    calibration = {}  # launches of the calibration pass (set-up)
    if calibrate:  # the tower then serves in "int8_static"
        t0 = time.perf_counter()
        flash, attr = counters["flash_attention"]
        before = getattr(flash, attr)
        scales = calibrate_vit_act_scales(
            model, synthetic_calibration_images(SEED + 99, CALIB_IMAGES), batch=CALIB_IMAGES)
        sync()
        calib_flash = getattr(flash, attr) - before
        calibration = {"flash_attention": calib_flash}
        log(f"[main {tag}] calibrated on {CALIB_IMAGES} seeded images in "
            f"{time.perf_counter() - t0:.1f} s, {calib_flash} flash_attention launches: "
            + ", ".join(f"{k} {v:.5f}" for k, v in scales))
        depth = model.visual_encoder.cfg.depth
        assert calib_flash == depth, f"the calibration pass launched flash_attention {calib_flash}x"
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
    encode_launches = {k: getattr(obj, attr) for k, (obj, attr) in counters.items()}
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
               lambda: model.extract_target_features(first), per_batch and per_batch["encode"])
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
                                     "--model-type", "pretrain_vitL",
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
    # the quantisers per batch: GALLERY / ENCODE_BATCH encode batches, then one
    # query batch per request and one to warm the server (K1 launches once each)
    batches = {"encode": GALLERY // ENCODE_BATCH, "query": launches["token_max_sim"]}
    got = {"encode": {k: encode_launches[k] for k in QUANTIZERS},
           "query": {k: launches[k] - encode_launches[k] for k in QUANTIZERS}}
    want = {part: {k: (per_batch[part][k] if per_batch else 0) * n for k in QUANTIZERS}
            for part, n in batches.items()}
    log(f"[main {tag}] quantiser launches: {got['encode']} over {batches['encode']} encode "
        f"batches, {got['query']} over {batches['query']} query batches")
    if got != want:
        raise RuntimeError(f"{tag}: quantiser launches {got}, expected {want}")

    # the same 32 queries (the same stored reference embeds and target feats):
    # stage by stage, then through the all-plain path on the card
    engine, index = service.engine, service.index
    tok = engine.tokenizer(caps, max_length=engine.model.cfg.max_txt_len)
    query = (index.reference_embeds(refs).to(DEVICE), index.target_feats,
             torch.as_tensor(tok["input_ids"], device=DEVICE),
             torch.as_tensor(tok["attention_mask"], device=DEVICE))
    stage_pass(tag, f"{len(refs)} queries", counters, lambda: engine.model.inference(*query),
               per_batch and per_batch["query"])
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
    return {"launches": launches, "calibration_launches": calibration,
            "encode_imgs_per_s": GALLERY / encode_s,
            "query_1_median_ms": float(np.median(single_ms)),
            "query_32_median_ms": float(np.median(batch_ms)),
            "target_feats": target_feats, "served": served}


def phase_eva_int8(gallery):
    """One encode batch of the int8 serving configuration of
    blip2_cir_align_prompt / pretrain (EVA ViT-g, full width; scales
    calibrated on the seeded images of phase 4b): the launches of that batch
    (39 int8 blocks, each quantising its ctx once; 12 int8 Q-Former layers and
    the image rows quantised once), its output, and the batch stage by
    stage."""
    from sprc_tpu_torch.loader import calibrate_vit_act_scales, load_model
    from sprc_tpu_torch.utils.artifacts import synthetic_calibration_images

    tag = "int8 EVA"
    counters = _counters()
    t0 = time.perf_counter()
    model = load_model("blip2_cir_align_prompt", "pretrain", device=DEVICE, seed=SEED,
                       vit_quant="int8_calib", qformer_int8=True)
    calibrate_vit_act_scales(model, synthetic_calibration_images(SEED + 99, CALIB_IMAGES),
                             batch=CALIB_IMAGES)
    sync()
    vcfg = model.cfg.vit_config()
    log(f"[main {tag}] model blip2_cir_align_prompt/pretrain on {DEVICE}, tower "
        f"{vcfg.quant!r}, W {vcfg.width}, depth {vcfg.depth}: built and calibrated in "
        f"{time.perf_counter() - t0:.1f} s")
    first = torch.from_numpy(gallery[0][1]).to(DEVICE)
    with torch.inference_mode():
        model.extract_target_features(first)  # warm-up
        sync()
        for obj, attr in counters.values():
            setattr(obj, attr, 0)
        tf, frozen = model.extract_target_features(first)
        sync()
    launches = {k: getattr(obj, attr) for k, (obj, attr) in counters.items()}
    log(f"[counters] launches of one {tag} encode batch: {launches}")
    want = {"fused_vit_block_i8": vcfg.depth, "fused_qformer_layer_int8": 12,
            **INT8_QUANTIZE_PER_BATCH["encode EVA"]}
    if {k: launches[k] for k in want} != want:
        raise RuntimeError(f"{tag}: launches {launches}, expected {want}")
    assert tf.shape == (ENCODE_BATCH, model.cfg.num_query_token, model.cfg.embed_dim), tf.shape
    assert bool(torch.isfinite(tf).all()) and bool(torch.isfinite(frozen.float()).all())
    assert bool(((tf.norm(dim=-1) - 1).abs() < 1e-3).all()), "target features are not unit norm"
    stage_pass(tag, f"gallery encode, {ENCODE_BATCH} images", counters,
               lambda: model.extract_target_features(first), INT8_QUANTIZE_PER_BATCH["encode EVA"])
    del model, tf, frozen, first
    torch.cuda.empty_cache()
    return launches


def _write_cirr_val(root, names, n_queries, seed):
    """A synthetic CIRR val split in the reference's on-disk layout (JSON
    only: the images are the seeded pixel batches, never files)."""
    rng = np.random.default_rng(seed)
    words = ["red", "dress", "with", "long", "sleeves", "and", "a", "blue", "shirt", "dog"]
    triplets = []
    for i in range(n_queries):
        members = [names[j] for j in rng.choice(len(names), 6, replace=False)]
        triplets.append({"pairid": i, "reference": members[0], "target_hard": members[1],
                         "caption": " ".join(rng.choice(words, rng.integers(3, 9))),
                         "img_set": {"members": members}})
    for sub, name, payload in (("captions", "cap.rc2.val.json", triplets),
                               ("image_splits", "split.rc2.val.json",
                                {n: f"dev/{n}.png" for n in names})):
        os.makedirs(os.path.join(root, "cirr", sub), exist_ok=True)
        with open(os.path.join(root, "cirr", sub, name), "w") as f:
            json.dump(payload, f)
    return root


CIRR_KEYS = ["group_recall_at1", "group_recall_at2", "group_recall_at3", "recall_at1",
             "recall_at5", "recall_at10", "recall_at50", "mean(R@5+R_s@1)", "arithmetic_mean",
             "harmonic_mean", "geometric_mean"]


def phase_validate(work, route, gallery):
    """The port's validate path on blip2_cir_align_prompt / pretrain (EVA
    ViT-g, full width) with the tower on ``route``."""
    from sprc_tpu_torch.cli import validate
    from sprc_tpu_torch.ops import primitives
    from sprc_tpu_torch.utils.artifacts import write_synthetic_bert_vocab

    tag = f"validate {route}"
    overrides, own = ROUTES[route]
    os.makedirs(work, exist_ok=True)
    vocab = write_synthetic_bert_vocab(os.path.join(work, "vocab.txt"))
    names = [n for batch_names, _ in gallery for n in batch_names]
    data = _write_cirr_val(os.path.join(work, "cirr_val"), names, VALIDATE_QUERIES, SEED + 2)
    argv = ["--dataset", "CIRR", "--data-path", data, "--vocab-path", vocab,
            "--encode-batch", str(ENCODE_BATCH), "--query-batch", str(QUERY_BATCH)]
    args = validate.make_parser().parse_args(argv + (["--model-overrides", *overrides]
                                                    if overrides else []))
    assert (args.device, args.model_type, args.model_path) == ("cuda", "pretrain", None)
    counters = _counters()

    t0 = time.perf_counter()
    model, engine = validate.build_engine(args)
    sync()
    vcfg = model.cfg.vit_config()
    assert (vcfg.width, vcfg.depth, vcfg.head_dim, vcfg.mlp_hidden) == (1408, 39, 88, 6144)
    assert model.cfg.qformer_config().encoder_width == 1408
    log(f"[{tag}] model blip2_cir_align_prompt/pretrain on {DEVICE}: "
        f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f} M params, tower route "
        f"fused_block={vcfg.fused_block!r} fused_mlp={vcfg.fused_mlp}, built in "
        f"{time.perf_counter() - t0:.1f} s")
    engine.build_index(iter(gallery[:1]))  # warm-up
    sync()

    timed = {}
    inner = engine.build_index

    def build_index(batches):  # the engine's own, with a clock around it
        t0 = time.perf_counter()
        timed["index"] = inner(batches)
        sync()
        timed["encode_s"] = time.perf_counter() - t0
        return timed["index"]

    engine.build_index = build_index
    queries = validate.cirr_queries(data)
    assert len(queries["refs"]) == VALIDATE_QUERIES and all(len(g) == 6 for g in queries["groups"])
    for obj, attr in counters.values():  # count only the main path from here on
        setattr(obj, attr, 0)
    t0 = time.perf_counter()
    results = validate.evaluate_cirr(engine, iter(gallery), queries)
    sync()
    total_s = time.perf_counter() - t0
    launches = {k: getattr(obj, attr) for k, (obj, attr) in counters.items()}
    engine.build_index = inner
    index = timed["index"]

    assert list(results) == CIRR_KEYS, list(results)
    assert all(np.isfinite(v) and 0.0 <= v <= 100.0 for v in results.values()), results
    assert results["recall_at50"] >= results["recall_at10"] >= results["recall_at1"]
    assert results["group_recall_at3"] >= results["group_recall_at2"] >= results["group_recall_at1"]
    tf = index.target_feats
    assert tf.shape == (GALLERY, model.cfg.num_query_token, model.cfg.embed_dim), tf.shape
    assert bool(torch.isfinite(tf).all())
    assert bool(((tf.norm(dim=-1) - 1).abs() < 1e-3).all()), "target features are not unit norm"
    assert tuple(index.frozen_embeds.shape) == (GALLERY, vcfg.seq_len, vcfg.width)
    imgs_per_s = GALLERY / timed["encode_s"]
    log(f"[{tag}] {GALLERY} images encoded in {timed['encode_s']:.3f} s = {imgs_per_s:.2f} "
        f"imgs/s (encode_batch {ENCODE_BATCH}); {VALIDATE_QUERIES} queries scored; "
        f"{total_s:.3f} s in all")
    log(f"[{tag}] " + json.dumps({"route": route, "encode_imgs_per_s": imgs_per_s,
                                  "metrics": results}))

    # counters: the route's own kernels 39 times per image batch, the other routes' never
    log(f"[counters] launches during the {tag} path: {launches}")
    batches = len(gallery)
    for name in ROUTE_KERNELS:
        want = vcfg.depth * batches if name in own else 0
        if launches[name] != want:
            raise RuntimeError(f"{tag}: {name} launched {launches[name]}x, expected {want}")
    missing = [k for k in ("fused_qformer_layer", "token_max_sim", "gemm", "gemm_f32",
                           "attention_bf16", "attention_f32", "layer_norm") if launches[k] <= 0]
    moved = [k for k in ("fused_vit_block_i8", "fused_qformer_layer_int8", "gemm_i8",
                         "layer_norm_q8", "quantize_static", "quantize_rows") if launches[k] != 0]
    if missing or moved:
        raise RuntimeError(f"{tag}: not launched {missing}; launched from the int8 path {moved}")

    # the first gallery batch and the first 32 queries again: stage by stage,
    # then through the all-plain path on the card
    first = torch.from_numpy(gallery[0][1]).to(DEVICE)
    stage_pass(tag, f"gallery encode, {ENCODE_BATCH} images", counters,
               lambda: model.extract_target_features(first))
    with torch.inference_mode(), primitives.plain_reference():
        plain_tf, plain_frozen = model.extract_target_features(first)
    sync()
    b = ENCODE_BATCH
    err_frozen = (plain_frozen.cpu() - index.frozen_embeds[:b].float()).abs()
    err_tf = (plain_tf.float() - tf[:b]).abs()
    log(f"[{tag}] all-plain gallery encode on the card, {b} images: frozen embeds max_abs "
        f"{err_frozen.max().item():.3e} mean_abs {err_frozen.mean().item():.3e}; target feats "
        f"max_abs {err_tf.max().item():.3e} mean_abs {err_tf.mean().item():.3e}")
    assert err_frozen.max().item() <= EVA_BOUNDS["frozen"][0]
    assert err_frozen.mean().item() <= EVA_BOUNDS["frozen"][1]
    assert err_tf.max().item() <= EVA_BOUNDS["target"][0]
    assert err_tf.mean().item() <= EVA_BOUNDS["target"][1]

    refs, caps = queries["refs"][:QUERY_BATCH], queries["captions"][:QUERY_BATCH]
    tok = engine.tokenizer(caps, max_length=model.cfg.max_txt_len)
    query = (index.reference_embeds(refs).to(DEVICE), index.target_feats,
             torch.as_tensor(tok["input_ids"], device=DEVICE),
             torch.as_tensor(tok["attention_mask"], device=DEVICE))
    stage_pass(tag, f"{len(refs)} queries", counters, lambda: model.inference(*query))
    with torch.inference_mode():
        got = model.inference(*query).cpu().numpy()
        with primitives.plain_reference():
            plain = model.inference(*query).cpu().numpy()
    for k, (obj, attr) in counters.items():  # that comparison is not the main path either
        setattr(obj, attr, launches[k])
    top1_same = int((got.argmax(-1) == plain.argmax(-1)).sum())
    log(f"[{tag}] all-plain path on the card: max |score diff| {np.abs(got - plain).max():.3e} "
        f"over {got.shape}; top-1 equal on {top1_same}/{len(refs)}")
    assert np.abs(got - plain).max() <= EVA_BOUNDS["score"]
    assert top1_same >= EVA_BOUNDS["top1"]
    target_feats = tf.cpu()
    del engine, model, index, tf, first, query
    torch.cuda.empty_cache()
    return {"route": route, "launches": launches, "encode_imgs_per_s": imgs_per_s,
            "metrics": results, "target_feats": target_feats}


def check_routes_agree(runs):
    base = runs["block"]["target_feats"]
    for route, run in runs.items():
        d = (run["target_feats"] - base).abs()
        log(f"[validate] route {route} against the whole-block route, target feats of "
            f"{GALLERY} images: max_abs {d.max().item():.3e} mean_abs {d.mean().item():.3e}")
        assert d.max().item() <= ROUTE_TARGET_MAX_ABS, (route, d.max().item())
        assert d.mean().item() <= ROUTE_TARGET_MEAN_ABS, (route, d.mean().item())


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

    def entry(name, source, replaces, checks, library_ms=None, count=None):
        rs = [by_check[c] for c in checks]
        work = {"bytes": sum(r["bytes"] for r in rs),
                "op_seconds": sum(r["op_seconds"] for r in rs)}
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches[count or name],
                "max_abs_err": max(r["max_abs_err"] for r in rs),
                "ms": sum(r["ms"] for r in rs), "plain_ms": sum(r["plain_ms"] for r in rs),
                **bound_ms(work), "library_ms": library_ms}

    shapes = ("queries", "fusion", "prompt")  # K3 / K4: summed over the serving shapes
    qf_attention = [c for c in by_check if c.startswith("attention f32 qformer ")]
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
        # K6 to K8 at the shapes of the validate path (EVA ViT-g, 64 images)
        entry("fused_attn_block", "sprc_tpu_torch/ops/fused_block.py",
              "sprc_tpu/ops/pallas_block.py:640", ["K6 attn_block eva_g"]),
        entry("fused_mlp_block", "sprc_tpu_torch/ops/fused_block.py",
              "sprc_tpu/ops/pallas_mlp.py:129", ["K7 mlp_block eva_g"]),
        entry("flash_attention", "sprc_tpu_torch/csrc/attention.cu",
              "sprc_tpu/ops/pallas_attention.py:428", ["K8 flash_attention D=88"],
              library_ms=by_check["K8 flash_attention D=88"]["library_ms"]),
        # the same kernel at ViT-L's head dim: its launches are those of the int8
        # configuration's calibration pass (set-up of that main path)
        entry("flash_attention D=64", "sprc_tpu_torch/csrc/attention.cu",
              "sprc_tpu/ops/pallas_attention.py:428", ["K8 flash_attention D=64"],
              library_ms=by_check["K8 flash_attention D=64"]["library_ms"],
              count="flash_attention_calibration"),
        # the SPRC_ATTN_V variants (v4 to v11) are TPU schedules of the same
        # function: the one kernel above, its numbers again
        entry("flash_attention_variants", "sprc_tpu_torch/csrc/attention.cu",
              "sprc_tpu/ops/pallas_attention.py:84", ["K8 flash_attention D=88"],
              library_ms=by_check["K8 flash_attention D=88"]["library_ms"],
              count="flash_attention"),
        # the tiled matmul of scripts/ablate_int8.py, at its shape, in both its modes
        entry("gemm_i8", "sprc_tpu_torch/csrc/gemm_i8.cu", "scripts/ablate_int8.py:194",
              ["gemm_i8 ablate 4096^3"],
              library_ms=by_check["gemm_i8 ablate 4096^3"]["library_ms"]),
        entry("gemm", "sprc_tpu_torch/csrc/gemm.cu", "scripts/ablate_int8.py:194",
              ["gemm bf16 ablate 4096^3"],
              library_ms=by_check["gemm bf16 ablate 4096^3"]["library_ms"]),
        # the true-fp32 GEMM of K3's ten dense ops, at its largest product (the
        # image's key / value projection of the queries pass)
        entry("gemm_f32", "sprc_tpu_torch/csrc/gemm.cu", "sprc_tpu/ops/pallas_qformer.py:168",
              ["gemm f32 qformer cross kv, queries pass"],
              library_ms=by_check["gemm f32 qformer cross kv, queries pass"]["library_ms"]),
        # the chains' own kernels: the fp32 attention of K3 / K4 summed over the
        # Q-Former's five calls (beside SDPA in fp32), the LayerNorm at ViT-L's
        # encode batch in bf16 (beside F.layer_norm in bf16) and to int8
        entry("attention_f32", "sprc_tpu_torch/csrc/attention.cu",
              "sprc_tpu/ops/pallas_qformer.py:74", qf_attention,
              library_ms=sum(by_check[c]["library_ms"] for c in qf_attention)),
        entry("layer_norm", "sprc_tpu_torch/csrc/layernorm.cu", "sprc_tpu/ops/pallas_block.py:261",
              ["layer_norm vit_l bf16"], library_ms=by_check["layer_norm vit_l bf16"]["library_ms"]),
        entry("layer_norm_q8", "sprc_tpu_torch/csrc/layernorm.cu",
              "sprc_tpu/ops/pallas_block.py:417", ["layer_norm vit_l bf16 -> s8"]),
        # the quantisers at ViT-L's ctx and the image rows of an encode batch
        # (ms: the kernels' device time; no one PyTorch call computes either)
        entry("quantize_static", "sprc_tpu_torch/csrc/quantize.cu",
              "sprc_tpu/ops/pallas_block.py:417", ["quantize static vit_l ctx"]),
        entry("quantize_rows", "sprc_tpu_torch/csrc/quantize.cu",
              "sprc_tpu/ops/pallas_qformer.py:55", ["quantize rows image vit_l encode"]),
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
    eva_int8 = phase_eva_int8(gallery)
    del bf16["target_feats"], int8["target_feats"]
    runs = {route: phase_validate(work, route, gallery) for route in ROUTES}
    check_routes_agree(runs)
    log(f"[done] every phase passed in {time.perf_counter() - t_start:.1f} s")

    # each kernel's count comes from the path that is its own (K1: the first)
    launches = {**int8["launches"], **{k: bf16["launches"][k] for k in PATH_KERNELS["bf16"]},
                "flash_attention_calibration": int8["calibration_launches"]["flash_attention"]}
    for route, (_, own) in ROUTES.items():
        if route != "block":  # K2's count stays the pretrain_vitL path's
            launches.update({k: runs[route]["launches"][k] for k in own})
    keep = ("encode_imgs_per_s", "query_1_median_ms", "query_32_median_ms")
    print(json.dumps({"kernels": kernel_table(rows, launches),
                      "gemm_launches": {"bf16": launches["gemm"], "fp32": launches["gemm_f32"]},
                      "bf16": {k: bf16[k] for k in keep}, "int8": {k: int8[k] for k in keep},
                      "int8_vs_bf16_random_weights": against,
                      "int8_eva_encode_batch_launches": eva_int8,
                      "validate_pretrain": {route: {k: run[k] for k in
                                                    ("encode_imgs_per_s", "metrics", "launches")}
                                            for route, run in runs.items()}}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
