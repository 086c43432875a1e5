"""Where the serving path's time goes on one GPU.

    python -m sprc_tpu_torch.cli.profile_serving [--model-type pretrain|pretrain_vitL]
        [--fused-block block|attn|none] [--fused-mlp] [--int8] [--gallery N] [--out DIR]

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

With ``--int8`` the model is the int8 serving configuration (the tower's
activation scales calibrated on 16 seeded images, ``vit_quant="int8_static"``,
``qformer_int8=True``); the tower's rate is then its dense integer
operations over the int8 GEMM time. ``other_kernels`` lists every device
kernel that is not one of the port's own, with its launches and time: the
patch convolution and the ``vision_proj`` / ``text_proj`` products are
PyTorch calls, and no other library GEMM may appear there.

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


def _group(name: str) -> str:
    for key, label in GROUPS:
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


def _profile(fn, name: str, out: str) -> dict:
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
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        label = _group(evt.name)
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
    args = ap.parse_args(argv)
    suffix = "".join(f"_{part}" for part, on in (
        (args.model_type, args.model_type != "pretrain_vitL"),
        (args.fused_block, args.fused_block != "block"), ("mlp", args.fused_mlp),
        ("int8", args.int8), (f"gallery{args.gallery}", args.gallery != GALLERY)) if on)
    args.out = args.out or "sprc_tpu_torch/_build/profile" + suffix
    if not torch.cuda.is_available():
        sys.exit("profile_serving: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from sprc_tpu_torch.loader import calibrate_vit_act_scales, load_model
    from sprc_tpu_torch.ops import primitives
    from sprc_tpu_torch.ops.layers import l2_normalize
    from sprc_tpu_torch.utils.artifacts import synthetic_calibration_images

    os.makedirs(args.out, exist_ok=True)
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
    with open(os.path.join(args.out, "profile.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
