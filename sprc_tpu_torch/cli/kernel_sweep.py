"""The kernels redesigned for Hopper alone on the card: the bf16 GEMM, the s8
GEMM, the true-fp32 GEMM, the bf16 and fp32 attention, the LayerNorm, the
two activation quantisers and K1 (token-max similarity).

    python -m sprc_tpu_torch.cli.kernel_sweep
        [--only gemm|gemm_i8|gemm_f32|attention|attention_f32|layernorm|quantize|sim]
        [--no-times] [--baseline-sim SRC ...]

Builds the kernel library, prints what ``ptxas -v`` said about those kernels
(registers, shared memory, spills), holds them against their plain versions
over the ragged shapes of ``kernel_checks`` (tile edges, every epilogue and
output mode, strided and BSHD layouts, a fully masked row), and then times
them at the main paths' shapes beside the one PyTorch call that computes the
same function (``F.linear``, ``torch._int_mm``,
``F.scaled_dot_product_attention``, ``F.layer_norm``; the fp32 attention and
LayerNorm rows also with both sides' device times from ``torch.profiler`` and
the names of the kernels SDPA ran; the quantisers, which no one PyTorch call
computes, by their device times at every call of ``kernel_checks.QUANT_CALLS``
with the instantiation each call takes; K1 at the galleries of
``kernel_checks.SIM_SWEEP`` by its device time, beside ``F.linear`` + ``amax``
and, with ``--baseline-sim``, other ``token_max_sim.cu`` files built alone from
SRC ... and timed on the same inputs; then the card's ``mma.sync`` tf32 rate,
``csrc/probes/mma_tf32_rate.cu``): one JSON line per check, with the
achieved TFLOP/s or TOP/s and the share of the card's bound for each
product, every tile the kernel is built with side by side (whatever its plan
would choose), and the host cost of one call of each GEMM. Ends with the
card's name and power limit. Needs CUDA and ``nvcc``; exits nonzero when a
check fails.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time

import torch


KERNELS = ("gemm_bf16", "gemm_i8", "gemm_f32", "attention_bf16", "attention_f32", "layernorm",
           "quantize", "token_max_sim", "mma_tf32_rate")


def ptxas_report(log_text: str) -> list:
    """(kernel, registers, spill bytes, static shared bytes) for the kernels
    of :data:`KERNELS`, from the build's ``nvcc.log``."""
    rows = []
    entries = re.split(r"ptxas info\s+: Compiling entry function '", log_text)[1:]
    for entry in entries:
        name = entry.split("'", 1)[0]
        if not any(k in name for k in KERNELS):
            continue
        regs = re.search(r"Used (\d+) registers", entry)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", entry)
        smem = re.search(r"(\d+) bytes smem", entry)
        stack = re.search(r"(\d+) bytes stack frame", entry)
        rows.append({"kernel": name, "stack_frame": int(stack.group(1)) if stack else None, "registers": int(regs.group(1)) if regs else None,
                     "spill_stores": int(spill.group(1)) if spill else None,
                     "spill_loads": int(spill.group(2)) if spill else None,
                     "static_smem": int(smem.group(1)) if smem else 0})
    return rows


def time_tile_widths(device: str) -> list:
    """Both tile widths of the bf16 GEMM on the tower's products, whatever the
    plan would choose, without bias or residual and with each activation,
    beside ``F.linear``."""
    from sprc_tpu_torch import kernel_checks as kc
    from sprc_tpu_torch.ops import _ext, primitives

    lib = _ext.library()
    rows = []
    gen = torch.Generator(device=device).manual_seed(0)
    for name, (M, N, K, dtype, _) in kc.GEMM_PRODUCTS.items():
        if dtype != torch.bfloat16:
            continue
        x = torch.empty(M, K, device=device).normal_(generator=gen).to(dtype)
        w = torch.empty(N, K, device=device).normal_(0, 0.02, generator=gen).to(dtype)
        y = torch.empty(M, N, device=device, dtype=dtype)
        row = {"product": name, "M": M, "N": N, "K": K}
        for tile_n in (128, 256):
            for act in (None, "quick_gelu", "gelu"):
                def run():
                    _ext.check(lib.sprc_gemm(x.data_ptr(), w.data_ptr(), None, None, y.data_ptr(),
                                             M, N, K, _ext.BF16, _ext.ACT[act], 0, 128, tile_n,
                                             primitives._stream()), "gemm")
                row[f"tile_{tile_n}_{act or 'none'}_ms"] = kc.cuda_ms(run, iters=20, warmup=3)
        row["linear_ms"] = kc.cuda_ms(lambda: torch.nn.functional.linear(x, w), iters=20, warmup=3)
        rows.append(row)
    return rows


def time_i8_tiles(device: str) -> list:
    """Both tile widths of the s8 GEMM on every product of
    ``GEMM_I8_PRODUCTS``, raw (s32 out; the wide tile is built only for the
    raw, bf16 and int8 outputs without an activation) and, on the narrow
    tile, with the main path's output type, beside ``torch._int_mm`` and the
    TOP/s of each."""
    from sprc_tpu_torch import kernel_checks as kc
    from sprc_tpu_torch.ops import _ext, primitives

    lib = _ext.library()
    rows = []
    gen = torch.Generator(device=device).manual_seed(0)
    for name, (M, N, K, epilogue) in kc.GEMM_I8_PRODUCTS.items():
        a8 = torch.randint(-127, 128, (M, K), generator=gen, device=device).to(torch.int8)
        w8 = torch.randint(-127, 128, (N, K), generator=gen, device=device).to(torch.int8)
        cs = torch.rand(N, generator=gen, device=device) * 1e-4
        y32 = torch.empty(M, N, device=device, dtype=torch.int32)
        row = {"product": name, "M": M, "N": N, "K": K}
        for tile_n in (128, 256):
            def run():
                _ext.check(lib.sprc_gemm_i8(a8.data_ptr(), w8.data_ptr(), None, None, None, None,
                                            y32.data_ptr(), M, N, K, _ext.OUT_S32, 0,
                                            0.0, 1.0, tile_n, primitives._stream()), "gemm_i8")
            ms = kc.cuda_ms(run, iters=20, warmup=3)
            row[f"tile_{tile_n}_s32_ms"] = ms
            row[f"tile_{tile_n}_s32_tops"] = 2 * M * N * K / (ms * 1e-3) / 1e12
        if epilogue is not None:
            out = {"f32": _ext.OUT_F32, "s8": _ext.OUT_S8}.get(epilogue.split("->")[-1],
                                                               _ext.OUT_BF16)
            dt = {_ext.OUT_F32: torch.float32, _ext.OUT_S8: torch.int8}.get(out, torch.bfloat16)
            y = torch.empty(M, N, device=device, dtype=dt)

            def run_epilogue():
                _ext.check(lib.sprc_gemm_i8(a8.data_ptr(), w8.data_ptr(), None, cs.data_ptr(),
                                            None, None, y.data_ptr(), M, N, K, out, 0, 20.0, 1.0,
                                            128, primitives._stream()), "gemm_i8")
            row["tile_128_out_ms"] = kc.cuda_ms(run_epilogue, iters=20, warmup=3)
        wt = w8.t()
        row["int_mm_ms"] = kc.cuda_ms(lambda: torch._int_mm(a8, wt), iters=20, warmup=3)
        rows.append(row)
    return rows


def time_f32_tiles(device: str) -> list:
    """Every block tile of the fp32 GEMM on every product of
    ``GEMM_F32_PRODUCTS`` (bias only), beside the one its plan chooses and
    ``F.linear``, with the TFLOP/s of each."""
    from sprc_tpu_torch import kernel_checks as kc
    from sprc_tpu_torch.ops import _ext, primitives, schedules

    lib = _ext.library()
    rows = []
    gen = torch.Generator(device=device).manual_seed(0)
    for name, (M, N, K, _) in kc.GEMM_F32_PRODUCTS.items():
        x = torch.empty(M, K, device=device).normal_(generator=gen)
        w = torch.empty(N, K, device=device).normal_(0, 0.02, generator=gen)
        b = torch.empty(N, device=device).normal_(0, 0.02, generator=gen)
        y = torch.empty(M, N, device=device)
        plan = schedules.gemm_f32_plan(M, N, K)
        row = {"product": name, "M": M, "N": N, "K": K,
               "plan": f"{plan['tile_m']}x{plan['tile_n']}"}
        for tm, tn in schedules.GEMM_F32_TILES:
            def run():
                _ext.check(lib.sprc_gemm(x.data_ptr(), w.data_ptr(), b.data_ptr(), None,
                                         y.data_ptr(), M, N, K, _ext.F32, 0, 0, tm, tn,
                                         primitives._stream()), "gemm")
            ms = kc.cuda_ms(run, iters=20, warmup=3)
            row[f"tile_{tm}x{tn}_ms"] = ms
            row[f"tile_{tm}x{tn}_tflops"] = 2 * M * N * K / (ms * 1e-3) / 1e12
        row["linear_ms"] = kc.cuda_ms(lambda: torch.nn.functional.linear(x, w, b), iters=20,
                                      warmup=3)
        rows.append(row)
    return rows


def baseline_sim(src: str, index: int):
    """Another ``token_max_sim.cu`` (its C entry ``sprc_token_max_sim`` with
    the same signature; e.g. the parent commit's) built alone with the
    library's flags; prints its ``ptxas`` report and returns that C entry."""
    from sprc_tpu_torch.ops import _ext

    name = "sprc_token_max_sim"
    lib, log = _ext.build_alone(src, f"baseline_sim{index}", {name: _ext._SIGNATURES[name]})
    for row in ptxas_report(log):
        print(json.dumps({"baseline": src, **row}), flush=True)
    return getattr(lib, name)


def mma_tf32_rate(device: str) -> list:
    """The card's issue rate of ``mma.sync.m16n8k8`` tf32
    (``csrc/probes/mma_tf32_rate.cu``: nothing but the products, into 4 or 8
    independent accumulators a warp) at 8 warps a block and 2 or 4 blocks an
    SM (K1's 2 x 8 among them): products a microsecond, TFLOP/s (2,048
    operations a product) and the share of the card's TF32 rate."""
    import ctypes

    from sprc_tpu_torch import kernel_checks as kc
    from sprc_tpu_torch.ops import _ext

    src = _ext.CSRC / "probes" / "mma_tf32_rate.cu"
    lib, log = _ext.build_alone(src, "probe_mma_tf32",
                                {"sprc_probe_mma_tf32": [ctypes.c_void_p] + [ctypes.c_int] * 4
                                 + [ctypes.c_void_p]})
    for row in ptxas_report(log):
        print(json.dumps(row), flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    rows, warps, iters = [], 8, 4096
    for per_sm, acc in ((2, 8), (2, 4), (4, 8)):
        blocks = sms * per_sm
        out = torch.empty(blocks * warps * 32, device=device)

        def launch():
            _ext.check(lib.sprc_probe_mma_tf32(out.data_ptr(), blocks, warps, iters, acc, stream),
                       "mma_tf32_rate")
        ms = kc.cuda_ms(launch, iters=5)
        mma = blocks * warps * iters * acc
        rows.append({"check": "mma.sync m16n8k8 tf32 rate", "blocks_per_sm": per_sm,
                     "warps_per_block": warps, "accumulators_per_warp": acc, "ms": ms,
                     "mma_per_us": mma / (ms * 1e3), "tflops": mma * 2048 / ms / 1e9,
                     "share_of_tf32_peak": mma * 2048 / (ms * 1e-3) / kc.PEAK_OPS["tf32"]})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=None, choices=(
        "gemm", "gemm_i8", "gemm_f32", "attention", "attention_f32", "layernorm", "quantize",
        "sim"))
    ap.add_argument("--no-times", action="store_true", help="the checks of rightness only")
    ap.add_argument("--baseline-sim", nargs="+", default=(), metavar="SRC",
                    help="token_max_sim.cu files (same C entry) to build alone and time beside K1")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("kernel_sweep: needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from sprc_tpu_torch import kernel_checks as kc
    from sprc_tpu_torch.ops import _ext

    t0 = time.perf_counter()
    _ext.build()
    _ext.library()
    print(json.dumps({"build_s": time.perf_counter() - t0}), flush=True)
    log_text = (_ext.BUILD_DIR / "nvcc.log").read_text()
    for row in ptxas_report(log_text):
        print(json.dumps(row), flush=True)
    for line in sorted({ln.strip() for ln in log_text.splitlines()
                        if "warning" in ln.lower() or "wgmma" in ln or "setmaxnreg" in ln}):
        print(json.dumps({"nvcc": line}), flush=True)

    rows = []

    def run(check, fn, *a, **kw):
        row = dict(check=check, **fn(*a, **kw))
        row.pop("stages", None)
        rows.append(row)
        print(json.dumps(row), flush=True)

    dev = "cuda"

    def on(what):
        return args.only in (None, what)

    if on("gemm"):
        run("gemm bf16 edges", kc.check_gemm_edges, dev)
    if on("gemm_f32"):
        run("gemm f32 edges", kc.check_gemm_edges, dev, dtype=torch.float32)
    if on("gemm_i8"):
        run("gemm_i8 edges", kc.check_gemm_i8_edges, dev)
    if on("attention"):
        run("attention bf16 edges", kc.check_attention_edges, dev)
    if on("attention_f32"):
        run("attention f32 edges", kc.check_attention_f32_edges, dev)
    if on("layernorm"):
        run("layer_norm edges", kc.check_layer_norm_edges, dev)
    if on("quantize"):
        run("quantizer edges", kc.check_quantizer_edges, dev)
    if on("sim"):
        run("token_max_sim edges", kc.check_token_max_sim_edges, dev)
        run("token_max_sim plan", kc.check_token_max_sim_plan, dev)
    if not args.no_times:
        if on("gemm"):
            run("gemm bf16 ablate 4096^3", kc.check_gemm_bf16_ablate, dev)
            for name in kc.GEMM_PRODUCTS:
                run(f"gemm {name}", kc.check_gemm, name, dev)
            for row in time_tile_widths(dev):
                print(json.dumps(row), flush=True)
        if on("gemm_i8"):
            for name in kc.GEMM_I8_PRODUCTS:
                run(f"gemm_i8 {name}", kc.check_gemm_i8, name, dev)
            for row in time_i8_tiles(dev):
                print(json.dumps(row), flush=True)
        if on("gemm_f32"):
            for row in kc.run_qformer_fp32(dev):
                row.pop("stages", None)
                rows.append(row)
                print(json.dumps(row), flush=True)
            for row in time_f32_tiles(dev):
                print(json.dumps(row), flush=True)
        if any(on(k) for k in ("gemm", "gemm_i8", "gemm_f32")):
            run("gemm host cost", kc.check_gemm_host_cost, dev)
        if on("attention"):
            for D in (64, 88):
                run(f"K8 flash_attention D={D}", kc.check_flash_attention, D, device=dev)
                run(f"attention D={D} bf16", kc.check_attention, D, device=dev)
        if on("attention_f32"):
            for row in kc.run_attention_f32(dev):
                rows.append(row)
                print(json.dumps(row), flush=True)
        if on("layernorm"):
            for row in kc.run_layer_norm(dev):
                rows.append(row)
                print(json.dumps(row), flush=True)
            run("library yardsticks", kc.check_library_yardsticks, dev)
        if on("quantize"):
            for row in kc.run_quantize(dev):
                rows.append(row)
                print(json.dumps(row), flush=True)
        if on("sim"):
            baseline = {src: baseline_sim(src, i) for i, src in enumerate(args.baseline_sim)}
            for row in kc.run_token_max_sim_sweep(dev, baseline):
                rows.append(row)
                print(json.dumps(row), flush=True)
            for row in mma_tf32_rate(dev):
                print(json.dumps(row), flush=True)
    for row in rows:
        if "ms" in row:
            bound = kc.bound_ms(row)
            print(json.dumps({"check": row["check"], "ms": row["ms"],
                              "library_ms": row.get("library_ms"),
                              "device_ms": row.get("device_ms"),
                              "library_device_ms": row.get("library_device_ms"),
                              "over_library": row["ms"] / row["library_ms"]
                              if row.get("library_ms") else None,
                              "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
                              "share_of_bound": bound["bound_ms"] / row["ms"],
                              "device_share_of_bound": bound["bound_ms"] / row["device_ms"]
                              if row.get("device_ms") else None,
                              **{k: row[k] for k in ("plain_device_ms", "baseline_ms",
                                                     "yardstick_ms", "tf32x3_ms") if k in row},
                              **({"mma_per_us": row["mma"] / (row["device_ms"] * 1e3)}
                                 if "mma" in row else {})}),
                  flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip(), flush=True)
    bad = [r["check"] for r in rows if not r["ok"]]
    if bad:
        print(json.dumps({"failed": bad}), flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
