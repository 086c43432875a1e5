"""The two tensor-core kernels (bf16 GEMM, bf16 attention) alone on the card.

    python -m sprc_tpu_torch.cli.kernel_sweep [--only gemm|attention] [--no-times]

Builds the kernel library, prints what ``ptxas -v`` said about the two
kernels (registers, shared memory, spills), holds both against their plain
versions over the ragged shapes of ``kernel_checks`` (tile edges, every
epilogue, strided and BSHD layouts, a fully masked row), and then times them
at the towers' shapes beside ``F.linear`` and
``F.scaled_dot_product_attention``: one JSON line per check, with the achieved
TFLOP/s and the share of the card's bound for each tower product, both GEMM
tile widths side by side, and the host cost of one GEMM call. Ends with the
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


def ptxas_report(log_text: str) -> list:
    """(kernel, registers, spill bytes, static shared bytes) for the bf16 GEMM
    and attention kernels, from the build's ``nvcc.log``."""
    rows = []
    entries = re.split(r"ptxas info\s+: Compiling entry function '", log_text)[1:]
    for entry in entries:
        name = entry.split("'", 1)[0]
        if "gemm_bf16" not in name and "attention_bf16" not in name:
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
                                             M, N, K, _ext.BF16, _ext.ACT[act], 0, tile_n,
                                             primitives._stream()), "gemm")
                row[f"tile_{tile_n}_{act or 'none'}_ms"] = kc.cuda_ms(run, iters=20, warmup=3)
        row["linear_ms"] = kc.cuda_ms(lambda: torch.nn.functional.linear(x, w), iters=20, warmup=3)
        rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=("gemm", "attention"), default=None)
    ap.add_argument("--no-times", action="store_true", help="the checks of rightness only")
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
    if args.only != "attention":
        run("gemm bf16 edges", kc.check_gemm_edges, dev)
    if args.only != "gemm":
        run("attention bf16 edges", kc.check_attention_edges, dev)
    if not args.no_times:
        if args.only != "attention":
            run("gemm bf16 ablate 4096^3", kc.check_gemm_bf16_ablate, dev)
            for name, spec in kc.GEMM_PRODUCTS.items():
                if spec[3] == torch.bfloat16:
                    run(f"gemm {name}", kc.check_gemm, name, dev)
            run("gemm host cost", kc.check_gemm_host_cost, dev)
            for row in time_tile_widths(dev):
                print(json.dumps(row), flush=True)
        if args.only != "gemm":
            for D in (64, 88):
                run(f"K8 flash_attention D={D}", kc.check_flash_attention, D, device=dev)
                run(f"attention D={D} bf16", kc.check_attention, D, device=dev)
    for row in rows:
        if "ms" in row:
            bound = kc.bound_ms(row)
            print(json.dumps({"check": row["check"], "ms": row["ms"],
                              "library_ms": row.get("library_ms"),
                              "over_library": row["ms"] / row["library_ms"]
                              if row.get("library_ms") else None,
                              "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
                              "share_of_bound": bound["bound_ms"] / row["ms"]}), flush=True)
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
