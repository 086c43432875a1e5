"""How many of its kernels a short ``torch.profiler`` run keeps as a process
ages, and whether ``kernel_checks.device_ms`` (CUDA events over calls queued
behind a spin) reads what a whole profile reads.

    python -m sprc_tpu_torch.cli.profile_window [--minutes 3] [--load-s 20]
        [--out chiprun_out/profile_window.json]

Each round keeps the card busy ``--load-s`` seconds with bf16 products of
8192 x 8192, then, for K1 at the stage-1 fine-tune's shape (B = N = 100,
Q = 32, E = 256; about 10 us a launch), reads

- ``tight`` / ``padded``: the kernels each of ten profiles of 20 launches
  kept, the window cut tight to the work and padded (the card idle 50 ms
  before the profile, and the window 50 ms past the work's start and end),
  the two interleaved;
- ``device_ms``: ``kernel_checks.device_ms`` of a launch, and
  ``profile_ms``: the kernels' own time per launch in the first tight
  profile that kept all 20 (None where none did).

Writes one JSON object with every round's readings and the card's name and
power limit, and prints a line a round. Needs CUDA and ``nvcc``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

from sprc_tpu_torch import kernel_checks as kc
from sprc_tpu_torch.ops.sim_kernels import token_max_sim

CUDA = torch.autograd.DeviceType.CUDA
PAD_S, ITERS = 0.05, 20


def profile(fn, pad_s: float) -> list:
    """The device ms of every kernel one profile of ``ITERS`` calls kept."""
    torch.cuda.synchronize()
    time.sleep(pad_s)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        time.sleep(pad_s)
        for _ in range(ITERS):
            fn()
        torch.cuda.synchronize()
        time.sleep(pad_s)
    return [e.time_range.elapsed_us() / 1e3 for e in prof.events() if e.device_type == CUDA]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--minutes", type=float, default=3.0)
    ap.add_argument("--load-s", type=float, default=20.0)
    ap.add_argument("--out", default="chiprun_out/profile_window.json")
    args = ap.parse_args(argv)
    r = kc._Rand("cuda", 0)
    f, t = kc._unit(r, 100, 256), kc._unit(r, 100, 32, 256)
    a = r.normal(8192, 8192, dtype=torch.bfloat16)

    def k1():
        return token_max_sim(f, t)

    k1()  # builds the library
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    t_start, rounds = time.perf_counter(), []
    while time.perf_counter() - t_start < args.minutes * 60:
        t_load = time.perf_counter()
        while time.perf_counter() - t_load < args.load_s:
            for _ in range(50):
                a.copy_(a @ a * 1e-4)
            torch.cuda.synchronize()
        row = {"s": time.perf_counter() - t_start, "tight": [], "padded": [], "profile_ms": None}
        for _ in range(10):
            tight = profile(k1, 0.0)
            row["tight"].append(len(tight))
            if len(tight) == ITERS and row["profile_ms"] is None:
                row["profile_ms"] = sum(tight) / ITERS
            row["padded"].append(len(profile(k1, PAD_S)))
        row["device_ms"] = kc.device_ms(k1)[0]
        rounds.append(row)
        print(json.dumps(row), flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump({"card": card, "rounds": rounds}, fh)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
