"""Each Hopper kernel against its plain PyTorch version on the card, at the
shapes the serving path gives it: gallery encode in batches of
:data:`ENCODE_BATCH` images, queries in batches of :data:`QUERY_BATCH`
against a gallery of :data:`GALLERY` images.

Used by ``chip_smoke.py`` and ``tests/test_torch_kernels*_cuda.py``. Every
check draws its inputs from a seeded generator on the device, runs the
kernel wrapper and the plain version on the same tensors, and returns a row
with the errors, both times (CUDA events, mean over ``iters`` launches after
a warm-up) and ``ok``; the tolerances are stated beside each check.

A chain of blocks or layers is held stage by stage
(:class:`StageRecorder` inside ``primitives.stage_check``): every kernel
launch of the chain is compared with its plain version on the inputs the
kernel run gave it. Two free-running int8 chains drift apart, because a
value that differs in its last bit flips a code at a half step and the flip
feeds the next quantiser, so a bound on their final difference can tell
little; held stage by stage they cannot drift, and each stage is held as
tightly as the primitive alone (:data:`STAGE_BOUNDS`).

The kernels redesigned for Hopper (the bf16, s8 and fp32 GEMMs, the bf16 and
fp32 attention, the LayerNorm, the two quantisers and K1) are also run over
ragged shapes (:func:`run_edges`): a fault at a tile edge shows only there,
not at the towers' shapes.

A timed row also carries the work of its call, from the shapes alone:
``bytes`` (each input read once, each output written once) and
``op_seconds`` (its operations over the card's peak rate for their type,
:data:`PEAK_OPS`, summed over the types). :func:`bound_ms` turns them into
the least time the card could take. Where one PyTorch call computes the same
function, ``library_ms`` is that call's time on the same inputs; the port
itself never makes that call. The fp32 attention and LayerNorm rows also
carry ``device_ms`` / ``library_device_ms``: the calls' time on the
device's clock with the host's pace out of it (:func:`device_ms`), which a
loop through a Python wrapper hides where the host's cost of a call exceeds
its kernel; the quantisers'
rows (:func:`check_quantize`) take it as their ``ms``, and K1's
(:func:`check_token_max_sim`) carry it beside the wrapper loop's ``ms``.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List

import numpy as np
import torch

from sprc_tpu_torch.ops import primitives, quant, schedules
from sprc_tpu_torch.ops.attention import FlashAttention, flash_attention
from sprc_tpu_torch.ops.fused_block import (FusedAttnBlock, FusedMlpBlock, FusedViTBlock,
                                            fused_attn_block, fused_attn_block_plain,
                                            fused_mlp_block, fused_mlp_block_plain,
                                            fused_vit_block, fused_vit_block_i8,
                                            fused_vit_block_i8_plain, fused_vit_block_plain)
from sprc_tpu_torch.ops.fused_qformer import (fused_qformer_layer, fused_qformer_layer_plain,
                                              quantize_layer_params)
from sprc_tpu_torch.ops.layers import recompute
from sprc_tpu_torch.ops.sim_kernels import TokenMaxSim, token_max_sim, token_max_sim_plain

# the main path's batches: what chip_smoke.py drives and the engine's defaults
ENCODE_BATCH, QUERY_BATCH, GALLERY = 64, 32, 512

# NVIDIA H100 SXM data sheet, dense rates: operations per second by type, and
# bytes per second of HBM3
PEAK_OPS = {"int8": 1979e12, "bf16": 989e12, "tf32": 495e12, "fp32": 67e12}
PEAK_BYTES = 3.35e12


def bound_ms(row: dict) -> Dict[str, object]:
    """The least time the card could take for a row's work, and which of the
    two limits sets it."""
    by_bytes, by_ops = row["bytes"] / PEAK_BYTES, row["op_seconds"]
    return {"bound_ms": max(by_bytes, by_ops) * 1e3,
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def cuda_ms(fn: Callable[[], object], iters: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# the clock rate at which device_ms reckons its hold on the stream (the H100
# SXM's boost clock, cycles a second; a slower clock holds it longer)
HOLD_HZ = 1.98e9


def device_ms(fn: Callable[[], object], iters: int = 20, warmup: int = 2) -> tuple:
    """(device ms per call of ``fn``, the kernels that one ``torch.profiler``
    run of a call saw, by name, with the mean device ms of one launch).

    The time is read on the device's clock with the host's pace out of it:
    a spin (``torch.cuda._sleep``) holds the stream while the host queues
    the ``iters`` calls, and two CUDA events time the calls from the spin's
    end, back to back (the gaps between dependent kernels included;
    ``cuda_ms`` over a loop measures the host where a call's host cost
    exceeds its kernel). The spin lasts twice the host's time for the calls
    and doubles until the start event is still pending once every call is
    queued; after four tries it raises, so that no host-paced time stands in
    for the device's. The profile only names the kernels: a profile loses
    launches at random (``cli/profile_window.py``), so its counts give no
    time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    hold_s = max(2 * (time.perf_counter() - t0), 1e-3)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(4):
        torch.cuda._sleep(int(hold_s * HOLD_HZ))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        queued = not start.query()
        torch.cuda.synchronize()
        if queued:
            break
        hold_s *= 2
    else:
        raise RuntimeError(f"device_ms: the host did not queue {iters} calls within a hold "
                           f"of {hold_s / 2:.3f} s")
    launches: Dict[str, List[float]] = {}
    for _ in range(3):  # a profile that saw no kernel is taken again
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        for evt in prof.events():
            if evt.device_type == torch.autograd.DeviceType.CUDA:
                launches.setdefault(evt.name, []).append(evt.time_range.elapsed_us() / 1e3)
        if launches:
            break
    return (start.elapsed_time(end) / iters,
            {name: sum(ms) / len(ms) for name, ms in launches.items()})


def profile_decode_step(step: Callable[[], tuple], iters: int = 20) -> Dict[str, float]:
    """One cached decode step of an LLM head, the host's pace against the
    device's. ``host_ms``: the wall time a step when steps run back to back,
    as the decode loop runs them (one synchronisation at the end);
    ``device_ms``: the device's time a step with no host in the way, the
    step captured once in a CUDA graph and the graph replayed ``iters``
    times between two CUDA events (:func:`device_ms`'s spin cannot hold
    decode steps: on an H100 the host was still queueing 20 of them, some
    30,000 launches, when an 8.5 s spin ended);
    ``graph_max_abs``: the replay's first output against the step's;
    ``busy_share``: ``device_ms / host_ms``; ``aten_ops``: the ATen
    operators one step dispatches, of them ``aten_views`` views, which queue
    no kernel; ``kernels_profiled`` / ``kernel_ms_profiled``: the launches
    one ``torch.profiler`` run of a step saw and their summed device time (a
    floor: a profile can lose launches on the card), ``top_kernels`` the five
    kernel names of most time there (name, launches, ms). ``step`` must give the
    same result every call, as a decode step at a fixed position does (it
    rewrites its cache slot with the same values)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        ops = views = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops += 1
            self.views += bool(getattr(func, "is_view", False))
            return func(*args, **(kwargs or {}))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture's stream, as CUDA graphs ask
        for _ in range(2):
            want = step()[0].clone()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        step()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / iters * 1e3
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = step()[0]
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    dev_ms = start.elapsed_time(end) / iters
    graph_err = (got.float() - want.float()).abs().max().item()
    del graph
    with Count() as count:
        step()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    by_name: Dict[str, List[float]] = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            by_name.setdefault(evt.name, []).append(evt.time_range.elapsed_us() / 1e3)
    top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:5]
    return {"host_ms": host_ms, "device_ms": dev_ms, "graph_max_abs": graph_err,
            "busy_share": dev_ms / host_ms, "aten_ops": count.ops, "aten_views": count.views,
            "kernels_profiled": sum(len(ms) for ms in by_name.values()),
            "kernel_ms_profiled": sum(sum(ms) for ms in by_name.values()),
            "top_kernels": [(name[:80], len(ms), sum(ms)) for name, ms in top]}


def _errors(got: torch.Tensor, want: torch.Tensor) -> Dict[str, float]:
    d = (got.float() - want.float()).abs()
    return {"max_abs_err": d.max().item(), "mean_abs_err": d.mean().item(),
            "finite": bool(torch.isfinite(got).all().item())}


class _Rand:
    def __init__(self, device, seed: int):
        self.device = device
        self.gen = torch.Generator(device=device).manual_seed(seed)

    def normal(self, *shape, std=1.0, mean=0.0, dtype=torch.float32):
        t = torch.empty(shape, device=self.device).normal_(mean, std, generator=self.gen)
        return t.to(dtype)


# ------------------------------------------------- a chain, stage by stage

_TYPE = {torch.int8: "s8", torch.bfloat16: "bf16", torch.float32: "f32"}

# kind of stage -> (the largest share of a call's elements that may differ
# from the plain version on the same inputs, the largest difference: in
# codes for an int8 output, else relative to the call's largest |plain
# value|). A stage that repeats the plain version's fp32 roundings step by
# step is held equal: the s8 GEMM's f32 and bf16 epilogues and the two
# quantisers. The others are held at 2 to 4 times the worst reading over the
# main path's real activations (chip_smoke.py) and the random chains below,
# on an H100; the reading stands beside each bound. One bf16 step at the top
# of a call's range is 2^-8 to 2^-7 = 3.9e-3 to 7.8e-3 in these units.
STAGE_BOUNDS = {
    # the int8 chains
    "gemm_i8 -> bf16": (0.0, 0.0),           # 0, 0
    "gemm_i8 -> f32": (0.0, 0.0),            # 0, 0 (exact GELU included)
    "gemm_i8 -> s8": (1.5e-6, 1),            # 3.6e-7, by one code: expf against sigmoid
    "quantize_static -> s8": (0.0, 0),       # 0, 0
    "quantize_rows codes": (0.0, 0),         # 0, 0
    "quantize_rows scales": (0.0, 0.0),      # 0, 0
    "layer_norm -> s8": (5e-6, 1),           # 1.4e-6, by one code: the row sum's order
    # shared with the bf16 / fp32 chains
    "attention -> bf16": (1.0, 1.6e-2),      # 0.49, 7.6e-3: one bf16 step; held to two
    "attention -> f32": (1.0, 5e-6),         # 0.93, 1.3e-6
    "layer_norm -> bf16": (5e-5, 7.9e-3),    # 1.2e-5, 3.0e-3: one bf16 step
    "layer_norm -> f32": (1.0, 1e-6),        # 0.50, 2.3e-7
    "gemm -> bf16": (0.75, 1.6e-2),          # 0.26, 6.7e-3: plain rounds twice (product, then bias)
    "gemm -> f32": (1.0, 1.5e-5),            # 0.97, 3.8e-6
    # the MLP kernel's fc2: the residual joins the fp32 sum before the one
    # rounding; plain rounds the product first, so a bf16 step apart as above
    "gemm, fp32 residual -> bf16": (0.75, 1.6e-2),   # 0.29, 7.2e-3
    "gemm, fp32 residual -> f32": (1.0, 1.5e-5),     # 0.96, 2.5e-6
    # head dim 88 (EVA ViT-g): the head padded to 96 with zero lanes
    "attention D=88 -> bf16": (1.0, 1.6e-2),         # 0.49, 7.7e-3: one bf16 step, as at D=64
    "attention D=88 -> f32": (1.0, 5e-6),            # 0.93, 1.2e-6
    # flash_attention: the kernel rounds the unnormalised probabilities and
    # divides after P V, its plain version normalises first (the Pallas v3):
    # one bf16 step, as for "attention" (the same kernel and the same order)
    "flash_attention -> bf16": (1.0, 1.6e-2),        # 0.49, 5.2e-3
    "flash_attention -> f32": (1.0, 5e-6),           # 0.93, 1.2e-6
    "flash_attention D=88 -> bf16": (1.0, 1.6e-2),   # 0.49, 7.7e-3
    "flash_attention D=88 -> f32": (1.0, 5e-6),      # 0.93, 5.9e-7
}


class StageRecorder:
    """The ``record`` of ``primitives.stage_check``: per kind of stage (the
    primitive and its output type), the calls, and over them the worst share
    of elements that differ and the worst difference, in the units of
    :data:`STAGE_BOUNDS`."""

    def __init__(self):
        self.stats: Dict[str, dict] = {}

    def __call__(self, name: str, got, want) -> None:
        if isinstance(got, tuple):  # quantize_rows
            self.add(f"{name} codes", got[0], want[0])
            self.add(f"{name} scales", got[1], want[1])
        else:
            self.add(f"{name} -> {_TYPE[got.dtype]}", got, want)

    def add(self, kind: str, got: torch.Tensor, want: torch.Tensor) -> None:
        d = (got.float() - want.float()).abs()
        differ, worst, top = torch.stack(
            [(d > 0).float().mean(), d.max(), want.float().abs().max()]).tolist()
        err = worst if got.dtype == torch.int8 else worst / max(top, 1e-30)
        s = self.stats.setdefault(kind, {"calls": 0, "differ": 0.0, "err": 0.0})
        s["calls"] += 1
        s["differ"], s["err"] = max(s["differ"], differ), max(s["err"], err)

    def rows(self) -> List[dict]:
        """One row per kind: ``kind``, ``calls``, ``differ``, ``err`` and
        ``ok`` (a kind without a bound fails)."""
        out = []
        for kind, s in sorted(self.stats.items()):
            share, err = STAGE_BOUNDS.get(kind, (-1.0, -1.0))
            out.append({"kind": kind, **s, "ok": s["differ"] <= share and s["err"] <= err})
        return out

    def describe(self) -> str:
        return "; ".join(f"{r['kind']} x{r['calls']}: differ {r['differ']:.1e} err {r['err']:.1e}"
                         f"{'' if r['ok'] else ' FAIL'}" for r in self.rows())

    def ok(self) -> bool:
        return bool(self.stats) and all(r["ok"] for r in self.rows())


# ------------------------------------------------------------------- K1


def _unit(r: _Rand, *shape) -> torch.Tensor:
    """L2-normalised rows, as the model's projections emit them."""
    return torch.nn.functional.normalize(r.normal(*shape), dim=-1)


def _sim_yardstick(f: torch.Tensor, t: torch.Tensor) -> Callable[[], object]:
    """``F.linear`` over the gallery's tokens, then ``amax``: two PyTorch
    calls, a yardstick beside K1, not a library call computing its function."""
    flat = t.view(-1, t.shape[-1])
    return lambda: torch.nn.functional.linear(f, flat).view(f.shape[0], t.shape[0], -1).amax(-1)


def check_token_max_sim(device="cuda", B=QUERY_BATCH, N=GALLERY, Q=32, E=256, seed=0,
                        baseline=None, plain=True) -> dict:
    """K1 in fp32 against its plain version: atol 1e-4 and the same top-10
    order per query (and 1e-5, the edge check's bound, reported as
    ``within_1e-5``). ``ms`` and ``plain_ms`` are loops through the wrapper
    and the plain version timed with CUDA events, as every other kernel's
    row; ``device_ms`` and ``plain_device_ms`` their device times
    (:func:`device_ms`: at small galleries the host's cost of a call, about
    30 us, exceeds the kernel's, and the loop times the host);
    ``tf32x3_ms`` the products' time at the card's TF32 rate, three products
    each (what the tensor cores must do in 3xTF32: a tighter operations
    bound than ``op_seconds``' fp32 rate); beside them the device time of
    ``F.linear`` + ``amax`` in fp32 (``yardstick_ms``; two calls, so
    ``library_ms`` stays null) and, for each entry of ``baseline``
    (name -> a C entry with ``sprc_token_max_sim``'s signature), that
    kernel's device time and its difference from K1 on the same inputs
    (``baseline_ms``, ``baseline_max_abs_err``: dicts by name).
    ``plain=False`` skips the plain version's time (its ``[B, N, Q]``
    product at the largest galleries)."""
    r = _Rand(device, seed)
    f = _unit(r, B, E)
    t = _unit(r, N, Q, E)
    with torch.inference_mode():
        got = token_max_sim(f, t)
        want = token_max_sim_plain(f, t)
        torch.cuda.synchronize()
        row = _errors(got, want)
        k = min(10, N)
        top_k = torch.sort(got, dim=-1, descending=True, stable=True).indices[:, :k]
        top_p = torch.sort(want, dim=-1, descending=True, stable=True).indices[:, :k]
        row["top10_equal"] = bool(torch.equal(top_k, top_p))
        del want
        row["ms"] = cuda_ms(lambda: token_max_sim(f, t))
        row["device_ms"], row["device_kernels"] = device_ms(lambda: token_max_sim(f, t))
        row["plain_ms"] = cuda_ms(lambda: token_max_sim_plain(f, t)) if plain else None
        row["plain_device_ms"] = device_ms(lambda: token_max_sim_plain(f, t))[0] if plain else None
        row["yardstick_ms"] = device_ms(_sim_yardstick(f, t))[0]
        stream = torch.cuda.current_stream().cuda_stream
        for name, entry in (baseline or {}).items():
            out = torch.empty_like(got)

            def other(entry=entry, out=out):
                code = entry(f.data_ptr(), t.data_ptr(), out.data_ptr(), B, N, Q, E, stream)
                if code:
                    raise RuntimeError(f"{name}: cudaError {code}")
            other()
            torch.cuda.synchronize()
            row.setdefault("baseline_max_abs_err", {})[name] = (out - got).abs().max().item()
            row.setdefault("baseline_ms", {})[name] = device_ms(other)[0]
    row["library_ms"] = None
    row["within_1e-5"] = row["max_abs_err"] <= 1e-5
    row["ok"] = row["finite"] and row["max_abs_err"] <= 1e-4 and row["top10_equal"]
    row["plan"] = plan = schedules.token_max_sim_plan(B, N, Q, E)
    # the kernel's mma.sync m16n8k8: 3 a k-step for each m16 and n8 tile
    row["mma"] = 3 * plan["ksteps"] * plan["mtiles"] * -(-Q // 8) * plan["tiles"] * N
    row["shape"] = f"B={B} N={N} Q={Q} E={E} fp32"
    row["bytes"] = 4 * (B * E + N * Q * E + B * N)
    row["op_seconds"] = 2 * B * N * Q * E / PEAK_OPS["fp32"]
    row["tf32x3_ms"] = 3 * 2 * B * N * Q * E / PEAK_OPS["tf32"] * 1e3
    return row


# the edge check's shapes: query batches around the 32-row tile, galleries
# from one item to CIRR val's, token counts around the n8 tiles, depths from
# one ragged k-step to the widest
SIM_EDGE_B = (1, 17, 32, 33, 128)
SIM_EDGE_N = (1, 7, 129, 2297)
SIM_EDGE_Q = (1, 8, 31, 32)
SIM_EDGE_E = (4, 128, 256, 512)
SIM_PAST_INT32 = 262145  # N Q E >= 2^31 at Q = 32, E = 256


def _nan_equal(got: torch.Tensor, want: torch.Tensor) -> tuple:
    """(NaN and each infinity where and only where plain has them, worst
    |difference| elsewhere)."""
    inf = torch.isinf(want)
    same = (torch.equal(torch.isnan(got), torch.isnan(want))
            and torch.equal(torch.isinf(got), inf) and torch.equal(got[inf], want[inf]))
    d = (got - want).abs().masked_fill(~torch.isfinite(want), 0.0)
    return same, d.max().item()


def check_token_max_sim_edges(device="cuda", seed=27) -> dict:
    """K1 against its plain version over :data:`SIM_EDGE_B` x
    :data:`SIM_EDGE_N` x :data:`SIM_EDGE_Q` x :data:`SIM_EDGE_E` on
    L2-normalised inputs, within 1e-5 absolute; in each gallery of two items
    or more, the last item a copy of the first (their scores tie bit for bit,
    so the stable top-k keeps gallery order); at B = 33 and N = 129, a NaN in
    one query row and in one token of one item (NaN exactly where ``amax``
    gives it: that row and that item), then infinities: -inf in one token
    of item 23 at a depth every query row holds positive (those scores -inf:
    the item's score is its other tokens' max), +inf in one token of item 41
    and -inf in query row 9 (plus or minus inf, or NaN, exactly where the
    plain version gives them); and one launch at N = 262,145, Q = 32, E =
    256 (N Q E >= 2^31: 8.6 GB of gallery)."""
    r = _Rand(device, seed)
    bad, cases, worst = [], 0, 0.0

    def hold(what, got, want):
        nonlocal cases, worst
        cases += 1
        same, err = _nan_equal(got, want)
        worst = max(worst, err)
        if not same or err > 1e-5 or got.shape != want.shape:
            bad.append(f"{what}: NaN where plain has it {same}, max_abs {err:.2e}")

    with torch.inference_mode():
        for E in SIM_EDGE_E:
            for Q in SIM_EDGE_Q:
                for N in SIM_EDGE_N:
                    t = _unit(r, N, Q, E)
                    if N > 1:
                        t[N - 1] = t[0]
                    for B in SIM_EDGE_B:
                        f = _unit(r, B, E)
                        got = token_max_sim(f, t)
                        hold(f"B={B} N={N} Q={Q} E={E}", got, token_max_sim_plain(f, t))
                        if N > 1 and not torch.equal(got[:, 0], got[:, N - 1]):
                            bad.append(f"B={B} N={N} Q={Q} E={E}: a copied item does not tie")
                        if B == 33 and N == 129:
                            fn, tn = f.clone(), t.clone()
                            fn[5, E // 2] = float("nan")
                            tn[17, Q - 1, 0] = float("nan")
                            hold(f"NaN B={B} N={N} Q={Q} E={E}", token_max_sim(fn, tn),
                                 token_max_sim_plain(fn, tn))
                            fi, ti = f.clone(), t.clone()
                            fi[:, 0] = fi[:, 0].abs()
                            ti[23, 0, 0] = -float("inf")
                            ti[41, Q - 1, E - 1] = float("inf")
                            fi[9, E // 2] = -float("inf")
                            hold(f"inf B={B} N={N} Q={Q} E={E}", token_max_sim(fi, ti),
                                 token_max_sim_plain(fi, ti))
        f = _unit(r, QUERY_BATCH, 256)
        t = _unit(r, SIM_PAST_INT32, 32, 256)
        hold(f"B=32 N={SIM_PAST_INT32} Q=32 E=256", token_max_sim(f, t), token_max_sim_plain(f, t))
        del t
        torch.cuda.synchronize()
    return {"ok": not bad, "finite": True, "max_abs_err": worst, "mean_abs_err": 0.0,
            "shape": (f"{cases} cases: B {SIM_EDGE_B} x N {SIM_EDGE_N} x Q {SIM_EDGE_Q} x E "
                      f"{SIM_EDGE_E}, a copied item in each gallery, NaN and inf at B=33 N=129, "
                      f"N={SIM_PAST_INT32}: within 1e-5, ties exact"
                      + (f"; FAILED ({len(bad)}): {bad[:8]}" if bad else ""))}


def check_token_max_sim_plan(device="cuda") -> dict:
    """The C entry's plan (``sprc_token_max_sim_plan``) against
    ``schedules.token_max_sim_plan`` at every shape of :data:`SIM_SWEEP` and
    of the edge check, and the card's resident blocks an SM at that shared
    memory against the plan's ``blocks_per_sm``."""
    import ctypes

    from sprc_tpu_torch.ops import _ext

    lib = _ext.library()
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    keys = ("warps", "pitch", "stages", "blocks_per_sm", "tiles", "groups", "grid", "smem_bytes")
    shapes = [(B, N, 32, 256) for B, N in SIM_SWEEP] + [
        (B, N, Q, E) for B in SIM_EDGE_B for N in SIM_EDGE_N for Q in SIM_EDGE_Q
        for E in SIM_EDGE_E]
    bad, resident = [], {}
    for B, N, Q, E in shapes:
        out = (ctypes.c_int * 9)()
        _ext.check(lib.sprc_token_max_sim_plan(B, N, Q, E, sms, out), "token_max_sim_plan")
        plan = schedules.token_max_sim_plan(B, N, Q, E, sms=sms)
        got = dict(zip(keys, out[:8]))
        if got != {k: plan[k] for k in keys} or out[8] < plan["blocks_per_sm"]:
            bad.append({"shape": (B, N, Q, E), "launch": got, "resident": out[8]})
        resident[f"Q={Q} E={E}"] = (plan["blocks_per_sm"], out[8])
    return {"ok": not bad, "shapes": len(shapes), "sms": sms, "mismatch": bad[:4],
            "blocks_per_sm_planned_vs_resident": resident}


# K1's sweep: the galleries users score (chip_smoke's 512 items, CIRR val,
# FashionIQ shirt val, CIRCO's COCO 2017 unlabeled split, and one past the old
# 2^31-element limit) at the serving batch, and other query batches at two
SIM_SWEEP = ([(QUERY_BATCH, n) for n in (GALLERY, 2297, 6346, 123403, SIM_PAST_INT32)]
             + [(b, n) for n in (GALLERY, 123403) for b in (1, 128)])


def run_token_max_sim_sweep(device="cuda", baseline=None) -> List[dict]:
    """K1 at every (B, N) of :data:`SIM_SWEEP` (Q = 32, E = 256), with the
    baseline kernels' device times where given (name -> C entry; not at 2^31
    elements or more, which a kernel that indexes in 32 bits cannot read)."""
    rows = []
    for B, N in SIM_SWEEP:
        big = N * 32 * 256 >= 2 ** 31
        row = check_token_max_sim(device, B=B, N=N, baseline=None if big else baseline,
                                  plain=N <= 6346)
        rows.append(dict(check=f"K1 token_max_sim B={B} N={N}", **row))
        torch.cuda.empty_cache()
    return rows


TRAIN_BATCH = 128  # the fine-tune CLI's default batch: K1's training shape is [128, 128]


def grad_gap(got: List[torch.Tensor], want: List[torch.Tensor], names: List[str]) -> dict:
    """How far one step's gradients lie from another's: per tensor, max
    |got - want| over the tensor's scale, its max |want| floored at 1e-4 of
    the largest of all (a gradient that is 0 in exact arithmetic keeps only
    rounding). ``gap``: the worst; ``tensor``, ``err``, ``scale``,
    ``at_floor``: that tensor's name, difference and scale, and whether the
    scale is the floor; ``worst``: the three worst as (name, gap, scale)."""
    tops = torch.stack([w.abs().max() for w in want]).tolist()
    errs = torch.stack([(g - w).abs().max() for g, w in zip(got, want)]).tolist()
    floor = 1e-4 * max(tops)
    scales = [max(t, floor) for t in tops]
    gaps = sorted(((e / sc, n, e, sc) for n, e, sc in zip(names, errs, scales)), reverse=True)
    gap, name, err, scale = gaps[0]
    return {"gap": gap, "tensor": name, "err": err, "scale": scale, "at_floor": scale == floor,
            "worst": [(n, g, sc) for g, n, _, sc in gaps[:3]]}


def check_token_max_sim_grad(device="cuda", B=TRAIN_BATCH, N=TRAIN_BATCH, Q=32, E=256,
                             seed=31) -> dict:
    """K1 with a gradient (``TokenMaxSim``, the in-batch losses' call) against
    autograd over the plain version, on the same inputs and cotangent: the
    forward within K1's edge bound 1e-5, both gradients within 1e-5; then
    the same with exact ties (item n's tokens 0 and 1 both equal to query
    n's feature, so query n's max is tied), where the gradient must split
    evenly over the two tokens, as ``jnp.max``'s VJP splits it. ``launches``:
    K1's launches in those two forwards (2). ``ms`` / ``plain_ms``: the
    device time of the Function's forward (the kernel) and of the plain
    forward (:func:`device_ms`), the work ``bytes`` / ``op_seconds`` count;
    ``fwd_bwd_ms`` / ``plain_fwd_bwd_ms``: forward and backward of each
    through autograd (CUDA events over a loop: the backward is the plain
    version recomputed, and the host paces it)."""
    r = _Rand(device, seed)
    f, t, g = _unit(r, B, E), _unit(r, N, Q, E), r.normal(B, N)
    row = {"max_abs_err": 0.0, "grad_max_abs_err": 0.0, "finite": True}
    before = token_max_sim.launches

    def run(fn, feats, targets):
        fx = feats.clone().requires_grad_()
        tx = targets.clone().requires_grad_()
        out = fn(fx, tx)
        out.backward(g)
        return out.detach(), fx.grad, tx.grad

    for case in ("random", "ties"):
        if case == "ties":
            t = t.clone()
            t[:, 0] = t[:, 1] = f[torch.arange(N, device=device) % B]
        got = run(TokenMaxSim.call, f, t)
        want = run(token_max_sim_plain, f, t)
        row["max_abs_err"] = max(row["max_abs_err"], (got[0] - want[0]).abs().max().item())
        row["grad_max_abs_err"] = max(row["grad_max_abs_err"], *(
            (a - b).abs().max().item() for a, b in zip(got[1:], want[1:])))
        row["finite"] &= all(bool(torch.isfinite(x).all()) for x in got)
    torch.cuda.synchronize()
    row["launches"] = token_max_sim.launches - before
    tied = got[2]  # the tied case's target gradient
    row["tie_split_even"] = bool(torch.equal(tied[:, 0], tied[:, 1])) and bool(
        (tied[:min(B, N), 0].abs().sum(-1) > 0).all())
    with torch.no_grad():
        row["ms"] = device_ms(lambda: TokenMaxSim.call(f, t))[0]
        row["plain_ms"] = device_ms(lambda: token_max_sim_plain(f, t))[0]
    row["fwd_bwd_ms"] = cuda_ms(lambda: run(TokenMaxSim.call, f, t))
    row["plain_fwd_bwd_ms"] = cuda_ms(lambda: run(token_max_sim_plain, f, t))
    row["ok"] = (row["finite"] and row["max_abs_err"] <= 1e-5
                 and row["grad_max_abs_err"] <= 1e-5 and row["tie_split_even"]
                 and row["launches"] == 2)
    row["shape"] = f"B={B} N={N} Q={Q} E={E} fp32, forward + backward, random and tied"
    # the forward's work (``ms``): f and t read, the scores written; one product
    row["bytes"] = 4 * (B * E + N * Q * E + B * N)
    row["op_seconds"] = 2 * B * N * Q * E / PEAK_OPS["fp32"]
    return row


# ------------------------------------------------------------------- K2


def vit_block_params(r: _Rand, W=1024, M=4096, dtype=torch.bfloat16) -> tuple:
    """Random block weights at the model's init scale (weights [out, in]
    normal(0.02) in ``dtype``; fp32 LayerNorms near 1 and small biases)."""
    return (r.normal(W, std=0.1, mean=1.0), r.normal(W, std=0.02),
            r.normal(3 * W, W, std=0.02, dtype=dtype), r.normal(3 * W, std=0.02),
            r.normal(W, W, std=0.02, dtype=dtype), r.normal(W, std=0.02),
            r.normal(W, std=0.1, mean=1.0), r.normal(W, std=0.02),
            r.normal(M, W, std=0.02, dtype=dtype), r.normal(M, std=0.02),
            r.normal(W, M, std=0.02, dtype=dtype), r.normal(W, std=0.02))


def _vit_block_work(B, S, W, M, int8: bool, dtype=torch.bfloat16) -> Dict[str, float]:
    """One ViT block: dense 2 B S (4 W^2 + 2 W M) operations (bf16, int8 or
    fp32), attention 4 B S^2 W in bf16 (fp32 in an fp32 tower); x in and out
    in the model dtype, the weights once (two bytes each in bf16, four in
    fp32, one in int8 plus an fp32 scale per output channel), biases and
    LayerNorm parameters in fp32."""
    dense, attn = 2 * B * S * (4 * W * W + 2 * W * M), 4 * B * S * S * W
    weights = 4 * W * W + 2 * W * M
    vectors = 4 * (3 * W + W + M + W + 4 * W)
    scales = 4 * (3 * W + W + M + W) if int8 else 0
    size = 1 if int8 else dtype.itemsize
    peak = "int8" if int8 else ("fp32" if dtype == torch.float32 else "bf16")
    return {"bytes": 2 * dtype.itemsize * B * S * W + weights * size + vectors + scales,
            "op_seconds": (dense / PEAK_OPS[peak]
                           + attn / PEAK_OPS["fp32" if dtype == torch.float32 else "bf16"])}


# the two towers' block shapes: (W, M, heads, QuickGELU, LN eps)
TOWERS = {"vit_l": (1024, 4096, 16, True, 1e-5), "eva_g": (1408, 6144, 16, False, 1e-6)}


# K2 in fp32 (the fp32 tower of the COCO retrieval models, 364 px: S = 677):
# max |difference| over the output's max |value| (the fp32 GEMMs and attention
# in 3xTF32 against true fp32); reading on an H100 7.4e-7 (5.5e-6 of 7.41)
VIT_F32_REL = 3e-6


def check_vit_block(device="cuda", B=ENCODE_BATCH, S=257, W=1024, M=4096, heads=16,
                    seed=1, quick=True, eps=1e-5, dtype=torch.bfloat16) -> dict:
    """bf16, output scale ~5: max-abs <= 0.0625 and mean-abs <= 4e-3 (twice
    the JAX kernel's own envelope against XLA, for another accumulation
    order). fp32: max-abs <= VIT_F32_REL of the output's max |value|."""
    r = _Rand(device, seed)
    x = r.normal(B, S, W, dtype=dtype)
    params = vit_block_params(r, W, M, dtype=dtype)
    kw = dict(heads=heads, eps=eps, scale=(W // heads) ** -0.5, quick=quick)
    with torch.inference_mode():
        got = fused_vit_block(x, *params, **kw)
        want = fused_vit_block_plain(x, *params, **kw)
        torch.cuda.synchronize()
        row = _errors(got, want)
        row["out_max_abs"] = want.float().abs().max().item()
        row["ms"] = cuda_ms(lambda: fused_vit_block(x, *params, **kw))
        row["plain_ms"] = cuda_ms(lambda: fused_vit_block_plain(x, *params, **kw))
    if dtype == torch.float32:
        row["ok"] = row["finite"] and row["max_abs_err"] <= VIT_F32_REL * row["out_max_abs"]
    else:
        row["ok"] = (row["finite"] and row["max_abs_err"] <= 0.0625
                     and row["mean_abs_err"] <= 4e-3)
    row["shape"] = f"B={B} S={S} W={W} M={M} H={heads} {_TYPE[dtype]}"
    row.update(_vit_block_work(B, S, W, M, int8=False, dtype=dtype))
    return row


def _vit_chain(device, seed, depth, B, S, W, M, heads, int8: bool) -> dict:
    """``depth`` random blocks. The kernel chain runs inside ``stage_check``
    and is held stage by stage; the plain chain beside it runs free from the
    same input, and their final difference is reported, not bounded (bf16
    rounding, and in int8 flipped codes, compound over depth)."""
    r = _Rand(device, seed)
    x = r.normal(B, S, W, dtype=torch.bfloat16)
    kw = dict(heads=heads, eps=1e-5, scale=(W // heads) ** -0.5, quick=True)
    stages = StageRecorder()
    with torch.inference_mode():
        got, want = x, x
        for _ in range(depth):
            if int8:
                p = quantize_vit_block(vit_block_params(r, W, M, dtype=torch.float32))
                with primitives.stage_check(stages):
                    got = fused_vit_block_i8(got, *p, **kw, acts=VIT_I8_ACTS)
                want = fused_vit_block_i8_plain(want, *p, **kw, acts=VIT_I8_ACTS)
            else:
                p = vit_block_params(r, W, M)
                with primitives.stage_check(stages):
                    got = fused_vit_block(got, *p, **kw)
                want = fused_vit_block_plain(want, *p, **kw)
        torch.cuda.synchronize()
        row = _errors(got, want)
        row["out_max_abs"] = want.float().abs().max().item()
    row["stages"] = stages.rows()
    row["ok"] = row["finite"] and stages.ok()
    row["shape"] = (f"depth={depth} B={B} S={S} W={W} {'int8 dense, ' if int8 else ''}bf16; "
                    f"stage by stage: {stages.describe()}; free-running plain chain")
    return row


def check_vit_tower(device="cuda", depth=23, B=8, S=257, W=1024, M=4096, heads=16,
                    seed=2) -> dict:
    """The 23-block bf16 chain: every stage within :data:`STAGE_BOUNDS`."""
    return _vit_chain(device, seed, depth, B, S, W, M, heads, int8=False)


# ------------------------------------------------------------------- K3


def _attn_p(r, W, Wk):
    return {"query": (r.normal(W, W, std=0.02), r.normal(W, std=0.02)),
            "key": (r.normal(W, Wk, std=0.02), r.normal(W, std=0.02)),
            "value": (r.normal(W, Wk, std=0.02), r.normal(W, std=0.02)),
            "out": (r.normal(W, W, std=0.02), r.normal(W, std=0.02)),
            "ln": (r.normal(W, std=0.1, mean=1.0), r.normal(W, std=0.02))}


def _ffn_p(r, W, M):
    return {"fc1": (r.normal(M, W, std=0.02), r.normal(M, std=0.02)),
            "fc2": (r.normal(W, M, std=0.02), r.normal(W, std=0.02)),
            "ln": (r.normal(W, std=0.1, mean=1.0), r.normal(W, std=0.02))}


def qformer_layer_params(r: _Rand, cross: bool, W=768, Wi=1024, M=3072) -> dict:
    return {"self_p": _attn_p(r, W, W), "cross_p": _attn_p(r, W, Wi) if cross else None,
            "ffn_q_p": _ffn_p(r, W, M), "ffn_t_p": _ffn_p(r, W, M)}


# the rerank's tiles: bench.py's (15 queries x their top 50 candidates, as
# serving's defaults take them) and a CIRR validation tile (15 x 200)
RERANK_TILE, RERANK_CIRR_TILE = 15 * 50, 15 * 200
RERANK_MEMORY = 2 * 257  # [reference; candidate] image rows at 224 px

SERVING_SHAPES = {  # name -> (B, S, with image, with a padded text mask, image rows)
    "queries": (ENCODE_BATCH, 32, True, False, 257),  # gallery encode: queries only
    "fusion": (QUERY_BATCH, 64, True, True, 257),     # composed query, pass 1
    "prompt": (QUERY_BATCH, 64, False, True, 257),    # composed query, pass 2 (no image)
    # the ITM rerank: queries and caption into the [reference; candidate] memory
    "rerank": (RERANK_TILE, 64, True, True, RERANK_MEMORY),
}
# the variant zoo's no-grad passes inside a training step or a forward
# (models/cir_variants.py): blip2_cir_cls's 5 candidate captions a sample
# fused with its reference, the plain text pass (no queries) at the training
# batch, and blip2_cir_slt's second pass (its 4 selected query tokens and
# the caption, no image)
VARIANT_SHAPES = {
    "cls candidates": (TRAIN_BATCH * 5, 64, True, True, 257),
    "text": (TRAIN_BATCH, 32, False, True, 257),
    "slt prompt": (QUERY_BATCH, 36, False, True, 257),
}
# the image <-> text retrieval of BLIP-2 stage 1 at COCO's 364 px (677 image
# rows of EVA ViT-g's width): the gallery's queries pass at the encode batch,
# the captions' CLS pass (256 a call, max_txt_len 35, no queries), and the ITM
# rescoring (itm_batch 16 candidates of 32 queries + 35 text rows)
RETRIEVAL_MEMORY = 677
RETRIEVAL_SHAPES = {
    "coco queries": (ENCODE_BATCH, 32, True, False, RETRIEVAL_MEMORY),
    "coco text": (256, 35, False, True, RETRIEVAL_MEMORY),
    "coco itm": (16, 67, True, True, RETRIEVAL_MEMORY),
}
# COCO's test split: 25,010 captions against 5,000 images (K1's retrieval call)
RETRIEVAL_SIM = (25000, 5000)
# BLIP-2 stage 2's caption evaluation (caption_coco_{opt2.7b,flant5xl}_eval.yaml):
# the fp32 EVA ViT-g tower at 364 px and the Q-Former's queries-only pass into
# its 677 rows, at the YAML's batch_size_eval of 16
CAPTION_BATCH = 16
CAPTION_SHAPES = {"caption queries": (CAPTION_BATCH, 32, True, False, RETRIEVAL_MEMORY)}
# BLIP-2 stage 2's training and zero-shot VQA: pretrain_stage2.yaml's frozen bf16
# EVA ViT-g at 224 px and its batch of 32 (caption_coco_blip2_ft.yaml's fp32 tower
# at 364 px and batch 16 is the caption path's check), and the VQA YAMLs'
# batch_size_eval of 16 through the bf16 tower and the queries-only pass into
# its 257 rows (the training steps run the Q-Former unfused)
STAGE2_TRAIN_BATCH = 32
VQA_BATCH = 16
VQA_SHAPES = {"vqa queries": (VQA_BATCH, 32, True, False, 257)}
# the InstructBLIP-style CIR models (models/instruct_cir.py) at their batch of
# 16 over the bf16 EVA ViT-g's 257 rows: the 32 queries and the instruction's
# BERT text cross-attending the image, at blip2_vicuna_instruct's max_txt_len of
# 128 (retrieval) and blip2_instruct_cir's 32 (generation); the gallery's
# queries-only pass is VQA_SHAPES' shape
INSTRUCT_SHAPES = {"instruct fusion L=128": (VQA_BATCH, 32 + 128, True, True, 257),
                   "instruct fusion L=32": (VQA_BATCH, 32 + 32, True, True, 257)}
SHAPE_Q = {"text": 0, "slt prompt": 4, "coco text": 0}  # query rows where they are not 32
# image rows' width where it is not 1024
SHAPE_WI = {s: 1408 for s in (*RETRIEVAL_SHAPES, *CAPTION_SHAPES, *VQA_SHAPES,
                              *INSTRUCT_SHAPES)}
QF_SHAPES = {**SERVING_SHAPES, **VARIANT_SHAPES, **RETRIEVAL_SHAPES, **CAPTION_SHAPES,
             **VQA_SHAPES, **INSTRUCT_SHAPES}


def _qf_inputs(r, shape, Q, Si, W, Wi):
    B, S, with_img, with_mask, _ = QF_SHAPES[shape]
    x = r.normal(B, S, W)
    img = r.normal(B, Si, Wi) if with_img else None
    bias = None
    if with_mask:
        lengths = torch.randint(4, S - Q + 1, (B,), generator=r.gen, device=r.device)
        cols = torch.arange(S, device=r.device)[None]
        bias = torch.where(cols < Q + lengths[:, None], 0.0, -10000.0).float().contiguous()
    return x, bias, img


def _qformer_layer_work(shape, Q, Si, W, Wi, M, int8: bool) -> Dict[str, float]:
    """One Q-Former layer in a serving shape: the dense operations (fp32 or
    int8) and the fp32 attention; x in and out, the image rows and the column
    bias in fp32, and the weights the shape uses, once."""
    B, S, with_img, with_mask, _ = QF_SHAPES[shape]
    R = B * S
    dense = 4 * 2 * R * W * W + 4 * R * W * M  # q, k, v, out; one FFN per row
    attn = 4 * B * S * S * W
    weights, vectors = 4 * W * W, 4 * W + 2 * W
    ffns = 1 if (not with_img or S == Q) else 2
    weights += ffns * 2 * W * M
    vectors += ffns * (M + W + 2 * W)
    if with_img:
        dense += 2 * 2 * B * Q * W * W + 2 * 2 * B * Si * Wi * W
        attn += 4 * B * Q * Si * W
        weights += 2 * W * W + 2 * Wi * W
        vectors += 4 * W + 2 * W
    acts = 2 * R * W + (B * Si * Wi if with_img else 0) + (B * S if with_mask else 0)
    # int8: one byte a weight and an fp32 scale per output channel (as many as biases)
    w_bytes = weights + 4 * vectors if int8 else 4 * weights
    return {"bytes": 4 * acts + w_bytes + 4 * vectors,
            "op_seconds": dense / PEAK_OPS["int8" if int8 else "fp32"] + attn / PEAK_OPS["fp32"]}


def _int8_layer(p: dict) -> dict:
    return {k: quantize_layer_params(v) for k, v in p.items()}


# K4, one layer, against its plain version on identical inputs. Every GEMM
# and quantiser is equal to plain on equal inputs; the fp32 attention and
# LayerNorm kernels sum in another order, so a value that sits within 1e-6
# of a half step flips a code in the next quantiser, and one flip moves a row
# of outputs by about scale x |w| ~ 1e-3. The bounds are about 3x the
# readings on an H100 (max-abs 1.21e-2, mean-abs 1.9e-5, at output scale ~4).
QF_INT8_LAYER_MAX_ABS, QF_INT8_LAYER_MEAN_ABS = 4e-2, 6e-5


def check_qformer_layer(shape: str, device="cuda", Q=32, W=768, Wi=1024,
                        M=3072, heads=12, seed=3, int8=False) -> dict:
    """fp32 (true fp32 on both sides, TF32 off): atol 1e-4 per layer. With
    ``int8`` (K4): QF_INT8_LAYER_MAX_ABS and QF_INT8_LAYER_MEAN_ABS."""
    r = _Rand(device, seed)
    Q = SHAPE_Q.get(shape, Q)
    Wi = SHAPE_WI.get(shape, Wi)
    B, S, Si = (QF_SHAPES[shape][i] for i in (0, 1, 4))
    x, bias, img = _qf_inputs(r, shape, Q, Si, W, Wi)
    p = qformer_layer_params(r, cross=img is not None, W=W, Wi=Wi, M=M)
    if int8:
        p = _int8_layer(p)
    kw = dict(heads=heads, eps=1e-12, Q=Q, text_ffn_all=img is None, int8=int8)

    def run(fn):
        return fn(x, bias, p["self_p"], img, p["cross_p"], p["ffn_q_p"], p["ffn_t_p"], **kw)

    with torch.inference_mode():
        got, want = run(fused_qformer_layer), run(fused_qformer_layer_plain)
        torch.cuda.synchronize()
        row = _errors(got, want)
        row["ms"] = cuda_ms(lambda: run(fused_qformer_layer))
        row["plain_ms"] = cuda_ms(lambda: run(fused_qformer_layer_plain), iters=3, warmup=1)
    if int8:
        row["ok"] = (row["finite"] and row["max_abs_err"] <= QF_INT8_LAYER_MAX_ABS
                     and row["mean_abs_err"] <= QF_INT8_LAYER_MEAN_ABS)
    else:
        row["ok"] = row["finite"] and row["max_abs_err"] <= 1e-4
    row["shape"] = (f"{shape}: B={B} S={S} Si={Si} W={W} "
                    f"{'int8 dense, ' if int8 else ''}fp32")
    row.update(_qformer_layer_work(shape, Q, Si, W, Wi, M, int8))
    return row


def check_qformer_trunk(shape: str, device="cuda", layers=12, Q=32, W=768,
                        Wi=1024, M=3072, heads=12, seed=4, int8=False) -> dict:
    """The 12-layer chain (cross-attention on even layers), the kernel chain
    inside ``stage_check``: every stage within :data:`STAGE_BOUNDS`, and in
    fp32 the final difference from the free-running plain chain within 5e-4.
    With ``int8`` that difference is reported, not bounded."""
    r = _Rand(device, seed)
    B, S, Si = (SERVING_SHAPES[shape][i] for i in (0, 1, 4))
    x, bias, img = _qf_inputs(r, shape, Q, Si, W, Wi)
    kw = dict(heads=heads, eps=1e-12, Q=Q, text_ffn_all=img is None, int8=int8)
    stages = StageRecorder()
    with torch.inference_mode():
        got, want = x, x
        for i in range(layers):
            p = qformer_layer_params(r, cross=(i % 2 == 0) and img is not None, W=W, Wi=Wi, M=M)
            if int8:
                p = _int8_layer(p)
            args = (p["self_p"], img, p["cross_p"], p["ffn_q_p"], p["ffn_t_p"])
            with primitives.stage_check(stages):
                got = fused_qformer_layer(got, bias, *args, **kw)
            want = fused_qformer_layer_plain(want, bias, *args, **kw)
        torch.cuda.synchronize()
        row = _errors(got, want)
    row["stages"] = stages.rows()
    row["ok"] = row["finite"] and stages.ok() and (int8 or row["max_abs_err"] <= 5e-4)
    row["shape"] = (f"{shape}: {layers} layers B={B} S={S} {'int8 dense, ' if int8 else ''}fp32; "
                    f"stage by stage: {stages.describe()}; free-running plain chain")
    return row


# ------------------------------------------------------- the dense kernels

# The s8 products of the int8 main path, and the tiled matmul of
# scripts/ablate_int8.py. name -> (M, N, K, the epilogue the path runs on it).
# Tower: ENCODE_BATCH images of 257 tokens. Q-Former: the queries pass has
# ENCODE_BATCH items of 32 rows and 257 image rows of width 1024; a query
# batch has QUERY_BATCH items of 64 rows (32 query rows, 32 text rows).
_VIT_M, _Q_M, _F_M = ENCODE_BATCH * 257, ENCODE_BATCH * 32, QUERY_BATCH * 64
GEMM_I8_PRODUCTS = {
    "ablate 4096^3": (4096, 4096, 4096, None),
    "vit qkv": (_VIT_M, 3072, 1024, "bf16"),
    "vit proj": (_VIT_M, 1024, 1024, "bf16+residual"),
    "vit fc1": (_VIT_M, 4096, 1024, "quick_gelu->s8"),
    "vit fc2": (_VIT_M, 1024, 4096, "bf16+residual"),
    "qformer self, all rows": (_F_M, 768, 768, "rows->f32"),
    "qformer self, query rows": (_F_M // 2, 768, 768, "rows->f32"),
    "qformer cross kv, queries pass": (_VIT_M, 768, 1024, "rows->f32"),
    "qformer cross kv, fusion pass": (QUERY_BATCH * 257, 768, 1024, "rows->f32"),
    "qformer fc1, all rows": (_Q_M, 3072, 768, "rows,gelu->f32"),
    "qformer fc2, all rows": (_Q_M, 768, 3072, "rows->f32"),
    "qformer fc1, half the rows": (_F_M // 2, 3072, 768, "rows,gelu->f32"),
    "qformer fc2, half the rows": (_F_M // 2, 768, 3072, "rows->f32"),
    # EVA ViT-g: 1408 = 11 x 128 and 4224 = 33 x 128 are odd multiples of the tile
    "eva qkv": (_VIT_M, 4224, 1408, "bf16"),
    "eva proj": (_VIT_M, 1408, 1408, "bf16+residual"),
    "eva fc1": (_VIT_M, 6144, 1408, "gelu->s8"),
    "eva fc2": (_VIT_M, 1408, 6144, "bf16+residual"),
    "qformer cross kv, queries pass, EVA": (_VIT_M, 768, 1408, "rows->f32"),
    # the int8 rerank on EVA ViT-g at a CIRR tile: M K = 2.17e9, past 2^31
    "qformer cross kv, rerank, EVA": (RERANK_CIRR_TILE * RERANK_MEMORY, 768, 1408,
                                      "rows->f32"),
}
assert _Q_M == _F_M  # the queries pass and a query batch give the same self and FFN products


def _codes(r: _Rand, *shape) -> torch.Tensor:
    return torch.randint(-127, 128, shape, generator=r.gen, device=r.device).to(torch.int8)


def _epilogue(r: _Rand, epilogue: str, M: int, N: int) -> tuple:
    """(its kind of stage in STAGE_BOUNDS, the keyword arguments of ``gemm_i8``)."""
    if epilogue.startswith("rows"):  # the Q-Former's: a dynamic scale per row
        kw = dict(row_scale=r.normal(M).abs() * 1e-2 + 1e-3)
        return "gemm_i8 -> f32", dict(kw, act="gelu") if "gelu" in epilogue else kw
    kw = dict(col_alpha=0.037)  # the tower's: one static scale
    if epilogue.endswith("->s8"):
        return "gemm_i8 -> s8", dict(kw, act=epilogue.split("->")[0], out_scale=0.05)
    if epilogue == "bf16+residual":
        kw["residual"] = r.normal(M, N, dtype=torch.bfloat16)
    return "gemm_i8 -> bf16", dict(kw, out_dtype=torch.bfloat16)


def check_gemm_i8(name: str, device="cuda", seed=5) -> dict:
    """One product of :data:`GEMM_I8_PRODUCTS` on random codes. The raw s32
    output (the tiled s8 matmul of scripts/ablate_int8.py) is integer
    arithmetic: equal to the plain version, max-abs 0. Then the epilogue the
    main path runs on this product, against the plain version on the same
    codes, within the bound of its stage in :data:`STAGE_BOUNDS`: the same
    fp32 roundings step by step, so equal too, except that QuickGELU -> int8
    moves a code in a million by one. The times are the raw product's (and
    ``epilogue_ms`` the call with the path's epilogue); the library call is
    ``torch._int_mm``."""
    M, N, K, epilogue = GEMM_I8_PRODUCTS[name]
    r = _Rand(device, seed)
    a8, w8 = _codes(r, M, K), _codes(r, N, K)
    with torch.inference_mode():
        got = primitives.gemm_i8_cuda(a8, w8)
        want = primitives.gemm_i8_plain(a8, w8)
        torch.cuda.synchronize()
        d = (got.long() - want.long()).abs()
        row = {"max_abs_err": d.max().item(), "mean_abs_err": d.double().mean().item(),
               "finite": True, "epilogue_differ": 0.0, "epilogue_max_abs_err": 0.0}
        row["ok"] = got.dtype == torch.int32 and row["max_abs_err"] == 0
        del got, want, d
        if epilogue is not None:
            cs, bias = r.normal(N).abs() * 1e-5 + 1e-6, r.normal(N, std=0.1)
            kind, kw = _epilogue(r, epilogue, M, N)
            d = (primitives.gemm_i8_cuda(a8, w8, cs, bias, **kw).float()
                 - primitives.gemm_i8_plain(a8, w8, cs, bias, **kw).float()).abs()
            row["epilogue_differ"] = (d > 0).float().mean().item()
            row["epilogue_max_abs_err"] = d.max().item()
            share, by = STAGE_BOUNDS[kind]
            row["ok"] = (row["ok"] and row["epilogue_differ"] <= share
                         and row["epilogue_max_abs_err"] <= by)
            del d
            row["epilogue_ms"] = cuda_ms(lambda: primitives.gemm_i8_cuda(a8, w8, cs, bias, **kw))
        row["ms"] = cuda_ms(lambda: primitives.gemm_i8_cuda(a8, w8))
        row["plain_ms"] = cuda_ms(lambda: primitives.gemm_i8_plain(a8, w8), iters=3, warmup=1)
        wt = w8.t()
        row["library_ms"] = cuda_ms(lambda: torch._int_mm(a8, wt))
    row["shape"] = (f"M={M} N={N} K={K} s8 x s8 -> s32; epilogue {epilogue}: differ "
                    f"{row['epilogue_differ']:.1e}, max_abs {row['epilogue_max_abs_err']:.1e}; "
                    f"torch._int_mm {row['library_ms']:.4f} ms")
    row["bytes"] = M * K + N * K + 4 * M * N
    row["op_seconds"] = 2 * M * N * K / PEAK_OPS["int8"]
    row["tops"] = 2 * M * N * K / (row["ms"] * 1e-3) / 1e12
    return row


def check_gemm_bf16_ablate(device="cuda", n=4096, seed=11) -> dict:
    """The bf16 -> bf16 mode of the tiled matmul of scripts/ablate_int8.py,
    at its shape: the bf16 GEMM kernel against its plain version and
    ``F.linear``. fp32 accumulation in another order, then one rounding:
    at most one bf16 step at the top of the output's range (2^-7 of the
    largest |value|)."""
    r = _Rand(device, seed)
    x, w = r.normal(n, n, dtype=torch.bfloat16), r.normal(n, n, std=0.02, dtype=torch.bfloat16)
    with torch.inference_mode():
        got, want = primitives.gemm_cuda(x, w), primitives.gemm_plain(x, w)
        torch.cuda.synchronize()
        row = _errors(got, want)
        row["out_max_abs"] = want.float().abs().max().item()
        row["ms"] = cuda_ms(lambda: primitives.gemm_cuda(x, w))
        row["plain_ms"] = cuda_ms(lambda: primitives.gemm_plain(x, w))
        row["library_ms"] = cuda_ms(lambda: torch.nn.functional.linear(x, w))
    row["ok"] = row["finite"] and row["max_abs_err"] <= row["out_max_abs"] * 2.0 ** -7
    row["shape"] = f"M=N=K={n} bf16 -> bf16; F.linear {row['library_ms']:.4f} ms"
    row["bytes"] = 2 * 3 * n * n
    row["op_seconds"] = 2 * n ** 3 / PEAK_OPS["bf16"]
    return row


def check_quantizers(device="cuda", B=ENCODE_BATCH, S=257, W=1024, seed=7) -> dict:
    """``quantize_static`` (bf16 in) and ``quantize_rows`` (fp32 in) round the
    same fp32 values as their plain versions: codes and scales bit-equal.
    LayerNorm -> int8 sums a row in another order, so its fp32 value moves by
    an ulp or two before the rounding: a few codes in a million differ, by
    one (held to the bound of its stage in :data:`STAGE_BOUNDS`)."""
    r = _Rand(device, seed)
    xb = r.normal(B, S, W, std=2.0, dtype=torch.bfloat16)
    xf = r.normal(B, S, W, std=2.0)
    lw, lb = r.normal(W, std=0.1, mean=1.0), r.normal(W, std=0.02)
    with torch.inference_mode():
        st = primitives.quantize_static_cuda(xb, 0.05).int() - quant.quantize_static(xb, 0.05)
        codes, sc = primitives.quantize_rows_cuda(xf)
        pcodes, psc = quant.quantize_rows(xf)
        ln = (primitives.layer_norm_cuda(xb, lw, lb, 1e-5, out_scale=0.04).int()
              - primitives.layer_norm_plain(xb, lw, lb, 1e-5, out_scale=0.04))
        torch.cuda.synchronize()
        row = {"finite": True, "static_differ": (st != 0).float().mean().item(),
               "rows_differ": (codes != pcodes).float().mean().item(),
               "rows_scale_max_abs": (sc - psc).abs().max().item(),
               "ln_differ": (ln != 0).float().mean().item(),
               "max_abs_err": float(ln.abs().max().item()), "mean_abs_err": 0.0}
        row["static_ms"] = cuda_ms(lambda: primitives.quantize_static_cuda(xb, 0.05))
        row["rows_ms"] = cuda_ms(lambda: primitives.quantize_rows_cuda(xf))
        row["ln_q8_ms"] = cuda_ms(lambda: primitives.layer_norm_cuda(xb, lw, lb, 1e-5,
                                                                     out_scale=0.04))
    share, by = STAGE_BOUNDS["layer_norm -> s8"]
    row["ok"] = (row["static_differ"] == 0 and row["rows_differ"] == 0
                 and row["rows_scale_max_abs"] == 0 and row["ln_differ"] <= share
                 and row["max_abs_err"] <= by)
    row["shape"] = (f"[{B},{S},{W}]: codes that differ: static {row['static_differ']:.1e}, rows "
                    f"{row['rows_differ']:.1e}, LN->s8 {row['ln_differ']:.1e}; ms static "
                    f"{row['static_ms']:.4f}, rows {row['rows_ms']:.4f}, LN->s8 "
                    f"{row['ln_q8_ms']:.4f}")
    return row


# ------------------------------------------------------------------- K5


def quantize_vit_block(fp: tuple) -> tuple:
    """K5's parameters from fp32 :func:`vit_block_params`: each weight as
    codes and scales, in the JAX kernel's order."""
    l1s, l1b, wqkv, bqkv, wproj, bproj, l2s, l2b, w1, b1, w2, b2 = fp
    q = quant.quantize_weight
    return (l1s, l1b, *q(wqkv), bqkv, *q(wproj), bproj, l2s, l2b, *q(w1), b1, *q(w2), b2)


# static activation scales (qkv, proj, fc1, fc2) that cover these random
# blocks' activations about as a calibration would: amax / 127
VIT_I8_ACTS = (6.0 / 127, 0.5 / 127, 6.0 / 127, 4.0 / 127)


def check_vit_block_i8(device="cuda", B=ENCODE_BATCH, S=257, W=1024, M=4096, heads=16,
                       seed=8, quick=True, eps=1e-5) -> dict:
    """K5 against its plain version, bf16 activations, output scale ~5.75:
    max-abs <= 0.125 and mean-abs <= 0.015, 2 to 2.5x the readings on an H100
    (0.0625 and 5.76e-3 at B=64). The GEMM epilogues and the quantisers are bit-equal
    to plain and LN -> s8 all but (``check_quantizers``); the bf16 attention
    kernel differs from plain by a bf16 step, which the ctx quantiser and then
    the fc1 / fc2 quantisers turn into flipped codes, so more outputs land on
    the other side of a bf16 rounding than in K2 (mean-abs 1.6e-3 there)."""
    r = _Rand(device, seed)
    x = r.normal(B, S, W, dtype=torch.bfloat16)
    params = quantize_vit_block(vit_block_params(r, W, M, dtype=torch.float32))
    kw = dict(heads=heads, eps=eps, scale=(W // heads) ** -0.5, quick=quick, acts=VIT_I8_ACTS)
    with torch.inference_mode():
        got = fused_vit_block_i8(x, *params, **kw)
        want = fused_vit_block_i8_plain(x, *params, **kw)
        torch.cuda.synchronize()
        row = _errors(got, want)
        row["out_max_abs"] = want.float().abs().max().item()
        row["ms"] = cuda_ms(lambda: fused_vit_block_i8(x, *params, **kw))
        row["plain_ms"] = cuda_ms(lambda: fused_vit_block_i8_plain(x, *params, **kw),
                                  iters=3, warmup=1)
    row["ok"] = row["finite"] and row["max_abs_err"] <= 0.125 and row["mean_abs_err"] <= 0.015
    row["shape"] = f"B={B} S={S} W={W} M={M} H={heads} int8 dense, bf16"
    row.update(_vit_block_work(B, S, W, M, int8=True))
    return row


def check_vit_tower_i8(device="cuda", depth=23, B=8, S=257, W=1024, M=4096, heads=16,
                       seed=9) -> dict:
    """The 23-block int8 chain: every stage within :data:`STAGE_BOUNDS`."""
    return _vit_chain(device, seed, depth, B, S, W, M, heads, int8=True)


def check_library_yardsticks(device="cuda", B=ENCODE_BATCH, S=257, W=1024, heads=16,
                             seed=10) -> dict:
    """The building-block kernels beside the one PyTorch call that computes
    the same function, at the tower's shapes (times only; the errors of these
    kernels are held through the chains above)."""
    F = torch.nn.functional
    r = _Rand(device, seed)
    x = r.normal(B, S, W, dtype=torch.bfloat16)
    w, b = r.normal(3 * W, W, std=0.02, dtype=torch.bfloat16), r.normal(3 * W, std=0.02)
    lw, lb = r.normal(W, std=0.1, mean=1.0), r.normal(W, std=0.02)
    qkv = r.normal(B, S, 3 * W, dtype=torch.bfloat16)
    q, k, v = qkv[..., :W], qkv[..., W:2 * W], qkv[..., 2 * W:]
    heads4 = [t.reshape(B, S, heads, W // heads).transpose(1, 2) for t in (q, k, v)]
    bb = b.to(torch.bfloat16)
    with torch.inference_mode():
        row = {"finite": True, "max_abs_err": 0.0, "mean_abs_err": 0.0, "ok": True,
               "gemm_bf16_ms": cuda_ms(lambda: primitives.gemm_cuda(x, w, b)),
               "linear_ms": cuda_ms(lambda: F.linear(x, w, bb)),
               "attention_ms": cuda_ms(lambda: primitives.attention_cuda(
                   q, k, v, heads, (W // heads) ** -0.5)),
               "sdpa_ms": cuda_ms(lambda: F.scaled_dot_product_attention(*heads4)),
               "layer_norm_ms": cuda_ms(lambda: primitives.layer_norm_cuda(x, lw, lb, 1e-5)),
               "f_layer_norm_ms": cuda_ms(lambda: F.layer_norm(x.float(), (W,), lw, lb, 1e-5)),
               "f_layer_norm_bf16_ms": cuda_ms(lambda: F.layer_norm(
                   x, (W,), lw.to(x.dtype), lb.to(x.dtype), 1e-5))}
    row["shape"] = (f"B={B} S={S} W={W} bf16, kernel / library ms: gemm [3W,W] "
                    f"{row['gemm_bf16_ms']:.4f} / F.linear {row['linear_ms']:.4f}; attention "
                    f"{row['attention_ms']:.4f} / SDPA {row['sdpa_ms']:.4f}; LayerNorm "
                    f"{row['layer_norm_ms']:.4f} / F.layer_norm(fp32 copy) "
                    f"{row['f_layer_norm_ms']:.4f}, F.layer_norm(bf16) "
                    f"{row['f_layer_norm_bf16_ms']:.4f}")
    return row


# ------------------------------------------- the bf16 / fp32 dense kernel

# The bf16 products of the towers' encode (ENCODE_BATCH images): name -> (M,
# N, K, dtype, epilogue).
GEMM_PRODUCTS = {
    "vit qkv": (_VIT_M, 3072, 1024, torch.bfloat16, "bias"),
    "vit proj": (_VIT_M, 1024, 1024, torch.bfloat16, "bias+residual"),
    "vit fc1": (_VIT_M, 4096, 1024, torch.bfloat16, "bias,quick_gelu"),
    "eva qkv": (_VIT_M, 4224, 1408, torch.bfloat16, "bias"),
    "eva proj": (_VIT_M, 1408, 1408, torch.bfloat16, "bias+residual"),
    "eva fc1": (_VIT_M, 6144, 1408, torch.bfloat16, "bias,gelu"),
    "eva fc2": (_VIT_M, 1408, 6144, torch.bfloat16, "bias+residual_f32"),
    "vit fc2, fp32 residual": (_VIT_M, 1024, 4096, torch.bfloat16, "bias+residual_f32"),
}

# The fp32 products of the Q-Former (K3's ten dense ops) at the main paths'
# shapes: the queries pass (ENCODE_BATCH items of 32 rows, 257 image rows) and
# a query batch (QUERY_BATCH items of 64 rows: 32 query rows, 32 text rows),
# over ViT-L's 1024-wide and EVA's 1408-wide image rows; and an fp32 tower's
# fc2. name -> (M, N, K, epilogue).
_QF_W, _QF_M = 768, 3072
GEMM_F32_PRODUCTS = {
    "qformer self qkv / out, 2048 rows": (_F_M, _QF_W, _QF_W, "bias"),
    "qformer cross q / out, query rows": (_F_M // 2, _QF_W, _QF_W, "bias"),
    "qformer cross kv, queries pass": (_VIT_M, _QF_W, 1024, "bias"),
    "qformer cross kv, fusion pass": (QUERY_BATCH * 257, _QF_W, 1024, "bias"),
    "qformer cross kv, queries pass, EVA": (_VIT_M, _QF_W, 1408, "bias"),
    "qformer cross kv, fusion pass, EVA": (QUERY_BATCH * 257, _QF_W, 1408, "bias"),
    "qformer fc1, 2048 rows": (_F_M, _QF_M, _QF_W, "bias,gelu"),
    "qformer fc2, 2048 rows": (_F_M, _QF_W, _QF_M, "bias"),
    "qformer fc1, half the rows": (_F_M // 2, _QF_M, _QF_W, "bias,gelu"),
    "qformer fc2, half the rows": (_F_M // 2, _QF_W, _QF_M, "bias"),
    "fp32 tower fc2, fp32 residual": (8 * 257, 1024, 4096, "bias+residual_f32"),
    # the rerank's memory: bench.py's tile on ViT-L, and a CIRR validation tile
    # on EVA ViT-g, whose M K = 1,542,000 x 1408 is past 2^31 (one launch)
    "qformer cross kv, rerank": (RERANK_TILE * RERANK_MEMORY, _QF_W, 1024, "bias"),
    "qformer cross kv, rerank, EVA": (RERANK_CIRR_TILE * RERANK_MEMORY, _QF_W, 1408, "bias"),
}


def _gemm_spec(name: str) -> tuple:
    if name in GEMM_PRODUCTS:
        return GEMM_PRODUCTS[name]
    M, N, K, epilogue = GEMM_F32_PRODUCTS[name]
    return M, N, K, torch.float32, epilogue


def _held(kind: str, got: torch.Tensor, want: torch.Tensor) -> dict:
    """One call held as a stage of ``kind``: its row of :class:`StageRecorder`."""
    rec = StageRecorder()
    rec.add(f"{kind} -> {_TYPE[got.dtype]}", got, want)
    return rec.rows()[0]


def check_gemm(name: str, device="cuda", seed=12) -> dict:
    """One product of :data:`GEMM_PRODUCTS` or :data:`GEMM_F32_PRODUCTS` with
    the epilogue its path runs, against the plain version, within the bound
    of its stage in :data:`STAGE_BOUNDS`; the library call is ``F.linear``
    (without the epilogue's residual; in fp32 with TF32 off, as the caller
    sets it)."""
    M, N, K, dtype, epilogue = _gemm_spec(name)
    r = _Rand(device, seed)
    x, w = r.normal(M, K, dtype=dtype), r.normal(N, K, std=0.02, dtype=dtype)
    b = r.normal(N, std=0.02)
    kw = {}
    if "gelu" in epilogue:
        kw["act"] = "quick_gelu" if "quick_gelu" in epilogue else "gelu"
    if "residual" in epilogue:
        kw["residual"] = r.normal(M, N, dtype=dtype)
        kw["residual_f32"] = epilogue.endswith("_f32")
    kind = "gemm, fp32 residual" if kw.get("residual_f32") else "gemm"
    with torch.inference_mode():
        got, want = primitives.gemm_cuda(x, w, b, **kw), primitives.gemm_plain(x, w, b, **kw)
        torch.cuda.synchronize()
        row = _errors(got, want)
        stage = _held(kind, got, want)
        del got, want
        row["ms"] = cuda_ms(lambda: primitives.gemm_cuda(x, w, b, **kw))
        row["plain_ms"] = cuda_ms(lambda: primitives.gemm_plain(x, w, b, **kw), iters=3, warmup=1)
        bb = b.to(dtype)
        row["library_ms"] = cuda_ms(lambda: torch.nn.functional.linear(x, w, bb))
    row["ok"] = row["finite"] and stage["ok"]
    row["shape"] = (f"M={M} N={N} K={K} {_TYPE[dtype]} {epilogue}: differ {stage['differ']:.2e}, "
                    f"relative err {stage['err']:.2e}; F.linear {row['library_ms']:.4f} ms")
    elt = 2 if dtype == torch.bfloat16 else 4
    row["bytes"] = elt * (M * K + N * K + M * N * (2 if "residual" in kw else 1)) + 4 * N
    row["op_seconds"] = 2 * M * N * K / PEAK_OPS["bf16" if elt == 2 else "fp32"]
    row["tflops"] = 2 * M * N * K / (row["ms"] * 1e-3) / 1e12
    return row


# Ragged products for the bf16 kernel's tile edges: a last row tile of 1, 63
# and 65 rows, N beside a multiple of either tile width (and odd, which takes
# the epilogue's scalar stores), K of 8 and 72 (a depth box that hangs over
# the edge), a product smaller than one tile and one of several tiles each way.
GEMM_EDGE_SHAPES = [(1, 8, 8), (63, 72, 72), (65, 130, 8), (257, 1000, 72), (129, 257, 136),
                    (127, 255, 200), (300, 37, 64), (128, 256, 64), (385, 384, 1032),
                    (16 * 257, 520, 328)]
# The same kinds of shape for the fp32 kernel (K % 4 == 0; depth steps of 32),
# with products that take each of its block tiles (128 x 128 where a product
# needs several waves of it: 2047 x 3070; 64 x 96 elsewhere)
GEMM_F32_EDGE_SHAPES = [(1, 8, 4), (63, 72, 36), (65, 130, 4), (257, 1000, 72), (129, 257, 132),
                        (127, 255, 200), (300, 37, 64), (64, 96, 32), (385, 384, 1028),
                        (1024, 768, 768), (2048, 768, 100), (16 * 257, 520, 328),
                        (2047, 3070, 68)]
# name -> (with a bias, activation, residual: None, "model dtype" or "fp32")
GEMM_EPILOGUES = {"none": (False, None, None), "bias": (True, None, None),
                  "quick_gelu": (True, "quick_gelu", None), "gelu": (True, "gelu", None),
                  "residual": (True, None, "model dtype"), "residual_f32": (True, None, "fp32")}


def check_gemm_edges(device="cuda", seed=17, dtype=torch.bfloat16) -> dict:
    """The bf16 (or fp32) GEMM kernel over :data:`GEMM_EDGE_SHAPES` (or
    :data:`GEMM_F32_EDGE_SHAPES`), each with every epilogue and both residual
    modes, against the plain version within the bound of its stage; every
    output element is compared, so a fault at a tile's edge (a row or column
    dropped, a depth box not zero-filled) fails it. The wrapper must refuse a
    K that is not a whole number of 16-byte units (K % 8 in bf16, K % 4 in
    fp32) before any launch."""
    r = _Rand(device, seed)
    worst = {"differ": 0.0, "err": 0.0}
    bad, cases = [], 0
    shapes = GEMM_EDGE_SHAPES if dtype == torch.bfloat16 else GEMM_F32_EDGE_SHAPES
    with torch.inference_mode():
        for M, N, K in shapes:
            x = r.normal(M, K, dtype=dtype)
            w = r.normal(N, K, std=0.05, dtype=dtype)
            b, res = r.normal(N, std=0.05), r.normal(M, N, dtype=dtype)
            for name, (with_bias, act, residual) in GEMM_EPILOGUES.items():
                kw = {"act": act}
                if residual is not None:
                    kw.update(residual=res, residual_f32=residual == "fp32")
                bias = b if with_bias else None
                got = primitives.gemm_cuda(x, w, bias, **kw)
                want = primitives.gemm_plain(x, w, bias, **kw)
                kind = "gemm, fp32 residual" if kw.get("residual_f32") else "gemm"
                stage = _held(kind, got, want)
                cases += 1
                worst = {k: max(worst[k], stage[k]) for k in worst}
                if not stage["ok"] or not bool(torch.isfinite(got).all()) or got.shape != want.shape:
                    bad.append(f"{M}x{N}x{K} {name}: differ {stage['differ']:.2e} err {stage['err']:.2e}")
        bad_k = 12 if dtype == torch.bfloat16 else 6
        before = (primitives.gemm_cuda.launches_bf16, primitives.gemm_cuda.launches_f32)
        try:
            primitives.gemm_cuda(r.normal(4, bad_k, dtype=dtype), r.normal(4, bad_k, dtype=dtype))
            bad.append(f"K={bad_k} was not refused")
        except ValueError:
            pass
        if (primitives.gemm_cuda.launches_bf16, primitives.gemm_cuda.launches_f32) != before:
            bad.append(f"K={bad_k} was counted as a launch")
        torch.cuda.synchronize()
    return {"ok": not bad, "finite": True, "max_abs_err": worst["err"], "mean_abs_err": 0.0,
            "shape": (f"{cases} cases over {len(shapes)} ragged shapes x {len(GEMM_EPILOGUES)} "
                      f"epilogues, {_TYPE[dtype]}: worst differ {worst['differ']:.2e}, worst "
                      f"relative err {worst['err']:.2e}" + (f"; FAILED: {bad}" if bad else ""))}


# Ragged products for the s8 kernel's tile edges: a last row tile of 1, 63 and
# 65 rows; N = 2 mod 16 (no TMA for int8 rows: 18, 130, 34), 2 mod 8 (none for
# bf16 rows either: 266, 34) and 8 mod 16 (bf16 through TMA, int8 not: 1000,
# 520); K of 16, 48 and 144 (a depth box that hangs over the edge) and 1040
# (several steps, the last one ragged); one tile, several each way, the
# Q-Former's one-wave 2048 x 768 x 768, and a product on the wide tile.
GEMM_I8_EDGE_SHAPES = [(1, 18, 16), (63, 130, 48), (65, 266, 144), (129, 256, 144),
                       (257, 1000, 48), (300, 34, 16), (385, 384, 1040), (2048, 768, 768),
                       (16 * 257, 2048, 80), (16 * 257, 520, 336)]
# name -> (kind of stage, row scales, bias, activation, output: "f32" / "bf16" /
# "s8", residual: None, "aligned" or "8-byte": a view whose data starts 8
# bytes past a 16-byte boundary, which the kernel must store without TMA)
GEMM_I8_EPILOGUES = {
    "rows->f32": ("gemm_i8 -> f32", True, True, None, "f32", None),
    "rows,gelu->f32": ("gemm_i8 -> f32", True, True, "gelu", "f32", None),
    "->f32+residual, no bias": ("gemm_i8 -> f32", False, False, None, "f32", "aligned"),
    "bf16": ("gemm_i8 -> bf16", False, True, None, "bf16", None),
    "bf16, no bias": ("gemm_i8 -> bf16", False, False, None, "bf16", None),
    "bf16+residual": ("gemm_i8 -> bf16", False, True, None, "bf16", "aligned"),
    "bf16+residual, 8-byte aligned": ("gemm_i8 -> bf16", False, True, None, "bf16", "8-byte"),
    "gelu->bf16": ("gemm_i8 -> bf16", False, True, "gelu", "bf16", None),
    "->s8": ("gemm_i8 -> s8", False, True, None, "s8", None),
    "gelu->s8": ("gemm_i8 -> s8", False, True, "gelu", "s8", None),
    "quick_gelu->s8": ("gemm_i8 -> s8", False, True, "quick_gelu", "s8", None),
}


def check_gemm_i8_edges(device="cuda", seed=20) -> dict:
    """The s8 GEMM kernel over :data:`GEMM_I8_EDGE_SHAPES`: the raw s32
    product equal to plain, and every epilogue of :data:`GEMM_I8_EPILOGUES`
    within the bound of its stage in :data:`STAGE_BOUNDS`, the share of
    elements that differ counted over all the cases of that kind (QuickGELU
    -> int8 moves a code in a million by one, so one small product alone
    could not hold a share). The wrapper must refuse K % 16 != 0 and odd N
    before any launch."""
    r = _Rand(device, seed)
    tally: Dict[str, List[float]] = {}  # kind -> [elements that differ, elements, worst]
    bad, cases = [], 0
    with torch.inference_mode():
        for M, N, K in GEMM_I8_EDGE_SHAPES:
            a8, w8 = _codes(r, M, K), _codes(r, N, K)
            got, want = primitives.gemm_i8_cuda(a8, w8), primitives.gemm_i8_plain(a8, w8)
            cases += 1
            if got.dtype != torch.int32 or got.shape != want.shape or not torch.equal(
                    got.long(), want.long()):
                bad.append(f"{M}x{N}x{K} raw s32")
            # sums of K products of codes: about 5400 sqrt(K); rescaled to about 2
            unit = 2.0 / (5400.0 * K ** 0.5)
            rs = r.normal(M).abs() + 0.5
            cs = (r.normal(N).abs() + 0.5) * unit
            bias = r.normal(N, std=0.5)
            for name, (kind, rows, with_bias, act, out, residual) in GEMM_I8_EPILOGUES.items():
                kw = {"act": act, "bias": bias if with_bias else None,
                      "row_scale": rs if rows else None, "col_alpha": 1.0 if rows else 0.5}
                if out == "s8":
                    kw["out_scale"] = 0.05
                else:
                    kw["out_dtype"] = torch.float32 if out == "f32" else torch.bfloat16
                if residual is not None:
                    dt = kw["out_dtype"]
                    pad = 8 // dt.itemsize if residual == "8-byte" else 0
                    kw["residual"] = r.normal(M * N + pad, dtype=dt)[pad:].view(M, N)
                got = primitives.gemm_i8_cuda(a8, w8, cs, **kw)
                want = primitives.gemm_i8_plain(a8, w8, cs, **kw)
                cases += 1
                d = (got.float() - want.float()).abs()
                top = max(want.float().abs().max().item(), 1e-30)
                worst = d.max().item() if got.dtype == torch.int8 else d.max().item() / top
                t = tally.setdefault(kind, [0.0, 0.0, 0.0])
                t[0] += (d > 0).sum().item()
                t[1] += d.numel()
                t[2] = max(t[2], worst)
                if got.dtype != want.dtype or got.shape != want.shape or not bool(
                        torch.isfinite(got.float()).all()):
                    bad.append(f"{M}x{N}x{K} {name}: {got.dtype} {tuple(got.shape)}")
        for kind, (differ, n, worst) in tally.items():
            share, by = STAGE_BOUNDS[kind]
            if differ / n > share or worst > by:
                bad.append(f"{kind}: share that differs {differ / n:.2e}, worst {worst:.2e}")
        before = primitives.gemm_i8_cuda.launches
        for M, N, K in ((4, 8, 24), (4, 7, 32)):
            try:
                primitives.gemm_i8_cuda(_codes(r, M, K), _codes(r, N, K))
                bad.append(f"N={N} K={K} was not refused")
            except ValueError:
                pass
        if primitives.gemm_i8_cuda.launches != before:
            bad.append("a refused call was counted as a launch")
        torch.cuda.synchronize()
    summary = "; ".join(f"{kind}: differ {d / n:.1e} of {int(n)}, worst {w:.1e}"
                        for kind, (d, n, w) in sorted(tally.items()))
    return {"ok": not bad, "finite": True,
            "max_abs_err": max(w for _, _, w in tally.values()), "mean_abs_err": 0.0,
            "shape": (f"{cases} cases over {len(GEMM_I8_EDGE_SHAPES)} ragged shapes (raw s32 and "
                      f"{len(GEMM_I8_EPILOGUES)} epilogues): {summary}"
                      + (f"; FAILED: {bad}" if bad else ""))}


def check_gemm_host_cost(device="cuda", calls=200, seed=18) -> dict:
    """What one call of ``gemm_cuda`` and of ``gemm_i8_cuda`` costs on the
    host (the wrapper's checks, the plan, the tensor maps and the launch), on
    a product so small that the device never falls behind: wall time of
    ``calls`` calls without a synchronise, over their number. The s8 GEMM is
    taken raw and with the Q-Former's epilogue (row and column scales, bias,
    fp32 out)."""

    r = _Rand(device, seed)
    x, w = r.normal(128, 64, dtype=torch.bfloat16), r.normal(128, 64, dtype=torch.bfloat16)
    xf, wf = x.float(), w.float()
    a8, w8 = _codes(r, 128, 64), _codes(r, 128, 64)
    cs, b, rs = r.normal(128).abs() * 1e-3, r.normal(128), r.normal(128).abs()
    calls_of = {"bf16": lambda: primitives.gemm_cuda(x, w),
                "f32": lambda: primitives.gemm_cuda(xf, wf),
                "s8": lambda: primitives.gemm_i8_cuda(a8, w8),
                "s8_rows": lambda: primitives.gemm_i8_cuda(a8, w8, cs, b, row_scale=rs)}
    out = {}
    with torch.inference_mode():
        for name, fn in calls_of.items():
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            out[name] = (time.perf_counter() - t0) / calls * 1e6
            torch.cuda.synchronize()
    return {"ok": True, "finite": True, "max_abs_err": 0.0, "mean_abs_err": 0.0,
            **{f"host_us_{k}": v for k, v in out.items()},
            "shape": (f"host side of one call, 128x128x64: gemm_cuda bf16 (plan, 2 tensor maps, "
                      f"launch) {out['bf16']:.1f} us, fp32 (plan, launch) {out['f32']:.1f} us; "
                      f"gemm_i8_cuda (plan, 2 tensor maps, launch) raw {out['s8']:.1f} us, row "
                      f"and column scales, bias -> fp32 {out['s8_rows']:.1f} us")}


# ------------------------------------------------------------- attention


def _sdpa_fn(q, k, v):
    """``F.scaled_dot_product_attention`` on BSHD tensors (its BHSD views)."""
    h = [t.transpose(1, 2) for t in (q, k, v)]
    return lambda: torch.nn.functional.scaled_dot_product_attention(*h)


def _device_times(row: dict, kernel: Callable[[], object], library: Callable[[], object]) -> None:
    """The kernel's and the library call's device ms (:func:`device_ms`) on a
    row, with the names of the kernels the library call ran."""
    row["device_ms"], _ = device_ms(kernel)
    row["library_device_ms"], names = device_ms(library)
    row["library_kernels"] = sorted(names)


def check_attention(D: int, dtype=torch.bfloat16, device="cuda", B=ENCODE_BATCH, S=257,
                    heads=16, seed=13) -> dict:
    """The attention kernel on a packed qkv, read in place, at head dim ``D``
    against its plain version, within the bound of its stage."""
    r = _Rand(device, seed)
    W = heads * D
    qkv = r.normal(B, S, 3 * W, dtype=dtype)
    q, k, v = qkv[..., :W], qkv[..., W:2 * W], qkv[..., 2 * W:]
    scale = D ** -0.5
    kind = "attention" if D == 64 else f"attention D={D}"
    with torch.inference_mode():
        got = primitives.attention_cuda(q, k, v, heads, scale)
        want = primitives.attention_plain(q, k, v, heads, scale)
        torch.cuda.synchronize()
        row = _errors(got, want)
        stage = _held(kind, got, want)
        row["ms"] = cuda_ms(lambda: primitives.attention_cuda(q, k, v, heads, scale))
        row["plain_ms"] = cuda_ms(lambda: primitives.attention_plain(q, k, v, heads, scale),
                                  iters=3, warmup=1)
        library = _sdpa_fn(*(t.reshape(B, S, heads, D) for t in (q, k, v)))
        row["library_ms"] = cuda_ms(library)
        _device_times(row, lambda: primitives.attention_cuda(q, k, v, heads, scale), library)
    row["ok"] = row["finite"] and stage["ok"]
    row["shape"] = (f"B={B} S={S} H={heads} D={D} {_TYPE[dtype]}, packed qkv: differ "
                    f"{stage['differ']:.2e}, relative err {stage['err']:.2e}; SDPA "
                    f"{row['library_ms']:.4f} ms")
    elt = 2 if dtype == torch.bfloat16 else 4
    row["bytes"] = elt * 4 * B * S * W
    row["op_seconds"] = 4 * B * S * S * W / PEAK_OPS["bf16" if elt == 2 else "fp32"]
    return row


def check_flash_attention(D: int, dtype=torch.bfloat16, device="cuda", B=ENCODE_BATCH, Sq=257,
                          Sk=257, heads=16, seed=14) -> dict:
    """K8 on separate BSHD tensors against its plain version (normalise,
    then round), within the bound of its stage; the library call is
    ``F.scaled_dot_product_attention``."""
    r = _Rand(device, seed)
    q = r.normal(B, Sq, heads, D, dtype=dtype)
    k, v = r.normal(B, Sk, heads, D, dtype=dtype), r.normal(B, Sk, heads, D, dtype=dtype)
    scale = D ** -0.5
    kind = "flash_attention" if D == 64 else f"flash_attention D={D}"
    with torch.inference_mode():
        got = flash_attention(q, k, v, scale)
        want = primitives.flash_attention_plain(q, k, v, scale)
        torch.cuda.synchronize()
        row = _errors(got, want)
        stage = _held(kind, got, want)
        row["ms"] = cuda_ms(lambda: flash_attention(q, k, v, scale))
        row["plain_ms"] = cuda_ms(lambda: primitives.flash_attention_plain(q, k, v, scale),
                                  iters=3, warmup=1)
        library = _sdpa_fn(q, k, v)
        row["library_ms"] = cuda_ms(library)
        _device_times(row, lambda: flash_attention(q, k, v, scale), library)
    row["ok"] = row["finite"] and stage["ok"] and got.shape == q.shape
    row["shape"] = (f"B={B} Sq={Sq} Sk={Sk} H={heads} D={D} {_TYPE[dtype]} BSHD: differ "
                    f"{stage['differ']:.2e}, relative err {stage['err']:.2e}; SDPA "
                    f"{row['library_ms']:.4f} ms")
    elt = 2 if dtype == torch.bfloat16 else 4
    row["bytes"] = elt * 2 * B * (Sq + Sk) * heads * D
    row["op_seconds"] = 4 * B * Sq * Sk * heads * D / PEAK_OPS["bf16" if elt == 2 else "fp32"]
    return row


# The Q-Former's fp32 attention calls (12 heads of 64) in the three serving
# shapes: name -> (B, Sq, Sk, with the padded text mask's column bias). The
# queries pass attends over its 32 query rows, then into the 257 image rows;
# a query batch's fusion pass over 64 rows (masked), then its 32 query rows
# into the image; the prompt pass over 64 rows (masked).
QF_ATTENTION = {
    "queries self": (ENCODE_BATCH, 32, 32, False),
    "queries cross": (ENCODE_BATCH, 32, 257, False),
    "fusion self": (QUERY_BATCH, 64, 64, True),
    "fusion cross": (QUERY_BATCH, 32, 257, False),
    "prompt self": (QUERY_BATCH, 64, 64, True),
    # a CIRR rerank tile: the queries into the 514-row memory (the last 32-key
    # chunk holds 2 keys; B = 3000 in gridDim.z), and the masked self-attention
    "rerank cross": (RERANK_CIRR_TILE, 32, RERANK_MEMORY, False),
    "rerank self": (RERANK_CIRR_TILE, 64, 64, True),
}


def check_qformer_attention(name: str, device="cuda", heads=12, W=768, seed=21) -> dict:
    """The attention kernel's fp32 path at one Q-Former call of
    :data:`QF_ATTENTION` against its plain version, within the bound of its
    stage; the library call is ``F.scaled_dot_product_attention`` in fp32
    (TF32 off, as the caller sets it) with the same additive column bias."""
    B, Sq, Sk, masked = QF_ATTENTION[name]
    r = _Rand(device, seed)
    q, k, v = r.normal(B, Sq, W), r.normal(B, Sk, W), r.normal(B, Sk, W)
    bias = None
    if masked:
        lengths = torch.randint(Sk // 2, Sk + 1, (B,), generator=r.gen, device=device)
        cols = torch.arange(Sk, device=device)[None]
        bias = torch.where(cols < lengths[:, None], 0.0, -10000.0).float().contiguous()
    scale = (W // heads) ** -0.5
    heads4 = [t.reshape(B, -1, heads, W // heads).transpose(1, 2) for t in (q, k, v)]
    mask = None if bias is None else bias[:, None, None, :]
    with torch.inference_mode():
        got = primitives.attention_cuda(q, k, v, heads, scale, bias)
        want = primitives.attention_plain(q, k, v, heads, scale, bias)
        torch.cuda.synchronize()
        row = _errors(got, want)
        stage = _held("attention", got, want)
        row["ms"] = cuda_ms(lambda: primitives.attention_cuda(q, k, v, heads, scale, bias))
        row["plain_ms"] = cuda_ms(lambda: primitives.attention_plain(q, k, v, heads, scale, bias),
                                  iters=3, warmup=1)
        library = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
            *heads4, attn_mask=mask, scale=scale)
        row["library_ms"] = cuda_ms(library)
        _device_times(row, lambda: primitives.attention_cuda(q, k, v, heads, scale, bias), library)
    row["ok"] = row["finite"] and stage["ok"]
    row["shape"] = (f"B={B} Sq={Sq} Sk={Sk} H={heads} D={W // heads} fp32"
                    f"{', column bias' if masked else ''}: differ {stage['differ']:.2e}, relative "
                    f"err {stage['err']:.2e}; SDPA {row['library_ms']:.4f} ms")
    row["bytes"] = 4 * (2 * B * Sq * W + 2 * B * Sk * W + (B * Sk if masked else 0))
    row["op_seconds"] = 4 * B * Sq * Sk * W / PEAK_OPS["fp32"]
    return row


def run_qformer_fp32(device="cuda") -> List[dict]:
    """The Q-Former's two fp32 kernels alone at the main paths' shapes: the
    GEMM at every product of :data:`GEMM_F32_PRODUCTS` beside ``F.linear``,
    and the attention at every call of :data:`QF_ATTENTION` beside SDPA."""
    rows = [dict(check=f"gemm f32 {name}", **check_gemm(name, device))
            for name in GEMM_F32_PRODUCTS]
    rows += [dict(check=f"attention f32 qformer {name}", **check_qformer_attention(name, device))
             for name in QF_ATTENTION]
    return rows


# (Sq, Sk) for the bf16 attention kernel's tile edges: one row, one key, a
# last warp tile of 1 and of 15 rows, a block of exactly 96 rows and one more,
# a last key chunk of 1, 63 and 64 keys, a last score tile or P V step half
# full, the Q-Former's 32 into 257
ATTN_EDGE_SHAPES = [(1, 1), (1, 257), (257, 1), (31, 32), (32, 257), (257, 257), (96, 64),
                    (97, 130), (16, 65), (200, 63), (130, 72), (113, 120)]


def check_attention_edges(device="cuda", seed=19) -> dict:
    """The bf16 attention kernel over :data:`ATTN_EDGE_SHAPES` at both head
    dims, against the plain version within the bound of its stage: q, k and v
    as strided views of one packed tensor (read in place), as BSHD tensors
    through ``flash_attention_cuda``, and with a 0 / -10000 column bias whose
    first item is fully masked (spread evenly, as the plain softmax does)."""
    r = _Rand(device, seed)
    B, heads = 3, 4
    worst = {"differ": 0.0, "err": 0.0}
    bad, cases = [], 0

    def hold(kind, what, got, want):
        nonlocal worst, cases
        stage = _held(kind, got, want)
        cases += 1
        worst = {k: max(worst[k], stage[k]) for k in worst}
        if not stage["ok"] or not bool(torch.isfinite(got).all()) or got.shape != want.shape:
            bad.append(f"{what}: differ {stage['differ']:.2e} err {stage['err']:.2e}")

    with torch.inference_mode():
        for D in primitives.HEAD_DIMS:
            W, scale = heads * D, D ** -0.5
            kind = "attention" if D == 64 else f"attention D={D}"
            for Sq, Sk in ATTN_EDGE_SHAPES:
                S = max(Sq, Sk)
                packed = r.normal(B, S, 3 * W, dtype=torch.bfloat16)
                q, k, v = packed[:, :Sq, :W], packed[:, :Sk, W:2 * W], packed[:, :Sk, 2 * W:]
                hold(kind, f"D={D} {Sq}x{Sk} packed", primitives.attention_cuda(q, k, v, heads, scale),
                     primitives.attention_plain(q, k, v, heads, scale))
                bias = torch.where(torch.rand(B, Sk, generator=r.gen, device=device) < 0.7,
                                   0.0, -10000.0).float()
                bias[0] = -10000.0
                hold(kind, f"D={D} {Sq}x{Sk} bias",
                     primitives.attention_cuda(q, k, v, heads, scale, bias.contiguous()),
                     primitives.attention_plain(q, k, v, heads, scale, bias))
                q4 = r.normal(B, Sq, heads, D, dtype=torch.bfloat16)
                k4, v4 = (r.normal(B, Sk, heads, D, dtype=torch.bfloat16) for _ in range(2))
                hold(f"flash_{kind}", f"D={D} {Sq}x{Sk} BSHD",
                     primitives.flash_attention_cuda(q4, k4, v4, scale),
                     primitives.flash_attention_plain(q4, k4, v4, scale))
        torch.cuda.synchronize()
    return {"ok": not bad, "finite": True, "max_abs_err": worst["err"], "mean_abs_err": 0.0,
            "shape": (f"{cases} cases over {len(ATTN_EDGE_SHAPES)} ragged (Sq, Sk) x head dims "
                      f"{primitives.HEAD_DIMS} x packed / bias / BSHD: worst differ "
                      f"{worst['differ']:.2e}, worst relative err {worst['err']:.2e}"
                      + (f"; FAILED: {bad}" if bad else ""))}


def _exact_scores(t: torch.Tensor) -> torch.Tensor:
    """``t`` as multiples of 1/8 of size at most 2: every product of two such
    values is a multiple of 1/64, and a sum of a head's products is exact in
    fp32 in any order."""
    return (torch.round(t * 8).clamp(-16, 16) / 8).to(t.dtype)


def check_attention_f32_edges(device="cuda", seed=22) -> dict:
    """The fp32 attention kernel over :data:`ATTN_EDGE_SHAPES` at both head
    dims, against the plain version within the bound of its stage: q, k and
    v as strided views of one packed tensor, as BSHD tensors through
    ``flash_attention_cuda``, with a 0 / -10000 column bias, and with an item
    whose every key is masked (spread evenly, as the plain softmax does). The
    masked item's q and k are multiples of 1/8 (:func:`_exact_scores`): at
    -10000 the fp32 grid is 2^-10, so two right sums that differ in the last
    bit can round a score to neighbouring points and move that row by 1e-5;
    with exact scores the case checks the mask and the softmax alone. The
    kernel's warps a block (``sprc_attention_f32_warps``) must equal
    ``schedules.attention_f32_warps`` at every Sq."""
    from sprc_tpu_torch.ops import _ext, schedules

    r = _Rand(device, seed)
    B, heads = 3, 4
    worst = {"differ": 0.0, "err": 0.0}
    bad, cases = [], 0

    def hold(kind, what, got, want):
        nonlocal worst, cases
        stage = _held(kind, got, want)
        cases += 1
        worst = {k: max(worst[k], stage[k]) for k in worst}
        if not stage["ok"] or not bool(torch.isfinite(got).all()) or got.shape != want.shape:
            bad.append(f"{what}: differ {stage['differ']:.2e} err {stage['err']:.2e}")

    lib = _ext.library()
    with torch.inference_mode():
        for Sq in sorted({sq for sq, _ in ATTN_EDGE_SHAPES} | {32, 64, 65, 128, 129}):
            if lib.sprc_attention_f32_warps(Sq) != schedules.attention_f32_warps(Sq):
                bad.append(f"Sq={Sq}: the kernel takes {lib.sprc_attention_f32_warps(Sq)} warps, "
                           f"the plan {schedules.attention_f32_warps(Sq)}")
        for D in primitives.HEAD_DIMS:
            W, scale = heads * D, D ** -0.5
            kind = "attention" if D == 64 else f"attention D={D}"
            for Sq, Sk in ATTN_EDGE_SHAPES:
                S = max(Sq, Sk)
                packed = r.normal(B, S, 3 * W)
                q, k, v = packed[:, :Sq, :W], packed[:, :Sk, W:2 * W], packed[:, :Sk, 2 * W:]
                hold(kind, f"D={D} {Sq}x{Sk} packed",
                     primitives.attention_cuda(q, k, v, heads, scale),
                     primitives.attention_plain(q, k, v, heads, scale))
                bias = torch.where(torch.rand(B, Sk, generator=r.gen, device=device) < 0.7,
                                   0.0, -10000.0).float()
                bias[:, 0] = 0.0
                hold(kind, f"D={D} {Sq}x{Sk} bias",
                     primitives.attention_cuda(q, k, v, heads, scale, bias.contiguous()),
                     primitives.attention_plain(q, k, v, heads, scale, bias))
                bias[0] = -10000.0
                qe, ke = _exact_scores(q).contiguous(), _exact_scores(k).contiguous()
                hold(kind, f"D={D} {Sq}x{Sk} item 0 fully masked",
                     primitives.attention_cuda(qe, ke, v, heads, scale, bias.contiguous()),
                     primitives.attention_plain(qe, ke, v, heads, scale, bias))
                q4 = r.normal(B, Sq, heads, D)
                k4, v4 = (r.normal(B, Sk, heads, D) for _ in range(2))
                hold(f"flash_{kind}", f"D={D} {Sq}x{Sk} BSHD",
                     primitives.flash_attention_cuda(q4, k4, v4, scale),
                     primitives.flash_attention_plain(q4, k4, v4, scale))
        torch.cuda.synchronize()
    return {"ok": not bad, "finite": True, "max_abs_err": worst["err"], "mean_abs_err": 0.0,
            "shape": (f"{cases} cases over {len(ATTN_EDGE_SHAPES)} ragged (Sq, Sk) x head dims "
                      f"{primitives.HEAD_DIMS} x packed / bias / fully masked item / BSHD, fp32: "
                      f"worst differ {worst['differ']:.2e}, worst relative err {worst['err']:.2e}"
                      + (f"; FAILED: {bad}" if bad else ""))}


# LayerNorm calls of the main paths: name -> (rows, W, dtype, with a residual,
# int8 out). The towers' pre-LNs (two a block) over an encode batch, the
# int8 towers' LN -> s8, the Q-Former's post-LN (fp32, residual first) over
# the queries pass and a query batch, and an fp32 tower's LN (validate
# --no-bf16, 8 images).
LN_CALLS = {
    "vit_l bf16": (_VIT_M, 1024, torch.bfloat16, False, False),
    "vit_l bf16 -> s8": (_VIT_M, 1024, torch.bfloat16, False, True),
    "eva bf16": (_VIT_M, 1408, torch.bfloat16, False, False),
    "eva bf16 -> s8": (_VIT_M, 1408, torch.bfloat16, False, True),
    "qformer fp32 + residual, queries pass": (_Q_M, 768, torch.float32, True, False),
    "qformer fp32 + residual, query batch": (_F_M, 768, torch.float32, True, False),
    "fp32 tower vit_l": (8 * 257, 1024, torch.float32, False, False),
}


def check_layer_norm(name: str, device="cuda", seed=23) -> dict:
    """The LayerNorm kernel at one call of :data:`LN_CALLS` against its plain
    version, within the bound of its stage. The library call is
    ``F.layer_norm`` on the same input in its own dtype (bf16 weights for a
    bf16 input, as PyTorch needs them), where one call computes the same
    function: not for the residual's sum nor the int8 codes (null)."""
    rows, W, dtype, with_residual, int8 = LN_CALLS[name]
    r = _Rand(device, seed)
    x = r.normal(rows, W, std=2.0, mean=0.3, dtype=dtype)
    res = r.normal(rows, W, dtype=dtype) if with_residual else None
    lw, lb = r.normal(W, std=0.1, mean=1.0), r.normal(W, std=0.02)
    eps = 1e-5
    kw = {"residual": res, "out_scale": 0.04 if int8 else None}
    with torch.inference_mode():
        got = primitives.layer_norm_cuda(x, lw, lb, eps, **kw)
        want = primitives.layer_norm_plain(x, lw, lb, eps, **kw)
        torch.cuda.synchronize()
        row = _errors(got, want)
        stage = _held("layer_norm", got, want)
        kernel = lambda: primitives.layer_norm_cuda(x, lw, lb, eps, **kw)  # noqa: E731
        row["ms"] = cuda_ms(kernel, iters=20)
        row["plain_ms"] = cuda_ms(lambda: primitives.layer_norm_plain(x, lw, lb, eps, **kw),
                                  iters=5, warmup=1)
        row["device_ms"], _ = device_ms(kernel)
        row["library_ms"] = row["library_device_ms"] = None
        if not with_residual and not int8:
            wl, bl = lw.to(dtype), lb.to(dtype)
            library = lambda: torch.nn.functional.layer_norm(x, (W,), wl, bl, eps)  # noqa: E731
            row["library_ms"] = cuda_ms(library, iters=20)
            row["library_device_ms"], _ = device_ms(library)
    row["ok"] = row["finite"] and stage["ok"]
    elt = x.element_size()
    row["bytes"] = rows * W * (elt * (2 if with_residual else 1) + (1 if int8 else elt)) + 8 * W
    row["op_seconds"] = 0.0
    row["shape"] = (f"{rows} x {W} {_TYPE[dtype]}{' + residual' if with_residual else ''} -> "
                    f"{'s8' if int8 else _TYPE[dtype]}: differ {stage['differ']:.2e}, err "
                    f"{stage['err']:.2e}; device {row['device_ms']:.4f} ms"
                    + (f", F.layer_norm {row['library_device_ms']:.4f} ms"
                       if row["library_device_ms"] else ""))
    return row


# widths (the main path's, a generic multiple of 16 bytes, the largest, one
# that is not a whole number of 16-byte loads) and ragged row counts (blocks
# of 4 rows: 1, 7, 9 rows; 257; 1031)
LN_EDGE_WIDTHS = (768, 1000, 1024, 1408, 4096, 77)
LN_EDGE_ROWS = (1, 7, 9, 257, 1031)


def check_layer_norm_edges(device="cuda", seed=24) -> dict:
    """The LayerNorm kernel over :data:`LN_EDGE_WIDTHS` x :data:`LN_EDGE_ROWS`
    in bf16 and fp32, in its three modes (model dtype out, the residual added
    first, int8 out; the last two also together) and on rows that are not
    16-byte aligned (a view one element into its buffer), against the plain
    version. The worst difference is held per call to the bound of its stage;
    the share of elements that differ is counted over all the calls of a kind
    together (a one-row call has too few elements for a share of 5e-6 to
    mean anything)."""
    r = _Rand(device, seed)
    totals: Dict[str, List[float]] = {}
    bad, cases, worst = [], 0, 0.0
    with torch.inference_mode():
        for dtype in (torch.bfloat16, torch.float32):
            for W in LN_EDGE_WIDTHS:
                lw, lb = r.normal(W, std=0.1, mean=1.0), r.normal(W, std=0.02)
                for rows in LN_EDGE_ROWS:
                    x = r.normal(rows, W, std=2.0, mean=0.3, dtype=dtype)
                    res = r.normal(rows, W, dtype=dtype)
                    shifted = r.normal(rows * W + 1, std=2.0, dtype=dtype)[1:].view(rows, W)
                    calls = [("", x, None, None), (" + residual", x, res, None),
                             (" -> s8", x, None, 0.04), (" + residual -> s8", x, res, 0.04),
                             (" unaligned", shifted, None, None)]
                    for what, xi, ri, scale in calls:
                        got = primitives.layer_norm_cuda(xi, lw, lb, 1e-5, ri, scale)
                        want = primitives.layer_norm_plain(xi, lw, lb, 1e-5, ri, scale)
                        kind = f"layer_norm -> {_TYPE[got.dtype]}"
                        d = (got.float() - want.float()).abs()
                        err = d.max().item()  # int8: in codes; else relative to the top
                        if got.dtype != torch.int8:
                            err /= max(want.float().abs().max().item(), 1e-30)
                            worst = max(worst, err)
                        t = totals.setdefault(kind, [0.0, 0.0])
                        t[0] += (d > 0).sum().item()
                        t[1] += d.numel()
                        cases += 1
                        if (err > STAGE_BOUNDS[kind][1] or got.shape != want.shape
                                or not bool(torch.isfinite(got.float()).all())):
                            bad.append(f"{_TYPE[dtype]} {rows}x{W}{what}: err {err:.2e}")
        torch.cuda.synchronize()
    shares = {kind: n / total for kind, (n, total) in totals.items()}
    bad += [f"{kind}: share {v:.2e}" for kind, v in shares.items() if v > STAGE_BOUNDS[kind][0]]
    return {"ok": not bad, "finite": True, "max_abs_err": worst, "mean_abs_err": 0.0,
            "shape": (f"{cases} cases: W {LN_EDGE_WIDTHS} x rows {LN_EDGE_ROWS} x bf16 / fp32 x "
                      f"plain / residual / s8 / residual s8 / unaligned: share that differs "
                      + ", ".join(f"{k} {v:.2e}" for k, v in sorted(shares.items()))
                      + f"; worst relative err {worst:.2e}" + (f"; FAILED: {bad}" if bad else ""))}


# The quantisers' calls on the main paths: name -> (kernel, rows, W, dtype).
# quantize_static: the int8 tower's ctx before proj (one a block). quantize_rows:
# the Q-Former's rows, ctx and cross q rows of the queries pass and of a query
# batch (64 x 32 rows), the GELU output before fc2, the query batch's query
# and text slices (32 x 32 rows), and the image rows once a pass (encode: 64
# x 257; fusion: 32 x 257) at ViT-L's and EVA's widths.
QUANT_CALLS = {
    "static vit_l ctx": ("static", _VIT_M, 1024, torch.bfloat16),
    "static eva ctx": ("static", _VIT_M, 1408, torch.bfloat16),
    "rows qformer rows": ("rows", _Q_M, 768, torch.float32),
    "rows qformer gelu": ("rows", _Q_M, 3072, torch.float32),
    "rows query slice": ("rows", _F_M // 2, 768, torch.float32),
    "rows query slice gelu": ("rows", _F_M // 2, 3072, torch.float32),
    "rows image vit_l encode": ("rows", _VIT_M, 1024, torch.float32),
    "rows image eva encode": ("rows", _VIT_M, 1408, torch.float32),
    "rows image vit_l fusion": ("rows", QUERY_BATCH * 257, 1024, torch.float32),
    "rows image eva fusion": ("rows", QUERY_BATCH * 257, 1408, torch.float32),
}
QUANT_SCALE = 0.05  # the static scale of the checks (inv = 20)


def _quantize_fns(kind: str, x: torch.Tensor, scale: float = QUANT_SCALE) -> tuple:
    """(kernel, plain) of one quantiser on ``x``, each returning (codes, scales
    or None)."""
    if kind == "static":
        return (lambda: (primitives.quantize_static_cuda(x, scale), None),
                lambda: (quant.quantize_static(x, scale), None))
    return lambda: primitives.quantize_rows_cuda(x), lambda: quant.quantize_rows(x)


def _quantize_differ(got: tuple, want: tuple) -> tuple:
    """(codes that differ, worst difference in codes, worst scale difference)."""
    d = (got[0].int() - want[0].int()).abs()
    scale_err = 0.0 if got[1] is None else (got[1] - want[1]).abs().max().item()
    return int((d > 0).sum().item()), int(d.max().item()), scale_err


def check_quantize(name: str, device="cuda", seed=25) -> dict:
    """One quantiser at one call of :data:`QUANT_CALLS` against its plain
    version: codes and scales bit-equal. ``ms`` is the kernel's device time
    (:func:`device_ms`): a loop through the wrapper (``wrapper_ms``) measures
    the host's cost of a call (about 30 us) wherever the kernel is shorter.
    No one PyTorch call computes either function (``torch.quantize_per_tensor``
    clips to -128 and divides where ``quantize_static`` multiplies by
    ``1 / a``): ``library_ms`` null."""
    kind, rows, W, dtype = QUANT_CALLS[name]
    x = _Rand(device, seed).normal(rows, W, std=2.0, dtype=dtype)
    kernel, plain = _quantize_fns(kind, x)
    with torch.inference_mode():
        differ, worst, scale_err = _quantize_differ(kernel(), plain())
        torch.cuda.synchronize()
        row = {"finite": True, "max_abs_err": float(worst), "mean_abs_err": differ / x.numel(),
               "scale_max_abs": scale_err}
        row["device_ms"], row["device_kernels"] = device_ms(kernel)
        row["ms"] = row["device_ms"]
        row["wrapper_ms"] = cuda_ms(kernel, iters=20)
        row["plain_ms"] = cuda_ms(plain, iters=5, warmup=1)
    row["library_ms"] = None
    row["ok"] = differ == 0 and scale_err == 0.0
    row["bytes"] = rows * W * (x.element_size() + 1) + (4 * rows if kind == "rows" else 0)
    row["op_seconds"] = 0.0
    plan = (schedules.quantize_static_plan(rows * W, x.element_size()) if kind == "static"
            else schedules.quantize_rows_plan(W, x.element_size(), rows=rows))
    row["plan"] = plan
    row["shape"] = (f"{rows} x {W} {_TYPE[dtype]}: codes that differ {differ}, scale diff "
                    f"{scale_err:.1e}; device {row['device_ms']:.4f} ms, through the wrapper "
                    f"{row['wrapper_ms']:.4f} ms; {plan}")
    return row


def run_quantize(device="cuda") -> List[dict]:
    """Both quantisers at every call of :data:`QUANT_CALLS`."""
    return [dict(check=f"quantize {name}", **check_quantize(name, device)) for name in QUANT_CALLS]


# rows and widths of the quantisers' edge checks: one row, a partial block of
# four rows, a warp-count past a block, the encode's rows; widths below a
# 16-byte load, ragged ones, the main path's, a generic multiple of 16 bytes
# and the widest
QUANT_EDGE_ROWS = (1, 3, 33, _VIT_M)
QUANT_EDGE_WIDTHS = (1, 7, 13, 768, 1000, 1024, 1408, 3072, 4096)


def _tie_rows(rows: int, W: int, dtype: torch.dtype) -> torch.Tensor:
    """Rows whose values land on half steps in ``quantize_rows``: each row's
    |max| A sets sc = f32(A) * f32(1 / 127) (a power of two where A = 127 x
    2^e, so that every tie is exact in bf16 too), and the other values are
    (k + 0.5) sc wherever f32(x / sc) is exactly k + 0.5."""
    one = np.float32(1.0 / 127.0)
    k = np.arange(-126, 127)
    out = np.zeros((rows, W), np.float32)
    amaxes = [127 * 2.0 ** -6, 127 * 2.0 ** 3] + ([3.7, 0.013] if dtype == torch.float32 else [])
    for i in range(rows):
        A = np.float32(amaxes[i % len(amaxes)])
        sc = np.float32(A * one)
        t = ((k + 0.5) * np.float64(sc)).astype(np.float32)
        t = t[(t / sc) == (k + 0.5).astype(np.float32)]
        out[i] = np.resize(t, W)
        out[i, i % W] = A if i % 2 else -A
    return torch.from_numpy(out).to(dtype)


def _static_ties(n: int, dtype: torch.dtype) -> tuple:
    """(values, scale) whose products land on half steps in ``quantize_static``:
    (k + 0.5) / 4 with the scale 0.25 (inv 4, every product exact), and the
    same past +-127 (clipped)."""
    k = np.arange(-140, 140)
    return torch.from_numpy(np.resize(((k + 0.5) / 4.0).astype(np.float32), n)).to(dtype), 0.25


def check_quantizer_edges(device="cuda", seed=26) -> dict:
    """Both quantisers, bf16 and fp32, over :data:`QUANT_EDGE_ROWS` x
    :data:`QUANT_EDGE_WIDTHS` (``quantize_static`` on the same rows x W
    values), against their plain versions: zero codes and zero scale
    difference in every case. Each case runs on random rows (std 8: the
    static codes clip at +-127), on a view whose base pointer is 2 or 4 bytes
    past a 16-byte boundary (bf16: both; fp32: 4), on all-zero rows (the
    scale clamped at 1e-8 / 127) and on rows whose values land exactly on
    k + 0.5 before the rounding (ties to even)."""
    r = _Rand(device, seed)
    bad, cases, ties, worst_all = [], 0, 0, 0
    with torch.inference_mode():
        for dtype in (torch.bfloat16, torch.float32):
            elt = torch.tensor([], dtype=dtype).element_size()
            for rows in QUANT_EDGE_ROWS:
                for W in QUANT_EDGE_WIDTHS:
                    n = rows * W
                    pad = r.normal(n + 2, std=8.0, dtype=dtype)
                    inputs = [("", r.normal(rows, W, std=8.0, dtype=dtype), QUANT_SCALE),
                              ("zero", torch.zeros(rows, W, dtype=dtype, device=device),
                               QUANT_SCALE)]
                    inputs += [(f"+{k * elt} bytes", pad[k:k + n].view(rows, W), QUANT_SCALE)
                               for k in (1, 2) if k * elt in (2, 4)]
                    tied, scale = _static_ties(n, dtype)
                    inputs.append(("static ties", tied.view(rows, W).to(device), scale))
                    if rows <= 33 or W in (1024, 1408):
                        inputs.append(("rows ties", _tie_rows(rows, W, dtype).to(device),
                                       QUANT_SCALE))
                    for what, x, sc in inputs:
                        for kind in ("static", "rows"):
                            kernel, plain = _quantize_fns(kind, x, sc)
                            got, want = kernel(), plain()
                            differ, worst, scale_err = _quantize_differ(got, want)
                            cases += 1
                            ties += "ties" in what
                            worst_all = max(worst_all, worst)
                            if (differ or scale_err or got[0].shape != want[0].shape
                                    or (got[1] is not None and got[1].shape != want[1].shape)):
                                bad.append(f"{kind} {_TYPE[dtype]} {rows}x{W} {what}: "
                                           f"{differ} codes differ (by up to {worst}), "
                                           f"scale {scale_err:.1e}")
        torch.cuda.synchronize()
    return {"ok": not bad, "finite": True, "max_abs_err": float(worst_all), "mean_abs_err": 0.0,
            "shape": (f"{cases} cases ({ties} on exact ties): rows {QUANT_EDGE_ROWS} x W "
                      f"{QUANT_EDGE_WIDTHS} x bf16 / fp32 x random (clipped) / zero / base "
                      f"+2, +4 bytes / ties, both kernels: codes and scales equal"
                      + (f"; FAILED ({len(bad)}): {bad[:8]}" if bad else ""))}


def run_attention_f32(device="cuda") -> List[dict]:
    """The fp32 attention at its seven calls of the main paths (the Q-Former's
    five, an fp32 tower's packed qkv and the unfused route's BSHD), each
    beside SDPA in fp32, with device times."""
    rows = [dict(check=f"attention f32 qformer {name}", **check_qformer_attention(name, device))
            for name in QF_ATTENTION]
    return rows + [
        dict(check="attention D=88 fp32", **check_attention(88, torch.float32, device, B=8)),
        dict(check="K8 flash_attention D=64 fp32",
             **check_flash_attention(64, torch.float32, device, B=8))]


def run_layer_norm(device="cuda") -> List[dict]:
    """The LayerNorm kernel at every call of :data:`LN_CALLS`."""
    return [dict(check=f"layer_norm {name}", **check_layer_norm(name, device)) for name in LN_CALLS]


def run_edges(device="cuda") -> List[dict]:
    """The kernels redesigned for Hopper at their tile edges, and the host
    side of a GEMM call."""
    return [dict(check="gemm bf16 edges", **check_gemm_edges(device)),
            dict(check="gemm f32 edges", **check_gemm_edges(device, dtype=torch.float32)),
            dict(check="gemm_i8 edges", **check_gemm_i8_edges(device)),
            dict(check="attention bf16 edges", **check_attention_edges(device)),
            dict(check="attention f32 edges", **check_attention_f32_edges(device)),
            dict(check="layer_norm edges", **check_layer_norm_edges(device)),
            dict(check="quantizer edges", **check_quantizer_edges(device)),
            dict(check="token_max_sim edges", **check_token_max_sim_edges(device)),
            dict(check="gemm host cost", **check_gemm_host_cost(device))]


# -------------------------------------------------------------- K6 and K7


def check_attn_block(device="cuda", B=ENCODE_BATCH, S=257, W=1024, heads=16, eps=1e-5,
                     seed=15) -> dict:
    """K6 against its plain version, bf16, output scale ~5: max-abs <= 0.0625
    and mean-abs <= 4e-3 (K2's bounds: the same four stages, and the residual
    carries the output's scale)."""
    r = _Rand(device, seed)
    x = r.normal(B, S, W, dtype=torch.bfloat16)
    params = vit_block_params(r, W, 128)[:6]
    kw = dict(heads=heads, eps=eps, scale=(W // heads) ** -0.5)
    with torch.inference_mode():
        got = fused_attn_block(x, *params, **kw)
        want = fused_attn_block_plain(x, *params, **kw)
        torch.cuda.synchronize()
        row = _errors(got, want)
        row["ms"] = cuda_ms(lambda: fused_attn_block(x, *params, **kw))
        row["plain_ms"] = cuda_ms(lambda: fused_attn_block_plain(x, *params, **kw),
                                  iters=3, warmup=1)
    row["ok"] = row["finite"] and row["max_abs_err"] <= 0.0625 and row["mean_abs_err"] <= 4e-3
    row["shape"] = f"B={B} S={S} W={W} H={heads} D={W // heads} bf16"
    row["bytes"] = 2 * 2 * B * S * W + 2 * 4 * W * W + 4 * (3 * W + W + 2 * W)
    row["op_seconds"] = (8 * B * S * W * W + 4 * B * S * S * W) / PEAK_OPS["bf16"]
    return row


def check_mlp_block(device="cuda", B=ENCODE_BATCH, S=257, W=1024, M=4096, quick=True, eps=1e-5,
                    seed=16) -> dict:
    """K7 against its plain version, bf16: max-abs <= 0.0625 and mean-abs <=
    4e-3 (K2's bounds; the fc2 stage alone is held in ``check_gemm``)."""
    r = _Rand(device, seed)
    x = r.normal(B, S, W, dtype=torch.bfloat16)
    params = vit_block_params(r, W, M)[6:]
    kw = dict(eps=eps, quick=quick)
    with torch.inference_mode():
        got = fused_mlp_block(x, *params, **kw)
        want = fused_mlp_block_plain(x, *params, **kw)
        torch.cuda.synchronize()
        row = _errors(got, want)
        row["ms"] = cuda_ms(lambda: fused_mlp_block(x, *params, **kw))
        row["plain_ms"] = cuda_ms(lambda: fused_mlp_block_plain(x, *params, **kw),
                                  iters=3, warmup=1)
    row["ok"] = row["finite"] and row["max_abs_err"] <= 0.0625 and row["mean_abs_err"] <= 4e-3
    row["shape"] = f"B={B} S={S} W={W} M={M} {'QuickGELU' if quick else 'exact GELU'} bf16"
    row["bytes"] = 2 * 2 * B * S * W + 2 * 2 * W * M + 4 * (M + W + 2 * W)
    row["op_seconds"] = 4 * B * S * W * M / PEAK_OPS["bf16"]
    return row


def run_validate_path(device="cuda") -> List[dict]:
    """The checks of the validate path's kernels: K6, K7 and K8 at both
    towers' shapes, the attention kernel at head dim 88, K2 and K5 at EVA
    ViT-g's shapes and the towers' bf16 dense products."""
    rows = []
    for D in (64, 88):
        rows.append(dict(check=f"K8 flash_attention D={D}", **check_flash_attention(D, device=device)))
    rows += [dict(check="K8 flash_attention D=88 fp32 Sq=32",
                  **check_flash_attention(88, torch.float32, device, B=8, Sq=32)),
             dict(check="K8 flash_attention D=64 fp32",
                  **check_flash_attention(64, torch.float32, device, B=8)),
             dict(check="attention D=88 bf16", **check_attention(88, device=device)),
             dict(check="attention D=88 fp32",
                  **check_attention(88, torch.float32, device, B=8))]
    for tower, (W, M, heads, quick, eps) in TOWERS.items():
        rows += [dict(check=f"K6 attn_block {tower}",
                      **check_attn_block(device, W=W, heads=heads, eps=eps)),
                 dict(check=f"K7 mlp_block {tower}",
                      **check_mlp_block(device, W=W, M=M, quick=quick, eps=eps))]
    W, M, heads, quick, eps = TOWERS["eva_g"]
    rows += [dict(check="K2 vit_block eva_g",
                  **check_vit_block(device, W=W, M=M, heads=heads, quick=quick, eps=eps)),
             dict(check="K5 vit_block_i8 eva_g",
                  **check_vit_block_i8(device, W=W, M=M, heads=heads, quick=quick, eps=eps))]
    rows += [dict(check=f"gemm {name}", **check_gemm(name, device)) for name in GEMM_PRODUCTS]
    return rows


def check_token_max_sim_retrieval(device="cuda", B=RETRIEVAL_SIM[0], N=RETRIEVAL_SIM[1], Q=32,
                                  E=256, seed=31) -> dict:
    """K1 at COCO's retrieval call (25,000 captions against 5,000 images;
    the plain version's [B, N, Q] product is 16 GB): within 1e-4, as
    :func:`check_token_max_sim`; ``top16_rows_differ``, the rows whose 16
    best items differ in order (``k_test`` of the smoke run; a swap needs
    two scores within the error), reported. Times over fewer launches;
    ``tf32x3_ms`` as :func:`check_token_max_sim`'s (the tensor cores' bound
    in 3xTF32, beside ``op_seconds``' fp32 rate)."""
    r = _Rand(device, seed)
    f = _unit(r, B, E)
    t = _unit(r, N, Q, E)
    with torch.inference_mode():
        got = token_max_sim(f, t)
        want = token_max_sim_plain(f, t)
        torch.cuda.synchronize()
        row = _errors(got, want)
        top_k = torch.sort(got, dim=-1, descending=True, stable=True).indices[:, :16]
        top_p = torch.sort(want, dim=-1, descending=True, stable=True).indices[:, :16]
        row["top16_rows_differ"] = int((top_k != top_p).any(dim=1).sum().item())
        del want, top_k, top_p
        row["ms"] = cuda_ms(lambda: token_max_sim(f, t), iters=5, warmup=1)
        row["plain_ms"] = cuda_ms(lambda: token_max_sim_plain(f, t), iters=2, warmup=1)
        row["yardstick_ms"] = cuda_ms(_sim_yardstick(f, t), iters=2, warmup=1)
    row["library_ms"] = None
    row["ok"] = row["finite"] and row["max_abs_err"] <= 1e-4
    row["shape"] = f"B={B} N={N} Q={Q} E={E} fp32 (COCO test: captions x images)"
    row["bytes"] = 4 * (B * E + N * Q * E + B * N)
    row["op_seconds"] = 2 * B * N * Q * E / PEAK_OPS["fp32"]
    row["tf32x3_ms"] = 3 * 2 * B * N * Q * E / PEAK_OPS["tf32"] * 1e3
    return row


STAGE1_BATCH = 100  # configs/runs/pretrain_stage1.yaml's batch


def run_stage1(device="cuda") -> List[dict]:
    """The checks of BLIP-2 stage 1's paths: its retrieval evaluation at
    COCO's shapes (K1 at 25,000 x 5,000, K2 in fp32 at 364 px: S = 677, EVA
    ViT-g's block, its fp32 attention call, and K3 against 677 memory rows:
    :data:`RETRIEVAL_SHAPES`) and its pretraining's frozen tower (K2 in bf16
    at the YAML's batch of 100, 224 px)."""
    W, M, heads, quick, eps = TOWERS["eva_g"]
    rows = [dict(check="K1 token_max_sim coco", **check_token_max_sim_retrieval(device)),
            dict(check="K2 vit_block eva_g fp32 S=677",
                 **check_vit_block(device, S=RETRIEVAL_MEMORY, W=W, M=M, heads=heads,
                                   quick=quick, eps=eps, dtype=torch.float32)),
            dict(check="K2 vit_block eva_g B=100",
                 **check_vit_block(device, B=STAGE1_BATCH, W=W, M=M, heads=heads, quick=quick,
                                   eps=eps)),
            # the fp32 tower's attention call (packed qkv, D 88) at S = 677
            dict(check="attention D=88 fp32 S=677",
                 **check_attention(88, torch.float32, device, S=RETRIEVAL_MEMORY))]
    rows += [dict(check=f"K3 qformer_layer {shape}", **check_qformer_layer(shape, device))
             for shape in RETRIEVAL_SHAPES]
    return rows


def run_caption(device="cuda") -> List[dict]:
    """The checks of BLIP-2 stage 2's caption path at its batch of 16: K2 in
    fp32 at 364 px (S = 677, EVA ViT-g's block), its fp32 attention call
    (packed qkv, D 88), and K3's queries-only pass into the 677 rows
    (:data:`CAPTION_SHAPES`)."""
    W, M, heads, quick, eps = TOWERS["eva_g"]
    B, S = CAPTION_BATCH, RETRIEVAL_MEMORY
    return [dict(check="K2 vit_block eva_g fp32 S=677 B=16",
                 **check_vit_block(device, B=B, S=S, W=W, M=M, heads=heads, quick=quick, eps=eps,
                                   dtype=torch.float32)),
            dict(check="attention D=88 fp32 S=677 B=16",
                 **check_attention(88, torch.float32, device, B=B, S=S)),
            dict(check="K3 qformer_layer caption queries",
                 **check_qformer_layer("caption queries", device))]


def run_stage2(device="cuda") -> List[dict]:
    """The checks of BLIP-2 stage 2's training and zero-shot VQA paths that
    the caption path's do not cover: K2 in bf16 at 224 px (S = 257, EVA
    ViT-g's block) and its bf16 attention call (packed qkv, D 88) at
    pretrain_stage2.yaml's batch of 32 and at the VQA batch of 16, and K3's
    queries-only pass into the 257 rows (:data:`VQA_SHAPES`)."""
    W, M, heads, quick, eps = TOWERS["eva_g"]
    rows = []
    for B in (STAGE2_TRAIN_BATCH, VQA_BATCH):
        rows += [dict(check=f"K2 vit_block eva_g B={B}",
                      **check_vit_block(device, B=B, W=W, M=M, heads=heads, quick=quick,
                                        eps=eps)),
                 dict(check=f"attention D=88 bf16 B={B}",
                      **check_attention(88, torch.bfloat16, device, B=B))]
    return rows + [dict(check="K3 qformer_layer vqa queries",
                        **check_qformer_layer("vqa queries", device))]


def run_instruct(device="cuda") -> List[dict]:
    """K3 at the InstructBLIP-style models' fusion passes
    (:data:`INSTRUCT_SHAPES`); their tower's K2 and attention at the batch of
    16 and the gallery's queries-only pass are :func:`run_stage2`'s checks."""
    return [dict(check=f"K3 qformer_layer {shape}", **check_qformer_layer(shape, device))
            for shape in INSTRUCT_SHAPES]


# ---------------------------------------------- the Functions of a tower that trains

# The autograd Functions of K2, K6, K7 and K8 (a tower that trains, BLIP-2
# stage 1's coco fine-tune) against autograd over the plain version on the
# same card, inputs and cotangent, at the tower's shapes: EVA ViT-g fp32 at
# 364 px (S = 677, W 1408, D 88) and a batch of UNFROZEN_BATCH, and K2 in bf16
# at ViT-L's shapes. Bounds, fixed before the first reading: the forward is
# the kernel's, held as its own check (K2, K6, K7 fp32: VIT_F32_REL of the
# output's largest |value|; K2 bf16: K2's 0.0625 / 4e-3; K8 fp32: its stage
# bound); the backward recomputes the plain version from the same inputs, so
# the input's and every parameter's gradient equal autograd's over the plain
# version but for the order of the library's sums: max |difference| within
# GRAD_REL of the tensor's largest |gradient| (fp32 1e-5; bf16 one step of
# the largest, 2^-7, should a product round otherwise).
UNFROZEN_BATCH = 4
GRAD_REL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}
FUNCTIONS = {  # name -> (Function, wrapper, plain)
    "FusedViTBlock": (FusedViTBlock, fused_vit_block, fused_vit_block_plain),
    "FusedAttnBlock": (FusedAttnBlock, fused_attn_block, fused_attn_block_plain),
    "FusedMlpBlock": (FusedMlpBlock, fused_mlp_block, fused_mlp_block_plain),
    "FlashAttention": (FlashAttention, flash_attention, primitives.flash_attention_plain),
}


def check_function_grad(name: str, device="cuda", tower="eva_g", dtype=torch.float32,
                        B=UNFROZEN_BATCH, S=RETRIEVAL_MEMORY, seed=41) -> dict:
    """One Function of :data:`FUNCTIONS` with a gradient: its forward output,
    the input's and every parameter's gradient against autograd over the
    plain version, within the bounds above. ``launches``: the wrapper's
    launches in the Function's forward (1; its backward launches none).
    ``ms`` / ``plain_ms``: the forward, kernel and plain (CUDA events);
    ``fwd_bwd_ms`` / ``plain_fwd_bwd_ms``: forward and backward through the
    Function and through autograd over the plain version; ``library_ms``:
    SDPA's forward on K8's inputs (none for the chains)."""
    function, wrapper, plain = FUNCTIONS[name]
    W, M, heads, quick, eps = TOWERS[tower]
    r = _Rand(device, seed)
    scale = (W // heads) ** -0.5
    if name == "FlashAttention":
        ins = [r.normal(B, S, heads, W // heads, dtype=dtype) for _ in range(3)]
        kw = dict(scale=scale)
    else:
        params = list(vit_block_params(r, W, M, dtype=dtype))
        params = {"FusedViTBlock": params, "FusedAttnBlock": params[:6],
                  "FusedMlpBlock": params[6:]}[name]
        ins = [r.normal(B, S, W, dtype=dtype)] + params
        kw = dict(heads=heads, eps=eps, scale=scale, quick=quick)
        if name != "FusedViTBlock":
            kw = {k: kw[k] for k in (("heads", "eps", "scale") if name == "FusedAttnBlock"
                                     else ("eps", "quick"))}
    cot = r.normal(*ins[0].shape, dtype=dtype)

    def run(fn):
        leaves = [t.detach().clone().requires_grad_() for t in ins]
        out = fn(*leaves, **kw)
        out.backward(cot)
        return out.detach(), [t.grad for t in leaves]

    before = wrapper.launches
    got, got_grads = run(function.call)
    row = {"launches": wrapper.launches - before}
    want, want_grads = run(plain)
    torch.cuda.synchronize()
    row.update(_errors(got, want))
    row["out_max_abs"] = want.float().abs().max().item()
    gap = grad_gap([g.float() for g in got_grads], [w.float() for w in want_grads],
                   [str(i) for i in range(len(ins))])
    row["grad_rel"], row["grad_worst"] = gap["gap"], gap["tensor"]
    row["grads_finite"] = all(bool(torch.isfinite(g).all()) for g in got_grads)
    del got_grads, want_grads
    if name == "FlashAttention":
        fwd_ok = _held(f"flash_attention D={W // heads}", got, want)["ok"]
    elif dtype == torch.float32:
        fwd_ok = row["max_abs_err"] <= VIT_F32_REL * row["out_max_abs"]
    else:
        fwd_ok = row["max_abs_err"] <= 0.0625 and row["mean_abs_err"] <= 4e-3
    with torch.inference_mode():
        row["ms"] = cuda_ms(lambda: wrapper(*ins, **kw), iters=3, warmup=1)
        row["plain_ms"] = cuda_ms(lambda: plain(*ins, **kw), iters=3, warmup=1)
        row["library_ms"] = (cuda_ms(_sdpa_fn(*ins), iters=3, warmup=1)
                             if name == "FlashAttention" else None)
    row["fwd_bwd_ms"] = cuda_ms(lambda: run(function.call), iters=3, warmup=1)
    row["plain_fwd_bwd_ms"] = cuda_ms(lambda: run(plain), iters=3, warmup=1)
    row["ok"] = (row["finite"] and row["grads_finite"] and fwd_ok and row["launches"] == 1
                 and row["grad_rel"] <= GRAD_REL[dtype])
    row["shape"] = (f"B={B} S={S} W={W} {_TYPE[dtype]}, forward + backward: gradients "
                    f"{row['grad_rel']:.2e} of their scale (input {row['grad_worst']})")
    # the forward's work (``ms``), as the serving checks count it
    elt = dtype.itemsize
    if name == "FusedViTBlock":
        row.update(_vit_block_work(B, S, W, M, int8=False, dtype=dtype))
    else:
        peak = PEAK_OPS["fp32" if dtype == torch.float32 else "bf16"]
        ops, weights, vectors = {
            "FusedAttnBlock": (8 * B * S * W * W + 4 * B * S * S * W, 4 * W * W, 6 * W),
            "FusedMlpBlock": (4 * B * S * W * M, 2 * W * M, M + 3 * W),
            "FlashAttention": (4 * B * S * S * W, 0, 0)}[name]
        moved = (4 if name == "FlashAttention" else 2) * B * S * W
        row["bytes"] = elt * (moved + weights) + 4 * vectors
        row["op_seconds"] = ops / peak
    return row


def run_unfrozen(device="cuda") -> List[dict]:
    """The four Functions at the COCO tower's shapes (fp32, S = 677), and
    K2's in bf16 at ViT-L's."""
    rows = [dict(check=f"{name} eva_g fp32 S=677", **check_function_grad(name, device))
            for name in FUNCTIONS]
    rows.append(dict(check="FusedViTBlock vit_l bf16 S=257",
                     **check_function_grad("FusedViTBlock", device, "vit_l", torch.bfloat16,
                                           S=257)))
    torch.cuda.empty_cache()
    return rows


def profile_block_backward(device="cuda", B=32, S=RETRIEVAL_MEMORY, iters=3,
                           seed=43) -> Dict[str, dict]:
    """One EVA ViT-g block (fp32, S = 677) at the COCO fine-tune's batch,
    three ways that each keep only the block's input: ``function``
    (``FusedViTBlock``: the kernel forward; the backward recomputes the
    whole plain block and calls ``torch.autograd.grad`` on it), ``remat``
    (the plain block through ``layers.recompute``, as ``vit_remat`` runs it:
    ``torch.utils.checkpoint``, non-reentrant, whose recompute stops once
    every tensor the backward saved is back) and ``remat_full`` (the same
    with that early stop off, so that its recompute runs the whole block).
    Per way: the forward's and the backward's ms (CUDA events, the median of
    ``iters`` after a warm-up), and from a profiled backward its device ms,
    its GEMM kernels (launches and device ms), all its kernel launches, and
    the allocator's new segments (``cudaMalloc`` calls) in it. A profile loses
    launches at random (31 of this backward's 141 in one card run;
    ``cli/profile_window.py``), so ``iters`` backwards are profiled and the one with the
    most kernels is kept (``profiles_kernels``: each profile's count)."""
    _, _, plain = FUNCTIONS["FusedViTBlock"]
    W, M, heads, quick, eps = TOWERS["eva_g"]
    r = _Rand(device, seed)
    leaves = [t.requires_grad_() for t in [r.normal(B, S, W)]
              + list(vit_block_params(r, W, M, dtype=torch.float32))]
    cot = r.normal(B, S, W)
    kw = dict(heads=heads, eps=eps, scale=(W // heads) ** -0.5, quick=quick)

    def remat(*t):
        return recompute(lambda *a: plain(*a, **kw), *t, always=True)

    def remat_full(*t):
        with torch.utils.checkpoint.set_checkpoint_early_stop(False):
            return remat(*t)

    ways = {"function": lambda *t: FusedViTBlock.call(*t, **kw), "remat": remat,
            "remat_full": remat_full}
    rows: Dict[str, dict] = {}
    for name, fwd in ways.items():
        times = []
        for i in range(iters + 1):
            for t in leaves:
                t.grad = None
            events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            torch.cuda.synchronize()
            events[0].record()
            out = fwd(*leaves)
            events[1].record()
            out.backward(cot)
            events[2].record()
            torch.cuda.synchronize()
            if i:
                times.append((events[0].elapsed_time(events[1]),
                              events[1].elapsed_time(events[2])))
        kernels, counts, segments = [], [], 0
        for _ in range(iters):
            for t in leaves:
                t.grad = None
            out = fwd(*leaves)
            torch.cuda.synchronize()
            before = torch.cuda.memory_stats().get("segment.all.allocated", 0)
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                out.backward(cot)
                torch.cuda.synchronize()
            segments = max(segments,
                           torch.cuda.memory_stats().get("segment.all.allocated", 0) - before)
            seen = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
            kernels = max(kernels, seen, key=len)
            counts.append(len(seen))
            del out
        gemms = [e for e in kernels if "gemm" in e.name.lower()]
        rows[name] = {"forward_ms": float(np.median([f for f, _ in times])),
                      "backward_ms": float(np.median([b for _, b in times])),
                      "backward_device_ms": sum(e.time_range.elapsed_us() for e in kernels) / 1e3,
                      "backward_kernels": len(kernels), "profiles_kernels": counts,
                      "backward_gemms": len(gemms),
                      "backward_gemm_ms": sum(e.time_range.elapsed_us() for e in gemms) / 1e3,
                      "backward_new_segments": segments}
    for t in leaves:
        t.grad = None
    torch.cuda.empty_cache()
    return rows


def run_int8(device="cuda") -> List[dict]:
    """The checks of the int8 serving path's kernels."""
    rows = [dict(check=f"gemm_i8 {name}", **check_gemm_i8(name, device))
            for name in GEMM_I8_PRODUCTS]
    rows += [dict(check="quantizers", **check_quantizers(device))] + run_quantize(device)
    rows += [dict(check="K5 vit_block_i8", **check_vit_block_i8(device)),
             dict(check="K5 vit_tower_i8", **check_vit_tower_i8(device))]
    for shape in SERVING_SHAPES:
        rows.append(dict(check=f"K4 qformer_layer_int8 {shape}",
                         **check_qformer_layer(shape, device, int8=True)))
        rows.append(dict(check=f"K4 qformer_trunk_int8 {shape}",
                         **check_qformer_trunk(shape, device, int8=True)))
    return rows


def run_all(device="cuda") -> List[dict]:
    """Every check, in order; the rows carry ``check`` names."""
    rows = [dict(check="K1 token_max_sim", **check_token_max_sim(device)),
            dict(check="K2 vit_block", **check_vit_block(device)),
            dict(check="K2 vit_tower", **check_vit_tower(device))]
    for shape in SERVING_SHAPES:
        rows.append(dict(check=f"K3 qformer_layer {shape}", **check_qformer_layer(shape, device)))
        rows.append(dict(check=f"K3 qformer_trunk {shape}", **check_qformer_trunk(shape, device)))
    rows += [dict(check=f"K3 qformer_layer {shape}", **check_qformer_layer(shape, device))
             for shape in VARIANT_SHAPES]
    rows += run_qformer_fp32(device) + run_layer_norm(device)
    rows += [dict(check="gemm bf16 ablate 4096^3", **check_gemm_bf16_ablate(device)),
             dict(check="library yardsticks", **check_library_yardsticks(device))]
    return (rows + run_int8(device) + run_validate_path(device) + run_stage1(device)
            + run_unfrozen(device) + run_caption(device) + run_stage2(device)
            + run_instruct(device) + run_edges(device))
