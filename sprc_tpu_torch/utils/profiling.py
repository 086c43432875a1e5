"""Profiling hooks (counterpart of ``sprc_tpu/utils/profiling.py``).

Usage::

    with trace("/path/to/profile"):    # a Chrome trace (chrome://tracing, Perfetto)
        trainer.train_step(batch)

    timer = StepTimer()
    for batch in loader:
        with timer:
            trainer.train_step(batch)
    print(timer.summary())

:func:`trace` records the host and, where CUDA is available, the device
(``torch.profiler``); :func:`annotate` names a region inside it
(``record_function``). :class:`StepTimer` synchronizes the device before
it reads the clock, at both ends of a step, so a step's time holds the work
it queued.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, List, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str, *, name: str = "trace.json") -> Iterator[torch.profiler.profile]:
    """``torch.profiler`` over the block; ``log_dir/name`` gets its Chrome
    trace when the block ends."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, name))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named region inside an active trace."""
    with torch.profiler.record_function(name):
        yield


def _sync(device: Optional[torch.device]) -> None:
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)


class StepTimer:
    """Wall-clock step times with the first ``discard_first`` left out of
    the summary (warm-up), the device synchronized at both ends of a step."""

    def __init__(self, discard_first: int = 2, device=None):
        self.discard_first = discard_first
        if device is None and torch.cuda.is_available():
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = None if device is None else torch.device(device)
        self.times: List[float] = []
        self._t0: Optional[float] = None

    def __enter__(self) -> "StepTimer":
        _sync(self.device)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        _sync(self.device)
        self.times.append(time.perf_counter() - self._t0)

    def summary(self) -> Dict[str, float]:
        times = sorted(self.times[self.discard_first:]) or sorted(self.times)
        if not times:
            return {}
        n = len(times)
        return {"steps": n, "mean_s": sum(times) / n, "p50_s": times[n // 2],
                "p90_s": times[min(n - 1, int(n * 0.9))], "max_s": times[-1],
                "steps_per_sec": n / sum(times)}
