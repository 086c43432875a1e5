"""Preemption-aware graceful shutdown (the port's copy of
``sprc_tpu/utils/preempt.py``; it has no JAX in it, and
``tests/test_torch_framework.py`` pins the copy equal to the original).

Managed clusters deliver SIGTERM with a short grace
window before killing a preempted worker. The reference has no handling at
all — a preempted run loses everything since its last best-checkpoint save
(SURVEY.md §5.3/§5.4: the SPRC scripts never save optimizer state).

:class:`PreemptionGuard` converts the signal into a cooperative flag the
training loop checks BETWEEN steps (never inside one), so the
runner can save a fully resumable state (params + optimizer + step) and
exit cleanly instead of dying mid-step.
"""

from __future__ import annotations

import logging
import signal
import threading
from typing import Iterable

log = logging.getLogger("sprc_tpu_torch.preempt")


class PreemptionGuard:
    """Signal -> cooperative stop flag.

    Usage::

        guard = PreemptionGuard.install()   # no-op off the main thread
        for batch in loader:
            state = step(state, batch)
            if guard is not None and guard.should_stop:
                save_state(path, state); break

    ``install`` returns None when handlers can't be registered (non-main
    thread, or an environment that forbids it) — callers treat that as
    "no preemption handling", matching the reference's behavior.
    """

    def __init__(self, signals: Iterable[int]):
        self._flag = threading.Event()
        self._received: int | None = None
        self._prev = {}
        for s in signals:
            self._prev[s] = signal.signal(s, self._handler)

    @classmethod
    def install(cls, signals: Iterable[int] = (signal.SIGTERM,)):
        try:
            return cls(signals)
        except ValueError:  # signal only works in the main thread
            log.warning("PreemptionGuard unavailable off the main thread")
            return None

    def _handler(self, signum, frame):
        # async-signal-safe: set a flag, never touch the device or the
        # filesystem here — the training loop does the actual save
        self._received = signum
        self._flag.set()

    @property
    def should_stop(self) -> bool:
        return self._flag.is_set()

    @property
    def received_signal(self):
        return self._received

    def restore(self) -> None:
        """Re-install the previous handlers (for tests / nested use)."""
        for s, h in self._prev.items():
            signal.signal(s, h)
        self._prev = {}
