"""Learning-rate schedule (counterpart of ``sprc_tpu/train/schedules.py``).

``onecycle_schedule`` is ``torch.optim.lr_scheduler.OneCycleLR`` with its
cos anneal, as a function of the optimizer update count, the form the JAX
package gives to optax: the reference's ``OneCycleLR(max_lr, pct_start=1/50,
steps_per_epoch, epochs=80)`` (blip_fine_tune_2.py:261) schedules 80 epochs
and trains fewer, so only a prefix of the cycle is walked (``total_steps``).
It does not cycle AdamW's momentum, as the JAX optimizer does not.
"""

from __future__ import annotations

import math
from typing import Callable


def onecycle_schedule(max_lr: float, total_steps: int, pct_start: float = 0.3,
                      div_factor: float = 25.0,
                      final_div_factor: float = 1e4) -> Callable[[int], float]:
    """Returns ``f(update) -> lr``; update 0 is the first optimizer step,
    which takes ``max_lr / div_factor``."""
    initial_lr = max_lr / div_factor
    min_lr = initial_lr / final_div_factor
    up_steps = float(pct_start * total_steps) - 1.0
    down_steps = float(total_steps - up_steps - 1.0)

    def anneal(start: float, end: float, frac: float) -> float:
        return end + (start - end) / 2.0 * (math.cos(math.pi * frac) + 1.0)

    def schedule(step: int) -> float:
        if step <= up_steps:
            return anneal(initial_lr, max_lr, min(max(step / max(up_steps, 1e-8), 0.0), 1.0))
        return anneal(max_lr, min_lr,
                      min(max((step - up_steps) / max(down_steps, 1e-8), 0.0), 1.0))

    return schedule
