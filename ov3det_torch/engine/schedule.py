"""Cosine learning-rate schedule with linear warm-up, per iteration.

Counterpart of `ov3det/engine/schedule.py` (reference engine.py:22-44): a
linear warm-up from warm_lr to base_lr over warm_lr_epochs, then a cosine
from base_lr down to final_lr over the rest of the run.  The optimiser
evaluates it at its own update count, the first update at step 0, as optax
does; the count lives on the host, so the schedule is plain Python.
"""
from __future__ import annotations

import math
from typing import Callable

from ov3det_torch.config import OptimConfig


def make_lr_schedule(cfg: OptimConfig, max_epoch: int, iters_per_epoch: int) -> Callable[[int], float]:
    max_iters = max(max_epoch * iters_per_epoch, 1)

    def schedule(step: int) -> float:
        frac = min(max(step / max_iters, 0.0), 1.0)
        warm_frac = cfg.warm_lr_epochs / max_epoch if max_epoch > 0 else 0.0
        if frac <= warm_frac and cfg.warm_lr_epochs > 0:
            return cfg.warm_lr + frac * max_epoch * (
                (cfg.base_lr - cfg.warm_lr) / max(cfg.warm_lr_epochs, 1))
        return cfg.final_lr + 0.5 * (cfg.base_lr - cfg.final_lr) * (1.0 + math.cos(math.pi * frac))

    return schedule
