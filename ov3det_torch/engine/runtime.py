"""Runtime services: profiling and preemption-safe checkpointing.

Counterpart of `ov3det/engine/runtime.py:20-58`.  `profile_steps` wraps
`torch.profiler` (CPU and, on a card, CUDA activity) and writes a Chrome
trace into its directory.  `PreemptionGuard` is the JAX package's, as it is.
Multi-host initialisation (`init_multihost`) comes with data parallelism,
ROADMAP Queue 1 item 6.
"""
from __future__ import annotations

import os
import signal
import time
from contextlib import contextmanager
from typing import Optional

import torch


@contextmanager
def profile_steps(log_dir: Optional[str]):
    """torch.profiler context writing `trace-<time>.json` (Chrome trace
    format) into `log_dir`; a no-op when `log_dir` is None."""
    if log_dir is None:
        yield
        return
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, f"trace-{time.time_ns()}.json"))


class PreemptionGuard:
    """SIGTERM/SIGINT-aware flag for checkpoint-on-preemption.

    Usage: guard = PreemptionGuard(); inside the epoch loop, check
    `guard.should_stop` and save + exit cleanly.  Cloud preemptions deliver
    SIGTERM with a grace window.
    """

    def __init__(self, signals=(signal.SIGTERM,)):
        self.should_stop = False
        self._prev = {}
        for sig in signals:
            try:
                self._prev[sig] = signal.signal(sig, self._handler)
            except (ValueError, OSError):  # non-main thread / unsupported
                pass

    def _handler(self, signum, frame):
        self.should_stop = True

    def restore(self):
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
