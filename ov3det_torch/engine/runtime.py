"""Runtime services: profiling, preemption-safe checkpointing and the
ranks of a data-parallel run.

Counterpart of `ov3det/engine/runtime.py:20-84`.  `profile_steps` wraps
`torch.profiler` (CPU and, on a card, CUDA activity) and writes a Chrome
trace into its directory.  `PreemptionGuard` is the JAX package's; under a
data group its flag is the maximum over the ranks (`stop_requested`), so
that every rank leaves the loop at the same step.  `plan_ranks` and
`init_multihost` place the ranks of `--ngpus`: JAX runs one process a host
over a mesh of its devices, the port one process a device (a rank), rank =
process_id * ranks a host + local rank, joined over
`tcp://<coordinator_address>` (`ov3det/engine/runtime.py:61-84`); torchrun's
environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT) is
honoured as JAX defers to JAX_COORDINATOR_ADDRESS.
"""
from __future__ import annotations

import os
import signal
import socket
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Optional

import torch

from ov3det_torch.parallel.mesh import DataGroup, any_rank, init_data_group


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

    def stop_requested(self) -> bool:
        """`should_stop` on any rank of the data group (this process's flag
        without one): a rank that left the loop alone would leave the others
        waiting in the step's next collective."""
        return any_rank(self.should_stop)

    def restore(self):
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)


@dataclass(frozen=True)
class RankPlan:
    """The ranks of a run: `world` in all, `local` of them in this process's
    host starting at rank `first`, joined at `init_method`."""

    world: int
    local: int
    first: int
    init_method: str


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def plan_ranks(ngpus: int, coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> RankPlan:
    """The ranks of `--ngpus` on this host.  One host: `ngpus` ranks joined on
    a free local port.  Several (`--coordinator_address host:port
    --num_processes M --process_id I`): ngpus / M ranks a host, this host's
    from I * ngpus / M, as `ov3det/main.py:383-393` demands ngpus a positive
    multiple of the process count.  Under torchrun this process is the one
    rank its environment names."""
    env = os.environ
    if "RANK" in env and "WORLD_SIZE" in env and "MASTER_ADDR" in env:
        world, local_rank = int(env["WORLD_SIZE"]), int(env.get("LOCAL_RANK", 0))
        if ngpus not in (1, world):
            raise ValueError(f"--ngpus {ngpus} but torchrun started {world} ranks")
        return RankPlan(world, int(env.get("LOCAL_WORLD_SIZE", 1)), int(env["RANK"]) - local_rank,
                        "env://")
    if ngpus < 1:
        raise ValueError(f"--ngpus must be positive, got {ngpus}")
    if coordinator_address is None and num_processes is None:
        return RankPlan(ngpus, ngpus, 0, f"tcp://localhost:{_free_port()}")
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("a multi-host run needs --coordinator_address, --num_processes and "
                         "--process_id")
    if ngpus < num_processes or ngpus % num_processes:
        raise ValueError(f"multi-host run with {num_processes} processes needs num_devices "
                         f"(--ngpus) to be a positive multiple of the process count, got {ngpus}")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"--process_id {process_id} outside [0, {num_processes})")
    local = ngpus // num_processes
    return RankPlan(ngpus, local, process_id * local, f"tcp://{coordinator_address}")


def init_multihost(plan: RankPlan, local_rank: int, device: torch.device) -> DataGroup:
    """Join the run's data group as this host's `local_rank`-th rank: gloo
    on the CPU, nccl on a card."""
    return init_data_group(plan.first + local_rank, plan.world, plan.init_method, device)
