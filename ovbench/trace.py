"""Reading `torch.profiler` traces: the device's busy time, the idle gaps,
the top device operations, and the device time of a profiler range.

`range_kernels` is `chip_smoke.range_kernels`, copied: the kernels
launched while a range was open on the host, matched to their device
events by correlation id (the backward's on any thread: autograd launches
from threads of its own).
"""
from __future__ import annotations

import collections
import time

import torch

ANY_THREAD_RANGES = ("backward",)
MARGIN_S = 0.2  # idle host time each side of a profiled stretch


def _device(e) -> bool:
    return e.device_type != torch.autograd.DeviceType.CPU


def profile(fn, reps: int):
    """`fn` `reps` times under the profiler, after one untraced-for-the-result
    call under it (the profiler's warm-up); returns (profiler, host seconds
    of the active stretch, from its first call to the device sync)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    schedule = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts, schedule=schedule) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        time.sleep(MARGIN_S)
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        time.sleep(MARGIN_S)
        prof.step()
    return prof, wall


def _annotations(prof) -> set:
    return {e.name for e in prof.events() if not _device(e)} | {
        e.name for e in prof.events() if getattr(e, "is_user_annotation", False)}


def device_intervals(prof) -> list:
    """[(start us, end us, name)] of the device's operations (kernels,
    copies, fills), ranges' device-side markers left out."""
    ranges = _annotations(prof)
    return sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                  if _device(e) and e.name not in ranges and e.time_range.end > e.time_range.start)


def busy_seconds(intervals: list) -> float:
    """The union of the intervals, in seconds."""
    busy, end = 0.0, None
    for s, e, _ in intervals:
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy / 1e6


def breakdown(prof, intervals: list, top: int = 10) -> dict:
    """The device operations that took most time and the longest idle gaps
    between the first and the last device operation, each gap named by the
    innermost host operation open at its start."""
    per_op = collections.Counter()
    for s, e, name in intervals:
        per_op[name] += (e - s) / 1e6
    gaps, end = [], None
    for s, e, _ in intervals:
        if end is not None and s > end:
            gaps.append((s - end, end))
        end = e if end is None else max(end, e)
    gaps.sort(reverse=True)
    host = [(e.time_range.start, e.time_range.end, e.name) for e in prof.events()
            if not _device(e) and not e.name.startswith("ProfilerStep")]

    def doing(t):
        open_ = [h for h in host if h[0] <= t <= h[1]]
        return min(open_, key=lambda h: h[1] - h[0])[2] if open_ else "host idle"

    return {"device_ops": [[n[:120], s] for n, s in per_op.most_common(top)],
            "idle_gaps": [[doing(t)[:120], g / 1e6] for g, t in gaps[:top]]}


def range_kernels(prof, name: str):
    """(device ms, kernel count) of the kernels launched while the profiler
    range `name` was open on the host, or None when it holds none."""
    cpu = torch.autograd.DeviceType.CPU
    events = prof.events()
    spans = [(e.time_range.start, e.time_range.end, e.thread) for e in events
             if e.name == name and e.device_type == cpu]
    own_thread = name not in ANY_THREAD_RANGES
    launched = {e.id for e in events
                if e.device_type == cpu and e.name.startswith("cu")
                and any(s <= e.time_range.start <= t and (e.thread == th or not own_thread)
                        for s, t, th in spans)}
    kernels = [e.time_range.end - e.time_range.start for e in events
               if e.device_type != cpu and e.name != name and e.id in launched]
    return (sum(kernels) / 1e3, len(kernels)) if kernels else None
