"""Detection traffic: requests of `batch_size_per_device` scenes to
`Detector.detect` from one client in a closed loop, as the pseudo-label
pass and evaluation call it: the next request is sent as soon as the
previous one's detections are on the host.  The window sends requests for
`--seconds`; the scenes of all its requests over the time until the last
one is answered are the cell's rate, and a request's latency runs from the
call to `detect` until its detections are on the host.

Parameters (the workload file's "traffic_params"): `pool`, the distinct
requests made in set-up, sent in turn; `sample`, how many of the window's
first `checked` requests, drawn from the seed, have their answers compared
with the reference.

Correctness: the request's forward outputs (a copy taken, for the sampled
requests only, as the graph hands them to `detect`) against the plain
reference's forward on the same scenes; its kept boxes against the
reference's parse of those same outputs; its detections against the
reference's assembly of them.
"""
from __future__ import annotations

import gc
import statistics
import time

import numpy as np
import torch
from torch.profiler import record_function

from ovbench import compare, harness, scenes, sides, trace, work
from ovbench.reference import detector as ref_detector
from ovbench.reference import parse as ref_parse

INPUT_KEYS = ("point_clouds", "point_cloud_dims_min", "point_cloud_dims_max")
TRACED_REQUESTS = 20
EAGER_REQUESTS = 3


def make_pool(cfg: dict, params: dict, seed: int) -> list:
    data, m = cfg["data"], cfg["model"]
    rng = np.random.default_rng(seed)
    pool = []
    for _ in range(params["pool"]):
        b = scenes.make_batch(rng, batch_size=data["batch_size_per_device"],
                              num_points=data["num_points"], max_num_obj=data["max_num_obj"],
                              num_semcls=m["num_semcls"], num_angle_bin=m["num_angle_bin"])
        pool.append({k: b[k] for k in INPUT_KEYS})
    return pool


class Keep:
    """Wraps the detector's graphed request: hands its outputs on as they
    are and, for the requests in `wanted`, keeps a device copy of them."""

    def __init__(self, request):
        self.request, self.wanted, self.kept, self.n = request, set(), {}, 0

    def __call__(self, inputs):
        out = self.request(inputs)
        if self.n in self.wanted:
            self.kept[self.n] = [t.clone() for t in out]
        self.n += 1
        return out


def program(ctx, pool: list) -> dict:
    from ov3det_torch.engine.infer import Detector
    from ov3det_torch.eval.parse import parse_predictions

    cfg, dev, seed = ctx.cfg, ctx.device, ctx.seed
    params = ctx.spec["traffic_params"]
    det = Detector(harness.train_config(cfg), device=dev)
    det.model.load_state_dict(sides.detector_weights(cfg, seed, dev))
    keep = det.request = Keep(det.request)
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    for r in range(2):  # the capture, then a replay
        det.detect(pool[r])
    setup_s = time.perf_counter() - ctx.t0

    # the window's requests whose answers are compared: drawn from the seed
    # among its first `checked`
    first = keep.n
    drawn = np.random.default_rng(seed).choice(params["checked"], size=params["sample"],
                                               replace=False)
    keep.wanted = {first + int(r) for r in drawn}
    lat, answers = [], {}
    n = 0
    mark = harness.host_mark()
    t0 = time.perf_counter()
    while (sent := time.perf_counter()) < t0 + ctx.seconds:
        dets = det.detect(pool[n % len(pool)])
        lat.append(time.perf_counter() - sent)
        if keep.n - 1 in keep.wanted:
            answers[keep.n - 1] = (n % len(pool), dets)
        n += 1
    window = time.perf_counter() - t0
    B = cfg["data"]["batch_size_per_device"]
    q = statistics.quantiles(lat, n=100)
    out = {"setup_s": setup_s, "detect_scenes_per_s": n * B / window,
           "detect_p95_ms": q[94] * 1e3, "attempted": n, "failed": 0,
           "host": dict(harness.host_detail(mark), p50_ms=q[49] * 1e3, p99_ms=q[98] * 1e3,
                        max_ms=max(lat) * 1e3)}
    if dev.type == "cuda":
        out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        out["peak_mem_gib"] = out["memory_peak_bytes"] / 2 ** 30
    out["checked"] = [(answers[r][0], answers[r][1], [t.cpu().numpy() for t in keep.kept[r]])
                      for r in sorted(answers)]
    keep.kept.clear()

    if ctx.trace:
        j = {"n": 0}

        def request():
            det.detect(pool[j["n"] % len(pool)])
            j["n"] += 1

        prof, wall = trace.profile(request, TRACED_REQUESTS)
        intervals = trace.device_intervals(prof)
        out["trace"] = {"busy_s": trace.busy_seconds(intervals), "window_s": wall,
                        "steps": TRACED_REQUESTS, "breakdown": trace.breakdown(prof, intervals)}
        del prof
        tensors = sides.to_tensors(pool[0], dev)

        def eager():
            with torch.inference_mode():
                with record_function("bench.forward"):
                    o = det.eval_step(tensors)
                with record_function("bench.parse"):
                    parse_predictions(o["box_corners"], o["sem_cls_prob"], o["objectness_prob"],
                                      tensors["point_clouds"])

        eager_prof, _ = trace.profile(eager, EAGER_REQUESTS)
        out["trace"]["ranges"] = {}
        for name in ("bench.forward", "bench.parse"):
            got = trace.range_kernels(eager_prof, name)
            if got is not None:
                out["trace"]["ranges"][name] = got[0] / EAGER_REQUESTS
        del eager_prof
    return out


def reference(ctx, pool: list, checked: list) -> tuple:
    """(the reference's forward outputs of each checked request, the parse
    and assembly mismatches of the program's own outputs)."""
    cfg, dev = ctx.cfg, ctx.device
    model = ref_detector.Model3DETR(cfg["model"], ctx.precision).to(dev)
    model.load_state_dict(sides.detector_weights(cfg, ctx.seed, dev))
    model.eval()
    outs, misses = [], 0
    for slot, dets, (corners, sem, obj, kept) in checked:
        x = sides.to_tensors(pool[slot], dev)
        with torch.no_grad():
            o = ref_detector.last_layer_outputs(model(x))
        outs.append(tuple(o[k].float().cpu().numpy() for k in
                          ("box_corners", "sem_cls_prob", "objectness_prob")))
        want_keep, _ = ref_parse.parse_predictions(
            torch.from_numpy(corners).to(dev), torch.from_numpy(sem).to(dev),
            torch.from_numpy(obj).to(dev), x["point_clouds"])
        misses += int((want_keep.cpu().numpy() != kept).sum())
        misses += compare.same_detections(
            dets, ref_parse.assemble_predictions(corners, sem, obj, kept))
    return outs, misses


def run(ctx) -> dict:
    cfg = ctx.cfg
    if ctx.device.type == "cuda":
        from ov3det_torch.ops.kernels import _build
        _build.build()
    pool = make_pool(cfg, ctx.spec["traffic_params"], ctx.seed)
    out = program(ctx, pool)
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    checked = out.pop("checked")
    ref, misses = reference(ctx, pool, checked)
    prog = [tuple(c[2][:3]) for c in checked]
    out["numbers"] = compare.detect_numbers(prog, ref, misses)
    out["request_seconds_at_peak"] = work.request_seconds(cfg, cfg["data"]["batch_size_per_device"])
    return out
