"""Training traffic: graphed steps of the port's `PackedStep` over a pool of
packed rows, as its training loop feeds them.

Parameters (the workload file's "traffic_params"): `pool`, the distinct
batches made in set-up (each `batch_size_per_device` scenes of 1 to 8
objects, padded to `max_num_obj`, with canvases when the configuration
has a teacher); `log_every`, the steps between reads of the loss.  A step
copies its pinned row to the card without blocking and calls the step at
the next iteration; the window ends at a device sync.

Correctness: set-up builds one `PackedStep` and drives it through its
first three steps (the warm-up and capture, then two replays) on rows 0-2;
the readings (each step's losses, the first moment after step 1, the
parameters before and after, the first step's forward outputs, and with a
teacher its boxes and region features) are compared with the plain reference's three steps from the
same weights, rows and dropout seeds once the window has closed and the
program's state is freed; the teacher's features with the reference
teacher's on the same canvases and the program's own boxes.
"""
from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch

from ovbench import compare, harness, scenes, sides, trace, work
from ovbench.reference import detector as ref_detector
from ovbench.reference.step import TrainStep

CHECK_STEPS = 3
TRACED_STEPS = 10
EAGER_STEPS = 3
RANGES = ("forward", "teacher", "criterion", "backward", "optimizer", "trunk")


def make_pool(cfg: dict, params: dict, seed: int) -> list:
    data, m = cfg["data"], cfg["model"]
    rng = np.random.default_rng(seed)
    pool = []
    for _ in range(params["pool"]):
        b = scenes.make_batch(rng, batch_size=data["batch_size_per_device"],
                              num_points=data["num_points"], max_num_obj=data["max_num_obj"],
                              num_semcls=m["num_semcls"], num_angle_bin=m["num_angle_bin"])
        pool.append(scenes.with_images(b, rng) if cfg["teacher"].get("enabled") else b)
    return pool


def host(tensors) -> list:
    """f32 copies on the host."""
    return [t.detach().to("cpu", torch.float32, copy=True) for t in tensors]


class Recorder:
    """What `pick(args, output)` takes from a module's calls in the checked
    steps: an eager call's copied to the host at once; a captured call's,
    with `static`, held by reference to the graph's static tensors and read
    after each replay, so that no copy enters the graph (without it, a
    replayed step records nothing)."""

    def __init__(self, module, device, pick, static: bool):
        self.cuda, self.pick, self.keep_static = device.type == "cuda", pick, static
        self.eager, self.static = None, None
        self.handle = module.register_forward_hook(self)

    def __call__(self, module, args, out):
        if self.cuda and torch.cuda.is_current_stream_capturing():
            if self.keep_static:
                self.static = self.pick(args, out)
        else:
            self.eager = host(self.pick(args, out))

    def read(self):
        """The last step's picks on the host, or None."""
        got = self.eager or (host(self.static) if self.static is not None else None)
        self.eager = None
        return got

    def close(self) -> None:
        self.handle.remove()
        self.static = None


def last_layer(args, out) -> tuple:
    """A forward's last decoder layer: box corners, class and objectness
    probabilities."""
    return tuple(out[k][-1] for k in ("box_corners", "sem_cls_prob", "objectness_prob"))


def program(ctx, pool: list) -> dict:
    """Set-up, the three checked steps, the window and the traced stretch;
    returns the readings, the end-to-end numbers and the state to free."""
    from ov3det_torch.datasets.loader import pack_batch
    from ov3det_torch.engine.train import PackedStep, build_training

    cfg, dev, seed = ctx.cfg, ctx.device, ctx.seed
    params = ctx.spec["traffic_params"]
    packed = [pack_batch(b) for b in pool]
    metas = packed[0][1]
    rows = torch.from_numpy(np.stack([p[0] for p in packed]))
    if dev.type == "cuda":
        rows = rows.pin_memory()
    teacher = None
    if cfg["teacher"].get("enabled"):
        state = sides.teacher_weights(cfg, seed, dev)
        teacher = sides.program_teacher(cfg, state, sides.calibration(pool[0]["image"][0], seed),
                                        dev)
        del state
    training = build_training(harness.train_config(cfg), cfg["iters_per_epoch"], device=dev,
                              seed=0, teacher=teacher)
    training.model.load_state_dict(sides.detector_weights(cfg, seed, dev))
    step = PackedStep(training, seed, dev)
    opt, model = training.optimizer, training.model
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    readings = {"p0": host(model.parameters()), "losses": []}
    # the first step's forward (eager); with a teacher, its boxes and features in every step
    fwd = Recorder(model, dev, last_layer, static=False)
    io = Recorder(teacher, dev, lambda a, o: (a[1], o), static=True) if teacher is not None \
        else None
    for it in range(CHECK_STEPS):
        metrics, _ = step(rows[it].to(dev, non_blocking=True), metas, it)
        readings["losses"].append({k: float(v) for k, v in metrics.items()})
        if io is not None:
            readings.setdefault("teacher", []).append(io.read())
        if it == 0:
            readings["mu1"] = host(opt.mu)
            readings["forward"] = fwd.read()
    readings["p3"] = host(model.parameters())
    for r in (fwd, io):
        if r is not None:
            r.close()
    setup_s = time.perf_counter() - ctx.t0

    B, log_every = cfg["data"]["batch_size_per_device"], params["log_every"]
    it, steps, failed = CHECK_STEPS, 0, 0
    mark = harness.host_mark()
    t0 = time.perf_counter()
    while True:
        metrics, _ = step(rows[it % len(pool)].to(dev, non_blocking=True), metas, it)
        it += 1
        steps += 1
        if steps % log_every == 0:
            failed += not math.isfinite(float(metrics["loss"]))
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    if dev.type == "cuda":
        torch.cuda.synchronize()
    window = time.perf_counter() - t0
    out = {"setup_s": setup_s, "train_scenes_per_s": steps * B / window,
           "attempted": steps, "failed": failed, "host": harness.host_detail(mark)}
    if dev.type == "cuda":
        out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        out["peak_mem_gib"] = out["memory_peak_bytes"] / 2 ** 30

    if ctx.trace:
        def graphed():
            nonlocal it
            step(rows[it % len(pool)].to(dev, non_blocking=True), metas, it)
            it += 1

        prof, wall = trace.profile(graphed, TRACED_STEPS)
        intervals = trace.device_intervals(prof)
        out["trace"] = {"busy_s": trace.busy_seconds(intervals), "window_s": wall,
                        "steps": TRACED_STEPS, "breakdown": trace.breakdown(prof, intervals)}
        del prof
        step.graph = False
        eager, _ = trace.profile(graphed, EAGER_STEPS)
        out["trace"]["ranges"] = {}
        for name in RANGES:
            got = trace.range_kernels(eager, name)
            if got is not None:
                out["trace"]["ranges"][name] = got[0] / EAGER_STEPS
        del eager
    out["readings"] = readings
    return out


def reference(ctx, pool: list, weights=None, judge=None) -> dict:
    """The plain reference's three steps from the same weights (or
    `weights`), rows and dropout seeds; with a teacher, its own (boxes,
    features) a step and, given another side's `judge` (its (boxes,
    features) a step), the reference teacher's features on those boxes and
    the same canvases (None where the other side's boxes are not the
    batch's)."""
    cfg, dev, seed = ctx.cfg, ctx.device, ctx.seed
    model = ref_detector.Model3DETR(cfg["model"], ctx.precision).to(dev)
    model.load_state_dict(weights or sides.detector_weights(cfg, seed, dev))
    teacher = None
    if cfg["teacher"].get("enabled"):
        state = sides.teacher_weights(cfg, seed, dev)
        teacher = sides.reference_teacher(cfg, state, sides.calibration(pool[0]["image"][0], seed),
                                          ctx.precision)
        del state
    stepper = TrainStep(model, cfg, teacher)
    gen = torch.Generator(device=dev)
    readings = {"p0": host(model.parameters()), "losses": []}
    for it in range(CHECK_STEPS):
        gen.manual_seed(sides.step_seed(seed, it))
        readings["losses"].append(stepper(sides.to_tensors(pool[it], dev), gen))
        if it == 0:
            readings["mu1"] = host(stepper.optimizer.mu)
    readings["p3"] = host(model.parameters())
    readings["names"] = [n for n, _ in model.named_parameters()]
    readings["assignments"] = stepper.assignments
    readings["forward"] = stepper.forward
    if teacher is not None:
        readings["teacher"] = stepper.teacher_io
        if judge is not None:
            readings["teacher_on_judged"] = [
                teacher_on(teacher, pool[it], boxes, dev) for it, (boxes, _) in enumerate(judge)]
    return readings


def teacher_on(teacher, batch: dict, boxes: torch.Tensor, device):
    """The reference teacher's features on `batch`'s canvases and `boxes`
    (f32, host), or None where the boxes are not one set a canvas."""
    images = torch.from_numpy(np.ascontiguousarray(batch["image"])).to(device)
    if boxes.shape[0] != images.shape[0]:
        return None
    return host([teacher(images, boxes.to(device))])[0]


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
    prog = out.pop("readings")
    ref = reference(ctx, pool, judge=prog.get("teacher"))
    out["numbers"] = compare.train_numbers(prog, ref)
    out["detail"] = dict(compare.worst_leaves(prog, ref, ref["names"]),
                         numbers={k: v if math.isfinite(v) else str(v)
                                  for k, v in out["numbers"].items()})
    out["step_seconds_at_peak"] = work.train_step_seconds(cfg)
    return out
