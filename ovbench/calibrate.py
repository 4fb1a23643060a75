"""The readings a cell's limits are set from, on the card, in one process:

    python3 ovbench/calibrate.py --workload <cell> --seeds <n> [<n> ...] [--faults 1]

For each seed and each of `--sides`: "program", the program's numbers in
a run of the cell (a short window: a training cell's readings come from
set-up); "control", the plain reference computed one precision lower
(`reference.precision.CONTROL`) in the program's place against the
float32 reference (for the teacher's features, the W4A4 teacher alone on
the float32 reference's boxes); for a training cell "perturbed" (the float32
reference from its weights rounded to bf16); and with `--faults` a
training cell's fault "half of the batch left out, the mean taken over the
rest" planted in the reference put in the program's place.  One JSON line
a reading: {"cell", "seed", "side", "numbers", "worst"}.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ovbench import harness  # noqa: E402

harness.set_cache_dirs()


def half(pool: list) -> list:
    """Each batch with its second half of scenes left out."""
    return [{k: v[: v.shape[0] // 2] for k, v in b.items()} for b in pool]


def train_side(ctx, which: str) -> tuple:
    """(numbers, worst leaves) against the float32 reference of: the
    control (`which` "control": the detector's products in float8 and, for
    `feature_gap`, the W4A4 teacher on the float32 reference's own boxes
    and canvases); the half-batch fault ("half_batch"); the reference
    itself from its weights rounded to bf16 ("perturbed": how far a
    rounding of the inputs moves the numbers, and the share of proposals
    the matcher then assigns otherwise)."""
    from ovbench import compare, sides
    from ovbench.reference.precision import CONTROL, FLOAT32

    drv = harness.traffic("train")
    pool = drv.make_pool(ctx.cfg, ctx.spec["traffic_params"], ctx.seed)
    f32 = SimpleNamespace(**{**vars(ctx), "precision": FLOAT32})
    if which == "control":
        got = drv.reference(SimpleNamespace(**{**vars(ctx), "precision": CONTROL}), pool)
    elif which == "perturbed":
        state = sides.detector_weights(ctx.cfg, ctx.seed, ctx.device)
        rounded = {k: v.bfloat16().float() if v.is_floating_point() else v
                   for k, v in state.items()}
        got = drv.reference(f32, pool, rounded)
    else:
        got = drv.reference(f32, half(pool))
    want = drv.reference(f32, pool, judge=got.get("teacher"))
    if which == "control" and "teacher" in want:
        state = sides.teacher_weights(ctx.cfg, ctx.seed, ctx.device)
        low = sides.reference_teacher(ctx.cfg, state, sides.calibration(pool[0]["image"][0],
                                                                        ctx.seed), CONTROL)
        got["teacher"] = [(b, drv.teacher_on(low, pool[it], b, ctx.device))
                          for it, (b, _) in enumerate(want["teacher"])]
        want["teacher_on_judged"] = [f for _, f in want["teacher"]]
    numbers = compare.train_numbers(got, want)
    if which == "perturbed":  # the share of proposals matched otherwise, a step
        numbers["flipped"] = [float((a != b).float().mean())
                              for a, b in zip(got["assignments"], want["assignments"])]
    return numbers, compare.worst_leaves(got, want, want["names"])


def detect_side(ctx) -> dict:
    """The control's forward outputs against the float32 reference's on the
    pool's first `sample` requests."""
    import torch

    from ovbench import compare, sides
    from ovbench.reference import detector as ref_detector
    from ovbench.reference.precision import CONTROL, FLOAT32

    pool = harness.traffic("detect").make_pool(ctx.cfg, ctx.spec["traffic_params"], ctx.seed)
    state = sides.detector_weights(ctx.cfg, ctx.seed, ctx.device)
    outs = []
    for prec in (CONTROL, FLOAT32):
        model = ref_detector.Model3DETR(ctx.cfg["model"], prec).to(ctx.device)
        model.load_state_dict(state)
        model.eval()
        got = []
        with torch.no_grad():
            for b in pool[: ctx.spec["traffic_params"]["sample"]]:
                o = ref_detector.last_layer_outputs(model(sides.to_tensors(b, ctx.device)))
                got.append(tuple(o[k].float().cpu().numpy() for k in
                                 ("box_corners", "sem_cls_prob", "objectness_prob")))
        outs.append(got)
    return compare.detect_numbers(outs[0], outs[1], 0)


def main() -> int:
    import torch

    from ovbench import run

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--faults", type=int, default=0)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--sides", default="program,control")
    a = p.parse_args()
    spec = harness.workload(a.workload)
    cfg = harness.config(spec["config"])
    dev = torch.device("cuda", 0)
    wanted = a.sides.split(",") + (["half_batch"] if a.faults else [])
    for seed in a.seeds:
        for side in wanted:
            t = time.perf_counter()
            if side == "program":
                res = run.execute(SimpleNamespace(workload=a.workload, seed=seed,
                                                  seconds=a.seconds, trace=0),
                                  device=dev, t0=t, spec=spec, cfg=cfg)
                numbers = (res.get("detail", {}).get("numbers")
                           or {k: v["value"] for k, v in res["checked"].items()})
                worst = res.get("detail")
            else:
                ctx = SimpleNamespace(cfg=cfg, spec=spec, device=dev, seed=seed, seconds=0,
                                      trace=False, t0=t, precision=None)
                numbers, worst = ((detect_side(ctx), None) if spec["traffic"] == "detect"
                                  else train_side(ctx, side))
            print(json.dumps({"cell": a.workload, "seed": seed, "side": side, "numbers": numbers,
                              "worst": worst,
                              "s": round(time.perf_counter() - t, 1)}), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
