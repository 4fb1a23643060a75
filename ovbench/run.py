"""Run one cell of the benchmark once.

    python3 ovbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Set-up builds the kernels (into
`ov3det_torch/_build/`), makes the cell's traffic and weights from the
seed and warms every shape; the window then runs the cell's traffic for
`--seconds`; after it, the program's state is freed and its outputs are
compared with the plain reference.  The last line of standard output is
the result as JSON: with `--trace 0` the cell's end-to-end metrics, with
`--trace 1` its per-layer metrics (from a profiled stretch after the
window).  The numbers compared, each beside its limit, are the last lines
of standard error and the last key of the result.  No result, and a
non-zero exit, without the cards the cell asks for, or when a module of
JAX or of the JAX package is loaded once the window has closed.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from ovbench import harness  # noqa: E402

harness.set_cache_dirs()


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def execute(args, device=None, t0=None, precision=None, spec=None, cfg=None,
            bench=None) -> dict:
    """One run of a cell: the traffic driver's numbers and the result line's
    fields.  `device` None is the first card (the benchmark's own runs);
    the other arguments let a test drive the rest of a run, `precision`
    the reference's (float32 unless given)."""
    import torch

    from ovbench import compare
    from ovbench.reference.precision import FLOAT32

    spec = spec or harness.workload(args.workload)
    cfg = cfg or harness.config(spec["config"])
    bench = bench or harness.benchmark()
    if device is None:
        device = torch.device("cuda", 0)
    ctx = SimpleNamespace(cfg=cfg, spec=spec, device=device, seed=args.seed,
                          seconds=args.seconds, trace=bool(args.trace), t0=T0 if t0 is None else t0,
                          precision=precision or FLOAT32)
    out = harness.traffic(spec["traffic"]).run(ctx)
    correct, rows = compare.verdict(out["numbers"], spec["limits"])
    correct = correct and out["failed"] == 0
    e2e, per_layer = harness.cell_metrics(bench, args.workload)
    if args.trace:
        ctx.trace = out.get("trace")
        ctx.out = out
        metrics = harness.read_per_layer(per_layer, ctx)
    else:
        metrics = {m["name"]: {"value": out[m["name"]], "unit": m["unit"]}
                   for m in e2e if m["name"] in out}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": out.get("memory_peak_bytes", 0)}
    result = {"correct": bool(correct), "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": dev}
    if args.trace and out.get("trace"):
        t = out["trace"]
        dev["busy_s"], dev["window_s"] = t["busy_s"], t["window_s"]
        result["breakdown"] = t["breakdown"]
    for key in ("detail", "host"):  # what a reading is looked into by
        if out.get(key):
            result[key] = out[key]
    result["checked"] = {name: {"value": v if math.isfinite(v) else str(v), "limit": lim}
                         for name, v, lim in rows}
    return result


def main(argv=None) -> int:
    args = parse(argv)
    spec = harness.workload(args.workload)
    missing = harness.require_devices(spec["chips"])
    if missing:
        print(f"ovbench: {missing}; no result", file=sys.stderr)
        return 3
    result = execute(args, spec=spec)
    found = harness.forbidden_modules()
    if found:
        print(f"ovbench: modules of JAX or of the JAX package are loaded: {found}; no result",
              file=sys.stderr)
        return 4
    for name, c in result["checked"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
