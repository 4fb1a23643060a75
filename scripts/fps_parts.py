#!/usr/bin/env python3
"""Where the time of furthest-point sampling goes, on one NVIDIA GPU.

    python3 scripts/fps_parts.py

For each call of the two main paths (8 scenes: 20000 -> 2048, 2048 -> 128,
40000 -> 2048, 2048 -> 1024, 1024 -> 256), one ragged cloud, the sizes at
around which the route changes the cluster, and the largest cloud, on seeded random
points:
  * the indices of the cluster design (as `fps.fps` routes it, and with every
    cluster size it can take: 1, 2, 4, 8, 16 CTAs a scene), of the first
    design and of the plain version must be equal;
  * each is timed with CUDA events, in turns;
  * the chain alone (the step's reductions, exchange and barrier on no
    points, `ov3_fps_chain`) is timed for every cluster size: the floor of a
    call with that many samples.
A cluster size that the card refuses to launch fails the run.
Then the shapes that strain the exchange rather than the clock: more
clusters than the card holds at once (64 scenes), as many samples as points,
one scene, an odd batch; the route's indices must equal the first design's
in each of five launches.  Prints one line per measurement and a JSON object
last.
"""
import json
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
from ov3det_torch.ops.kernels import _build  # noqa: E402
from ov3det_torch.ops.kernels import fps as F  # noqa: E402

BATCH = 8
CALLS = [(20000, 2048), (2048, 128), (40000, 2048), (2048, 1024), (1024, 256), (20001, 64),
         (1025, 256), (4096, 512), (8192, 512), (8193, 64), (65536, 64)]
STRESS = [(64, 20000, 512), (8, 2048, 2048), (1, 40000, 2048), (3, 8193, 300), (8, 1024, 1024)]
CLUSTERS = (1, 2, 4, 8, 16)
POINTS_PER_CTA = 32 * F.CLUSTER_THREADS  # the largest instantiation


def cuda_ms(fn, reps: int) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("fps_parts: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(f"card: {res.stdout.strip().splitlines()[0]}")
    log = _build.build(("fps",)).get("fps", "")
    worst = [line.strip() for line in log.splitlines()
             if "stack frame" in line and not line.strip().startswith("0 bytes stack frame, 0 bytes spill")]
    print(f"ptxas: stack frames or spills: {worst}" if worst else "ptxas: no stack frame, no spills")
    dev = torch.device("cuda")
    results = {}
    for n, k in CALLS:
        xyz = torch.rand(BATCH, n, 3, generator=torch.Generator().manual_seed(n + k)).to(dev) * 4 - 2
        reps = 3 if n > 4096 else 10
        want = F.fps_plain(xyz, k)
        got, first = F.fps(xyz, k), F.fps(xyz, k, _impl="first")
        if not (torch.equal(got, want) and torch.equal(first, want)):
            raise AssertionError(f"fps {n}->{k}: the designs and the plain version disagree")
        plan = F.plan(BATCH, n)
        row = {"plan": plan}
        first_ms = cuda_ms(lambda: F.fps(xyz, k, _impl="first"), reps)
        row["route_ms"] = cuda_ms(lambda: F.fps(xyz, k), reps)
        for c in CLUSTERS:
            if n > c * POINTS_PER_CTA:
                continue
            if not torch.equal(F.with_cluster(xyz, k, c), want):
                raise AssertionError(f"fps {n}->{k}, cluster {c}: indices differ from the plain version")
            ms = cuda_ms(lambda: F.with_cluster(xyz, k, c), reps)
            chain = cuda_ms(lambda: F.chain(BATCH, k, c, dev), reps)
            row[f"cluster_{c}"] = {"ms": ms, "chain_ms": chain}
            print(f"fps {n}->{k}, cluster {c}: {ms:.4f} ms ({ms / (k - 1) * 1e3:.3f} us a step); "
                  f"chain alone {chain:.4f} ms ({chain / (k - 1) * 1e3:.3f} us a step)")
        row["first_ms"] = min(first_ms, cuda_ms(lambda: F.fps(xyz, k, _impl="first"), reps))
        row["route_ms"] = min(row["route_ms"], cuda_ms(lambda: F.fps(xyz, k), reps))
        print(f"fps {n}->{k}: route (cluster {plan['cluster']}, {plan['ctas']} CTAs of {plan['threads']} "
              f"threads, {plan['clusters_at_once']} at once) {row['route_ms']:.4f} ms; first design "
              f"{row['first_ms']:.4f} ms; indices equal the plain version's")
        results[f"{n}->{k}"] = row
    for b, n, k in STRESS:
        xyz = torch.rand(b, n, 3, generator=torch.Generator().manual_seed(b * n + k)).to(dev) * 4 - 2
        want = F.fps(xyz, k, _impl="first")
        for launch in range(5):
            if not torch.equal(F.fps(xyz, k), want):
                raise AssertionError(f"fps {b}x{n}->{k}, launch {launch}: the route's indices differ "
                                     "from the first design's")
        plan = F.plan(b, n)
        print(f"fps {b}x{n}->{k}: 5 launches equal the first design's indices ({plan['ctas']} CTAs in "
              f"clusters of {plan['cluster']}, {plan['clusters_at_once']} clusters fit at once)")
    print(json.dumps({"batch": BATCH, "calls": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
