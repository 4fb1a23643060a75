#!/usr/bin/env python3
"""Where the time of the empty-box test's routed kernel goes, on one NVIDIA GPU.

    python3 scripts/points_in_box_parts.py

Times `points_in_box_cluster` (`ov3det_torch/csrc/points_in_box.cu`: a
cluster of CTAs a scene and tile of 16 boxes, each CTA a slice of the points
staged by cp.async, a thread 4 boxes in registers, the counts summed by
DSMEM in the leader) at both requests' parse shapes (B 8, K 128 x N 20 000
and K 256 x N 40 000, seeded boxes of a room's objects among seeded points)
as it is and with parts taken out: the count (each test's outcome is summed
into one register, with no shuffles and no DSMEM adds), the tests (what is
left is the box set-up, the staging and the cluster sum), the staging and
the tests (the box set-up and the cluster sum alone), and the whole body
(the launch alone).  A variant computes nothing meaningful; its time says
what the part that is left costs, and the difference to the whole kernel
what the part taken out costs.

The variants are made here, from the kernel's text in the checkout: each
cut is a textual replacement inside `points_in_box_cluster` that must match
exactly once, guarded by a macro, and every variant is the same file
compiled with other -D flags (one nvcc each, all at once) into
`ov3det_torch/_build/parts/` by `scripts/first_k_parts.py`'s functions.  The whole kernel of the variant library is
checked against the plain version before anything is timed.  Prints one
line per variant and a JSON object last.
"""
import ctypes
import json
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from first_k_parts import build_variants, cut, graph_ms, guard, kernel_source  # noqa: E402

from ov3det_torch.ops.kernels import points_in_box as PIB  # noqa: E402

REPS = 50  # calls a timing graph
HEAD = "__global__ void __launch_bounds__(kClusterThreads)\npoints_in_box_cluster("


def cluster_cuts(k: str) -> str:
    k = cut(k, "  __shared__ __align__(16) float ring[2][kRingWords];\n",
            "#ifdef LAUNCH_ONLY\n  return;\n#endif\n"
            "  __shared__ __align__(16) float ring[2][kRingWords];\n")
    k = guard(k, "    int i = q;\n",
              "    __syncthreads();  // stage t is read", "NO_TESTS")
    k = guard(k, "  if (stages > 0) stage(0);\n", "\n  if (tid < kClusterTile) {", "NO_STAGE",
              "  const int no_stages = 0;\n")
    k = cut(k, "  for (int t = 0; t < stages; ++t) {",
            "#ifdef NO_STAGE\n  for (int t = 0; t < no_stages; ++t) {\n#else\n"
            "  for (int t = 0; t < stages; ++t) {\n#endif")
    k = guard(k, "  // the lanes of one box group in a warp", "  cluster_wait();  // every CTA's `total`",
              "NO_SUM", "  if (hits[0] + hits[1] + hits[2] + hits[3] == -1) counts[0] = 0;\n"
              "  for (int j = 0; j < kBoxesPerThread; ++j) hits[j] = 0;\n")
    return k


VARIANTS = {  # name -> macros that take parts out
    "whole": (),
    "without the summed count": ("NO_SUM",),
    "box set-up, staging and cluster sum": ("NO_TESTS",),
    "box set-up and cluster sum alone": ("NO_TESTS", "NO_STAGE"),
    "the launch alone": ("LAUNCH_ONLY",),
}


def run(lib, points, corners, counts: torch.Tensor) -> None:
    B, N, _ = points.shape
    status = lib.ov3_points_in_box(points.data_ptr(), corners.data_ptr(), B, N, corners.shape[1],
                                   ctypes.c_float(PIB.EPS), counts.data_ptr(),
                                   torch.cuda.current_stream().cuda_stream)
    if status != 0:
        raise RuntimeError(f"ov3_points_in_box failed: CUDA error {status}")


def parts(cases: dict, reps: int = REPS) -> dict:
    """{case label: {variant: ms}} for `cases` (label -> (points, corners)
    on the card); each variant timed twice in turns, the smaller kept.  The
    whole kernel must give the plain version's counts."""
    libs = build_variants("points_in_box", kernel_source("points_in_box", HEAD, cluster_cuts),
                          VARIANTS, PIB._SIGNATURES)
    result = {}
    for label, (points, corners) in cases.items():
        counts = torch.empty(corners.shape[:2], dtype=torch.int32, device=points.device)
        run(libs["whole"], points, corners, counts)
        torch.cuda.synchronize()
        if not torch.equal(counts, PIB.points_in_box_plain(points, corners)):
            raise AssertionError(f"points_in_box parts: the whole kernel differs from the plain "
                                 f"version at {label}")
        ms = {name: [] for name in VARIANTS}
        for order in (list(VARIANTS), list(VARIANTS)[::-1]):
            for name in order:
                ms[name].append(graph_ms(lambda: run(libs[name], points, corners, counts), reps))
        result[label] = {name: min(v) for name, v in ms.items()}
    return result


def scenes(dev: torch.device) -> dict:
    """Seeded parse inputs at both requests' shapes: points of a 6 m room,
    boxes of 0.2 to 2.5 m at random yaw."""
    import numpy as np

    from ov3det_torch.geometry.boxes_np import corners_from_upright_depth_param_np

    out = {}
    for seed, (K, N) in enumerate(((128, 20000), (256, 40000))):
        rng = np.random.default_rng(seed)
        points = rng.uniform(0.0, 6.0, (8, N, 3)).astype(np.float32)
        corners = corners_from_upright_depth_param_np(
            rng.uniform(0.0, 6.0, (8 * K, 3)), rng.uniform(0.2, 2.5, (8 * K, 3)),
            rng.uniform(-np.pi, np.pi, 8 * K)).reshape(8, K, 8, 3).astype(np.float32)
        out[f"B 8, K {K} x N {N}"] = (torch.from_numpy(points).to(dev),
                                      torch.from_numpy(corners).to(dev))
    return out


def report(result: dict, card: str) -> None:
    for label, ms in result.items():
        whole = ms["whole"]
        print(f"points_in_box parts, {label}: "
              + ", ".join(f"{n} {v:.4f} ms" for n, v in ms.items())
              + f"; so the summed count {whole - ms['without the summed count']:.4f} ms, the "
              f"tests {whole - ms['box set-up, staging and cluster sum']:.4f} ms, the staging "
              f"{ms['box set-up, staging and cluster sum'] - ms['box set-up and cluster sum alone']:.4f}"
              f" ms ({card})")


def main() -> int:
    if not torch.cuda.is_available():
        print("points_in_box_parts: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    card = res.stdout.strip().splitlines()[0]
    print(f"card: {card}")
    result = parts(scenes(torch.device("cuda")))
    report(result, card)
    print(json.dumps({"card": card, "parts": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
