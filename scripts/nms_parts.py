#!/usr/bin/env python3
"""Where the time of the NMS kernels goes, on one NVIDIA GPU.

    python3 scripts/nms_parts.py

Times the two designs of `ov3det_torch/csrc/nms.cu` (the first,
`nms_kernel`: one CTA a scene; the routed one, `nms_cluster_kernel`: a
cluster of CTAs a scene) at a request's shapes (B 8, K 128 and 256, 3D
class-aware, threshold 0.25) as they are and with parts taken out: the
rank, the suppression bitmask, the greedy pass, all three (what is left is
the loads, the barriers and the keep mask's store), and the whole body (the
launch alone).  A variant computes nothing meaningful; its time says what
the part that is left costs, and the difference to the whole kernel what
the part taken out costs.

The variants are made here, from the kernel's text in the checkout: each
cut is a textual replacement inside one kernel that must match exactly
once, guarded by a macro, and every variant is the same file compiled with
other -D flags (one nvcc each, all at once) into
`ov3det_torch/_build/parts/`.  The whole kernel of each variant library is
checked against the plain version before anything is timed.  Standalone,
the scenes are seeded boxes of the size of a room's objects; chip_smoke.py
calls `parts` on its requests' own outputs.  Prints one line per variant
and a JSON object last.
"""
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
from ov3det_torch.ops.kernels import _build  # noqa: E402
from ov3det_torch.ops.kernels import nms as N  # noqa: E402

OUT_DIR = _build.BUILD_DIR / "parts"
THRESH = 0.25  # the eval's IoU of NMS
REPS = 50  # calls a timing graph


def cut(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise RuntimeError(f"expected exactly one match of:\n{old}")
    return text.replace(old, new)


def guard(text: str, start: str, end: str, macro: str, instead: str = "") -> str:
    """The lines from `start` up to `end` (exclusive) compiled only without
    `macro`; `instead` in their place with it."""
    block = text[text.index(start):text.index(end)]
    return cut(text, block, f"#ifdef {macro}\n{instead}#else\n{block}#endif\n")


def kernel_span(text: str, head: str) -> tuple:
    """(start, end) of the kernel whose definition begins with `head`: up to
    its closing brace at the start of a line."""
    start = text.index(head)
    return start, text.index("\n}\n", start) + 3


def first_cuts(k: str) -> str:
    k = cut(k, "  extern __shared__ __align__(16) unsigned char smem[];\n",
            "#ifdef LAUNCH_ONLY\n  return;\n#endif\n"
            "  extern __shared__ __align__(16) unsigned char smem[];\n")
    k = guard(k, "    int rank = 0;\n", "  }\n  __syncthreads();\n\n  // the bitmask", "NO_RANK",
              "    order[i] = i;\n")
    k = guard(k, "  // the bitmask: a warp a row", "  // the greedy pass", "NO_MASK",
              "  for (int i = tid; i < K * words; i += kThreads) mask[i] = 0u;\n  __syncthreads();\n")
    return guard(k, "  // the greedy pass", "  for (int i = tid; i < K; i += kThreads) keep_out",
                 "NO_GREEDY", "  __syncthreads();\n")


def cluster_cuts(k: str) -> str:
    k = cut(k, "  extern __shared__ __align__(16) unsigned char smem[];\n",
            "#ifdef LAUNCH_ONLY\n  return;\n#endif\n"
            "  extern __shared__ __align__(16) unsigned char smem[];\n")
    k = guard(k, "  // the rank:", "  cluster_barrier();  // every CTA holds the order",
              "NO_RANK", "  for (int i = tid; i < K; i += kThreads) order[i] = i;\n")
    k = guard(k, "  // the bitmask:", "  cluster_barrier();  // every row is in the leader",
              "NO_MASK",
              "  if (cta == 0)\n    for (int i = tid; i < K * words; i += kThreads) mask[i] = 0u;\n")
    return guard(k, "  // the greedy pass:", "  // the keep mask", "NO_GREEDY")


DESIGNS = {  # design -> (the kernel's first line, its cuts, the C entry that launches it)
    "first": ("template <int D>\n__global__ void __launch_bounds__(kThreads)\nnms_kernel(",
              first_cuts, "ov3_nms_first"),
    "cluster": ("template <int D>\n__global__ void __launch_bounds__(kThreads, 1)\nnms_cluster_kernel(",
                cluster_cuts, "ov3_nms"),
}

VARIANTS = {  # name -> macros that take parts out
    "whole": (),
    "without the rank": ("NO_RANK",),
    "without the bitmask": ("NO_MASK",),
    "without the greedy pass": ("NO_GREEDY",),
    "loads, barriers and the store alone": ("NO_RANK", "NO_MASK", "NO_GREEDY"),
    "the launch alone": ("LAUNCH_ONLY",),
}


def source(design: str) -> str:
    text = (_build.CSRC_DIR / "nms.cu").read_text()
    head, cuts, _ = DESIGNS[design]
    start, end = kernel_span(text, head)
    return text[:start] + cuts(text[start:end]) + text[end:]


def build(designs) -> dict:
    """(design, variant) -> the loaded library, every variant compiled at once."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for design in designs:
        src = OUT_DIR / f"nms-{design}.cu"
        src.write_text(source(design))
        for name, macros in VARIANTS.items():
            lib = OUT_DIR / f"nms-{design}-{'-'.join(macros) or 'whole'}.so"
            cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, f"-I{_build.CSRC_DIR}",
                   *(f"-D{m}" for m in macros), "-o", str(lib), str(src)]
            jobs[design, name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                        stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (lib, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{out}")
        handle = ctypes.CDLL(str(lib))
        for fn, (argtypes, restype) in N._SIGNATURES.items():
            getattr(handle, fn).argtypes = argtypes
            getattr(handle, fn).restype = restype
        libs[key] = handle
    return libs


def graph_ms(fn, reps: int) -> float:
    """Mean device time of one call, from one replay of a CUDA graph of
    `reps` calls (the host's launch cost left out)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def run(lib, entry: str, case: dict, keep: torch.Tensor) -> None:
    boxes, scores = case["aabb"], case["scores"]
    classes = case.get("classes")
    B, K = scores.shape
    status = getattr(lib, entry)(
        boxes.data_ptr(), scores.data_ptr(), classes.data_ptr() if classes is not None else None,
        case["valid"].view(torch.uint8).data_ptr(), B, K, boxes.shape[-1] // 2,
        ctypes.c_float(THRESH), 0, keep.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if status != 0:
        raise RuntimeError(f"{entry} failed: CUDA error {status}")


def parts(cases: dict, designs=tuple(DESIGNS), reps: int = REPS) -> dict:
    """{design: {case label: {variant: ms}}} for `cases` (label -> dict(aabb
    (B, K, 6) f32, scores (B, K) f32, classes (B, K) int64 or None, valid
    (B, K) bool) on the card); each variant timed twice in turns, the
    smaller kept.  The whole kernel of every library must give the plain
    version's keep mask."""
    libs = build(designs)
    out = {}
    for design in designs:
        entry = DESIGNS[design][2]
        out[design] = {}
        for label, case in cases.items():
            case = {k: (v.contiguous() if v is not None else None) for k, v in case.items()}
            want = N.nms_plain(case["aabb"], case["scores"], THRESH, case["valid"],
                               case.get("classes"))
            keep = torch.empty(case["scores"].shape, dtype=torch.bool, device=case["scores"].device)
            run(libs[design, "whole"], entry, case, keep)
            torch.cuda.synchronize()
            if not torch.equal(keep, want):
                raise AssertionError(f"nms parts: the {design} design differs from the plain "
                                     f"version on {label}")
            ms = {name: [] for name in VARIANTS}
            for order in (list(VARIANTS), list(VARIANTS)[::-1]):
                for name in order:
                    lib = libs[design, name]
                    ms[name].append(graph_ms(lambda: run(lib, entry, case, keep), reps))
            out[design][label] = {name: min(v) for name, v in ms.items()}
            out[design][label]["kept"] = int(want.sum())
    return out


def scenes(seed: int, B: int, K: int) -> dict:
    """Seeded 3D class-aware NMS inputs: boxes of 0.2 to 2 m in a 6 m room,
    uniform scores, 18 classes, 9 in 10 boxes valid."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0.0, 6.0, (B, K, 3))
    half = rng.uniform(0.1, 1.0, (B, K, 3))
    dev = torch.device("cuda")
    return dict(aabb=torch.from_numpy(np.concatenate([centers - half, centers + half], -1)
                                      .astype(np.float32)).to(dev),
                scores=torch.from_numpy(rng.random((B, K), dtype=np.float32)).to(dev),
                classes=torch.from_numpy(rng.integers(0, 18, (B, K))).to(dev),
                valid=torch.from_numpy(rng.random((B, K)) < 0.9).to(dev))


def report(result: dict, card: str) -> None:
    for design, cases in result.items():
        for label, ms in cases.items():
            whole = ms["whole"]
            parts_of = {"rank": whole - ms["without the rank"],
                        "bitmask": whole - ms["without the bitmask"],
                        "greedy pass": whole - ms["without the greedy pass"]}
            print(f"nms parts, {design} design, {label} ({ms['kept']} kept): "
                  + ", ".join(f"{n} {v:.4f} ms" for n, v in ms.items() if n != "kept")
                  + "; so the " + ", the ".join(f"{n} {v:.4f} ms" for n, v in parts_of.items())
                  + f" ({card})")


def main() -> int:
    if not torch.cuda.is_available():
        print("nms_parts: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    card = res.stdout.strip().splitlines()[0]
    print(f"card: {card}")
    designs = [d for d in DESIGNS if d in sys.argv[1:]] or list(DESIGNS)
    cases = {f"B 8, K {K}": scenes(K, 8, K) for K in (128, 256)}
    result = parts(cases, designs)
    report(result, card)
    print(json.dumps({"card": card, "parts": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
