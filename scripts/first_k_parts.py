#!/usr/bin/env python3
"""Where the time of the first-K query's routed kernel goes, on one NVIDIA GPU.

    python3 scripts/first_k_parts.py

Times `first_k_lanes` (`ov3det_torch/csrc/first_k.cu`: a lane four
centers, a warp a contiguous slice of the points staged by cp.async) at the masked first-K
request's two queries (the pre-encoder's: 8 x 40 000 points, M 2048, K 64,
r 0.2; the interim SA's: its 2048 points, M 1024, K 32, r 0.4, on a
synthetic ScanNet batch and its FPS centers) as it is and with parts taken
out: the bookkeeping (each step's hits appended to their balls' lists, a
branch a step; the steps' outcome is summed into a register instead), the
tests' arithmetic (each test is the sum |c|^2 + |x|^2 alone, which passes
almost never), the tests
as a whole (what is left is the staging, the counts' exchange and the
merge),
and the whole body (the launch alone).  A variant computes nothing
meaningful; its time says what the part that is left costs, and the
difference to the whole kernel what the part taken out costs.

The variants are made here, from the kernel's text in the checkout: each
cut is a textual replacement inside `first_k_lanes` that must match exactly
once, guarded by a macro, and every variant is the same file compiled with
other -D flags (one nvcc each, all at once) into
`ov3det_torch/_build/parts/`; `scripts/points_in_box_parts.py` makes its
variants with the same functions.  The whole kernel of the variant library is
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
from ov3det_torch.ops.kernels import _build  # noqa: E402
from ov3det_torch.ops.kernels import ball_query as BQ  # noqa: E402

OUT_DIR = _build.BUILD_DIR / "parts"
REPS = 20  # calls a timing graph
HEAD = "template <int S>\n__global__ void __launch_bounds__(32 * S)\nfirst_k_lanes("


def cut(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise RuntimeError(f"expected exactly one match of:\n{old}")
    return text.replace(old, new)


def guard(text: str, start: str, end: str, macro: str, instead: str = "") -> str:
    """The lines from `start` up to `end` (exclusive) compiled only without
    `macro`; `instead` in their place with it."""
    block = text[text.index(start):text.index(end)]
    return cut(text, block, f"#ifdef {macro}\n{instead}#else\n{block}#endif\n")


def lanes_cuts(k: str) -> str:
    k = cut(k, "  extern __shared__ __align__(16) unsigned char smem[];\n",
            "#ifdef LAUNCH_ONLY\n  return;\n#endif\n"
            "  extern __shared__ __align__(16) unsigned char smem[];\n")
    k = guard(k, "          const float cross", "          any |= d[u][r] < thr[r];", "NO_MATH",
              "          d[u][r] = __fadd_rn(c2[r], q.w);\n")
    for call, instead in (("      if (any_b) keep(db, at_b);\n", "      sink += any_b;\n"),
                          ("      if (any_a) keep(da, base + j);\n", "      sink += any_a;\n"),
                          ("    }\n    if (any_b) keep(db, at_b);\n", "    }\n    sink += any_b;\n")):
        k = cut(k, call, f"#ifdef NO_PICKS\n{instead}#else\n{call}#endif\n")
    k = guard(k, "    float da[kUnroll][kCenters], db[kUnroll][kCenters];",
              "    __syncwarp();  // every lane has read", "NO_TESTS")
    k = cut(k, "  if (stages > 0) stage(0);\n",
            "  int sink = 0;  // NO_PICKS's tests\n  if (stages > 0) stage(0);\n")
    return cut(k, "  ov3::cp_async_wait_all();\n",
               "  ov3::cp_async_wait_all();\n  if (sink < 0) out[0] = sink;  // never: keeps the tests\n")


VARIANTS = {  # name -> macros that take parts out
    "whole": (),
    "without the bookkeeping": ("NO_PICKS",),
    "without the distance arithmetic": ("NO_MATH",),
    "staging and merge alone": ("NO_TESTS",),
    "the launch alone": ("LAUNCH_ONLY",),
}


def kernel_source(name: str, head: str, cuts) -> str:
    """`csrc/<name>.cu` with `cuts` applied to the kernel whose definition
    begins with `head` (up to its closing brace at the start of a line)."""
    text = (_build.CSRC_DIR / f"{name}.cu").read_text()
    start = text.index(head)
    end = text.index("\n}\n", start) + 3
    return text[:start] + cuts(text[start:end]) + text[end:]


def build_variants(name: str, text: str, variants: dict, signatures: dict) -> dict:
    """variant -> the loaded library of `text` compiled with the variant's
    macros, every variant compiled at once into `OUT_DIR`."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    src = OUT_DIR / f"{name}-parts.cu"
    src.write_text(text)
    jobs = {}
    for variant, macros in variants.items():
        lib = OUT_DIR / f"{name}-{'-'.join(macros) or 'whole'}.so"
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, f"-I{_build.CSRC_DIR}",
               *(f"-D{m}" for m in macros), "-o", str(lib), str(src)]
        jobs[variant] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                               stderr=subprocess.STDOUT, text=True))
    libs = {}
    for variant, (lib, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {variant}:\n{out}")
        handle = ctypes.CDLL(str(lib))
        for fn, (argtypes, restype) in signatures.items():
            getattr(handle, fn).argtypes = argtypes
            getattr(handle, fn).restype = restype
        libs[variant] = handle
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


def run(lib, xyz, centers, radius: float, K: int, out: torch.Tensor) -> None:
    B, N, _ = xyz.shape
    status = lib.ov3_first_k(xyz.data_ptr(), centers.data_ptr(), B, N, centers.shape[1], K,
                             ctypes.c_float(BQ._r2(radius)), out.data_ptr(),
                             torch.cuda.current_stream().cuda_stream)
    if status != 0:
        raise RuntimeError(f"ov3_first_k failed: CUDA error {status}")


def parts(cases: dict, reps: int = REPS) -> dict:
    """{case label: {variant: ms}} for `cases` (label -> (xyz, centers,
    radius, K) on the card); each variant timed twice in turns, the smaller
    kept.  The whole kernel must give the plain version's indices."""
    libs = build_variants("first_k", kernel_source("first_k", HEAD, lanes_cuts), VARIANTS,
                          BQ._SIGNATURES)
    result = {}
    for label, (xyz, centers, radius, K) in cases.items():
        out = torch.empty((xyz.shape[0], centers.shape[1], K), dtype=torch.int64,
                          device=xyz.device)
        run(libs["whole"], xyz, centers, radius, K, out)
        torch.cuda.synchronize()
        if not torch.equal(out, BQ.first_k_plain(xyz, centers, radius, K)):
            raise AssertionError(f"first_k parts: the whole kernel differs from the plain "
                                 f"version at {label}")
        ms = {name: [] for name in VARIANTS}
        for order in (list(VARIANTS), list(VARIANTS)[::-1]):
            for name in order:
                ms[name].append(graph_ms(
                    lambda: run(libs[name], xyz, centers, radius, K, out), reps))
        result[label] = {name: min(v) for name, v in ms.items()}
    return result


def queries(dev: torch.device) -> dict:
    """The masked first-K request's two queries on a synthetic batch."""
    import chip_smoke
    from ov3det_torch.config import scannet_quick
    from ov3det_torch.ops.pointcloud import furthest_point_sample, gather_points

    masked = chip_smoke.scannet_masked().model
    batch = chip_smoke.synthetic_batches(scannet_quick(), 1, 900)[0]
    xyz = torch.from_numpy(batch["point_clouds"][..., :3]).to(dev).contiguous()
    pre = gather_points(xyz, furthest_point_sample(xyz, masked.preenc_npoints)).contiguous()
    interim = gather_points(pre, furthest_point_sample(pre, masked.preenc_npoints // 2))
    return {"pre-encoder (8 x 40 000, M 2048, K 64, r 0.2)":
            (xyz, pre, masked.preenc_radius, masked.preenc_nsample),
            "interim SA (8 x 2048, M 1024, K 32, r 0.4)":
            (pre, interim.contiguous(), masked.interim_radius, masked.interim_nsample)}


def report(result: dict, card: str) -> None:
    for label, ms in result.items():
        whole = ms["whole"]
        print(f"first_k parts, {label}: " + ", ".join(f"{n} {v:.4f} ms" for n, v in ms.items())
              + f"; so the bookkeeping {whole - ms['without the bookkeeping']:.4f} ms, the "
              f"distance arithmetic {whole - ms['without the distance arithmetic']:.4f} ms, the "
              f"tests {whole - ms['staging and merge alone']:.4f} ms ({card})")


def main() -> int:
    if not torch.cuda.is_available():
        print("first_k_parts: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    card = res.stdout.strip().splitlines()[0]
    print(f"card: {card}")
    result = parts(queries(torch.device("cuda")))
    report(result, card)
    print(json.dumps({"card": card, "parts": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
