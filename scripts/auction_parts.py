#!/usr/bin/env python3
"""Where the time of the matcher's auction goes, on one NVIDIA GPU.

    python3 scripts/auction_parts.py

Times the two designs of `ov3det_torch/csrc/auction.cu` at a
`sunrgbd_quick` step's shape (64 rows = 8 decoder layers x 8 scenes, 64
ground-truth slots, 128 queries; the cost as the criterion hands it, a
transposed view): the fused launch (`auction_lap_kernel`, the whole
`auction_lap`) as it is and with parts taken out: the rounds (what is left
is the load with the span, the fallback's test and the stores), the
fallback, and its body (the launch alone); the first design's
kernel alone (`auction_kernel`, the phases) and its whole `auction_lap`
(`_impl="first"`: the span and the fallback as torch ops around it); and
the plain version.  All are replays of a CUDA graph of calls.  A variant
with a part taken out computes nothing meaningful; its time says what the
rest costs.

The variants are made here from the source in the checkout: each cut is a
textual replacement inside the fused kernel that must match exactly once,
guarded by a macro, and every variant is the same file compiled with other
-D flags (one nvcc each, all at once) into `ov3det_torch/_build/parts/`.
The whole kernel of the variant library is checked against the plain
version before anything is timed.  Standalone, the costs are seeded
(normal, ragged live persons); chip_smoke.py calls `parts` on the criterion's
own costs of a training step.  Prints one line a case and a JSON object
last.
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
from ov3det_torch.ops.kernels import auction as A  # noqa: E402

OUT_DIR = _build.BUILD_DIR / "parts"
REPS = 20  # calls a timing graph


def cut(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise RuntimeError(f"expected exactly one match of:\n{old}")
    return text.replace(old, new)


def guard(text: str, start: str, end: str, macro: str, instead: str = "") -> str:
    """The lines from `start` up to `end` (exclusive) compiled only without
    `macro`; `instead` in their place with it."""
    block = text[text.index(start):text.index(end)]
    return cut(text, block, f"#ifdef {macro}\n{instead}#else\n{block}#endif\n")


def source() -> str:
    text = (_build.CSRC_DIR / "auction.cu").read_text()
    text = guard(text, "  // 2. the tight phase", "  // 3. the rank-matching fallback", "NO_ROUNDS",
                 "  int left = 0;\n")
    text = guard(text, "  // 3. the rank-matching fallback", "  // 4. the outputs", "NO_FALLBACK")
    return cut(text, "  const int r = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n"
                     "  int live = P;\n",
               "#ifdef LAUNCH_ONLY\n  return;\n#endif\n"
               "  const int r = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n"
               "  int live = P;\n")


VARIANTS = {  # name -> macros that take parts out of the fused kernel
    "fused": (),
    "fused without the rounds": ("NO_ROUNDS",),
    "fused without the fallback": ("NO_FALLBACK",),
    "fused: the launch alone": ("LAUNCH_ONLY",),
}


def build() -> dict:
    """variant -> the loaded library, every variant compiled at once."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    src = OUT_DIR / "auction-parts.cu"
    src.write_text(source())
    jobs = {}
    for name, macros in VARIANTS.items():
        lib = OUT_DIR / f"auction-{'-'.join(macros) or 'whole'}.so"
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, f"-I{_build.CSRC_DIR}",
               *(f"-D{m}" for m in macros), "-o", str(lib), str(src)]
        jobs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                            text=True))
    libs = {}
    for name, (lib, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        handle = ctypes.CDLL(str(lib))
        for fn, (argtypes, restype) in A._SIGNATURES.items():
            getattr(handle, fn).argtypes = argtypes
            getattr(handle, fn).restype = restype
        libs[name] = handle
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


def parts(cases: dict, reps: int = REPS) -> dict:
    """{case label: {variant: ms}} for `cases` (label -> (cost (R, P, O) f32
    on the card, any strides; n_persons (R,) int64)); each variant timed
    twice in turns, the smaller kept, beside "first design: the kernel
    alone", "first design: its whole auction_lap" and "plain".  The whole
    fused kernel of the variant library must give the plain version's
    outputs."""
    libs = build()
    out = {}
    for label, (cost, n) in cases.items():
        R, P, O = cost.shape
        dev = cost.device
        n = n.to(torch.int64).contiguous()
        p2o = torch.empty((R, P), dtype=torch.int64, device=dev)
        assigned = torch.empty((R, O), dtype=torch.float32, device=dev)
        o2p = torch.empty((R, O), dtype=torch.int64, device=dev)

        def fused(lib):
            status = lib.ov3_auction_lap(cost.data_ptr(), *cost.stride(), R, P, O, n.data_ptr(),
                                         500, 800, p2o.data_ptr(), assigned.data_ptr(),
                                         o2p.data_ptr(), torch.cuda.current_stream().cuda_stream)
            if status != 0:
                raise RuntimeError(f"auction parts: the fused kernel failed: CUDA error {status}")

        want = A.auction_lap_plain(cost, n)
        fused(libs["fused"])
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip((p2o, assigned, o2p), want)):
            raise AssertionError(f"auction parts: the fused kernel differs from the plain version "
                                 f"on {label}")
        benefit, live, span = A.auction_inputs(cost, n)
        eps_t, eps_l = span * 2e-4, span * 5e-3
        timed = {name: (lambda lib=lib: fused(lib)) for name, lib in libs.items()}
        timed["first design: the kernel alone"] = lambda: A.auction_phases(benefit, live, eps_t,
                                                                           eps_l)
        timed["first design: its whole auction_lap"] = lambda: A.auction_lap(cost, n,
                                                                             _impl="first")
        ms = {name: [] for name in timed}
        for order in (list(timed), list(timed)[::-1]):
            for name in order:
                ms[name].append(graph_ms(timed[name], reps))
        out[label] = {name: min(v) for name, v in ms.items()}
        torch.cuda.synchronize()
        plain = []
        for _ in range(3):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            A.auction_lap_plain(cost, n)
            end.record()
            torch.cuda.synchronize()
            plain.append(start.elapsed_time(end))
        out[label]["plain (host checks included)"] = min(plain)
    return out


def report(result: dict, card: str) -> None:
    for label, ms in result.items():
        whole = ms["fused"]
        print(f"auction parts, {label}: " + ", ".join(f"{n} {v:.4f} ms" for n, v in ms.items())
              + f"; so the rounds {whole - ms['fused without the rounds']:.4f} ms, the fallback "
              f"{whole - ms['fused without the fallback']:.4f} ms ({card})")


def seeded(seed: int = 17) -> tuple:
    """Seeded costs at a sunrgbd_quick step's shape, as the criterion hands
    them: (64, 128, 64) transposed to (64, 64, 128), 1 to 64 live persons."""
    rng = np.random.default_rng(seed)
    cost = torch.from_numpy(rng.normal(size=(64, 128, 64)).astype(np.float32)).cuda()
    return cost.transpose(1, 2), torch.from_numpy(rng.integers(1, 65, 64)).cuda()


def main() -> int:
    if not torch.cuda.is_available():
        print("auction_parts: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    card = res.stdout.strip().splitlines()[0]
    print(f"card: {card}")
    result = parts({"seeded 64 x 64 x 128": seeded()})
    report(result, card)
    print(json.dumps({"card": card, "parts": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
