#!/usr/bin/env python3
"""Where the time of the ball-group's feature-gradient scatter goes, on one
NVIDIA GPU.

    python3 scripts/feature_grad_parts.py

Times the two launches of `ov3det_torch/csrc/feature_grad.cu` (the inverse
map `feature_map`, a cluster of CTAs a scene; the sum `feature_sum<CW, RB>`,
a warp an item of CW channels, RB rows staged at a time) at the masked training
step's shape (the interim SA: 8 scenes x 2048 points, 1024 centers, K 32,
C 256): the whole scatter, each launch alone, and each with parts taken
out: the map without its counts or without its placement, the sum without
its row loads (the work records, the list and the adds are left), both with
their bodies gone (the launches alone); then the sum with its choices
changed (channels an item CW, rows staged at a time RB).  Beside them the plain
scatter (`_scatter`: the accumulating `index_put_`) and `index_add_`.  A
variant with a part taken out computes nothing meaningful; its time says
what the rest costs.

The variants are made here from the source in the checkout: each cut is a
textual replacement inside one kernel that must match exactly once, guarded
by a macro, and every variant is the same file compiled with other -D flags
(one nvcc each, all at once) into `ov3det_torch/_build/parts/`.  Each
variant library that computes the whole gradient is checked against
`_scatter` bit for bit before anything is timed.  Standalone, the sources
are the pick pass's on a seeded synthetic masked batch (FPS 40000 -> 2048
-> 1024 by the port's kernel); chip_smoke.py calls `parts` on the masked
step's own.  Prints the slots-a-point distribution, one line a variant, and
a JSON object last.
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
from ov3det_torch.ops.kernels import ball_group as BG  # noqa: E402

OUT_DIR = _build.BUILD_DIR / "parts"
REPS = 10  # calls a timing graph
RADIUS, K, C = 0.4, 32, 256  # the interim SA's


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
    text = (_build.CSRC_DIR / "feature_grad.cu").read_text()
    text = guard(text, "  // counts of each warp's segment", "  // this CTA's count of each point",
                 "NO_COUNT", "  __syncthreads();\n")
    text = guard(text, "  // the placement:", "}\n\n__device__ __forceinline__ void cp_async4", "NO_PLACE")
    text = cut(text, "  cg::cluster_group cluster = cg::this_cluster();\n",
               "#ifdef LAUNCH_ONLY\n  return;\n#endif\n"
               "  cg::cluster_group cluster = cg::this_cluster();\n")
    text = cut(text, "  constexpr int V = CW / 32;  // values a lane a row\n",
               "  constexpr int V = CW / 32;  // values a lane a row\n"
               "#ifdef LAUNCH_ONLY\n  return;\n#endif\n")
    return cut(text, "          if (c * 32 < lim) cp_async4(&buf[j][c * 32 + lane], p + c * 32);\n",
               "#ifdef NO_ROWS\n"
               "          if (c * 32 < lim) buf[j][c * 32 + lane] = __int_as_float(slot);\n#else\n"
               "          if (c * 32 < lim) cp_async4(&buf[j][c * 32 + lane], p + c * 32);\n"
               "#endif\n")


VARIANTS = {  # name -> (macros, the entry timed: "scatter" = both launches)
    "whole": ((), "scatter"),
    "map alone": ((), "map"),
    "sum alone": ((), "sum"),
    "map without its counts": (("NO_COUNT",), "map"),
    "map without its placement": (("NO_PLACE",), "map"),
    "sum without its row loads": (("NO_ROWS",), "sum"),
    "the launches alone": (("LAUNCH_ONLY",), "scatter"),
    **{f"sum at CW {cw}, RB {rb}": ((f"FG_CW={cw}", f"FG_RB={rb}"), "scatter")
       for cw, rb in ((32, 16), (32, 32), (64, 8), (128, 4), (128, 8))},
}


def build() -> dict:
    """variant -> the loaded library, every set of macros compiled at once."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    src = OUT_DIR / "feature_grad-parts.cu"
    src.write_text(source())
    jobs = {}
    for macros in sorted({m for m, _ in VARIANTS.values()}):
        tag = "-".join(m.replace("=", "") for m in macros) or "whole"
        lib = OUT_DIR / f"feature_grad-{tag}.so"
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, f"-I{_build.CSRC_DIR}",
               *(f"-D{m}" for m in macros), "-o", str(lib), str(src)]
        jobs[macros] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                              stderr=subprocess.STDOUT, text=True))
    by_macros = {}
    for macros, (lib, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {macros or 'the whole source'}:\n{out}")
        handle = ctypes.CDLL(str(lib))
        for fn, (argtypes, restype) in BG._SCATTER_SIGNATURES.items():
            getattr(handle, fn).argtypes = argtypes
            getattr(handle, fn).restype = restype
        by_macros[macros] = handle
    return {name: by_macros[macros] for name, (macros, _) in VARIANTS.items()}


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


def distribution(src: torch.Tensor, N: int) -> dict:
    """Slots a point over the scenes' points: max, mean, p99, and the share
    of points no slot names."""
    B = src.shape[0]
    flat = src.reshape(B, -1).long()
    rows = torch.where(flat >= 0, flat + N * torch.arange(B, device=src.device)[:, None], B * N)
    count = torch.bincount(rows.reshape(-1), minlength=B * N + 1)[:B * N].float()
    return dict(max=int(count.max()), mean=float(count.mean()), p99=float(count.quantile(0.99)),
                unnamed=float((count == 0).float().mean()))


def parts(src: torch.Tensor, grad: torch.Tensor, N: int, reps: int = REPS) -> dict:
    """{variant: ms} of the scatter of `grad` (B, K, M, 3 + C) f32 onto the
    points `src` (B, K, M) int32 names, on the card, each timed twice in
    turns (the smaller kept), with "plain (index_put_)" and "index_add_".
    Every variant that computes the whole gradient must give `_scatter`'s
    bits.  A cut map writes into scratch of its own, so that the sum's
    variants read the whole map's output."""
    libs = build()
    B, Kk, M = src.shape
    C_ = grad.shape[-1] - 3
    KM = Kk * M
    src, grad = src.contiguous(), grad.contiguous()
    want = BG._scatter(src, grad, N, C_)
    dev = src.device
    slots, spare_slots = (torch.empty((B, KM), dtype=torch.int32, device=dev) for _ in range(2))
    work, spare_work = (torch.empty((B, N, 4), dtype=torch.int32, device=dev) for _ in range(2))
    out = torch.empty((B, N, C_), dtype=torch.float32, device=dev)

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def call(lib, entry: str, own: bool = True):
        li, wk = (slots, work) if own else (spare_slots, spare_work)
        if entry == "map":
            status = lib.ov3_feature_map(src.data_ptr(), B, N, KM, li.data_ptr(), wk.data_ptr(),
                                         stream())
        elif entry == "sum":
            status = lib.ov3_feature_sum(grad.data_ptr(), B, N, KM, C_, li.data_ptr(),
                                         wk.data_ptr(), out.data_ptr(), stream())
        else:
            status = lib.ov3_feature_scatter(src.data_ptr(), grad.data_ptr(), B, N, KM, C_,
                                             li.data_ptr(), wk.data_ptr(), out.data_ptr(),
                                             stream())
        if status != 0:
            raise RuntimeError(f"feature_grad parts: {entry} failed: CUDA error {status}")

    for name, (macros, entry) in VARIANTS.items():
        if entry == "scatter" and "LAUNCH_ONLY" not in macros:
            out.fill_(float("nan"))
            call(libs[name], "scatter")
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise AssertionError(f"feature_grad parts: {name} differs from _scatter")
    call(libs["whole"], "map")  # the sum's variants read this map
    rows = torch.where(src >= 0, src.long() + N * torch.arange(B, device=dev)[:, None, None],
                       B * N).reshape(-1)
    feats = grad[..., 3:].reshape(-1, C_)
    atomics = torch.zeros(B * N + 1, C_, dtype=torch.float32, device=dev)
    timed = {}
    for name, (macros, entry) in VARIANTS.items():
        own = not (entry == "map" and macros) and "LAUNCH_ONLY" not in macros
        timed[name] = lambda lib=libs[name], entry=entry, own=own: call(lib, entry, own)
    timed["plain (index_put_)"] = lambda: BG._scatter(src, grad, N, C_)
    timed["index_add_"] = lambda: atomics.index_add_(0, rows, feats)
    ms = {name: [] for name in timed}
    for order in (list(timed), list(timed)[::-1]):
        for name in order:
            ms[name].append(graph_ms(timed[name], reps))
    return {name: min(v) for name, v in ms.items()}


def report(result: dict, dist: dict, card: str) -> None:
    whole = result["whole"]
    print(f"feature_grad slots a point: max {dist['max']}, mean {dist['mean']:.2f}, p99 "
          f"{dist['p99']:.1f}, named by no slot {dist['unnamed']:.4f}")
    print("feature_grad parts: " + ", ".join(f"{n} {v:.4f} ms" for n, v in result.items())
          + f"; so the map's counts {result['map alone'] - result['map without its counts']:.4f} "
          f"ms, its placement {result['map alone'] - result['map without its placement']:.4f} "
          f"ms, the sum's row loads "
          f"{result['sum alone'] - result['sum without its row loads']:.4f} ms, both launches "
          f"{whole:.4f} ms ({card})")


def masked_sources(seed: int = 300) -> tuple:
    """The pick pass's sources and a seeded cotangent at the interim SA of a
    seeded synthetic masked batch (8 x 40000 points)."""
    from ov3det_torch.datasets.synthetic import make_batch
    from ov3det_torch.ops.kernels import fps

    batch = make_batch(np.random.default_rng(seed), batch_size=8, num_points=40000, max_num_obj=64,
                       num_semcls=18, num_angle_bin=1)
    xyz = torch.from_numpy(batch["point_clouds"][..., :3]).contiguous().cuda()
    gather = lambda p, i: torch.gather(p, 1, i[..., None].expand(-1, -1, 3)).contiguous()  # noqa: E731
    pre = gather(xyz, fps.fps(xyz, 2048))
    mid = gather(pre, fps.fps(pre, 1024))
    src = BG.slot_sources(pre, mid, RADIUS, K)
    grad = torch.randn(8, K, 1024, 3 + C, generator=torch.Generator().manual_seed(3)).cuda()
    return src, grad, pre.shape[1]


def main() -> int:
    if not torch.cuda.is_available():
        print("feature_grad_parts: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    card = res.stdout.strip().splitlines()[0]
    print(f"card: {card}")
    src, grad, N = masked_sources()
    dist = distribution(src, N)
    result = parts(src, grad, N)
    report(result, dist, card)
    print(json.dumps({"card": card, "distribution": dist, "parts": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
