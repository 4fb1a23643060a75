#!/usr/bin/env python3
"""Where the time of the ball-group's feature gradient goes, on one NVIDIA
GPU.

    python3 scripts/feature_grad_parts.py
    python3 scripts/feature_grad_parts.py --parent TREE

At the masked training step's shape (the interim SA: 8 scenes x 2048
points, 1024 centers, K 32, C 256), on the inputs of the feature gradient
of one eager masked training step (recorded from `BallGroup.backward`),
times the launches of `ov3det_torch/csrc/feature_grad.cu`:

  * the fused picks and map `feature_sources_map` (a cluster of CTAs a
    scene), whole and with parts taken out: the picks (each slot takes a
    point of a fixed pattern, no distance is tested), the exchange (an empty
    slot takes its own CTA's first hit, no DSMEM read), the counts, the
    column prefix over the histogram's rows, the sums over the cluster, the
    two block scans, the places added to the histogram, the placement, all
    of it (the launch alone); and with its choices changed: the sums over
    the cluster as every CTA reading every CTA's counts of its own points
    (in place of each CTA summing a slice of the points for every CTA),
    2 or 8 distance tests before a thread looks for a hit (kPickTests), 4,
    16 or 32 histogram rows (kHistRows), a cluster of 4, 12 or 16 CTAs a
    scene (above 8 a size the card need not schedule: as many clusters as
    fit run at once);
  * the scatter on any sources: the inverse map `feature_map` and the sum
    `feature_sum<CW, RB>` (a warp an item of CW channels, RB rows staged at
    a time), both, each alone, the map without its counts or placement, the
    sum without its row loads (the work records, the list and the adds are
    left), both with their bodies gone; the sum with its choices changed
    (CW, RB);
  * beside them the plain scatter (`_scatter`: the accumulating
    `index_put_`) and `index_add_`.

The counts and the placement are one function of both maps (`sort_slots`):
a cut there cuts both.  A variant with a part taken out computes nothing
meaningful; its time says what the rest costs.  The variants are made here
from the source in the checkout: each cut is a textual replacement that
must match exactly once, guarded by a macro, and every variant is the same
file compiled with other -D flags (one nvcc each, all at once) into
`ov3det_torch/_build/parts/`.  Each variant that computes the whole result
is checked against the plain versions (the sources, list and work records;
the gradient bit for bit) before anything is timed.  Every variant is timed
twice in turns (in order, then in reverse), the smaller kept.

With --parent TREE (a checkout of the parent commit, e.g. unpacked by `git
archive` under `_checkout/`, which `.gitignore` lists): the parent's
`csrc/ball_group.cu` and `csrc/feature_grad.cu` are compiled as they are
into `ov3det_torch/_build/parts/parent-*.so` and, on the same recorded
inputs, in TURNS turns (the parent first in odd turns, this tree first in
even ones), timed: the parent's pick pass (`ball_group_tile<sources, 32>`)
and its `feature_map` against this tree's `sources_map`, and the parent's
whole gradient (the pick pass, `feature_map`, `feature_sum`) against this
tree's (`sources_map`, `feature_sum`); both gradients equal bit for bit.

Every line names the card.  Prints a JSON object last.  Needs CUDA; without
it exits 2.
"""
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
from ov3det_torch.ops.kernels import _build  # noqa: E402
from ov3det_torch.ops.kernels import ball_group as BG  # noqa: E402

OUT_DIR = _build.BUILD_DIR / "parts"
REPS = 10  # calls a timing graph
TURNS = 4  # turns of the parent's tree against this one
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


LAUNCH_ONLY = "#ifdef LAUNCH_ONLY\n  return;\n#endif\n"
ALL_READ = """  for (int k = k0; k < k1; k += 2) {  // two points' loads from every CTA at once
    const bool two = k + 1 < k1;
    int t0[kMapCluster], t1[kMapCluster];
#pragma unroll
    for (int cc = 0; cc < kMapCluster; ++cc) {
      const int* r = cluster.map_shared_rank(tot, cc);
      t0[cc] = r[k];
      t1[cc] = two ? r[k + 1] : 0;
    }
    int b0 = 0, n0 = 0, b1 = 0, n1 = 0;
#pragma unroll
    for (int cc = 0; cc < kMapCluster; ++cc) {
      b0 += cc < c ? t0[cc] : 0;
      b1 += cc < c ? t1[cc] : 0;
      n0 += t0[cc];
      n1 += t1[cc];
    }
    all[k] = n0;
    ahead[k] = b0;
    if (two) {
      all[k + 1] = n1;
      ahead[k + 1] = b1;
    }
  }
"""


def source() -> str:
    text = (_build.CSRC_DIR / "feature_grad.cu").read_text()
    text = guard(text, "  // counts of each warp's segment", "  // this CTA's count of each point",
                 "NO_COUNT", "  __syncthreads();\n")
    text = guard(text, "  // the placement:", "}\n\n// A cluster of kMapCluster CTAs a scene", "NO_PLACE")
    # the sort's middle: the column prefix, the cluster's sums, the block
    # scans, the places
    # (what a cut leaves is zeroed, so that every place stays inside the list)
    text = guard(text, "  for (int q = q0; q < q1; ++q) {\n    unsigned lo_run",
                 "  cluster.sync();  // every CTA's counts", "NO_PREFIX",
                 "  for (int k = k0; k < k1; ++k) tot[k] = 0;\n")
    text = guard(text, "  for (int k = c * N / kMapCluster + tid;",
                 "  cluster.sync();  // every CTA's `all` and `ahead` in place", "NO_SUMS",
                 "  for (int k = k0; k < k1; ++k) all[k] = ahead[k] = 0;\n")
    # the sums as every CTA reading every CTA's counts of its own points
    text = guard(text, "#ifdef NO_SUMS\n", "  cluster.sync();  // every CTA's `all` and `ahead` in place",
                 "ALL_READ", ALL_READ)
    text = guard(text, "  int total;\n  const int first = block_scan", "  int heavy = 0, run = first;",
                 "NO_SCANS", "  int total = 0, first = 0;\n")
    text = guard(text, "  int nheavy;\n  int hrun = block_scan", "  if (c == 0) {\n    // the work records",
                 "NO_SCANS", "  int nheavy = 0, hrun = 0;\n")
    text = guard(text, "  for (int q = q0; q < q1; ++q) {\n    const int ka", "#ifdef NO_SCANS\n  int nheavy",
                 "NO_PLACES")
    # a cluster of FG_CLUSTER CTAs a scene (more than 8: a size the card need not schedule)
    text = cut(text, "constexpr int kMapCluster = 8;",
               "#ifndef FG_CLUSTER\n#define FG_CLUSTER 8\n#endif\nconstexpr int kMapCluster = FG_CLUSTER;")
    text = cut(text, "  cudaLaunchConfig_t cfg = {};\n",
               "#if FG_CLUSTER > 8\n"
               "  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);\n"
               "  if (e != cudaSuccess) return e;\n#endif\n  cudaLaunchConfig_t cfg = {};\n")
    text = guard(text, "  const int p1 = min((k0 + nk) * Nb, N);\n",
                 "  __syncthreads();\n\n  // ---- 2. the effective sources", "NO_PICKS",
                 "  for (int l = tid; l < nloc; l += T) pick[l] = (l % M * 2 + l / M) % N;\n")
    text = guard(text, "      int v[kMapCluster];\n", "      for (int g = 0; g < nk; ++g) {\n"
                 "        int p = pick[g * M + m];", "NO_EXCHANGE", "      const int eff = pub[m];\n")
    text = cut(text, "constexpr int kPickTests = 4;",
               "#ifndef PICK_TESTS\n#define PICK_TESTS 4\n#endif\nconstexpr int kPickTests = PICK_TESTS;")
    text = cut(text, "constexpr int kHistRows = 8;",
               "#ifndef HIST_ROWS\n#define HIST_ROWS 8\n#endif\nconstexpr int kHistRows = HIST_ROWS;")
    for head in ("list,\n                int4* __restrict__ work) {\n",  # feature_map
                 "list,\n                        int4* __restrict__ work) {\n",  # feature_sources_map
                 "  constexpr int V = CW / 32;  // values a lane a row\n"):  # feature_sum
        text = cut(text, head, head + LAUNCH_ONLY)
    return cut(text, "          if (c * 32 < lim) cp_async4(&buf[j][c * 32 + lane], p + c * 32);\n",
               "#ifdef NO_ROWS\n"
               "          if (c * 32 < lim) buf[j][c * 32 + lane] = __int_as_float(slot);\n#else\n"
               "          if (c * 32 < lim) cp_async4(&buf[j][c * 32 + lane], p + c * 32);\n"
               "#endif\n")


VARIANTS = {  # name -> (macros, the entry timed: "scatter" = feature_map and the sum)
    "fused": ((), "fused"),
    "fused without the picks": (("NO_PICKS",), "fused"),
    "fused without the exchange": (("NO_EXCHANGE",), "fused"),
    "fused without the counts": (("NO_COUNT",), "fused"),
    "fused without the placement": (("NO_PLACE",), "fused"),
    "fused without the column prefix": (("NO_PREFIX",), "fused"),
    "fused without the cluster sums": (("NO_SUMS",), "fused"),
    "fused without the block scans": (("NO_SCANS",), "fused"),
    "fused, every CTA reading every CTA's counts of its own points": (("ALL_READ",), "fused"),
    "fused without the places": (("NO_PLACES",), "fused"),
    "fused, the launch alone": (("LAUNCH_ONLY",), "fused"),
    **{f"fused at {n} tests before a look": ((f"PICK_TESTS={n}",), "fused") for n in (2, 8)},
    **{f"fused with {n} histogram rows": ((f"HIST_ROWS={n}",), "fused") for n in (4, 16, 32)},
    **{f"fused on a cluster of {n}": ((f"FG_CLUSTER={n}",), "fused") for n in (4, 12, 16)},
    "fused and the sum": ((), "gradient"),
    "scatter": ((), "scatter"),
    "map alone": ((), "map"),
    "sum alone": ((), "sum"),
    "map without its counts": (("NO_COUNT",), "map"),
    "map without its placement": (("NO_PLACE",), "map"),
    "sum without its row loads": (("NO_ROWS",), "sum"),
    "scatter, the launches alone": (("LAUNCH_ONLY",), "scatter"),
    **{f"scatter, the sum at CW {cw}, RB {rb}": ((f"FG_CW={cw}", f"FG_RB={rb}"), "scatter")
       for cw, rb in ((32, 16), (64, 8), (128, 4))},
}
CUT = ("NO_PICKS", "NO_EXCHANGE", "NO_COUNT", "NO_PLACE", "NO_ROWS", "LAUNCH_ONLY", "NO_PREFIX",
       "NO_SUMS", "NO_SCANS", "NO_PLACES")


def compile_all(jobs: dict) -> dict:
    """{key: (source path, library path, macros)} -> {key: loaded library},
    one nvcc each, all at once."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for key, (src, lib, macros) in jobs.items():
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, f"-I{src.parent}",
               *(f"-D{m}" for m in macros), "-o", str(lib), str(src)]
        procs[key] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True)
    out = {}
    for key, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        handle = ctypes.CDLL(str(jobs[key][1]))
        for fn, (argtypes, restype) in {**BG._SCATTER_SIGNATURES, **BG._SIGNATURES}.items():
            if hasattr(handle, fn):
                getattr(handle, fn).argtypes = argtypes
                getattr(handle, fn).restype = restype
        out[key] = handle
    return out


def build() -> dict:
    """variant -> the loaded library, every set of macros compiled at once."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    src = OUT_DIR / "feature_grad-parts.cu"
    src.write_text(source())
    jobs = {}
    for macros in sorted({m for m, _ in VARIANTS.values()}):
        tag = "-".join(m.replace("=", "") for m in macros) or "whole"
        jobs[macros] = (src, OUT_DIR / f"feature_grad-{tag}.so", macros)
    libs = compile_all(jobs)
    return {name: libs[macros] for name, (macros, _) in VARIANTS.items()}


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


def check(status: int, what: str) -> None:
    if status != 0:
        raise RuntimeError(f"feature_grad parts: {what} failed: CUDA error {status}")


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


class Buffers:
    """The outputs of one variant's call: sources, list, work records and
    gradient, on the inputs' device."""

    def __init__(self, B: int, N: int, M: int, dev):
        self.src = torch.empty((B, K, M), dtype=torch.int32, device=dev)
        self.list = torch.empty((B, K * M), dtype=torch.int32, device=dev)
        self.work = torch.empty((B, N, 4), dtype=torch.int32, device=dev)
        self.out = torch.empty((B, N, C), dtype=torch.float32, device=dev)


def parts(xyz, centers, grad, reps: int = REPS) -> dict:
    """{variant: ms} on the recorded inputs, each timed twice in turns (the
    smaller kept), with "plain (index_put_)" and "index_add_"."""
    libs = build()
    B, N, _ = xyz.shape
    M = centers.shape[1]
    KM = K * M
    dev = xyz.device
    r2 = BG._f32(RADIUS * RADIUS)
    want_src, want_list, want_work = BG.sources_map_plain(xyz, centers, RADIUS, K)
    count = (want_work[..., 2] - want_work[..., 1]).sum(1)
    named = torch.arange(KM, device=dev)[None] < count[:, None]
    want = BG._scatter(want_src, grad, N, C)
    main, spare = Buffers(B, N, M, dev), Buffers(B, N, M, dev)

    def call(lib, entry: str, buf: Buffers):
        if entry in ("fused", "gradient"):
            check(lib.ov3_sources_map(xyz.data_ptr(), centers.data_ptr(), B, N, M, K, r2,
                                      buf.src.data_ptr(), buf.list.data_ptr(), buf.work.data_ptr(),
                                      stream()), entry)
        if entry == "map":
            check(lib.ov3_feature_map(want_src.data_ptr(), B, N, KM, buf.list.data_ptr(),
                                      buf.work.data_ptr(), stream()), entry)
        if entry in ("sum", "gradient"):  # the sum reads the whole map's output
            check(lib.ov3_feature_sum(grad.data_ptr(), B, N, KM, C, main.list.data_ptr(),
                                      main.work.data_ptr(), buf.out.data_ptr(), stream()), entry)
        if entry == "scatter":
            check(lib.ov3_feature_scatter(want_src.data_ptr(), grad.data_ptr(), B, N, KM, C,
                                          buf.list.data_ptr(), buf.work.data_ptr(),
                                          buf.out.data_ptr(), stream()), entry)

    for name, (macros, entry) in VARIANTS.items():
        if any(m in CUT for m in macros) or entry not in ("fused", "gradient", "scatter"):
            continue
        for b in (main.src, main.list, main.work):
            b.fill_(-7)
        main.out.fill_(float("nan"))
        call(libs[name], entry, main)
        torch.cuda.synchronize()
        if entry in ("fused", "gradient"):
            ok = (torch.equal(main.src, want_src) and torch.equal(main.work, want_work)
                  and torch.equal(main.list[named], want_list[named]))
            if not ok:
                raise AssertionError(f"feature_grad parts: {name} differs from sources_map_plain")
        if entry in ("gradient", "scatter") and not torch.equal(main.out, want):
            raise AssertionError(f"feature_grad parts: {name} differs from _scatter")
    call(libs["fused"], "fused", main)  # the sum's variants read this map
    offset = N * torch.arange(B, device=dev)[:, None, None]
    rows = torch.where(want_src >= 0, want_src.long() + offset, B * N).reshape(-1)
    feats = grad[..., 3:].reshape(-1, C)
    atomics = torch.zeros(B * N + 1, C, dtype=torch.float32, device=dev)
    timed = {name: (lambda lib=libs[name], entry=entry, cut_=any(m in CUT for m in macros):
                    call(lib, entry, spare if cut_ or entry != "gradient" else main))
             for name, (macros, entry) in VARIANTS.items()}
    timed["plain (index_put_)"] = lambda: BG._scatter(want_src, grad, N, C)
    timed["index_add_"] = lambda: atomics.index_add_(0, rows, feats)
    ms = {name: [] for name in timed}
    for order in (list(timed), list(timed)[::-1]):
        for name in order:
            ms[name].append(graph_ms(timed[name], reps))
    return {name: min(v) for name, v in ms.items()}


def report(result: dict, dist: dict, card: str) -> None:
    fused = result["fused"]
    print(f"feature_grad slots a point: max {dist['max']}, mean {dist['mean']:.2f}, p99 "
          f"{dist['p99']:.1f}, named by no slot {dist['unnamed']:.4f}")
    print("feature_grad parts: " + ", ".join(f"{n} {v:.4f} ms" for n, v in result.items()))
    print(f"feature_grad parts, so: the fused kernel {fused:.4f} ms, its picks "
          f"{fused - result['fused without the picks']:.4f}, exchange "
          f"{fused - result['fused without the exchange']:.4f}, counts "
          f"{fused - result['fused without the counts']:.4f}, placement "
          f"{fused - result['fused without the placement']:.4f}, column prefix "
          f"{fused - result['fused without the column prefix']:.4f}, cluster sums "
          f"{fused - result['fused without the cluster sums']:.4f}, block scans "
          f"{fused - result['fused without the block scans']:.4f}, places "
          f"{fused - result['fused without the places']:.4f}, the launch alone "
          f"{result['fused, the launch alone']:.4f}; feature_map {result['map alone']:.4f} ms, its "
          f"counts {result['map alone'] - result['map without its counts']:.4f}, placement "
          f"{result['map alone'] - result['map without its placement']:.4f}; the sum's row loads "
          f"{result['sum alone'] - result['sum without its row loads']:.4f} ms ({card})")


def record_inputs(seed: int = 400) -> tuple:
    """(xyz, centers, cotangent) of the feature gradient of one eager masked
    training step (after a warm-up step), on a seeded synthetic batch."""
    import chip_smoke as c
    from ov3det_torch.engine.train import batch_to_device, build_training

    dev = torch.device("cuda")
    cfg = c.scannet_masked()
    training = build_training(cfg, c.ITERS_PER_EPOCH, device=dev, seed=0)
    gen = torch.Generator(device=dev).manual_seed(0)
    batch = batch_to_device(c.synthetic_batches(cfg, 1, seed)[0], dev)
    training.train_step(batch, gen)  # warm-up
    seen, grad_of = [], BG.feature_grad

    def spy(xyz, centers, radius, nsample, grad_out, num_channels):
        seen.append((xyz.clone(), centers.clone(), radius, nsample, grad_out.clone(), num_channels))
        return grad_of(xyz, centers, radius, nsample, grad_out, num_channels)

    BG.feature_grad = spy
    try:
        training.train_step(batch, gen)
    finally:
        BG.feature_grad = grad_of
    torch.cuda.synchronize()
    if len(seen) != 1 or seen[0][2:4] != (RADIUS, K) or seen[0][5] != C:
        raise AssertionError(f"feature_grad parts: expected one interim SA gradient, got "
                             f"{[s[2:4] + s[5:] for s in seen]}")
    xyz, centers, _, _, grad, _ = seen[0]
    del training
    torch.cuda.empty_cache()
    return xyz, centers, grad.contiguous()


def against_parent(tree: str, xyz, centers, grad, card: str) -> dict:
    """The parent's pick pass and map, and its whole gradient, against this
    tree's, in TURNS turns on the same inputs."""
    csrc = Path(tree).resolve() / "ov3det_torch" / "csrc"
    jobs = {name: (csrc / f"{name}.cu", OUT_DIR / f"parent-{name}.so", ())
            for name in ("ball_group", "feature_grad")}
    parent = compile_all(jobs)
    B, N, _ = xyz.shape
    M = centers.shape[1]
    KM, dev, r2 = K * M, xyz.device, BG._f32(RADIUS * RADIUS)
    src = torch.empty((B, K, M), dtype=torch.int32, device=dev)
    lst = torch.empty((B, KM), dtype=torch.int32, device=dev)
    work = torch.empty((B, N, 4), dtype=torch.int32, device=dev)
    out = torch.empty((B, N, C), dtype=torch.float32, device=dev)

    def parent_picks_and_map():
        check(parent["ball_group"].ov3_ball_group_sources(
            xyz.data_ptr(), centers.data_ptr(), B, N, M, K, r2, src.data_ptr(), stream()), "parent")
        check(parent["feature_grad"].ov3_feature_map(src.data_ptr(), B, N, KM, lst.data_ptr(),
                                                     work.data_ptr(), stream()), "parent")

    def parent_gradient():
        parent_picks_and_map()
        check(parent["feature_grad"].ov3_feature_sum(grad.data_ptr(), B, N, KM, C, lst.data_ptr(),
                                                     work.data_ptr(), out.data_ptr(), stream()),
              "parent")

    parent_gradient()
    mine = BG.feature_grad(xyz, centers, RADIUS, K, grad, C)
    torch.cuda.synchronize()
    if not torch.equal(out, mine):
        raise AssertionError("feature_grad parts: the parent's gradient and this tree's differ")
    pairs = {"picks and map": (parent_picks_and_map, lambda: BG.sources_map(xyz, centers, RADIUS, K)),
             "gradient": (parent_gradient, lambda: BG.feature_grad(xyz, centers, RADIUS, K, grad, C))}
    turns = {f"{who} {what}": [] for what in pairs for who in ("parent", "tree")}
    for turn in range(TURNS):
        for what, (old, new) in pairs.items():
            order = (("parent", old), ("tree", new)) if turn % 2 == 0 else (("tree", new),
                                                                            ("parent", old))
            for who, fn in order:
                turns[f"{who} {what}"].append(graph_ms(fn, REPS))
    for what in pairs:
        new, old = turns[f"tree {what}"], turns[f"parent {what}"]
        wins = sum(a < b for a, b in zip(new, old))
        print(f"feature_grad against the parent, {what} (graph replays of {REPS} calls, in turns): "
              f"this tree {', '.join(f'{v:.4f}' for v in new)} ms, the parent "
              f"{', '.join(f'{v:.4f}' for v in old)} ms; this tree faster in {wins} of {TURNS} "
              f"turns ({card})")
    return turns


def main() -> int:
    if not torch.cuda.is_available():
        print("feature_grad_parts: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    card = res.stdout.strip().splitlines()[0]
    print(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build()
    xyz, centers, grad = record_inputs()
    N = xyz.shape[1]
    result = {"card": card}
    if len(sys.argv) > 2 and sys.argv[1] == "--parent":
        result["against_parent"] = against_parent(sys.argv[2], xyz, centers, grad, card)
    src = BG.slot_sources_plain(xyz, centers, RADIUS, K)
    result["distribution"] = distribution(src, N)
    result["parts"] = parts(xyz, centers, grad)
    report(result["parts"], result["distribution"], card)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
