#!/usr/bin/env python3
"""Where the time of the tile ball-group goes, on one NVIDIA GPU.

    python3 scripts/ball_group_parts.py

Times `ball_group_tile<fill, TM>` and `ball_group_tile<sources, TM>`
(csrc/ball_group.cu) at the three forward shapes of the main paths, on the
points and centers those paths give them (seeded synthetic scenes, centers
by FPS): `sunrgbd_quick`'s pre-encoder (8 x 20 000 points, M 2048, K 64,
C 0), the masked config's (8 x 40 000, same) and its interim SA (8 x 2048
tokens, M 1024, K 32, C 256, r 0.4).  For each shape:
  * the forward and the pick pass as the source routes them, at every tile
    of centers (16, 32, 64: the source's kNarrowRows and kWideRows forced
    to it), and the first design;
  * the forward with parts taken out: the bucket loads after the first two
    stages (the tests then run on stale points), the distance tests (every
    slot takes its bucket's first point), the fill (one value a CTA is
    written), and both the loads and the tests (the fill alone); and with
    its choices changed: a warp tests one or eight centers at once (not
    kRowsAtOnce), a thread keeps one gather in flight in the fill (not
    kInFlight), a stage holds 512 points (one bucket at 20 000 points, a
    bucket in two chunks at 40 000) instead of kStagePoints, wide rows
    stored by the warps rather than gathered into shared memory and written
    by TMA bulk stores.
    These are designs of their own: each is checked against the plain
    version and timed at every tile of centers.  The cuts run at the
    route's tile.  For wide rows also the writes alone (no feature read):
    the floor of this write pattern.
A variant computes nothing meaningful; its time says what the part that is
left costs when it runs alone.  The variants are made here from the
source's text: each cut is a textual replacement that must match exactly
once, guarded by a macro, and every variant is the same file compiled with
other -D flags (one nvcc each, all at once) into `ov3det_torch/_build/parts/`.
Every output of the whole kernel is checked against the plain version
before it is timed.  Times are device times, from replays of a CUDA graph of
the calls (`chip_smoke.graph_ms`).  Prints one line per measurement and a
JSON object last.
"""
import ctypes
import json
import os
import re
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
import chip_smoke  # noqa: E402
from ov3det_torch.config import sunrgbd_quick  # noqa: E402
from ov3det_torch.ops.kernels import _build  # noqa: E402
from ov3det_torch.ops.kernels import ball_group as BG  # noqa: E402
from ov3det_torch.ops.kernels import fps  # noqa: E402

OUT_DIR = _build.BUILD_DIR / "parts"
ROWS = (16, 32, 64)
REPS = 10


def cut(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise RuntimeError(f"expected exactly one match of:\n{old}")
    return text.replace(old, new)


def variant_source() -> str:
    text = original = (_build.CSRC_DIR / "ball_group.cu").read_text()
    text = cut(text, "    if (t + 1 < a.tiles) {\n      const Tile next",
               "#ifdef NO_LOAD\n    if (t + 1 < 2 && t + 1 < a.tiles) {\n#else\n"
               "    if (t + 1 < a.tiles) {\n#endif\n      const Tile next")
    test = "                     in_ball<MODE>(cx[j], cy[j], cz[j], c2[j], x, y, z, x2, a.r2);\n"
    text = cut(text, test, "#ifdef NO_TEST\n                     true;\n#else\n" + test + "#endif\n")
    text = cut(text, "  if (bulk) {\n", "#ifdef WARP_STORES\n  if (false) {\n#else\n  if (bulk) {\n#endif\n")
    gather = "                         : __ldg(f + (col - 3));\n"
    text = cut(text, gather, "#ifdef NO_GATHER\n                         : 1.0f;\n#else\n" + gather
               + "#endif\n")
    for macro, name, value in CONSTANTS:  # the source's value stays in the innermost #else
        line = re.search(rf"constexpr int {name} = \d+;", original).group(0)
        # the forced value in brackets, so that it never reads as the source's line
        text = cut(text, line, f"#ifdef {macro}\nconstexpr int {name} = ({value});\n#else\n{line}\n"
                   "#endif\n")
    text = cut(text, "  __syncthreads();\n\n  if (MODE == kSources) {",
               "  __syncthreads();\n#ifdef NO_FILL\n  if (MODE == kFill) {\n"
               "    if (threadIdx.x == 0) a.out[blockIdx.y * gridDim.x + blockIdx.x] = pick[0];\n"
               "    return;\n  }\n#endif\n\n  if (MODE == kSources) {")
    return text


CONSTANTS = (  # macro, constant of the source, the value the macro gives it
    ("ONE_ROW", "kRowsAtOnce", 1),
    ("EIGHT_ROWS", "kRowsAtOnce", 8),
    ("ONE_IN_FLIGHT", "kInFlight", 1),
    ("SMALL_STAGE", "kStagePoints", 512),
) + tuple((f"ROWS{rows}", name, rows) for rows in ROWS for name in ("kNarrowRows", "kWideRows"))
CUTS = {  # name -> macros that take parts out; built at the route's tile
    "without the bucket loads": ("NO_LOAD",),
    "without the distance tests": ("NO_TEST",),
    "without the fill": ("NO_FILL",),
    "the fill alone (no loads, no tests)": ("NO_LOAD", "NO_TEST"),
    "wide rows: no feature read (the writes alone)": ("NO_GATHER",),
}
ABLATIONS = {  # name -> macros of a design of its own; built at every tile
    "whole": (),
    "one center a warp at a time": ("ONE_ROW",),
    "eight centers a warp at once": ("EIGHT_ROWS",),
    "one gather in flight a thread": ("ONE_IN_FLIGHT",),
    "stages of 512 points (one bucket or a chunk)": ("SMALL_STAGE",),
    "wide rows: warp stores, not TMA bulk stores": ("WARP_STORES",),
}
# (variant, tile of centers or None for the route) -> macros
LIBS = {("whole", None): (), **{(name, None): m for name, m in CUTS.items()},
        **{(name, rows): m + (f"ROWS{rows}",) for name, m in ABLATIONS.items() for rows in ROWS}}


def shapes(dev: torch.device) -> list:
    """(label, xyz, feats, centers, radius, K) of the three forward calls."""
    sun = chip_smoke.synthetic_batches(sunrgbd_quick(), 1, 100)[0]
    masked = chip_smoke.synthetic_batches(chip_smoke.scannet_masked(), 1, 300)[0]
    gather = lambda p, i: torch.gather(p, 1, i[..., None].expand(-1, -1, 3)).contiguous()  # noqa: E731
    out = []
    xyz = torch.from_numpy(sun["point_clouds"]).to(dev)
    out.append(("sunrgbd C=0", xyz, None, gather(xyz, fps.fps(xyz, 2048)), 0.2, 64))
    xyz = torch.from_numpy(masked["point_clouds"]).to(dev)
    pre = gather(xyz, fps.fps(xyz, 2048))
    out.append(("masked pre-encoder C=0", xyz, None, pre, 0.2, 64))
    feats = torch.randn(8, 2048, 256, generator=torch.Generator().manual_seed(2)).to(dev)
    out.append(("masked interim C=256", pre, feats, gather(pre, fps.fps(pre, 1024)), 0.4, 32))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("ball_group_parts: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    print(f"card: {chip_smoke.card_line()}")
    src = OUT_DIR / "ball_group_parts.cu"
    src.write_text(variant_source())
    jobs = {}
    for key, macros in LIBS.items():
        lib = OUT_DIR / f"ball_group-{'-'.join(macros) or 'whole'}.so"
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, *(f"-D{m}" for m in macros), "-o", str(lib),
               str(src)]
        jobs[key] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                           text=True))
    libs = {}
    for key, (path, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        lib = ctypes.CDLL(str(path))
        for fn, (argtypes, restype) in BG._SIGNATURES.items():
            getattr(lib, fn).argtypes, getattr(lib, fn).restype = argtypes, restype
        libs[key] = lib
    dev = torch.device("cuda")
    results = {}
    for label, xyz, feats, centers, radius, K in shapes(dev):
        B, N, _ = xyz.shape
        M, C = centers.shape[1], 0 if feats is None else feats.shape[-1]
        r2, inv_r = BG._f32(radius * radius), BG._f32(1.0 / radius)
        out = torch.empty(B, K, M, 3 + C, device=dev)
        src = torch.empty(B, K, M, dtype=torch.int32, device=dev)
        want = BG.ball_group_plain(xyz, feats, centers, radius, K)
        want_src = BG.slot_sources_plain(xyz, centers, radius, K)
        fptr = None if feats is None else feats.data_ptr()

        # each call launches on the current stream: a CUDA graph's while it is captured
        def fill(lib, what):
            status = lib.ov3_ball_group(xyz.data_ptr(), fptr, centers.data_ptr(), B, N, M, K, C, r2,
                                        inv_r, None, out.data_ptr(),
                                        torch.cuda.current_stream().cuda_stream)
            if status:
                raise RuntimeError(f"{label}, {what}: CUDA error {status}")

        def sources(lib, what):
            status = lib.ov3_ball_group_sources(xyz.data_ptr(), centers.data_ptr(), B, N, M, K, r2,
                                                src.data_ptr(), torch.cuda.current_stream().cuda_stream)
            if status:
                raise RuntimeError(f"{label}, sources, {what}: CUDA error {status}")

        def timed(fn):
            return min(chip_smoke.graph_ms(fn, REPS) for _ in range(2))

        row = {}
        for rows in (None, *ROWS):
            what = "the route" if rows is None else f"{rows} centers a CTA ({-(-M // rows) * B} CTAs)"
            lib = libs[("whole", rows)]
            fill(lib, what)
            sources(lib, what)
            torch.cuda.synchronize()
            if not (torch.equal(out, want) and torch.equal(src, want_src)):
                raise AssertionError(f"{label}, {what}: the tile kernels differ from the plain "
                                     "versions")
            key = "route" if rows is None else rows
            row[f"fill_{key}"] = timed(lambda: fill(lib, what))
            row[f"sources_{key}"] = timed(lambda: sources(lib, what))
            print(f"{label}: {what}: forward {row[f'fill_{key}']:.4f} ms, pick pass "
                  f"{row[f'sources_{key}']:.4f} ms")
        row["first"] = timed(lambda: BG.ball_group(xyz, feats, centers, radius, K, _impl="first"))
        print(f"{label}: first design {row['first']:.4f} ms")
        for (name, rows), lib in libs.items():
            if name == "whole":
                continue
            what = "the route" if rows is None else f"{rows} centers a CTA"
            if name in ABLATIONS:  # a design of its own must still be right
                fill(lib, what)
                torch.cuda.synchronize()
                if not torch.equal(out, want):
                    raise AssertionError(f"{label}, {name}, {what}: differs from the plain version")
            row[f"{name}, {'route' if rows is None else rows}"] = ms = timed(lambda: fill(lib, what))
            print(f"{label}: {what}, {name}: {ms:.4f} ms")
        results[label] = row
    print(json.dumps({"ms": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
