#!/usr/bin/env python3
"""Where the time of the RoI head's two routed kernels goes, on one NVIDIA GPU.

    python3 scripts/roi_head_parts.py

Times `pool_attend_cluster` (`ov3det_torch/csrc/attn_pool.cu`) and
`roi_align_rows` (`csrc/roi_align.cu`) on the seeded inputs of one chunk
(`scripts/roi_head_designs.py`: 256 regions; 82 tokens, 40 heads, C 2560
in bf16; the (8, 33, 45, 1280) bf16 map, 18 x 18 outputs) as they are and
with parts taken out:

  * the cluster: without pass 1 (the partial logits' products), without the
    exchange (the cluster barriers, the DSMEM sums, the softmax and the
    rows pushed to the other CTAs: a block barrier in their place), without pass 2 (z's
    products), the loads and the rebuild alone (all three out: z written
    from zeros), the launch alone;
  * RoIAlign: without its stores (kept only on a value it never takes),
    without the map's loads (each pixel a value made from its offset), the
    launch alone.

A variant computes nothing meaningful; its time says what the part left
costs, the difference to the whole what the part taken out costs.  The
variants are made from the kernels' text in the checkout with the helpers of
`scripts/first_k_parts.py` (each cut must match exactly once), one nvcc
each, all at once, into `ov3det_torch/_build/parts/`, and called through the
wrappers with the variant's library in place of the built one.  The whole
kernels are checked against the plain versions first.  Prints one line a
kernel and a JSON object last.  Needs CUDA; without it exits 2.
"""
import json
import os
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "scripts"))
import chip_smoke as c  # noqa: E402
import roi_head_designs as designs  # noqa: E402
from first_k_parts import build_variants, cut, guard, kernel_source  # noqa: E402

CLUSTER_HEAD = ("template <typename OutT>\n__global__ void __launch_bounds__(kThreads, 2) "
                "pool_attend_cluster(")
ROWS_HEAD = ("template <typename T>\n__global__ void __launch_bounds__(kMaxOutput * kGroups, 4) "
             "roi_align_rows(")
CLUSTER_VARIANTS = {
    "whole": (),
    "without pass 1": ("NO_PASS1",),
    "without the exchange": ("NO_EXCHANGE",),
    "without pass 2": ("NO_PASS2",),
    "loads and rebuild alone": ("NO_PASS1", "NO_EXCHANGE", "NO_PASS2"),
    "the launch alone": ("LAUNCH_ONLY",),
}
ROWS_VARIANTS = {
    "whole": (),
    "without the stores": ("NO_STORE",),
    "without the map's loads": ("NO_LOADS",),
    "the launch alone": ("LAUNCH_ONLY",),
}


def cluster_cuts(k: str) -> str:
    k = cut(k, "  using bf16 = __nv_bfloat16;\n",
            "  using bf16 = __nv_bfloat16;\n#ifdef LAUNCH_ONLY\n  return;\n#endif\n")
    k = guard(k, "  for (int ks = k_begin; ks < k_end; ++ks) {", "  for (int round = 0; round < 2;",
              "NO_PASS1")
    k = guard(k, "  cluster_sync();  // every CTA's partials are written",
              "  // 4. pass 2", "NO_EXCHANGE", "  __syncthreads();\n")
    return guard(k, "  for (int ks = 0; ks < Lp; ks += 16) {",
                 "  __syncthreads();  // every warp is done with the tokens", "NO_PASS2")


def rows_cuts(k: str) -> str:
    k = cut(k, "  constexpr int kWords = ring_words<T>();\n",
            "  constexpr int kWords = ring_words<T>();\n#ifdef LAUNCH_ONLY\n  return;\n#endif\n")
    k = cut(k, "    if (valid) store8x(",
            "#ifdef NO_STORE\n    if (valid && acc[0] == 1234.5f) store8x(\n#else\n"
            "    if (valid) store8x(\n#endif\n")
    return cut(k, "          load8(src + xoff[kx], v);\n",
               "#ifdef NO_LOADS\n#pragma unroll\n          for (int e = 0; e < 8; ++e) "
               "v[e] = __int_as_float(xoff[kx] + e);\n#else\n"
               "          load8(src + xoff[kx], v);\n#endif\n")


def with_library(name: str, lib, fn):
    """fn() with `lib` in place of the built `csrc/<name>.cu` library."""
    from ov3det_torch.ops.kernels import _build

    saved = _build._loaded.get(name)
    _build._loaded[name] = lib
    try:
        return fn()
    finally:
        if saved is None:
            _build._loaded.pop(name, None)
        else:
            _build._loaded[name] = saved


def timed(name: str, libs: dict, fn) -> dict:
    """{variant: ms}, each timed twice in turns, the smaller kept."""
    ms = {v: [] for v in libs}
    for order in (list(libs), list(libs)[::-1]):
        for v in order:
            ms[v].append(with_library(name, libs[v], lambda v=v: c.graph_ms(fn, c.HEAD_REPS)))
    return {v: min(t) for v, t in ms.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("roi_head_parts: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    import ctypes

    from ov3det_torch.ops import roi_align as ra
    from ov3det_torch.ops.kernels import attn_pool as ap
    from ov3det_torch.ops.kernels import roi_align as kra

    card = c.card_line()
    dev = torch.device("cuda")
    errors = {"ov3_error_string": ([ctypes.c_int], ctypes.c_char_p)}
    pool_libs = build_variants("attn_pool", kernel_source("attn_pool", CLUSTER_HEAD, cluster_cuts),
                               CLUSTER_VARIANTS, {**ap._SIGNATURES, **errors})
    rows_libs = build_variants("roi_align", kernel_source("roi_align", ROWS_HEAD, rows_cuts),
                               ROWS_VARIANTS, {**kra._SIGNATURES, **errors})
    feat, boxes, x, pos, u = designs.inputs(dev)
    per_image = designs.REGIONS // designs.IMAGES
    xb, pb, ub = x.bfloat16(), pos.bfloat16(), u.bfloat16()
    t0 = ap.pool_tokens(xb, pb[0])
    hd = designs.WIDTH // designs.HEADS

    def attend():
        return ap.pool_attend(xb, pb, t0, ub, hd, torch.bfloat16)

    def align():
        return kra.roi_align(feat, boxes, None, designs.SCALE, designs.P, per_image=per_image)

    z = with_library("attn_pool", pool_libs["whole"], attend)
    want = ap.pool_attend_plain(xb, pb, t0, ub, hd, torch.bfloat16)
    big = want.float().abs().max().item()
    c.require(c.bf16_ulps(z, want, c.POOL_ATTEND_REL * big) <= 1,
              "roi_head_parts: the whole cluster differs from pool_attend_plain")
    pooled = with_library("roi_align", rows_libs["whole"], align)
    c.require(c.bits_equal(pooled, ra.roi_align_plain(feat, boxes, None, designs.SCALE, designs.P,
                                                      per_image=per_image)),
              "roi_head_parts: the whole roi_align_rows differs from roi_align_plain")
    result = {"pool_attend_cluster": timed("attn_pool", pool_libs, attend),
              "roi_align_rows": timed("roi_align", rows_libs, align)}
    for kernel, ms in result.items():
        print(f"{kernel} parts, one chunk (seeded data; graph replays of {c.HEAD_REPS} calls, in "
              f"turns): " + ", ".join(f"{v} {t:.4f} ms" for v, t in ms.items()) + f" ({card})")
    print(json.dumps({"card": card, "one_chunk_ms": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
