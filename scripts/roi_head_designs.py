#!/usr/bin/env python3
"""Both designs of the teacher's two redesigned RoI-head kernels at one chunk's shapes, on one
NVIDIA GPU.

    python3 scripts/roi_head_designs.py

Builds `ov3det_torch/csrc/roi_align.cu` and `csrc/attn_pool.cu` (their ptxas
lines printed), then on seeded inputs at the shapes of one chunk of the
teacher's forward (256 regions: 8 images of 32 `calibration_boxes` on 530 x
730 canvases, the (8, 33, 45, 1280) bf16 res4 map; 81 res5 tokens and token
0, 40 heads, C 2560, bf16 tokens, u and z):

  * `roi_align`, the routed design (`roi_align_rows`) and the first
    (`_impl="first"`), equal to `roi_align_plain` bit for bit, on those boxes
    and on `chip_smoke.crafted_roi_boxes`, in bf16 and f32;
  * `pool_attend`, the routed design (`pool_attend_cluster`) and the first,
    within 1 bf16 ulp or 1e-5 of the largest value of `pool_attend_plain`
    (f32 tokens: 1e-5 of the largest value);
  * a second launch of each equal to the first bit for bit;
  * each design timed in turns (routed, first, first, routed) by replays of
    a CUDA graph of `chip_smoke.HEAD_REPS` calls, beside the bound of the
    chunk's bytes; `pool_attend` also as `check_head` times it, in turns
    with its plain version and SDPA; the clusters of `pool_attend` the card
    holds at once.

Seeded data, not a forward's: `chip_smoke.py`'s phase 10 (`check_head`)
gives the numbers on the teacher's own activations.  Prints one line per
check and a JSON object last.  Needs CUDA; without it exits 2.
"""
import json
import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
import chip_smoke as c  # noqa: E402

REGIONS, IMAGES, MAP = 256, 8, (33, 45, 1280)
TOKENS, HEADS, WIDTH = 81, 40, 2560


SCALE, P = 1 / 16, 18  # res4's stride, the pooler's resolution


def inputs(dev: torch.device) -> tuple:
    """Seeded inputs at one chunk's shapes: the ReLU'd (8, 33, 45, 1280) bf16
    map, (256, 4) f32 boxes (32 an image), x (256, 81, 2560), pos (82, 2560)
    and u (256, 40, 2560) in f32."""
    from ov3det_torch.models.regionclip import calibration_boxes

    rng = np.random.default_rng(21)
    H, W, C = MAP
    feat = torch.from_numpy(np.maximum(rng.normal(size=(IMAGES, H, W, C)), 0).astype(np.float32))
    boxes = np.concatenate([calibration_boxes(rng, 530.0, 730.0, n=REGIONS // IMAGES)[0]
                            for _ in range(IMAGES)])
    x = rng.normal(size=(REGIONS, TOKENS, WIDTH)).astype(np.float32)
    pos = rng.normal(size=(TOKENS + 1, WIDTH)).astype(np.float32) * 0.1
    u = rng.normal(size=(REGIONS, HEADS, WIDTH)).astype(np.float32) * 0.05
    return (feat.to(dev, torch.bfloat16), torch.from_numpy(boxes).to(dev),
            *(torch.from_numpy(a).to(dev) for a in (x, pos, u)))


def main() -> int:
    if not torch.cuda.is_available():
        print("roi_head_designs: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    from ov3det_torch.ops import roi_align as ra
    from ov3det_torch.ops.kernels import _build
    from ov3det_torch.ops.kernels import attn_pool as ap
    from ov3det_torch.ops.kernels import roi_align as kra

    card = c.card_line()
    for name, log in sorted(_build.build(("roi_align", "attn_pool")).items()):
        for line in c.ptxas_summary(log):
            print(f"{name}: {line}")
    dev = torch.device("cuda")
    feat, boxes, x, pos, u = inputs(dev)
    per_image = REGIONS // IMAGES
    crafted = c.crafted_roi_boxes(IMAGES, per_image, 530.0, 730.0, 22).to(dev)
    for label, bx in (("calibration boxes", boxes), ("crafted boxes", crafted)):
        for dtype in (torch.bfloat16, torch.float32):
            f = feat.to(dtype)
            want = ra.roi_align_plain(f, bx, None, SCALE, P, per_image=per_image)
            for impl in (None, "first"):
                got, again = (kra.roi_align(f, bx, None, SCALE, P, per_image=per_image, _impl=impl)
                              for _ in range(2))
                torch.cuda.synchronize()
                c.require(c.bits_equal(got, want) and c.bits_equal(got, again),
                          f"roi_align {label} {dtype} ({impl or 'routed'} design): differs from "
                          "roi_align_plain or from itself")
            print(f"roi_align {label} {dtype}: both designs equal roi_align_plain bit for bit on "
                  f"two launches ({int(torch.isnan(want).flatten(1).any(1).sum())} NaN regions)")

    hd = WIDTH // HEADS
    for dtype, od in ((torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
                      (torch.float32, torch.float32)):
        xd, pd, ud = x.to(dtype), pos.to(dtype), u.to(dtype)
        t0 = ap.pool_tokens(xd, pd[0])
        want = ap.pool_attend_plain(xd, pd, t0, ud, hd, od)
        big = want.float().abs().max().item()
        for impl in (None, "first"):
            got, again = (ap.pool_attend(xd, pd, t0, ud, hd, od, _impl=impl) for _ in range(2))
            torch.cuda.synchronize()
            label = f"pool_attend {dtype} -> {od} ({impl or 'routed'} design)"
            c.require(c.bits_equal(got, again), f"{label}: two launches differ")
            if dtype == torch.bfloat16 and od == torch.bfloat16:
                ulps = c.bf16_ulps(got, want, c.POOL_ATTEND_REL * big)
                c.require(ulps <= 1, f"{label}: {ulps} bf16 ulps from the plain version")
                err = f"{ulps:.2f} ulps (or {c.POOL_ATTEND_REL} of the largest value)"
            else:
                rel = ((got.float() - want.float()).abs().max() / big).item()
                c.require(rel <= c.POOL_ATTEND_REL, f"{label}: {rel} of the largest value")
                err = f"{rel:.2e} of the largest value"
            print(f"{label}: {err} from pool_attend_plain, two launches equal")

    xb, pb, ub = x.bfloat16(), pos.bfloat16(), u.bfloat16()
    t0 = ap.pool_tokens(xb, pb[0])
    impls = {"routed": None, "first": "first"}
    runs = {
        "roi_align": {k: (lambda i=i: kra.roi_align(feat, boxes, None, SCALE, P,
                                                    per_image=per_image, _impl=i))
                      for k, i in impls.items()},
        "pool_attend": {k: (lambda i=i: ap.pool_attend(xb, pb, t0, ub, hd, torch.bfloat16,
                                                       _impl=i))
                        for k, i in impls.items()},
    }
    # the bytes each must move: roi_align the map once and the pooled rows
    # once; pool_attend the tokens, positional rows, token 0 and u once, z once
    roi_bytes = feat.numel() * 2 + boxes.numel() * 4 + REGIONS * P * P * MAP[2] * 2
    pool_bytes = (xb.numel() + pb.numel() + t0.numel() + ub.numel() + REGIONS * HEADS * WIDTH) * 2
    bounds = {"roi_align": roi_bytes / c.HBM_BYTES_PER_S * 1e3,
              "pool_attend": pool_bytes / c.HBM_BYTES_PER_S * 1e3}
    result = {}
    for name, fns in runs.items():
        ms = {k: [] for k in impls}
        for k in ("routed", "first", "first", "routed"):
            ms[k].append(c.graph_ms(fns[k], c.HEAD_REPS))
        best = {k: min(v) for k, v in ms.items()}
        result[name] = dict(best, bound=bounds[name])
        print(f"{name}, one chunk (seeded data): routed {best['routed']:.4f} ms, first "
              f"{best['first']:.4f} ms, bound {bounds[name]:.4f} ms (bytes): routed at "
              f"{bounds[name] / best['routed']:.2f} of it (graph replays of {c.HEAD_REPS} calls, "
              f"in turns) ({card})")
    # as chip_smoke.check_head times it: in turns with the plain version and
    # SDPA on the concatenated tokens, each by graph replays
    tokens = torch.cat([t0[:, None], xb + pb[None, 1:]], dim=1)[:, None]
    beside = c.in_turns({
        "routed": runs["pool_attend"]["routed"],
        "first": runs["pool_attend"]["first"],
        "plain": lambda: ap.pool_attend_plain(xb, pb, t0, ub, hd, torch.bfloat16),
        "library": lambda: torch.nn.functional.scaled_dot_product_attention(
            ub[:, None], tokens, tokens, scale=hd ** -0.5)})
    result["pool_attend, beside the plain version and SDPA"] = beside
    print("pool_attend, one chunk, timed as check_head times it (in turns with the plain version "
          "and SDPA): " + ", ".join(f"{k} {v:.4f} ms" for k, v in beside.items()) + f" ({card})")
    held = ap.clusters_held(TOKENS + 1, HEADS, WIDTH)
    print(f"pool_attend's cluster: {held} clusters of {ap.CLUSTER} CTAs on the card at once, "
          f"{REGIONS} a call ({card})")
    print(json.dumps({"card": card, "one_chunk_ms": result, "clusters_held": held}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
