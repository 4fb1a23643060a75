#!/usr/bin/env python3
"""The int8 teacher's forward and the graphed OV step of one or more trees, on one card.

    python3 scripts/teacher_parts.py [TREE ...]

Each TREE is a checkout of this repository (default: the one this script lies
in); each runs in a process of its own, in the order given, so that two
commits are compared on one card in turns (parent, change, change, parent).
A tree's process builds its kernels into its own `ov3det_torch/_build/`, then
on the `chip_smoke.ov_config()` teacher (int8 RN50x4, seeded weights, built
and calibrated as the CLI builds it) and one OV batch (8 `SyntheticOVDataset`
canvases of 530 x 730, `chip_smoke.ov_boxes`: 128 boxes each, 4 chunks of 256
regions) prints:

  * the teacher's forward alone (CUDA events, best of 2 x 3 calls) and its
    peak device memory above its inputs and weights;
  * one profiled forward with the device ms of the ranges
    `RegionCLIPTeacher.forward` opens (normalise, stem conv1, trunk,
    roi_align, res5, attnpool; a tree without them prints "not measured");
  * `chip_smoke.graph_vs_eager` at OV width (3 graphed steps equal to the
    eager ones bit for bit, 5 of each timed, the graphed step's peak memory,
    one graphed step profiled: busy ms and kernel count).

Every line names the tree and the card.  Needs CUDA; without it each
process exits 2.
"""
import inspect
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANGES = ("normalise", "stem conv1", "trunk", "roi_align", "res5", "attnpool")


def one(tree: str) -> int:
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        print("teacher_parts: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    import chip_smoke as c
    from ov3det_torch import main as cli
    from ov3det_torch.ops.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    label = os.path.relpath(tree, HERE)
    card = c.card_line()
    _build.build()
    dev = torch.device("cuda")
    cfg = c.ov_config()
    batches = c.ov_batches(cfg, c.GRAPH_STEPS, 1700)
    teacher = cli.build_teacher(cfg, {k: v[0] for k, v in batches[0].items()}, dev)
    images, boxes = torch.from_numpy(batches[0]["image"]).to(dev), c.ov_boxes(dev)

    def forward():
        with torch.no_grad():
            return teacher(images, boxes)

    forward()
    torch.cuda.synchronize()
    ms = min(c.cuda_ms(forward, 3) for _ in range(2))
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    forward()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    print(f"[{label}] teacher forward alone, 8 canvases x 128 boxes: {ms:.3f} ms (CUDA events, "
          f"best of 2 x 3 calls); peak device memory {peak / 2**20:.1f} MiB above its inputs and "
          f"weights ({card})")
    # an older tree's profile prints no kernels under a range
    top = {"range_top": 6} if "range_top" in inspect.signature(c.profile).parameters else {}
    c.profile(f"[{label}] profiled teacher forward", forward, ranges=RANGES, **top)
    c.graph_vs_eager(card, dev, f"[{label}] ov_sunrgbd", cfg, batches, c.ov_step(),
                     teacher=teacher)
    return 0


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        return one(os.path.abspath(sys.argv[2]))
    rc = 0
    for tree in sys.argv[1:] or [HERE]:
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__), "--one", tree],
                             check=False).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
