#!/usr/bin/env python3
"""The training steps of one or more trees on one card: the set abstraction's
shared MLP before and after its kernels.

    python3 scripts/sa_mlp_parts.py [TREE ...]

Each TREE is a checkout of this repository (default: the one this script lies
in); each runs in a process of its own, in the order given, so that two
commits are compared on one card in turns (parent, change, change, parent).
A tree's process builds its kernels into its own `ov3det_torch/_build/`, then
prints, with that tree's `chip_smoke.py`:

  * for `sunrgbd_quick()` and the masked config (`chip_smoke.scannet_masked()`),
    `chip_smoke.train`: a warm-up and STEPS eager steps (each step's launches
    gated as that tree counts them), the synchronised stage split, the
    step's peak device memory and one profiled eager step with the device
    ms, kernel count and largest kernels of its ranges (forward, criterion,
    backward, optimizer);
  * `chip_smoke.graph_vs_eager` for both and for the OV step
    (`chip_smoke.ov_config()`, the int8 teacher built as the CLI builds it):
    graphed = eager bit for bit, the graphed and eager step times, the
    graphed step's peak memory, one graphed step profiled.

Every line names the tree and the card.  Needs CUDA; without it each process
exits 2.
"""
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 3  # eager steps timed a config, after the warm-up
# the shared MLP's launches of one SA module's training step (3 widths); a
# tree without the kernels has no such counter, and `expect` drops the names
SA_STEP = dict(bn_stats=3, bn_relu_apply=3, bn_relu_grad_sums=3, bn_relu_grad_apply=3)
SUN_STEP = dict(fps=2, ball_group=1, attention_fwd=3, attention_dq=3, attention_dkv=3, auction=1)
# the feature gradient's launches: the fused picks and map, then the sum;
# a tree from before the fused kernel, the pick pass and the scatter
FEATURE_GRAD = dict(sources_map=1, feature_sum=1)
FEATURE_GRAD_FIRST = dict(slot_sources=1, feature_scatter=1)
MASKED_STEP = dict(fps=3, ball_group=2, attention_fwd_radius=3,
                   attention_dq_radius=3, attention_dkv_radius=3, auction=1)


def one(tree: str) -> int:
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        print("sa_mlp_parts: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    import chip_smoke as c
    from ov3det_torch import main as cli
    from ov3det_torch.config import sunrgbd_quick
    from ov3det_torch.ops.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    label = os.path.relpath(tree, HERE)
    card = c.card_line()
    _build.build()
    dev = torch.device("cuda")
    sun, masked = sunrgbd_quick(), c.scannet_masked()
    sun_step = c.expect(**SUN_STEP, **SA_STEP)
    grad = FEATURE_GRAD if "sources_map" in c.kernel_counters() else FEATURE_GRAD_FIRST
    masked_step = c.expect(**MASKED_STEP, **grad, **{k: 2 * v for k, v in SA_STEP.items()})
    print(f"[{label}] the shared MLP's kernels: "
          f"{'bn_stats' in c.kernel_counters()} ({card})")
    c.train(sun, STEPS, sun_step, f"[{label}] sunrgbd", 200, dev)
    c.train(masked, STEPS, masked_step, f"[{label}] scannet_masked", 400, dev)
    c.graph_vs_eager(card, dev, f"[{label}] sunrgbd", sun,
                     c.synthetic_batches(sun, c.GRAPH_STEPS, 1500), sun_step)
    c.graph_vs_eager(card, dev, f"[{label}] scannet_masked", masked,
                     c.synthetic_batches(masked, c.GRAPH_STEPS, 1600), masked_step)
    ov = c.ov_config()
    batches = c.ov_batches(ov, c.GRAPH_STEPS, 1700)
    teacher = cli.build_teacher(ov, {k: v[0] for k, v in batches[0].items()}, dev)
    c.graph_vs_eager(card, dev, f"[{label}] ov_sunrgbd", ov, batches, c.ov_step(), teacher=teacher)
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
