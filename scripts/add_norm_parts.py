#!/usr/bin/env python3
"""The training steps of one or more trees on one card: the transformer's
add & norm before and after its kernels, and the step's device time by
module class.

    python3 scripts/add_norm_parts.py [TREE ...]

Each TREE is a checkout of this repository (default: the one this script lies
in); each runs in a process of its own, in the order given, so that two
commits are compared on one card in turns (parent, change, change, parent).
A tree's process builds its kernels into its own `ov3det_torch/_build/`, then
prints, with that tree's `chip_smoke.py`:

  * for `sunrgbd_quick()` and the masked config (`chip_smoke.scannet_masked()`),
    `chip_smoke.train`: a warm-up and STEPS eager steps (each step's launches
    gated as that tree counts them), the synchronised stage split, the
    step's peak device memory and one profiled eager step;
  * one more eager step of each profiled by module class (LayerNorm with its
    add & norm, the GenericMLP's BatchNorm, ReLU and dropout, Dense,
    attention, the set abstraction, the transformer's dropout, the rest),
    with `profile_modules` of the `chip_smoke.py` beside this script, which
    reads no launch count and so runs on a tree of any slice;
  * `chip_smoke.graph_vs_eager` for both and for the OV step
    (`chip_smoke.ov_config()`, the int8 teacher built as the CLI builds it):
    graphed = eager bit for bit, the graphed and eager step times, the
    graphed step's peak memory, one graphed step profiled.

Every line names the tree and the card.  Needs CUDA; without it each process
exits 2.
"""
import importlib.util
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 3  # eager steps timed a config, after the warm-up
# the launches of one training step; a tree without a kernel has no counter
# for it, and `expect` drops the name
SA_STEP = dict(bn_stats=3, bn_relu_apply=3, bn_relu_grad_sums=3, bn_relu_grad_apply=3)
NORM_STEP = dict(add_norm=38, add_norm_grad=38)  # 3 encoder layers x 2, 8 decoder layers x 4
SUN_STEP = dict(fps=2, ball_group=1, attention_fwd=3, attention_dq=3, attention_dkv=3, auction=1)
MASKED_STEP = dict(fps=3, ball_group=2, slot_sources=1, feature_scatter=1, attention_fwd_radius=3,
                   attention_dq_radius=3, attention_dkv_radius=3, auction=1)


def attribution():
    """The `chip_smoke.py` beside this script, under a name of its own: its
    `attribution_step` profiles a step of any tree by module class."""
    spec = importlib.util.spec_from_file_location("add_norm_parts_smoke",
                                                  os.path.join(HERE, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def one(tree: str) -> int:
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        print("add_norm_parts: torch.cuda.is_available() is false", file=sys.stderr)
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
    sun_step = c.expect(**SUN_STEP, **SA_STEP, **NORM_STEP)
    masked_step = c.expect(**MASKED_STEP, **{k: 2 * v for k, v in SA_STEP.items()}, **NORM_STEP)
    print(f"[{label}] the add & norm kernels: {'add_norm' in c.kernel_counters()} ({card})")
    c.train(sun, STEPS, sun_step, f"[{label}] sunrgbd", 200, dev)
    c.train(masked, STEPS, masked_step, f"[{label}] scannet_masked", 400, dev)
    by_module = attribution()
    by_module.attribution_step(card, sun, f"[{label}] sunrgbd", 200, dev)
    by_module.attribution_step(card, masked, f"[{label}] scannet_masked", 400, dev)
    c.graph_vs_eager(card, dev, f"[{label}] sunrgbd", sun,
                     c.synthetic_batches(sun, c.GRAPH_STEPS, 1500), sun_step)
    c.graph_vs_eager(card, dev, f"[{label}] scannet_masked", masked,
                     c.synthetic_batches(masked, c.GRAPH_STEPS, 1600), masked_step)
    ov = c.ov_config()
    batches = c.ov_batches(ov, c.GRAPH_STEPS, 1700)
    teacher = cli.build_teacher(ov, {k: v[0] for k, v in batches[0].items()}, dev)
    c.graph_vs_eager(card, dev, f"[{label}] ov_sunrgbd", ov, batches,
                     c.expect(**{**{k: v for k, v in c.ov_step().items() if v}, **NORM_STEP}),
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
