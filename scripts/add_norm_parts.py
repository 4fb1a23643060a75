#!/usr/bin/env python3
"""The training steps of one or more trees on one card: the transformer's
add & norm kernels, each signature of a step's norms, the step's device time
by module class, and the kernels with parts cut out or choices changed.

    python3 scripts/add_norm_parts.py [TREE ...]
    python3 scripts/add_norm_parts.py --norms [TREE ...]

Each TREE is a checkout of this repository (default: the one this script lies
in); each runs in a process of its own, in the order given, so that two
commits are compared on one card in turns (parent, change, change, parent).
A tree's process builds its kernels into its own `ov3det_torch/_build/`, then
prints, with that tree's `chip_smoke.py`:

  * for `sunrgbd_quick()` and the masked config (`chip_smoke.scannet_masked()`),
    the norms of one eager training step held and timed by that tree's
    `check_add_norm` (each signature's forward and backward ms by graphs of
    REPS calls in turns with its plain version and the library pair: the
    encoder's rows alone and with the add, the decoder's; a step's totals
    beside the bound); with --norms, this and nothing more a tree;
  * `chip_smoke.train`: a warm-up and STEPS eager steps (each step's launches
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

Then, in a process of its own on the tree this script lies in, variants of
`csrc/add_norm.cu` made from its text (each cut must match exactly once),
compiled with one macro each, all at once, into `ov3det_torch/_build/parts/`:
the kernels without programmatic dependent launch (the source launches each
with the programmatic stream-serialization attribute and waits for its
inputs with `griddepcontrol.wait`); the backward without its column sums
(each CTA returns after the grid barrier), without the barrier too (it
returns after its partial row), without the CTA's row too (it returns after
its rows), and both kernels as launches alone; choices changed: the forward
without the next row's loads in flight, on one wave of the CTAs its launch
bounds keep resident (the source's grid is up to 8 CTAs an SM, more than
stay resident), or at 4 CTAs an SM without the next row's loads;
the backward's grid with at least 2 or 4 rows a warp (`grad_blocks` with a
floor, the source's kernel).  For each kind of norm of a `sunrgbd_quick` and
a masked step (1 024, 2 048, 8 192 and 16 384 rows, with the dropout-add
and alone), in CUDA graphs of REPS calls, every variant in turns (in order,
then in the reverse order): each kernel alone and, with the attribute and
without, each behind a bf16 Dense of the step's width (what runs in front of
a norm in the step), and the Dense alone.

Every line names the tree and the card.  Needs CUDA; without it each process
exits 2.
"""
import importlib.util
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 3  # eager steps timed a config, after the warm-up
REPS = 20  # calls a timing graph of the variants and of every tree's norms
# the launches of one training step; a tree without a kernel has no counter
# for it, and `expect` drops the name
SA_STEP = dict(bn_stats=3, bn_relu_apply=3, bn_relu_grad_sums=3, bn_relu_grad_apply=3)
NORM_STEP = dict(add_norm=38, add_norm_grad=38)  # 3 encoder layers x 2, 8 decoder layers x 4
SUN_STEP = dict(fps=2, ball_group=1, attention_fwd=3, attention_dq=3, attention_dkv=3, auction=1)
# the feature gradient's launches: the fused picks and map, then the sum;
# a tree from before the fused kernel, the pick pass and the scatter
FEATURE_GRAD = dict(sources_map=1, feature_sum=1)
FEATURE_GRAD_FIRST = dict(slot_sources=1, feature_scatter=1)
MASKED_STEP = dict(fps=3, ball_group=2, attention_fwd_radius=3,
                   attention_dq_radius=3, attention_dkv_radius=3, auction=1)
# the variants' cuts of csrc/add_norm.cu: the launches without the
# programmatic stream-serialization attribute (NO_PDL: its flag 0); each
# kernel returning after its wait for its inputs (LAUNCH_ONLY); the
# backward's column sums left out (NO_SUMS: each CTA returns after the grid
# barrier), the barrier too (NO_BARRIER), and its CTA rows too
# (NO_CTA_ROWS); the forward without the next row's loads in flight
# (FWD_NO_AHEAD), on one wave of the CTAs its launch bounds keep resident
# (FWD_WAVE), at 4 CTAs an SM (FWD_CTAS4)
PDL_FLAG = "  a.val.programmaticStreamSerializationAllowed = 1;\n"
FWD_TOP = "  wait_for_inputs();\n  const int lane = threadIdx.x & 31;\n"
BWD_TOP = "  wait_for_inputs();\n  __shared__ __align__(16) float ws[kC ? kC : kMaxC];\n"
LAUNCH_ONLY = "#ifdef LAUNCH_ONLY\n  return;\n#endif\n"
CTA_ROW = "  // 1. the CTA's partial row"
BARRIER = "  // 2. every CTA's row written (a grid barrier)"
SUMS = "  const int blocks = static_cast<int>(gridDim.x);\n  const int per ="
KERNEL_END = "}\n\n// ------------------------------------------------------------------ launches"
KEEP_SUMS = "  if (pw[0][0] == 1234.5f && pb[0][0] == -1.f) out[0] = 0.f;\n"
AHEAD = "  if constexpr (kC != 0) {  // the next row's loads in flight during this row's work\n"
FWD_GRID = "  const int64_t most = static_cast<int64_t>(sms) * kFwdGridCtas;\n"
FWD_CTAS = "constexpr int kFwdCtasWide = 3;"
# variant -> (macros, the backward's rows a warp at least: its grid from
# `grad_blocks` with that floor, or None)
VARIANTS = {"source": ((), None),
            "without programmatic launch": (("NO_PDL",), None),
            "backward without the column sums": (("NO_SUMS",), None),
            "backward without the barrier": (("NO_BARRIER",), None),
            "backward without the CTA rows": (("NO_CTA_ROWS",), None),
            "the launches alone": (("LAUNCH_ONLY",), None),
            "forward without the next row's loads": (("FWD_NO_AHEAD",), None),
            "forward on one wave of resident CTAs": (("FWD_WAVE",), None),
            "forward at 4 CTAs an SM, without the next row's loads":
                (("FWD_CTAS4", "FWD_NO_AHEAD"), None),
            "backward with 2 rows a warp at least": ((), 2),
            "backward with 4 rows a warp at least": ((), 4)}
PAIRED = ("source", "without programmatic launch")  # also timed behind a Dense


def attribution():
    """The `chip_smoke.py` beside this script, under a name of its own: its
    `attribution_step` profiles a step of any tree by module class."""
    spec = importlib.util.spec_from_file_location("add_norm_parts_smoke",
                                                  os.path.join(HERE, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def one(tree: str, norms_only: bool = False) -> int:
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
    grad = FEATURE_GRAD if "sources_map" in c.kernel_counters() else FEATURE_GRAD_FIRST
    masked_step = c.expect(**MASKED_STEP, **grad, **{k: 2 * v for k, v in SA_STEP.items()},
                           **NORM_STEP)
    print(f"[{label}] the add & norm kernels: {'add_norm' in c.kernel_counters()} ({card})")
    c.NORM_REPS = REPS  # every tree's norms timed alike
    for cfg, name, seed in ((sun, "sunrgbd", 100), (masked, "scannet_masked", 300)):
        records = c.record_add_norm(cfg, c.synthetic_batches(cfg, 1, seed)[0], dev)
        c.check_add_norm(card, f"[{label}] {name}", records, timed=True)
        del records
    if norms_only:
        return 0
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


def variant_source() -> str:
    """csrc/add_norm.cu with the variants' macros (`VARIANTS`)."""
    from first_k_parts import cut, guard
    from ov3det_torch.ops.kernels import _build

    text = (_build.CSRC_DIR / "add_norm.cu").read_text()
    text = cut(text, PDL_FLAG, "#ifdef NO_PDL\n"
                               "  a.val.programmaticStreamSerializationAllowed = 0;\n"
                               f"#else\n{PDL_FLAG}#endif\n")
    text = cut(text, FWD_TOP, FWD_TOP + LAUNCH_ONLY)
    text = cut(text, BWD_TOP, BWD_TOP + LAUNCH_ONLY)
    text = cut(text, AHEAD, "#ifdef FWD_NO_AHEAD\n  if constexpr (false) {\n"
                            f"#else\n{AHEAD}#endif\n")
    text = cut(text, FWD_GRID, "#ifdef FWD_WAVE\n  const int64_t most = static_cast<int64_t>(sms) * "
                               "(kC ? kFwdCtasWide : kFwdCtasGeneric);\n"
                               f"#else\n{FWD_GRID}#endif\n")
    text = cut(text, FWD_CTAS, "#ifdef FWD_CTAS4\nconstexpr int kFwdCtasWide = 4;\n"
                               f"#else\n{FWD_CTAS}\n#endif")
    text = guard(text, SUMS, KERNEL_END, "NO_SUMS")
    text = guard(text, BARRIER, KERNEL_END, "NO_BARRIER")
    return guard(text, CTA_ROW, KERNEL_END, "NO_CTA_ROWS", KEEP_SUMS)


def kernel_parts() -> int:
    """The variants of `VARIANTS` on four norms of a step, in turns."""
    sys.path.insert(0, HERE)
    import ctypes

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("add_norm_parts: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    import chip_smoke as c
    from first_k_parts import build_variants
    from ov3det_torch.config import sunrgbd_quick
    from ov3det_torch.ops.kernels import _build
    from ov3det_torch.ops.kernels import add_norm as an
    from roi_head_parts import with_library

    torch.backends.cuda.matmul.allow_tf32 = False
    card = c.card_line()
    _build.build()
    dev = torch.device("cuda")
    errors = {"ov3_error_string": ([ctypes.c_int], ctypes.c_char_p)}
    macros = {v: m for v, (m, _) in VARIANTS.items() if v == "source" or m}
    libs = build_variants("add_norm", variant_source(), macros, {**an._SIGNATURES, **errors})
    plain_grid = an.grad_blocks

    def floored(least):
        def grid(rows, sms, C):
            per_blk = max(plain_grid(rows, sms, C)[1], least * an.WARPS)
            return -(-rows // per_blk), per_blk
        return grid

    picks = {}
    for cfg, seed in ((sunrgbd_quick(), 100), (c.scannet_masked(), 300)):
        for rec in c.record_add_norm(cfg, c.synthetic_batches(cfg, 1, seed)[0], dev):
            rows = rec["x"].numel() // rec["x"].shape[-1]
            key = f"{rows} rows, {'the dropout-add' if rec['branch'] is not None else 'alone'}"
            picks.setdefault(key, rec)
    g = torch.Generator(device=dev).manual_seed(26)
    for key, rec in sorted(picks.items()):
        x, br, keep, kp, eps = rec["x"], rec["branch"], rec["keep"], rec["keep_prob"], rec["eps"]
        w, b = rec["weight"], rec["bias"]
        C = x.shape[-1]
        a = torch.randn((x.numel() // C, C), generator=g, device=dev).bfloat16()
        dense = torch.randn((C, C), generator=g, device=dev).bfloat16() / C ** 0.5
        x_new, _, stats = an.add_norm(x, w, b, eps, br, keep, kp)
        h = x if br is None else x_new
        bdt = None if br is None else br.dtype

        def fwd():
            return an.add_norm(x, w, b, eps, br, keep, kp)

        def bwd():
            return an.add_norm_grad(h, rec["grad_y"], stats, w, x.dtype, rec.get("grad_res"), bdt,
                                    keep, kp)

        runs = {"add_norm": fwd, "add_norm_grad": bwd}
        pairs = {"Dense alone": lambda: F.linear(a, dense),
                 "Dense + add_norm": lambda: (F.linear(a, dense), fwd()),
                 "Dense + add_norm_grad": lambda: (F.linear(a, dense), bwd())}
        ms = {}
        for order in (list(VARIANTS), list(VARIANTS)[::-1]):
            for variant in order:
                least = VARIANTS[variant][1]
                both = ({"add_norm_grad": bwd} if least else
                        {**runs, **(pairs if variant in PAIRED else {})})
                an.grad_blocks = floored(least) if least else plain_grid
                for name, fn in both.items():
                    try:
                        t = with_library("add_norm", libs.get(variant, libs["source"]),
                                         lambda fn=fn: c.graph_ms(fn, REPS))
                    except RuntimeError as e:
                        print(f"add & norm parts ({key}) {variant} {name}: failed: {e} ({card})")
                        torch.cuda.synchronize()
                        t = float("nan")
                    ms.setdefault(variant, {}).setdefault(name, []).append(t)
                an.grad_blocks = plain_grid
        for variant, times in ms.items():
            print(f"add & norm parts ({key}, {rec['name']}) {variant}: " + ", ".join(
                f"{name} {min(t):.4f} ms ({', '.join(f'{v:.4f}' for v in t)})"
                for name, t in times.items()) +
                f" (graph replays of {REPS} calls, in turns; {card})")
    return 0


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] in ("--one", "--one-norms"):
        return one(os.path.abspath(sys.argv[2]), norms_only=sys.argv[1] == "--one-norms")
    if len(sys.argv) > 1 and sys.argv[1] == "--parts":
        return kernel_parts()
    norms = len(sys.argv) > 1 and sys.argv[1] == "--norms"
    rc = 0
    for tree in sys.argv[1 + norms:] or [HERE]:
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one-norms" if norms else "--one", tree], check=False).returncode
    if not norms:
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__), "--parts"],
                             check=False).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
