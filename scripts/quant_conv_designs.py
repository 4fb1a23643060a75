"""The trunk conv's two designs on the card, without the rest of chip_smoke.

Builds every kernel library, prints the trunk conv's ptxas lines
(registers, spills, shared memory) and its SASS counts, says so where a wgmma
kernel spills or ptxas serialised its `wgmma` (which chip_smoke.py fails
on; the checks here go on), checks both designs against
the plain version on a small ragged conv, then runs phase 10's kernel check
(`chip_smoke.check_quant_conv`: every distinct conv of an int8 RN50x4 teacher
forward on an OV batch, bit for bit, timed in turns with the first design,
`_int_mm` alone, the plain version and cuDNN bf16) and the teacher's forward
alone (`chip_smoke.teacher_forward_times`).

    python3 scripts/quant_conv_designs.py

About two minutes on one H100 with the build; exits 2 without a card.
"""
from __future__ import annotations

import os
import sys
import time

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def small_check(dev: torch.device) -> None:
    """A 3 x 3 conv of 15 rows, C_in 48, C_out 48 (ragged in M and N): the
    routed design and the first one equal the plain version bit for bit."""
    from ov3det_torch.ops.kernels import quant_conv as qc

    g = torch.Generator(device=dev).manual_seed(15)
    x = torch.randint(-127, 128, (1, 3, 5, 48), generator=g, device=dev, dtype=torch.int8)
    k = torch.randint(-127, 128, (48, 9 * 48), generator=g, device=dev, dtype=torch.int8)
    args = [x, k, 3, 1, torch.tensor(0.02, device=dev), torch.rand(48, generator=g, device=dev),
            torch.randn(48, generator=g, device=dev), None, True, torch.tensor(0.05, device=dev),
            True, torch.bfloat16]
    want = qc.quant_conv_plain(*args)
    for impl in (None, "mma"):
        got = qc.quant_conv(*args, _impl=impl)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise SystemExit(f"quant_conv 3x3 48->48 at 1x3x5: the {impl or 'wgmma'} design differs "
                             f"from the plain version")
    print("quant_conv 3x3 48->48 at 1x3x5: both designs equal to the plain version bit for bit")


def main() -> int:
    if not torch.cuda.is_available():
        print("quant_conv_designs: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke as c
    from ov3det_torch import main as cli
    from ov3det_torch.models.regionclip import RegionCLIPTeacher, init_teacher_state
    from ov3det_torch.ops.kernels import _build

    card = c.card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    logs = _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s for {sorted(logs) or 'cached libraries'}")
    log = logs.get("quant_conv", "")
    lines, advisories = c.ptxas_summary(log), c.wgmma_advisories(log)
    for line in lines + advisories:
        print(f"  quant_conv: {line}")
    spills = [line for line in lines
              if "_wgmma" in line and (", 0 B spilled" not in line or "stack frame" in line)]
    if spills or advisories:  # chip_smoke fails on these; here the checks and times go on
        print(f"quant_conv: NOT READY for chip_smoke: spills {spills}, advisories {advisories}")
    for line in c.sass_summary():
        if "quant_conv" in line:
            print(f"  {line}")

    dev = torch.device("cuda")
    small_check(dev)
    cfg = c.ov_config()
    batch = c.ov_batches(cfg, 1, 700)[0]
    first = {k: v[0] for k, v in batch.items()}
    teacher = cli.build_teacher(cfg, first, dev)
    images, regions = torch.from_numpy(batch["image"]).to(dev), c.ov_boxes(dev)
    c.check_quant_conv(card, teacher, images, regions, dev)
    state = init_teacher_state(RegionCLIPTeacher(device="cpu"), seed=0)
    c.teacher_forward_times(card, teacher, state, images, regions, dev)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
