"""The plain reference against the port's CPU path at tiny sizes (the
port's plain kernels, float32): the forward, the criterion, the optimiser's
steps and the parse; and, on the card, every cell at its full width."""
import time

import numpy as np
import pytest
import torch

from ovbench import harness, run, sides
from ovbench.checks import tiny
from ovbench.reference import teacher as ref_teacher
from ovbench.reference.precision import FLOAT32

CPU = torch.device("cpu")


def execute(cell: str, seed: int = 12345, spec=None) -> dict:
    torch.set_num_threads(4)
    spec = spec or tiny.cell(cell)
    return run.execute(tiny.args(cell, seed), device=CPU, t0=time.perf_counter(), spec=spec,
                       cfg=tiny.config(spec["config"]))


@pytest.mark.parametrize("cell", ["ov_sunrgbd.detect", "scannet_masked.detect"])
def test_forward_and_parse(cell):
    got = execute(cell)["checked"]
    assert got["prob_gap"]["value"] <= 1e-5
    assert got["box_gap"]["value"] <= 1e-4
    assert got["parse_miss"]["value"] == 0


def test_train_step_masked():
    """The forward in training mode (its dropout masks drawn alike), the
    criterion, the backward and three clipped AdamW updates, through the
    masked encoder and the interim set abstraction, by every number the
    cell could compare."""
    got = execute("scannet_masked.train")["detail"]["numbers"]
    assert got["loss_gap"] <= 1e-5
    assert got["grad_gap"] <= 1e-4 and got["grad_median_gap"] <= 1e-5
    assert got["change_gap"] <= 1e-3 and got["change_median_gap"] <= 1e-5


def test_train_step_with_teacher():
    """The same with the int8 teacher, whose parts outside the convs the
    port keeps in bf16 and the reference in f32."""
    got = execute("ov_sunrgbd.train")["checked"]
    assert got["loss_gap"]["value"] <= 2e-3
    assert got["align_gap"]["value"] <= 2e-3
    assert got["feature_gap"]["value"] <= 2e-2
    assert got["grad_gap"]["value"] <= 2e-2
    assert got["change_gap"]["value"] <= 0.1


def test_teacher_features():
    """The reference teacher quantises and calibrates the float weights
    itself and agrees with the port's int8 teacher."""
    cfg = tiny.config("ov_sunrgbd")
    torch.manual_seed(0)
    rng = np.random.default_rng(3)
    images = rng.integers(0, 256, size=(2, 530, 730, 3), dtype=np.uint8)
    boxes = torch.tensor(ref_teacher.calibration_boxes(rng, 530.0, 730.0, 6)[0]).repeat(2, 1, 1)
    state = sides.teacher_weights(cfg, 7, CPU)
    calib = sides.calibration(images[0], 7)
    want = sides.reference_teacher(cfg, state, calib, FLOAT32)(torch.from_numpy(images), boxes)
    got = sides.program_teacher(cfg, state, calib, CPU)(torch.from_numpy(images), boxes)
    rel = float((got.float() - want).norm() / want.norm())
    assert rel <= 2e-2


@pytest.mark.card
@pytest.mark.parametrize("cell", ["ov_sunrgbd.train", "scannet_masked.train",
                                  "ov_sunrgbd.detect", "scannet_masked.detect"])
def test_full_width_on_the_card(card, cell):
    """A short run of each cell at its full width: its comparison passes."""
    spec = harness.workload(cell)
    res = run.execute(tiny.args(cell, 2147483947, seconds=2), device=card,
                      t0=time.perf_counter(), spec=spec)
    assert res["correct"], res["checked"]
