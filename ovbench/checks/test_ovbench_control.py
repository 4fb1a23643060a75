"""The comparison that decides `correct` fails what it must: the control
(the reference one precision lower, in the program's place) and, for a
training cell, the fault "half of the batch left out"; at tiny sizes on
the CPU, against each cell's own limits."""
import importlib.util
import os
import time
from types import SimpleNamespace

import pytest
import torch

from ovbench import compare, harness
from ovbench.checks import tiny

CPU = torch.device("cpu")


def _calibrate():
    path = os.path.join(harness.HERE, "calibrate.py")
    spec = importlib.util.spec_from_file_location("ovbench_calibrate", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ctx(cell: str, seed: int):
    spec = tiny.cell(cell)
    return SimpleNamespace(cfg=tiny.config(spec["config"]), spec=spec, device=CPU, seed=seed,
                           seconds=0, trace=False, t0=time.perf_counter(), precision=None)


@pytest.mark.parametrize("cell", ["ov_sunrgbd.train", "scannet_masked.train",
                                  "ov_sunrgbd.detect", "scannet_masked.detect"])
def test_control_is_not_correct(cell):
    torch.set_num_threads(4)
    cal, ctx = _calibrate(), _ctx(cell, 31)
    numbers = (cal.detect_side(ctx) if ctx.spec["traffic"] == "detect"
               else cal.train_side(ctx, "control")[0])
    correct, rows = compare.verdict(numbers, harness.workload(cell)["limits"])
    assert not correct, rows


@pytest.mark.parametrize("cell", ["ov_sunrgbd.train", "scannet_masked.train"])
def test_half_batch_is_not_correct(cell):
    torch.set_num_threads(4)
    cal, ctx = _calibrate(), _ctx(cell, 37)
    numbers = cal.train_side(ctx, "half_batch")[0]
    correct, rows = compare.verdict(numbers, harness.workload(cell)["limits"])
    assert not correct, rows


def test_w4a4_teacher_fails_the_feature_gap():
    """The teacher one precision lower (W4A4) alone, on the float32
    reference's own boxes and canvases, fails `feature_gap` by itself."""
    torch.set_num_threads(4)
    numbers = _calibrate().train_side(_ctx("ov_sunrgbd.train", 41), "control")[0]
    assert numbers["feature_gap"] > harness.workload("ov_sunrgbd.train")["limits"]["feature_gap"]


def test_feature_gap_of_boxes_not_the_batch():
    """Region features for fewer canvases than the batch holds read inf."""
    f = torch.ones(2, 3, 4)
    assert compare.feature_gap([(None, f)], [None]) == float("inf")
    assert compare.feature_gap([(None, f[:1])], [f]) == float("inf")
    assert compare.feature_gap([(None, f * 1.01)], [f]) == pytest.approx(0.01)
