"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card skipped, the rest of a run driven at tiny sizes
on the CPU, once for each fault a cell can have (one chip: no exchange
between chips to leave out)."""
import time

import numpy as np
import pytest
import torch

from ovbench import run
from ovbench.checks import tiny

CPU = torch.device("cpu")


def execute(cell: str) -> dict:
    torch.set_num_threads(4)
    spec = tiny.cell(cell)
    return run.execute(tiny.args(cell, 4242), device=CPU, t0=time.perf_counter(), spec=spec,
                       cfg=tiny.config(spec["config"]))


@pytest.mark.parametrize("cell", ["ov_sunrgbd.train", "scannet_masked.train"])
def test_step_returns_state_unchanged(cell, monkeypatch):
    import ov3det_torch.engine.train as train

    monkeypatch.setattr(train.AdamW, "apply", lambda self: torch.zeros(()))
    res = execute(cell)
    assert not res["correct"], res["checked"]
    assert res["detail"]["numbers"]["change_gap"] >= 1.0 - 1e-9


@pytest.mark.parametrize("cell", ["ov_sunrgbd.train", "scannet_masked.train"])
def test_half_the_batch_left_out(cell, monkeypatch):
    import ov3det_torch.engine.train as train

    unpack = train.unpack_batch

    def first_half(buf, metas, device=None):
        return {k: v[: v.shape[0] // 2] for k, v in unpack(buf, metas, device).items()}

    monkeypatch.setattr(train, "unpack_batch", first_half)
    res = execute(cell)
    assert not res["correct"], res["checked"]


@pytest.mark.parametrize("cell", ["ov_sunrgbd.detect", "scannet_masked.detect"])
def test_answer_altered(cell, monkeypatch):
    import ov3det_torch.engine.infer as infer

    assemble = infer.assemble_predictions

    def altered(*args, **kw):
        out = assemble(*args, **kw)
        for i, (cls, boxes, scores) in enumerate(out):
            if len(scores):
                out[i] = (cls, boxes, np.concatenate([scores[:1] * 0.5, scores[1:]]))
                break
        return out

    monkeypatch.setattr(infer, "assemble_predictions", altered)
    res = execute(cell)
    assert not res["correct"], res["checked"]
    assert res["checked"]["parse_miss"]["value"] > 0
