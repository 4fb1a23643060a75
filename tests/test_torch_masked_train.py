"""Two training steps of a small masked ScanNet-like detector (3DETR-m:
the masked encoder, one angle bin, the GIoU loss with its gradient, the
matcher and loss weights of reference scripts/scannet_masked_ep1080.sh) on
the CPU, the port's `make_train_step` against the JAX package's from the
same weights.  The masked layers take the boolean-mask path on both sides
at these sizes, and the interim SA's feature gradient runs through the
ball-group's backward.  Tolerances as `tests/test_torch_train.py`'s
docstring sets them for the whole step.
"""
import dataclasses

import numpy as np
import pytest
import torch

from ov3det import config as jc
from ov3det_torch import config as tc
from tests import torch_parity as tp

LR = 5e-4


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    torch.set_num_threads(2)
    monkeypatch.setenv("OV3DET_BALLGROUP", "pallas")  # the TPU's ball-group, interpreted


def _masked_run(pkg):
    """scannet_quick with the run script's matcher and loss weights."""
    q = pkg.scannet_quick()
    return dataclasses.replace(q, loss=dataclasses.replace(
        q.loss, matcher=pkg.MatcherConfig(1.0, 0.0, 0.0, 2.0), giou_weight=1.0,
        no_object_weight=0.25))


def test_two_masked_training_steps_match_jax_make_train_step():
    jm, tm = tp.masked_configs("float32")
    jq, tq = _masked_run(jc), _masked_run(tc)
    assert np.all(tp.masked_batch(seed=0)["gt_angle_class_label"] == 0)
    tp.assert_two_steps_match(tp.masked_batch(seed=0), jq, tq, jm, tm, LR)
