"""The two sides of a run, built from one configuration file and one seed:
the program (the port, `ov3det_torch`) and the plain reference
(`ovbench/reference`), with the same weights and the same inputs.
"""
from __future__ import annotations

import numpy as np
import torch

from ovbench import weights
from ovbench.reference import detector as ref_detector
from ovbench.reference import teacher as ref_teacher
from ovbench.scenes import IMG_H, IMG_W


def step_seed(seed: int, step: int) -> int:
    """The dropout generator's seed of training step `step`, as the port's
    training loop seeds it: [seed, step] as one 64-bit integer."""
    return ((seed & 0xFFFFFFFF) << 32) | (step & 0xFFFFFFFF)


def detector_weights(cfg: dict, seed: int, device) -> dict:
    """The detector's state dict from the seed, on `device`."""
    layout = [(k, tuple(v.shape)) for k, v in ref_detector.Model3DETR(cfg["model"]).state_dict().items()]
    return weights.detector_state(layout, seed, device)


def teacher_hparams(cfg: dict) -> dict:
    t = cfg["teacher"]
    return dict(width=t["width"], layers=tuple(t["layers"]), embed_dim=t["embed_dim"],
                pooler_resolution=t["pooler_resolution"], image_resolution=t["image_resolution"],
                roi_chunk_regions=t["roi_chunk_regions"])


def teacher_weights(cfg: dict, seed: int, device) -> dict:
    t = cfg["teacher"]
    layout = weights.teacher_layout(t["width"], t["layers"], t["embed_dim"], t["image_resolution"])
    return weights.teacher_state(layout, seed, device)


def calibration(image: np.ndarray, seed: int) -> tuple:
    """The teacher's calibration input: one canvas of the traffic and eight
    boxes inside it drawn from the seed."""
    boxes = ref_teacher.calibration_boxes(np.random.default_rng(seed), float(IMG_H), float(IMG_W))
    return np.asarray(image, np.float32)[None], boxes


def program_teacher(cfg: dict, state: dict, calib: tuple, device):
    """The port's int8 teacher, quantised and calibrated by the port from
    the float state, as its training CLI builds it."""
    from ov3det_torch.models.regionclip import RegionCLIPTeacher, quantize_teacher_params

    t = cfg["teacher"]
    teacher = RegionCLIPTeacher(**teacher_hparams(cfg), compute_dtype=t["compute_dtype"],
                                device=device)
    return teacher.load(quantize_teacher_params(state, t["compute_dtype"], teacher=teacher,
                                                calib=calib))


def reference_teacher(cfg: dict, state: dict, calib: tuple, prec):
    return ref_teacher.build_teacher(state, teacher_hparams(cfg), *calib, prec)


def to_tensors(batch: dict, device) -> dict:
    """numpy batch -> tensors on `device`: floats f32, other integers int64,
    uint8 and bool as they are."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if t.is_floating_point():
            t = t.float()
        elif t.dtype not in (torch.bool, torch.uint8):
            t = t.long()
        out[k] = t.to(device)
    return out
