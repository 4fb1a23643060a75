"""Prediction parsing: empty-box removal + NMS on the device, ragged assembly
on the host.

Counterpart of `ov3det/eval/parse.py:30-151` (reference
utils/ap_calculator.py:39-238) with every option of its AP config: the
default VoteNet one drops boxes holding fewer than 5 points, runs
class-aware 3D NMS at IoU 0.25 and proposes every kept box for every class
above confidence 0.05.
"""
from __future__ import annotations

import numpy as np
import torch

from ov3det_torch.geometry.nms import nms_2d, nms_3d, nms_3d_class_aware
from ov3det_torch.ops.kernels.points_in_box import points_in_box


def points_in_box_counts(points: torch.Tensor, corners: torch.Tensor) -> torch.Tensor:
    """points (B, N, 3) upright-depth; corners (B, K, 8, 3) camera coords.
    Returns (B, K) int32 counts of points inside each box (half-space test
    against the three edges at corner 0): one launch of the kernel for CUDA
    tensors, the plain version for CPU ones (`ops.kernels.points_in_box`)."""
    return points_in_box(points, corners)


def parse_predictions(box_corners, sem_cls_probs, objectness_probs, point_clouds,
                      nms_iou: float = 0.25, remove_empty_box: bool = True,
                      use_3d_nms: bool = True, cls_nms: bool = True, no_nms: bool = False):
    """Device part of parse_predictions (`ov3det/eval/parse.py:53-104`):
    returns (pred_mask (B, K) bool, pred_sem_cls (B, K) int64).  The
    default is VoteNet's: boxes holding fewer than 5 points dropped
    (`remove_empty_box` False, the train-time AP's approximate eval, keeps
    them all), then class-aware 3D NMS at `nms_iou`; `cls_nms` False is
    class-agnostic 3D NMS, `use_3d_nms` False 2D NMS on the bird's-eye
    boxes [xmin, zmin, xmax, zmax], `no_nms` returns the non-empty mask.
    Device ops only, no host wait: the graphed request captures it."""
    B, K = objectness_probs.shape
    pred_sem_cls = torch.argmax(sem_cls_probs, dim=-1)
    if remove_empty_box:
        nonempty = points_in_box_counts(point_clouds[..., :3], box_corners) >= 5
        # if every box is empty keep the highest-objectness one
        # (reference utils/ap_calculator.py:82-83)
        none_left = ~nonempty.any(dim=1, keepdim=True)
        best = torch.argmax(objectness_probs, dim=1)
        fallback = torch.nn.functional.one_hot(best, K).bool()
        nonempty = torch.where(none_left, fallback, nonempty)
    else:
        nonempty = torch.ones_like(objectness_probs, dtype=torch.bool)
    if no_nms:
        return nonempty, pred_sem_cls
    mins, maxs = box_corners.amin(dim=2), box_corners.amax(dim=2)
    if use_3d_nms:
        aabb = torch.cat([mins, maxs], dim=-1)
        if cls_nms:
            keep = nms_3d_class_aware(aabb, objectness_probs, pred_sem_cls, nms_iou, nonempty)
        else:
            keep = nms_3d(aabb, objectness_probs, nms_iou, nonempty)
    else:
        bev = torch.cat([mins[..., 0:1], mins[..., 2:3], maxs[..., 0:1], maxs[..., 2:3]], dim=-1)
        keep = nms_2d(bev, objectness_probs, nms_iou, nonempty)
    return keep, pred_sem_cls


def assemble_predictions(box_corners: np.ndarray, sem_cls_probs: np.ndarray,
                         objectness_probs: np.ndarray, pred_mask: np.ndarray,
                         pred_sem_cls: np.ndarray | None = None, conf_thresh: float = 0.05,
                         per_class_proposal: bool = True,
                         use_cls_confidence_only: bool = False) -> list:
    """Host-side ragged assembly (reference utils/ap_calculator.py:192-238,
    `ov3det/eval/parse.py:107-151`): one `(classes (M,), corners (M, 8, 3),
    scores (M,))` triple per scene of the boxes kept with objectness above
    `conf_thresh`.  With `per_class_proposal` every kept box is proposed
    for every class at score class prob x objectness, entries class-major
    as in the reference loops; otherwise once, as its `pred_sem_cls`, at
    its class probability (`use_cls_confidence_only`) or its objectness."""
    B, K, C = sem_cls_probs.shape
    if not per_class_proposal and pred_sem_cls is None:
        raise ValueError("per_class_proposal=False proposes each box as its pred_sem_cls: pass it")
    batch_pred = []
    for i in range(B):
        keep = (pred_mask[i] == 1) & (objectness_probs[i] > conf_thresh)
        idx = np.where(keep)[0]
        n = idx.shape[0]
        boxes_i = box_corners[i, idx]
        if per_class_proposal:
            conf = sem_cls_probs[i, idx, :] * objectness_probs[i, idx, None]
            batch_pred.append((
                np.repeat(np.arange(C, dtype=np.int64), n),
                np.tile(boxes_i, (C, 1, 1)),
                conf.T.reshape(-1),
            ))
            continue
        cls = pred_sem_cls[i, idx].astype(np.int64)
        scores = sem_cls_probs[i, idx, cls] if use_cls_confidence_only else objectness_probs[i, idx]
        batch_pred.append((cls, boxes_i, scores))
    return batch_pred
