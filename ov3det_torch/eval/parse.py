"""Prediction parsing: empty-box removal + NMS on the device, ragged assembly
on the host.

Counterpart of `ov3det/eval/parse.py:30-151` (reference
utils/ap_calculator.py:39-238 with its default VoteNet eval config: drop
boxes holding fewer than 5 points, class-aware 3D NMS at IoU 0.25, per-class
proposals above confidence 0.05).
"""
from __future__ import annotations

import numpy as np
import torch

from ov3det_torch.geometry.boxes import flip_axis_to_depth
from ov3det_torch.geometry.nms import nms_3d_class_aware


def points_in_box_counts(points: torch.Tensor, corners: torch.Tensor) -> torch.Tensor:
    """points (B, N, 3) upright-depth; corners (B, K, 8, 3) camera coords.
    Returns (B, K) int64 counts of points inside each box (half-space test
    against the three edges at corner 0)."""
    box_depth = flip_axis_to_depth(corners)
    origin = box_depth[:, :, 0, :]
    edges = torch.stack([box_depth[:, :, j, :] - origin for j in (1, 3, 4)], dim=2)
    sq = (edges * edges).sum(dim=-1)  # (B, K, 3)
    rel = points[:, None, :, :] - origin[:, :, None, :]  # (B, K, N, 3)
    proj = torch.matmul(rel, edges.transpose(-1, -2))  # (B, K, N, 3)
    eps = 1e-6
    inside = ((proj >= -eps) & (proj <= sq[:, :, None, :] + eps)).all(dim=-1)
    return inside.sum(dim=-1)


def parse_predictions(box_corners, sem_cls_probs, objectness_probs, point_clouds,
                      nms_iou: float = 0.25, remove_empty_box: bool = True):
    """Device part of parse_predictions, default config: returns
    (pred_mask (B, K) bool, pred_sem_cls (B, K) int64).  `remove_empty_box`
    False (the train-time AP's approximate eval) keeps every box for NMS."""
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
    aabb = torch.cat([box_corners.amin(dim=2), box_corners.amax(dim=2)], dim=-1)
    keep = nms_3d_class_aware(aabb, objectness_probs, pred_sem_cls, nms_iou, nonempty)
    return keep, pred_sem_cls


def assemble_predictions(box_corners: np.ndarray, sem_cls_probs: np.ndarray,
                         objectness_probs: np.ndarray, pred_mask: np.ndarray,
                         conf_thresh: float = 0.05) -> list:
    """Host-side ragged assembly with per-class proposals (reference
    utils/ap_calculator.py:192-238): one `(classes (M,), corners (M, 8, 3),
    scores (M,))` triple per scene, entries class-major as in the reference
    loops."""
    B, K, C = sem_cls_probs.shape
    batch_pred = []
    for i in range(B):
        keep = (pred_mask[i] == 1) & (objectness_probs[i] > conf_thresh)
        idx = np.where(keep)[0]
        n = idx.shape[0]
        conf = sem_cls_probs[i, idx, :] * objectness_probs[i, idx, None]
        batch_pred.append((
            np.repeat(np.arange(C, dtype=np.int64), n),
            np.tile(box_corners[i, idx], (C, 1, 1)),
            conf.T.reshape(-1),
        ))
    return batch_pred
