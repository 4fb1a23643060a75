"""The detector's parse as plain PyTorch: the empty-box test, class-aware
3D NMS and the host's assembly.

A frozen copy of `ov3det_torch/eval/parse.py` at its defaults (VoteNet's:
boxes holding fewer than 5 points dropped, class-aware 3D NMS at IoU 0.25,
every kept box proposed for every class above confidence 0.05), with the
plain versions of the box test and of NMS (`plain.points_in_box_plain`,
`plain.nms_plain`).
"""
from __future__ import annotations

import numpy as np
import torch

from .plain import nms_plain, points_in_box_plain


def parse_predictions(box_corners, sem_cls_probs, objectness_probs, point_clouds,
                      nms_iou: float = 0.25) -> tuple:
    """(keep (B, K) bool, pred_sem_cls (B, K) int64)."""
    B, K = objectness_probs.shape
    pred_sem_cls = torch.argmax(sem_cls_probs, dim=-1)
    nonempty = points_in_box_plain(point_clouds[..., :3].contiguous(), box_corners) >= 5
    none_left = ~nonempty.any(dim=1, keepdim=True)
    best = torch.argmax(objectness_probs, dim=1)
    nonempty = torch.where(none_left, torch.nn.functional.one_hot(best, K).bool(), nonempty)
    mins, maxs = box_corners.amin(dim=2), box_corners.amax(dim=2)
    keep = nms_plain(torch.cat([mins, maxs], dim=-1), objectness_probs, nms_iou, nonempty,
                     pred_sem_cls)
    return keep, pred_sem_cls


def assemble_predictions(box_corners: np.ndarray, sem_cls_probs: np.ndarray,
                         objectness_probs: np.ndarray, pred_mask: np.ndarray,
                         conf_thresh: float = 0.05) -> list:
    """One (classes (M,), corners (M, 8, 3), scores (M,)) triple a scene:
    each kept box above `conf_thresh` proposed for every class at class
    probability times objectness, class-major."""
    B, K, C = sem_cls_probs.shape
    out = []
    for i in range(B):
        idx = np.where((pred_mask[i] == 1) & (objectness_probs[i] > conf_thresh))[0]
        n = idx.shape[0]
        conf = sem_cls_probs[i, idx, :] * objectness_probs[i, idx, None]
        out.append((np.repeat(np.arange(C, dtype=np.int64), n),
                    np.tile(box_corners[i, idx], (C, 1, 1)), conf.T.reshape(-1)))
    return out
