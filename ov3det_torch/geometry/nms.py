"""Greedy class-aware 3D NMS over a batch, on the tensors' device.

Counterpart of `ov3det/geometry/nms.py:21-97`: the same pairwise AABB IoU,
the same descending-score greedy order (argmax, ties to the lowest index),
the same suppression rule (IoU > threshold, same class only).  The loop runs
K steps for the whole batch at once and returns a (B, K) bool keep mask.
"""
from __future__ import annotations

import torch

_NEG_INF = -1e30


def _aabb_iou_matrix(mins: torch.Tensor, maxs: torch.Tensor) -> torch.Tensor:
    """(B, K, 3) mins/maxs -> (B, K, K) pairwise IoU."""
    inter = torch.clamp(
        torch.minimum(maxs[:, :, None, :], maxs[:, None, :, :])
        - torch.maximum(mins[:, :, None, :], mins[:, None, :, :]),
        min=0.0,
    )
    inter_vol = inter[..., 0] * inter[..., 1] * inter[..., 2]
    ext = maxs - mins
    vol = ext[..., 0] * ext[..., 1] * ext[..., 2]
    union = vol[:, :, None] + vol[:, None, :] - inter_vol
    return inter_vol / torch.clamp(union, min=1e-12)


def nms_3d_class_aware(boxes, scores, classes, threshold: float, valid=None):
    """boxes (B, K, 6) [min xyz, max xyz]; scores (B, K); classes (B, K).

    Returns the (B, K) bool keep mask; invalid boxes are never kept.
    """
    B, K = scores.shape
    if valid is None:
        valid = torch.ones_like(scores, dtype=torch.bool)
    overlap = _aabb_iou_matrix(boxes[..., 0:3], boxes[..., 3:6])
    overlap = overlap * (classes[:, :, None] == classes[:, None, :])
    suppresses = overlap > threshold  # (B, K, K)
    rows = torch.arange(B, device=scores.device)
    keep = torch.zeros_like(valid)
    alive = valid.clone()
    neg = torch.full_like(scores, _NEG_INF)
    for _ in range(K):
        masked = torch.where(alive, scores, neg)
        i = torch.argmax(masked, dim=1)  # (B,)
        has = masked[rows, i] > _NEG_INF / 2
        keep[rows, i] |= has
        alive &= ~(suppresses[rows, i] & has[:, None])
        alive[rows, i] = False
    return keep
