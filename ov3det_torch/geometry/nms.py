"""Greedy non-maximum suppression over a batch, on the tensors' device.

Counterpart of `ov3det/geometry/nms.py`: the same pairwise AABB overlap
(IoU, or with `old_type` the legacy VoteNet intersection over the other
box's volume), the same descending-score greedy order (argmax, ties to the
lowest index, NaN first), the same suppression rule (overlap > threshold;
same class only in the class-aware variant), invalid boxes never kept.
Each function takes a batch, (B, K, ...) where JAX's takes one scene under
`vmap`, and returns the (B, K) bool keep mask.

CUDA tensors go to the hand-written kernel (`ops/kernels/nms.py`,
`csrc/nms.cu`: one launch for the batch); CPU tensors to the plain version,
`nms_plain`, JAX's K rounds written as torch ops.
"""
from __future__ import annotations

from typing import Optional

import torch

from ov3det_torch.ops.kernels.nms import _aabb_overlap_matrix, nms_keep, nms_plain  # noqa: F401


def _valid(scores: torch.Tensor, valid: Optional[torch.Tensor]) -> torch.Tensor:
    return torch.ones_like(scores, dtype=torch.bool) if valid is None else valid


def nms_3d(boxes, scores, threshold: float, valid=None, old_type: bool = False):
    """3D AABB NMS: boxes (B, K, 6) [xmin, ymin, zmin, xmax, ymax, zmax],
    scores (B, K) (reference utils/nms.py:79-117, nms_3d_faster)."""
    return nms_keep(boxes, scores, threshold, _valid(scores, valid), None, old_type)


def nms_3d_class_aware(boxes, scores, classes, threshold: float, valid=None,
                       old_type: bool = False):
    """Class-aware 3D NMS: only boxes of one class suppress each other;
    classes (B, K) int64 (reference utils/nms.py:120-162,
    nms_3d_faster_samecls)."""
    return nms_keep(boxes, scores, threshold, _valid(scores, valid), classes, old_type)


def nms_2d(boxes, scores, threshold: float, valid=None, old_type: bool = False):
    """2D AABB NMS: boxes (B, K, 4) [x1, y1, x2, y2] (reference
    utils/nms.py:43-76)."""
    return nms_keep(boxes, scores, threshold, _valid(scores, valid), None, old_type)
