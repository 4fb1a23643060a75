"""Axis-aligned 3D box utilities for the offline pseudo-label tools.

A copy of `ov3det/tools/box3d_np.py` (numpy only; the port never imports the JAX package).

Counterpart of reference 3DOVDet_tools/utils/box_3d_utils.py: AABB IoU in
both [min,max] ("vv") and [center,size] ("cs") layouts, the GSS-flavored
NMS with size/volume scoring and the `lhs` keep-extra option, and the
vv<->cs converters (pure functions here — the reference mutates in place).
"""
from __future__ import annotations

import numpy as np


def box_3d_iou(box_q: np.ndarray, box_k: np.ndarray, typ: str = "vv",
               eps: float = 1e-5) -> np.ndarray:
    """IoU of one box (6+,) against many (B, 6+)."""
    q = np.asarray(box_q, np.float64)[None, :6]
    k = np.asarray(box_k, np.float64)[:, :6]
    if typ == "cs":
        q = np.concatenate([q[:, :3] - q[:, 3:6] / 2, q[:, :3] + q[:, 3:6] / 2], 1)
        k = np.concatenate([k[:, :3] - k[:, 3:6] / 2, k[:, :3] + k[:, 3:6] / 2], 1)
    inter = np.prod(
        np.clip(np.minimum(q[:, 3:6], k[:, 3:6]) - np.maximum(q[:, :3], k[:, :3]), 0, None),
        -1,
    )
    vq = np.prod(q[:, 3:6] - q[:, :3], -1)
    vk = np.prod(k[:, 3:6] - k[:, :3], -1)
    return inter / (vq + vk - inter + eps)


def gss_nms(
    boxes: np.ndarray,
    overlap_threshold: float,
    old_type: bool = False,
    eps: float = 1e-8,
    use_size: bool = False,
    use_size_score: bool = False,
    class_wise: bool = False,
    size_typ: str | None = None,
    lhs: bool = False,
) -> np.ndarray:
    """Greedy NMS over rows [x1,y1,z1,x2,y2,z2,score,label(,volume,area)].

    Matches reference 3DOVDet_tools/utils/box_3d_utils.py:60-120 including
    the size-scored variants used after GSS proposal matching and the `lhs`
    option that additionally keeps half of each suppressed group.
    Returns the kept rows.
    """
    if boxes.shape[0] == 0:
        return boxes
    x1, y1, z1, x2, y2, z2 = (boxes[:, i] for i in range(6))
    score = boxes[:, 6].copy()
    label = boxes[:, 7]
    volume = (x2 - x1) * (y2 - y1) * (z2 - z1) + eps
    assert size_typ in (None, "Volume", "Area")
    if size_typ is not None:
        size = boxes[:, 8] if size_typ == "Volume" else boxes[:, 9]
        if use_size:
            score = size.copy()
        elif use_size_score:
            score = score * size

    order = np.argsort(score)
    pick = []
    while order.size:
        last = order.size
        i = order[-1]
        pick.append(i)
        rest = order[: last - 1]
        l = np.clip(np.minimum(x2[i], x2[rest]) - np.maximum(x1[i], x1[rest]), 0, None)
        w = np.clip(np.minimum(y2[i], y2[rest]) - np.maximum(y1[i], y1[rest]), 0, None)
        h = np.clip(np.minimum(z2[i], z2[rest]) - np.maximum(z1[i], z1[rest]), 0, None)
        inter = l * w * h
        o = inter / volume[rest] if old_type else inter / (volume[i] + volume[rest] - inter)
        if class_wise:
            o = o * (label[i] == label[rest])
        inds = np.where(o > overlap_threshold)[0]
        if lhs:
            for count in range(len(inds) // 2):
                pick.append(rest[inds[len(inds) - count - 1]])
        order = np.delete(order, np.concatenate(([last - 1], inds)))
    return boxes[np.array(pick, int)]


def vv2cs(box: np.ndarray) -> np.ndarray:
    """[min, max] -> [center, size] (columns 0:6); other columns pass through."""
    out = box.copy()
    out[:, 3:6] = box[:, 3:6] - box[:, :3]
    out[:, :3] = box[:, :3] + out[:, 3:6] / 2
    return out


def cs2vv(box: np.ndarray) -> np.ndarray:
    """[center, size] -> [min, max]."""
    out = box.copy()
    out[:, :3] = box[:, :3] - box[:, 3:6] / 2
    out[:, 3:6] = out[:, :3] + box[:, 3:6]
    return out
