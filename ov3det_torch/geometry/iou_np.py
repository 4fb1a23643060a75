"""Vectorized numpy rotated-box IoU for host-side evaluation.

A copy of `ov3det/geometry/iou_np.py:17-116`.  The VOC evaluation (greedy TP/FP matching) runs on the host over ragged
per-scan detection lists; the reference computes each det-gt IoU with a
python Sutherland–Hodgman + qhull ConvexHull call per pair
(reference utils/box_util.py:116-141 via utils/eval_det.py:57-59).  Here
the polygon clip is vectorized over all pairs at once in numpy — same
algorithm as the JAX package's `geometry/iou.py`, no per-pair python work.
"""
from __future__ import annotations

import numpy as np

_MAX_V = 8


def _clip_edge_np(poly, n, cp1, cp2):
    """poly: (P, V, 2); n: (P,); cp1/cp2: (P, 2). One half-plane clip."""
    P, V, _ = poly.shape
    idx = np.arange(V)[None, :]
    valid = idx < n[:, None]
    n_safe = np.maximum(n, 1)[:, None]
    prev_idx = np.mod(idx - 1 + n_safe, n_safe)
    s = np.take_along_axis(poly, prev_idx[:, :, None], axis=1)
    e = poly

    def side(p):
        return (cp2[:, None, 0] - cp1[:, None, 0]) * (p[..., 1] - cp1[:, None, 1]) - (
            cp2[:, None, 1] - cp1[:, None, 1]
        ) * (p[..., 0] - cp1[:, None, 0])

    inside_e = side(e) > 0
    inside_s = side(s) > 0

    dc = cp1 - cp2  # (P, 2)
    dp = s - e  # (P, V, 2)
    n1 = cp1[:, 0] * cp2[:, 1] - cp1[:, 1] * cp2[:, 0]  # (P,)
    n2 = s[..., 0] * e[..., 1] - s[..., 1] * e[..., 0]  # (P, V)
    den = dc[:, None, 0] * dp[..., 1] - dc[:, None, 1] * dp[..., 0]
    den = np.where(np.abs(den) < 1e-8, 1e-8, den)
    ix = (n1[:, None] * dp[..., 0] - n2 * dc[:, None, 0]) / den
    iy = (n1[:, None] * dp[..., 1] - n2 * dc[:, None, 1]) / den
    inter = np.stack([ix, iy], axis=-1)

    emit_inter = valid & (inside_e != inside_s)
    emit_e = valid & inside_e
    cand = np.stack([inter, e], axis=2).reshape(P, 2 * V, 2)
    flags = np.stack([emit_inter, emit_e], axis=2).reshape(P, 2 * V)

    keys = np.where(flags, np.arange(2 * V)[None, :], 2 * V)
    order = np.argsort(keys, axis=1, kind="stable")
    compacted = np.take_along_axis(cand, order[:, :V, None], axis=1)
    new_n = np.minimum(flags.sum(axis=1), V)
    return compacted, new_n


def _poly_area_np(poly, n):
    P, V, _ = poly.shape
    idx = np.arange(V)[None, :]
    valid = idx < n[:, None]
    nxt = np.where(idx + 1 < n[:, None], idx + 1, 0)
    x, y = poly[..., 0], poly[..., 1]
    xn = np.take_along_axis(x, nxt, axis=1)
    yn = np.take_along_axis(y, nxt, axis=1)
    cross = x * yn - y * xn
    return 0.5 * np.abs(np.where(valid, cross, 0.0).sum(axis=1))


def _quad_inter_area_np(subj, clip):
    """subj/clip: (P, 4, 2) ccw quads -> (P,) intersection areas."""
    P = subj.shape[0]
    poly = np.zeros((P, _MAX_V, 2), subj.dtype)
    poly[:, :4] = subj
    n = np.full(P, 4, np.int64)
    for k in range(4):
        poly, n = _clip_edge_np(poly, n, clip[:, (k - 1) % 4], clip[:, k])
    return _poly_area_np(poly, n)


def _vol_np(corners):
    a = np.linalg.norm(corners[..., 0, :] - corners[..., 1, :], axis=-1)
    b = np.linalg.norm(corners[..., 1, :] - corners[..., 2, :], axis=-1)
    c = np.linalg.norm(corners[..., 0, :] - corners[..., 4, :], axis=-1)
    return a * b * c


def box3d_iou_batch_np(corners1: np.ndarray, corners2: np.ndarray,
                       allow_native: bool = True) -> np.ndarray:
    """Pairwise exact rotated 3D IoU; corners (M, 8, 3) x (N, 8, 3) -> (M, N).

    Camera frame, up = -Y, same conventions as reference box3d_iou
    (utils/box_util.py:116-141).  Uses the C++ core (`ov3det_torch.native`)
    when a compiler is available; this vectorized numpy path is the fallback
    and the parity oracle.
    """
    M, N = corners1.shape[0], corners2.shape[0]
    if M == 0 or N == 0:
        return np.zeros((M, N), np.float64)
    if allow_native:
        from ov3det_torch.native import box3d_iou_batch_native

        out = box3d_iou_batch_native(corners1, corners2)
        if out is not None:
            return out
    rect1 = corners1[:, [3, 2, 1, 0]][:, :, [0, 2]]  # ccw BEV quads
    rect2 = corners2[:, [3, 2, 1, 0]][:, :, [0, 2]]
    r1 = np.broadcast_to(rect1[:, None], (M, N, 4, 2)).reshape(-1, 4, 2)
    r2 = np.broadcast_to(rect2[None, :], (M, N, 4, 2)).reshape(-1, 4, 2)
    inter_area = _quad_inter_area_np(r1, r2).reshape(M, N)

    ymax = np.minimum(corners1[:, None, 0, 1], corners2[None, :, 0, 1])
    ymin = np.maximum(corners1[:, None, 4, 1], corners2[None, :, 4, 1])
    inter_vol = inter_area * np.clip(ymax - ymin, 0.0, None)
    v1 = _vol_np(corners1)[:, None]
    v2 = _vol_np(corners2)[None, :]
    return inter_vol / np.clip(v1 + v2 - inter_vol, 1e-12, None)
