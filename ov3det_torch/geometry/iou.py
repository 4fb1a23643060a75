"""Generalized 3D IoU of box corner sets, rotated or axis-aligned, in torch.

Counterpart of `ov3det/geometry/iou.py:137-369` (the training step's part):
the rotated BEV intersection is the Green's-theorem form
(`_rect_intersection_area_batched`): each rectangle's edges are clipped to
the other rectangle by Liang-Barsky slabs and the shoelace sum of the
surviving sub-segments telescopes into the intersection area.  No vertex
buffers, no sorting; every step is an elementwise tensor op over the pair
batch.  Conventions follow the reference: camera-frame corners (up is -Y),
the BEV rectangle is corners [3, 2, 1, 0] projected to (x, z), counter-
clockwise; height spans corner-0 y (top) to corner-4 y (bottom).

The Sutherland-Hodgman clip and `box3d_iou_corners` belong to the eval/AP
slice and are not here.
"""
from __future__ import annotations

import torch

from ov3det_torch.geometry.boxes import box_volume_from_corners

_EPS = 1e-8
_BIG = 1e9
# An edge whose projection moves less than this across a slab is parallel to
# it; sized for f32 rounding of the dot products (iou.py:186-197).
PAR_EPS = 1e-5


def _cross2(a, b):
    return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]


def _slab_interval(p0k, dk, hi):
    """Entry/exit parameters of segments p0k + t dk against the slab [0, hi],
    and the flags of boundary-collinear parallel edges (on the lower / upper
    boundary).  p0k, dk (P, 4); hi (P,)."""
    parallel = dk.abs() < PAR_EPS
    safe = torch.where(parallel, torch.full_like(dk, PAR_EPS), dk)
    t1 = (0.0 - p0k) / safe
    t2 = (hi[:, None] - p0k) / safe
    tmin = torch.minimum(t1, t2)
    tmax = torch.maximum(t1, t2)
    par_in = (p0k >= -PAR_EPS) & (p0k <= hi[:, None] + PAR_EPS)
    big = torch.full_like(tmin, _BIG)
    tmin = torch.where(parallel, torch.where(par_in, -big, big), tmin)
    tmax = torch.where(parallel, torch.where(par_in, big, -big), tmax)
    on_lo = parallel & (p0k.abs() <= PAR_EPS)
    on_hi = parallel & ((p0k - hi[:, None]).abs() <= PAR_EPS)
    return tmin, tmax, on_lo, on_hi


def _edge_clip_cross_sum(subject, rect, dedup: bool = False):
    """sum over subject edges of cross(q0, q1) for the part of each edge
    inside `rect` (Liang-Barsky in rect's local frame).  subject (P, 4, 2) a
    ccw quad, rect (P, 4, 2) a ccw rectangle -> (P,).  With dedup, edges
    lying on rect's boundary in the same direction as rect's own edge are
    subtracted, so that across the two symmetric calls (dedup on one) a
    shared face segment counts once (iou.py:154-174)."""
    c0 = rect[:, 0, :]
    U = rect[:, 1, :] - c0
    V = rect[:, 3, :] - c0
    lu = torch.sqrt((U * U).sum(-1))
    lv = torch.sqrt((V * V).sum(-1))
    u = U / torch.clamp(lu, min=_EPS)[:, None]
    v = V / torch.clamp(lv, min=_EPS)[:, None]

    p0 = subject
    p1 = torch.roll(subject, -1, dims=1)
    d = p1 - p0

    def loc(p, axis):
        return ((p - c0[:, None, :]) * axis[:, None, :]).sum(-1)

    pu0 = loc(p0, u)
    pv0 = loc(p0, v)
    amin, amax, au_lo, au_hi = _slab_interval(pu0, loc(p1, u) - pu0, lu)
    bmin, bmax, bv_lo, bv_hi = _slab_interval(pv0, loc(p1, v) - pv0, lv)
    t0 = torch.clamp(torch.maximum(amin, bmin), 0.0, 1.0)
    t1 = torch.clamp(torch.minimum(amax, bmax), 0.0, 1.0)
    live = t1 > t0

    q0 = p0 + t0[..., None] * d
    q1 = p0 + t1[..., None] * d
    cross = _cross2(q0, q1)
    zero = torch.zeros_like(cross)
    total = torch.where(live, cross, zero).sum(1)
    if dedup:
        cdu = d[..., 0] * u[:, None, 1] - d[..., 1] * u[:, None, 0]
        cdv = d[..., 0] * v[:, None, 1] - d[..., 1] * v[:, None, 0]
        dup = (au_lo & (cdu > 0)) | (au_hi & (cdu < 0)) | (bv_lo & (cdv > 0)) | (bv_hi & (cdv < 0))
        total = total - torch.where(live & dup, cross, zero).sum(1)
    return total


def _rect_area(r):
    return _cross2(r[:, 1, :] - r[:, 0, :], r[:, 3, :] - r[:, 0, :]).abs()


def rect_intersection_area(rect1, rect2):
    """Exact intersection areas of P pairs of ccw rectangles, (P, 4, 2) x 2
    -> (P,), capped at the smaller area (iou.py:237-276)."""
    center = 0.125 * (rect1.sum(1) + rect2.sum(1))
    r1 = rect1 - center[:, None, :]
    r2 = rect2 - center[:, None, :]
    s = _edge_clip_cross_sum(r1, r2, dedup=True) + _edge_clip_cross_sum(r2, r1)
    return torch.minimum(0.5 * s.abs(), torch.minimum(_rect_area(r1), _rect_area(r2)))


def rotated_bev_intersection_area(rect1, rect2):
    """Pairwise BEV intersection areas: rect1 (..., K1, 4, 2), rect2
    (..., K2, 4, 2), ccw -> (..., K1, K2)."""
    batch = rect1.shape[:-3]
    K1, K2 = rect1.shape[-3], rect2.shape[-3]
    r1 = rect1[..., :, None, :, :].expand(*batch, K1, K2, 4, 2).reshape(-1, 4, 2)
    r2 = rect2[..., None, :, :, :].expand(*batch, K1, K2, 4, 2).reshape(-1, 4, 2)
    return rect_intersection_area(r1, r2).reshape(*batch, K1, K2)


def bev_rect(corners):
    """Camera-frame corners (..., 8, 3) -> ccw BEV rectangle (..., 4, 2) in
    (x, z) (reference utils/box_util.py:549-554)."""
    # slices, not index lists: a list is copied to the device on every call
    return corners[..., :4, :].flip(-2)[..., 0::2]


def enclosing_aabb_volume(corners1, corners2):
    """Volume of the axis-aligned box enclosing each pair: (B, K1, 8, 3),
    (B, K2, 8, 3) -> (B, K1, K2) (reference utils/box_util.py:466-514)."""
    mn = torch.minimum(corners1.amin(2)[:, :, None, :], corners2.amin(2)[:, None, :, :])
    mx = torch.maximum(corners1.amax(2)[:, :, None, :], corners2.amax(2)[:, None, :, :])
    diff = mx - mn
    return diff[..., 0] * diff[..., 1] * diff[..., 2]


def _pairwise_heights(corners1, corners2):
    """Vertical overlap; up is -Y, so corner 0 is the top face and corner 4
    the bottom (reference utils/box_util.py:543-546)."""
    ymax = torch.minimum(corners1[:, :, 0, 1][:, :, None], corners2[:, :, 0, 1][:, None, :])
    ymin = torch.maximum(corners1[:, :, 4, 1][:, :, None], corners2[:, :, 4, 1][:, None, :])
    return torch.clamp(ymax - ymin, min=0.0)


def _axis_aligned_bev_inter(rect1, rect2):
    """BEV overlap from rect vertex 1 (min) and 3 (max): exact for unrotated
    boxes, an upper-bound prefilter otherwise (box_util.py:556-560)."""
    lt = torch.maximum(rect1[:, :, None, 1, :], rect2[:, None, :, 1, :])
    rb = torch.minimum(rect1[:, :, None, 3, :], rect2[:, None, :, 3, :])
    wh = torch.clamp(rb - lt, min=0.0)
    return wh[..., 0] * wh[..., 1]


def generalized_box3d_iou(corners1, corners2, nums_k2=None, rotated_boxes: bool = True,
                          compute_dtype: torch.dtype = torch.float32):
    """Pairwise generalized IoU: corners1 (B, K1, 8, 3) predictions,
    corners2 (B, K2, 8, 3) targets -> (B, K1, K2) in corners1's dtype.
    nums_k2 (B,) counts the valid targets; the columns past it are zero.
    `compute_dtype` bfloat16 runs the geometry in bf16, as the JAX option
    does.  Differentiable."""
    out_dtype = corners1.dtype
    corners1 = corners1.to(compute_dtype)
    corners2 = corners2.to(compute_dtype)
    K2 = corners2.shape[1]

    height = _pairwise_heights(corners1, corners2)
    rect1, rect2 = bev_rect(corners1), bev_rect(corners2)
    non_rot_inter = _axis_aligned_bev_inter(rect1, rect2)
    if nums_k2 is not None:
        k2_mask = torch.arange(K2, device=corners2.device)[None, :] < nums_k2[:, None]
        non_rot_inter = non_rot_inter * k2_mask[:, None, :]

    enclosing = enclosing_aabb_volume(corners1, corners2)
    vols1 = torch.clamp(box_volume_from_corners(corners1), min=_EPS)
    vols2 = torch.clamp(box_volume_from_corners(corners2), min=_EPS)
    sum_vols = vols1[:, :, None] + vols2[:, None, :]
    good = (enclosing > 2 * _EPS) & (sum_vols > 4 * _EPS)

    if rotated_boxes:
        inter = rotated_bev_intersection_area(rect1, rect2)
        inter = torch.where(non_rot_inter > 0, inter, torch.zeros_like(inter))
    else:
        inter = non_rot_inter
    inter_vols = inter * height
    union = torch.clamp(sum_vols - inter_vols, min=_EPS)
    gious = inter_vols / union - (1.0 - union / enclosing)
    gious = gious * good
    if nums_k2 is not None:
        gious = gious * k2_mask[:, None, :]
    return gious.to(out_dtype)
