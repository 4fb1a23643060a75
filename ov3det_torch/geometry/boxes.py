"""Box codecs and coordinate-frame transforms in torch.

Counterpart of `ov3det/geometry/boxes.py:35-190`; same conventions:
points in upright-depth coords (X right, Y forward, Z up), box corners in
camera coords (X right, Y down, Z forward), corners 0-3 the top face.
Every function works on arbitrary leading batch dims.
"""
from __future__ import annotations

import math

import torch

# BEV footprint sign pattern of the 8 corners, top face first
# (reference utils/box_util.py:368-376): x holds length, y height, z width.
_CORNER_SIGNS_X = (1.0, 1.0, -1.0, -1.0, 1.0, 1.0, -1.0, -1.0)
_CORNER_SIGNS_Y = (1.0, 1.0, 1.0, 1.0, -1.0, -1.0, -1.0, -1.0)
_CORNER_SIGNS_Z = (1.0, -1.0, -1.0, 1.0, 1.0, -1.0, -1.0, 1.0)


def flip_axis_to_camera(xyz: torch.Tensor) -> torch.Tensor:
    """Upright-depth -> camera: cam (X, Y, Z) = depth (X, -Z, Y)."""
    return torch.stack([xyz[..., 0], -xyz[..., 2], xyz[..., 1]], dim=-1)


def flip_axis_to_depth(xyz: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`flip_axis_to_camera`."""
    return torch.stack([xyz[..., 0], xyz[..., 2], -xyz[..., 1]], dim=-1)


def rotz_batch(t: torch.Tensor) -> torch.Tensor:
    """Rotation about +Z. t: (...,) -> (..., 3, 3)."""
    c, s = torch.cos(t), torch.sin(t)
    zeros, ones = torch.zeros_like(t), torch.ones_like(t)
    rows = torch.stack([c, -s, zeros, s, c, zeros, zeros, zeros, ones], dim=-1)
    return rows.reshape(t.shape + (3, 3))


def roty_batch(t: torch.Tensor) -> torch.Tensor:
    """Rotation about +Y. t: (...,) -> (..., 3, 3)."""
    c, s = torch.cos(t), torch.sin(t)
    zeros, ones = torch.zeros_like(t), torch.ones_like(t)
    rows = torch.stack([c, zeros, s, zeros, ones, zeros, -s, zeros, c], dim=-1)
    return rows.reshape(t.shape + (3, 3))


def box_corners_from_param(box_size, angle, center) -> torch.Tensor:
    """Camera-frame (l, w, h) + heading + center -> (..., 8, 3) corners.

    Matches reference get_3d_box_batch (utils/box_util.py:355-381).
    """
    half = box_size * 0.5
    signs = half.new_tensor
    sx = half[..., 0:1] * signs(_CORNER_SIGNS_X)
    sy = half[..., 2:3] * signs(_CORNER_SIGNS_Y)
    sz = half[..., 1:2] * signs(_CORNER_SIGNS_Z)
    local = torch.stack([sx, sy, sz], dim=-1)  # (..., 8, 3)
    R = roty_batch(angle)  # (..., 3, 3), in angle's dtype
    dtype = torch.promote_types(local.dtype, R.dtype)
    rotated = torch.einsum("...kj,...ij->...ki", local.to(dtype), R.to(dtype))
    return rotated + center[..., None, :]


def corners_from_upright_depth_param(center_depth, size, angle) -> torch.Tensor:
    """Upright-depth center + (l, w, h) + heading -> camera-frame corners
    (reference datasets/sunrgbd.py:145-148)."""
    return box_corners_from_param(size, angle, flip_axis_to_camera(center_depth))


def gt_corners_upright_depth(center, half_size, heading) -> torch.Tensor:
    """Upright-depth corners (..., 8, 3) of a half-size parametrised GT box:
    rotz(-heading) of the (+-l, +-w, +-h) half extents (reference
    datasets/sunrgbd.py:155-165)."""
    signs = half_size.new_tensor
    sx = half_size[..., 0:1] * signs((-1.0, 1.0, 1.0, -1.0, -1.0, 1.0, 1.0, -1.0))
    sy = half_size[..., 1:2] * signs((1.0, 1.0, -1.0, -1.0, 1.0, 1.0, -1.0, -1.0))
    sz = half_size[..., 2:3] * signs((1.0, 1.0, 1.0, 1.0, -1.0, -1.0, -1.0, -1.0))
    local = torch.stack([sx, sy, sz], dim=-1)
    rotated = torch.einsum("...kj,...ij->...ki", local, rotz_batch(-heading))
    return rotated + center[..., None, :]


def shift_scale_points(xyz, src_range, dst_range=None) -> torch.Tensor:
    """Affine-map (B, N, 3) points from the src AABB range into dst range
    (default the unit box); ranges are pairs of (B, 3) min/max."""
    src_min, src_max = src_range
    if dst_range is None:
        dst_min, dst_max = torch.zeros_like(src_min), torch.ones_like(src_max)
    else:
        dst_min, dst_max = dst_range
    src_diff = (src_max - src_min)[:, None, :]
    dst_diff = (dst_max - dst_min)[:, None, :]
    return (xyz - src_min[:, None, :]) * dst_diff / src_diff + dst_min[:, None, :]


def angle_to_bin(angle: torch.Tensor, num_bins: int):
    """Continuous heading -> (bin id int64, residual): bin centres at
    k * 2 pi / num_bins, residual in [-pi / num_bins, pi / num_bins)
    (reference datasets/sunrgbd.py:102-120)."""
    two_pi = 2.0 * math.pi
    per = two_pi / num_bins
    shifted = torch.remainder(torch.remainder(angle, two_pi) + per / 2.0, two_pi)
    cls = torch.floor(shifted / per).to(torch.int64)
    residual = shifted - (cls.to(angle.dtype) * per + per / 2.0)
    return cls, residual


def bin_to_angle(cls, residual, num_bins: int, to_label_format: bool = True):
    """Heading bin + residual -> angle, optionally wrapped to (-pi, pi]
    (reference datasets/sunrgbd.py:122-140)."""
    per = 2.0 * math.pi / num_bins
    angle = cls.to(residual.dtype) * per + residual
    if to_label_format:
        angle = torch.where(angle > math.pi, angle - 2.0 * math.pi, angle)
    return angle


def box_volume_from_corners(corners: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Volume of (..., 8, 3) corners from the three edge lengths at corner 0,
    each squared length clamped at eps (reference utils/box_util.py:443-463)."""
    def edge(i, j):
        d = corners[..., i, :] - corners[..., j, :]
        return torch.sqrt(torch.clamp((d * d).sum(-1), min=eps))

    return edge(0, 1) * edge(1, 2) * edge(0, 4)
