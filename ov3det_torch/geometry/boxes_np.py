"""Numpy box corner codec for host-side data generation.

A copy of `ov3det/geometry/boxes_np.py`: same arithmetic, so the synthetic
scenes come out bit-identical to the JAX package's.
"""
from __future__ import annotations

import numpy as np

_SIGNS_X = np.array([1, 1, -1, -1, 1, 1, -1, -1], np.float32)
_SIGNS_Y = np.array([1, 1, 1, 1, -1, -1, -1, -1], np.float32)
_SIGNS_Z = np.array([1, -1, -1, 1, 1, -1, -1, 1], np.float32)


def flip_axis_to_camera_np(xyz: np.ndarray) -> np.ndarray:
    """Depth (X right, Y fwd, Z up) -> camera (X right, Y down, Z fwd)."""
    out = xyz[..., [0, 2, 1]].copy()
    out[..., 1] *= -1
    return out


def roty_batch_np(t: np.ndarray) -> np.ndarray:
    c, s = np.cos(t), np.sin(t)
    zeros = np.zeros_like(t)
    ones = np.ones_like(t)
    rows = np.stack([c, zeros, s, zeros, ones, zeros, -s, zeros, c], axis=-1)
    return rows.reshape(t.shape + (3, 3)).astype(np.float32)


def box_corners_from_param_np(box_size, angle, center) -> np.ndarray:
    """Camera-frame (l, w, h) + heading + center -> (..., 8, 3) corners."""
    half = box_size.astype(np.float32) * 0.5
    sx = half[..., 0:1] * _SIGNS_X
    sy = half[..., 2:3] * _SIGNS_Y
    sz = half[..., 1:2] * _SIGNS_Z
    local = np.stack([sx, sy, sz], axis=-1)  # (..., 8, 3)
    R = roty_batch_np(np.asarray(angle, np.float32))
    rotated = np.einsum("...kj,...ij->...ki", local, R)
    return (rotated + np.asarray(center, np.float32)[..., None, :]).astype(np.float32)


def corners_from_upright_depth_param_np(center_depth, size, angle) -> np.ndarray:
    """Upright-depth params -> camera-frame corners."""
    return box_corners_from_param_np(
        np.asarray(size), np.asarray(angle),
        flip_axis_to_camera_np(np.asarray(center_depth)),
    )
