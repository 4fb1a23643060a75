"""SUN RGB-D camera calibration and the projection of predicted 3D boxes
into the image.

A copy of `ov3det/utils/calibration.py` (reference utils/image_util.py:
117-298, `SUNRGBD_Calibration`, `project_box_3d_cuda`): Rtilt maps depth to
upright-depth coordinates, K projects camera coordinates to pixels.  Every
operation is batched over leading axes and runs on the tensors' device, so
the teacher's box projection stays on the card inside the training step.

Boxes come out as (x1, y1, x2, y2) = (u_min, v_min, u_max, v_max) pixels;
the reference's `project_box_3d[_cuda]` swaps u and v relative to its own
image clamp, and the JAX package keeps this consistent order.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch


def flip_axis_to_camera(pc: torch.Tensor) -> torch.Tensor:
    return torch.stack([pc[..., 0], -pc[..., 2], pc[..., 1]], dim=-1)


def flip_axis_to_depth(pc: torch.Tensor) -> torch.Tensor:
    return torch.stack([pc[..., 0], pc[..., 2], -pc[..., 1]], dim=-1)


class SunrgbdCalibration:
    """Batched calibration; Rtilt: (..., 3, 3), K: (..., 3, 3)."""

    def __init__(self, Rtilt: torch.Tensor, K: torch.Tensor):
        self.Rtilt = torch.as_tensor(Rtilt, dtype=torch.float32)
        self.K = torch.as_tensor(K, dtype=torch.float32)

    def project_upright_depth_to_camera(self, pc: torch.Tensor) -> torch.Tensor:
        """pc: (..., N, 3) upright depth -> camera coordinates."""
        pc2 = torch.einsum("...ji,...nj->...ni", self.Rtilt, pc)  # Rtilt^T @ pc
        return flip_axis_to_camera(pc2)

    def project_upright_depth_to_image(self, pc: torch.Tensor):
        """pc: (..., N, 3) -> (uv (..., N, 2), depth (..., N))."""
        cam = self.project_upright_depth_to_camera(pc)
        uvw = torch.einsum("...ni,...ji->...nj", cam, self.K)
        uv = uvw[..., :2] / torch.clamp(uvw[..., 2:3], min=1e-6)
        return uv, cam[..., 2]

    def project_image_to_camera(self, uv_depth: torch.Tensor) -> torch.Tensor:
        """uv_depth: (..., N, 3) [u, v, depth] -> camera coordinates."""
        f_u = self.K[..., 0, 0][..., None]
        f_v = self.K[..., 1, 1][..., None]
        c_u = self.K[..., 0, 2][..., None]
        c_v = self.K[..., 1, 2][..., None]
        x = (uv_depth[..., 0] - c_u) * uv_depth[..., 2] / f_u
        y = (uv_depth[..., 1] - c_v) * uv_depth[..., 2] / f_v
        return torch.stack([x, y, uv_depth[..., 2]], dim=-1)

    def project_image_to_upright_depth(self, uv_depth: torch.Tensor) -> torch.Tensor:
        depth = flip_axis_to_depth(self.project_image_to_camera(uv_depth))
        return torch.einsum("...ij,...nj->...ni", self.Rtilt, depth)


_CORNER_SIGNS = ((-1, 1, 1, -1, -1, 1, 1, -1),
                 (1, 1, -1, -1, 1, 1, -1, -1),
                 (1, 1, 1, 1, -1, -1, -1, -1))


@functools.lru_cache(maxsize=None)
def _corner_signs(device: torch.device) -> torch.Tensor:
    """The sign table on `device`, copied there once: a copy from the host
    on every call would make the host wait for the device.  Made outside
    inference mode, so that autograd may save it after a first call from
    an inference."""
    with torch.inference_mode(False):
        return torch.tensor(_CORNER_SIGNS, dtype=torch.float32, device=device)


def box_corners_upright_depth(center: torch.Tensor, half_size: torch.Tensor,
                              heading: torch.Tensor) -> torch.Tensor:
    """Corners (..., 8, 3) in upright depth coordinates: rotz(-heading) over
    half-size extents (reference utils/image_util.py:102-111)."""
    signs = _corner_signs(center.device)
    local = half_size[..., :, None] * signs  # (..., 3, 8)
    local = local.transpose(-1, -2)  # (..., 8, 3)
    c, s = torch.cos(-heading), torch.sin(-heading)
    zeros, ones = torch.zeros_like(c), torch.ones_like(c)
    R = torch.stack([c, -s, zeros, s, c, zeros, zeros, zeros, ones], dim=-1)
    R = R.reshape(*heading.shape, 3, 3)
    rotated = torch.einsum("...kj,...ij->...ki", local, R)
    return rotated + center[..., None, :]


def project_boxes_to_image(calib: SunrgbdCalibration, centers: torch.Tensor,
                           sizes: torch.Tensor, angles: torch.Tensor,
                           image_hw: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Predicted 3D boxes -> image-plane AABBs (B, Q, 4) [x1, y1, x2, y2],
    clamped to [0, w] x [0, h] when `image_hw` (B, 2) [h, w] is given.

    centers (B, Q, 3) in upright depth; `sizes` (B, Q, 3) are the model's
    FULL extents, so half of them is the corner extent (the reference feeds
    full sizes into its half-size corner formula, criterion.py:368,385,
    projecting double-size boxes; the JAX package projects the true box).
    """
    corners = box_corners_upright_depth(centers, sizes * 0.5, angles)  # (B, Q, 8, 3)
    B, Q = corners.shape[:2]
    uv, _ = calib.project_upright_depth_to_image(corners.reshape(B, Q * 8, 3))
    uv = uv.reshape(B, Q, 8, 2)
    boxes = torch.cat([uv.amin(dim=2), uv.amax(dim=2)], dim=-1)
    if image_hw is not None:
        h = image_hw[..., 0][:, None].to(boxes.dtype)
        w = image_hw[..., 1][:, None].to(boxes.dtype)
        zero = torch.zeros_like(h)
        boxes = torch.stack([torch.clamp(boxes[..., 0], zero, w),
                             torch.clamp(boxes[..., 1], zero, h),
                             torch.clamp(boxes[..., 2], zero, w),
                             torch.clamp(boxes[..., 3], zero, h)], dim=-1)
    return boxes
