"""Point-cloud set-abstraction primitives of the port.

Counterpart of `ov3det/ops/pointcloud.py:71-153, 247-374` as the TPU runs
them: exact greedy FPS and the fused bucketed ball-group, each through its
kernel wrapper (the CUDA kernel for CUDA tensors, the plain version for CPU
tensors), plus the index gather.  The ball-group passes a gradient to its
features, as `ball_group_pallas` does (`ops.kernels.ball_group.BallGroup`).
"""
from __future__ import annotations

import torch

from ov3det_torch.ops.kernels.ball_group import BallGroup
from ov3det_torch.ops.kernels.fps import fps


def furthest_point_sample(xyz: torch.Tensor, num_samples: int) -> torch.Tensor:
    """(B, N, 3) -> (B, num_samples) int64: exact greedy FPS, seed index 0,
    ties to the lowest index."""
    return fps(xyz.detach().float().contiguous(), num_samples)


def gather_points(points: torch.Tensor, inds: torch.Tensor) -> torch.Tensor:
    """points (B, N, C), inds (B, M) -> (B, M, C)."""
    return torch.gather(points, 1, inds[..., None].expand(-1, -1, points.shape[-1]))


def ball_group(xyz, features, centers, radius: float, nsample: int) -> torch.Tensor:
    """Bucketed ball query + group -> (B, nsample, M, 3 + C), neighbour-major
    (the layout the TPU kernel emits; the SA max-pool reduces axis 1).  The
    features are cast to f32 first, as the TPU kernel's wrapper does; their
    gradient flows back through the cast."""
    feats = None if features is None else features.float().contiguous()
    return BallGroup.apply(xyz.detach().float().contiguous(), feats,
                           centers.detach().float().contiguous(), radius, nsample)
