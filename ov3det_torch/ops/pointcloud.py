"""Point-cloud set-abstraction primitives of the port.

Counterpart of `ov3det/ops/pointcloud.py:71-153, 247-374` as the TPU runs
them: exact greedy FPS and the fused bucketed ball-group, each through its
kernel wrapper (the CUDA kernel for CUDA tensors, the plain version for CPU
tensors), plus the index gather.  The ball-group passes a gradient to its
features, as `ball_group_pallas` does (`ops.kernels.ball_group.BallGroup`).

`ball_query` (JAX's `method="first_k"`) and `group_points`
(`pointcloud.py:168-219, 377-401`) are the CUDA-parity neighbourhoods that
reference 3DETR checkpoints were trained with, XLA in JAX: the first
`nsample` points in index order whose squared distance, in the expanded
form of `_pairwise_d2` (`:156-165`), lies below r^2, the tail filled with
the first hit.  The query goes through its kernel wrapper
(`ops.kernels.ball_query.first_k`); the grouping is a gather.
"""
from __future__ import annotations

import numpy as np
import torch

from ov3det_torch.ops.kernels.ball_group import BallGroup
from ov3det_torch.ops.kernels.ball_query import first_k
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


def ball_query(xyz: torch.Tensor, centers: torch.Tensor, radius: float,
               nsample: int) -> torch.Tensor:
    """First-K fixed-radius neighbourhoods: xyz (B, N, 3), centers (B, M, 3)
    -> (B, M, nsample) int64 indices into xyz, in index order, the tail past
    the ball's count filled with its first hit (0 for an empty ball, as
    JAX's top-k leaves it).  The kernel for CUDA tensors; on the CPU the
    centers go through in chunks, so the (B, chunk, N) distances stay near
    `ops.kernels.ball_query.FIRST_K_ELEMENTS`.  The bucketed query is the
    fused `ball_group`."""
    return first_k(xyz.detach().float(), centers.detach().float(), radius, nsample)


def group_points(xyz: torch.Tensor, features, centers: torch.Tensor, group_inds: torch.Tensor,
                 radius: float) -> torch.Tensor:
    """Gather the grouped relative coordinates (over the radius) and the
    features of each center: xyz (B, N, 3), features (B, N, C) or None,
    centers (B, M, 3), group_inds (B, M, K) -> (B, M, K, 3 + C), the layout
    of `group_points` in JAX (the SA max-pool reduces axis 2).  The
    features get a gradient through the gather."""
    B, M, K = group_inds.shape
    flat = group_inds.reshape(B, M * K)
    rel = gather_points(xyz, flat).reshape(B, M, K, 3) - centers[:, :, None, :]
    rel = rel / torch.full((), np.float32(radius), dtype=torch.float32, device=rel.device)
    if features is None:
        return rel
    g_feat = gather_points(features, flat).reshape(B, M, K, features.shape[-1])
    return torch.cat([rel, g_feat.to(rel.dtype)], dim=-1)
