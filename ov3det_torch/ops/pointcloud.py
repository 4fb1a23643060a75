"""Point-cloud set-abstraction primitives of the port.

Counterpart of `ov3det/ops/pointcloud.py:71-153, 247-374` as the TPU runs
them: exact greedy FPS and the fused bucketed ball-group, each through its
kernel wrapper (the CUDA kernel for CUDA tensors, the plain version for CPU
tensors), plus the index gather.  The ball-group passes a gradient to its
features, as `ball_group_pallas` does (`ops.kernels.ball_group.BallGroup`).

`ball_query` (JAX's `method="first_k"`) and `group_points`
(`pointcloud.py:168-219, 377-401`) are the CUDA-parity neighbourhoods that
reference 3DETR checkpoints were trained with.  They are XLA in JAX and plain PyTorch here,
on both devices: the first `nsample` points in index order whose squared
distance, in the expanded form of `_pairwise_d2` (`:156-165`), lies below
r^2, found as the `nsample` smallest int32 index scores, the tail filled
with the first hit.
"""
from __future__ import annotations

import numpy as np
import torch

from ov3det_torch.ops.kernels.ball_group import BallGroup, _d2_expanded
from ov3det_torch.ops.kernels.fps import fps

# the (B, chunk, N) distances and scores of `ball_query` hold at most about
# this many elements: 8 x 40 000 points take chunks of 104 centers
_FIRST_K_ELEMENTS = 1 << 25


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
    JAX's top-k leaves it).  The centers go through in chunks, so the
    (B, chunk, N) distances stay near `_FIRST_K_ELEMENTS`.  The bucketed
    query is the fused `ball_group`."""
    xyz, centers = xyz.detach().float(), centers.detach().float()
    B, N, _ = xyz.shape
    M = centers.shape[1]
    r2 = torch.tensor(np.float32(radius * radius), device=xyz.device)
    order = torch.arange(N, dtype=torch.int32, device=xyz.device)
    chunk = max(1, _FIRST_K_ELEMENTS // max(1, B * N))
    out = []
    for m in range(0, M, chunk):
        in_ball = _d2_expanded(centers[:, m:m + chunk])(xyz) < r2  # (B, m, N)
        # in-ball points score their index, the others N: the nsample
        # smallest scores are the first hits, ascending
        scores = torch.where(in_ball, order, torch.tensor(N, dtype=torch.int32,
                                                          device=xyz.device))
        first = torch.topk(scores, nsample, dim=-1, largest=False, sorted=True).values
        count = in_ball.sum(-1, keepdim=True)
        head = torch.where(count > 0, first[..., :1], torch.zeros_like(first[..., :1]))
        slot = torch.arange(nsample, device=xyz.device)
        out.append(torch.where(slot < count, first, head).long())
    return torch.cat(out, dim=1)


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
    rel = rel / torch.tensor(np.float32(radius), device=rel.device)
    if features is None:
        return rel
    g_feat = gather_points(features, flat).reshape(B, M, K, features.shape[-1])
    return torch.cat([rel, g_feat.to(rel.dtype)], dim=-1)
