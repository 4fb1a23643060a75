"""Bucketed ball query + grouping: the CUDA kernel's wrapper and its plain
version.

The kernel (`ov3det_torch/csrc/ball_group.cu`) replaces the Pallas TPU
kernel `_kernel` (`ov3det/ops/pallas/ball_group_kernel.py:45`).  The point
axis is split into K contiguous buckets of Nb = ceil(N / K); slot k takes
bucket k's first point with d2 < r^2 (direct subtraction), empty slots copy
the first non-empty bucket's pick, an empty ball falls back to the center.
Output (B, K, M, 3 + C): relative xyz over the radius and the raw
features, neighbour-major.

`BallGroup` is the custom VJP of `ball_group_pallas`
(`ball_group_kernel.py:174-241`): the forward is the kernel (or its plain
version); the backward, `feature_grad`, is the port of `_bwd`
(`:207-238`), a scatter-add of the output's feature cotangent onto the
picked points.  In JAX that backward is XLA, not Pallas, so plain PyTorch on
both devices is its faithful port, not a fallback.  It recomputes the picks
as `bucket_picks` of the JAX package does (`ov3det/ops/pointcloud.py:
222-244`), with the expanded, clamped distance of `_pairwise_d2`
(`:156-165`) and not the forward's direct subtraction, so at the r^2
boundary the gradient can land on a point the forward did not pick, as it
does in JAX.  xyz and the centers get no gradient.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ov3det_torch.ops.kernels import _build

SOURCE = "ov3det_torch/csrc/ball_group.cu"
REPLACES = "ov3det/ops/pallas/ball_group_kernel.py:45"


def _f32(x: float) -> float:
    """The f32 value of a Python float (the JAX code compares against
    weakly typed Python floats, which become f32)."""
    return float(np.float32(x))


def _d2_direct(centers: torch.Tensor):
    """pts (B, n, 3) -> (B, M, n) squared distances to `centers` by direct
    subtraction, as the kernel forms them: (dx*dx + dy*dy) + dz*dz."""
    c = [centers[..., i, None] for i in range(3)]  # (B, M, 1) views

    def d2(pts):
        d = [c[i] - pts[:, None, :, i] for i in range(3)]
        return (d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]

    return d2


def _d2_expanded(centers: torch.Tensor):
    """pts (B, n, 3) -> (B, M, n) squared distances to `centers` as
    `_pairwise_d2` of the JAX package forms them (`ov3det/ops/pointcloud.py:
    156-165`): max((|c|^2 + |x|^2) - 2 c.x, 0), each operation rounded on
    its own."""
    c = centers[:, :, None, :]  # (B, M, 1, 3)
    c2 = (c[..., 0] * c[..., 0] + c[..., 1] * c[..., 1]) + c[..., 2] * c[..., 2]

    def d2(pts):
        x = pts[:, None]  # (B, 1, n, 3)
        x2 = (x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1]) + x[..., 2] * x[..., 2]
        cross = (c[..., 0] * x[..., 0] + c[..., 1] * x[..., 1]) + c[..., 2] * x[..., 2]
        return torch.clamp((c2 + x2) - 2.0 * cross, min=0.0)

    return d2


def _first_hits(xyz, centers, radius: float, nsample: int, d2_to):
    """First point of each bucket with d2 < f32(r^2), d2 from
    `d2_to(centers)`, one bucket at a time (the (B, M, N) distances are
    never built).  Returns (pick (B, M, K) int64 global point index, has
    (B, M, K) bool); pick is the bucket's first index where has is false."""
    B, N, _ = xyz.shape
    K = nsample
    Nb = -(-N // K)
    r2 = torch.tensor(_f32(radius * radius), dtype=torch.float32, device=xyz.device)
    d2 = d2_to(centers)
    picks, hits = [], []
    for k in range(K):
        pts = xyz[:, k * Nb:min((k + 1) * Nb, N)]  # (B, <=Nb, 3); padding is never in a ball
        if pts.shape[1] == 0:
            picks.append(torch.zeros(centers.shape[:2], dtype=torch.int64, device=xyz.device))
            hits.append(torch.zeros(centers.shape[:2], dtype=torch.bool, device=xyz.device))
            continue
        in_ball = d2(pts) < r2  # (B, M, nb)
        picks.append(torch.argmax(in_ball.to(torch.uint8), dim=-1) + k * Nb)  # first hit
        hits.append(in_ball.any(dim=-1))
    return torch.stack(picks, dim=-1), torch.stack(hits, dim=-1)


def bucket_picks(xyz, centers, radius: float, nsample: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's picks: the first in-radius point of each bucket, d2 by
    direct subtraction.  Returns (pick, has), (B, M, K) each."""
    return _first_hits(xyz, centers, radius, nsample, _d2_direct)


def bucket_picks_expanded(xyz, centers, radius: float,
                          nsample: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The picks of `bucket_picks` of the JAX package
    (`ov3det/ops/pointcloud.py:222-244`), which its backward recomputes:
    d2 in the expanded, clamped form.  Returns (pick, has) as
    `bucket_picks`."""
    return _first_hits(xyz, centers, radius, nsample, _d2_expanded)


def _slot_sources(pick, has):
    """(B, M, K) point index of each slot: its own pick, or the first
    non-empty bucket's pick for an empty slot; and (B, M, 1) whether the
    ball holds any point."""
    first_bucket = torch.argmax(has.to(torch.uint8), dim=-1, keepdim=True)
    return torch.where(has, pick, torch.gather(pick, -1, first_bucket)), has.any(-1, keepdim=True)


def feature_grad(xyz, centers, radius: float, nsample: int, grad_out: torch.Tensor,
                 num_channels: int) -> torch.Tensor:
    """The feature cotangent of the ball-group, `_bwd` of
    `ball_group_kernel.py:207-238`: (B, N, C) from the output's cotangent
    grad_out (B, K, M, 3 + C).  An empty slot takes the first non-empty
    bucket's pick; an empty ball passes no gradient; the rest is summed
    onto the picked points with `index_add_`."""
    B, N, _ = xyz.shape
    src, any_hit = _slot_sources(*bucket_picks_expanded(xyz, centers, radius, nsample))
    g = grad_out[..., 3:].float().transpose(1, 2)  # (B, K, M, C) -> (B, M, K, C)
    g = torch.where(any_hit[..., None], g, torch.zeros_like(g))
    flat = (src + torch.arange(B, device=xyz.device)[:, None, None] * N).reshape(-1)
    out = torch.zeros(B * N, num_channels, dtype=torch.float32, device=xyz.device)
    out.index_add_(0, flat, g.reshape(-1, num_channels))
    return out.view(B, N, num_channels)


class BallGroup(torch.autograd.Function):
    """`ball_group_pallas` with its custom VJP: the forward launches the
    kernel (the plain version for CPU tensors); the backward is
    `feature_grad`, for the features only."""

    @staticmethod
    def forward(ctx, xyz, features, centers, radius: float, nsample: int):
        ctx.save_for_backward(xyz, centers)
        ctx.radius, ctx.nsample = radius, nsample
        ctx.num_channels = 0 if features is None else features.shape[-1]
        return ball_group(xyz, features, centers, radius, nsample)

    @staticmethod
    def backward(ctx, grad_out):
        if not ctx.needs_input_grad[1]:
            return None, None, None, None, None
        xyz, centers = ctx.saved_tensors
        d_feats = feature_grad(xyz, centers, ctx.radius, ctx.nsample, grad_out,
                               ctx.num_channels)
        return None, d_feats, None, None, None


def ball_group_plain(xyz, features, centers, radius: float, nsample: int) -> torch.Tensor:
    """Plain PyTorch bucketed ball-group, the same function as the kernel.

    xyz (B, N, 3) f32, features (B, N, C) f32 or None, centers (B, M, 3) f32
    -> (B, K, M, 3 + C) f32.
    """
    B, N, _ = xyz.shape
    M = centers.shape[1]
    src, any_hit = _slot_sources(*bucket_picks(xyz, centers, radius, nsample))  # (B, M, K)
    src = src.transpose(1, 2)  # (B, K, M)
    valid = any_hit.transpose(1, 2)[..., None]  # (B, 1, M, 1)
    flat = src.reshape(B, -1)
    g_xyz = torch.gather(xyz, 1, flat[..., None].expand(-1, -1, 3)).reshape(B, nsample, M, 3)
    rel = (g_xyz - centers[:, None]) * torch.tensor(_f32(1.0 / radius), dtype=torch.float32)
    rel = torch.where(valid, rel, torch.zeros_like(rel))
    if features is None:
        return rel
    C = features.shape[-1]
    g_feat = torch.gather(features, 1, flat[..., None].expand(-1, -1, C)).reshape(B, nsample, M, C)
    g_feat = torch.where(valid, g_feat, torch.zeros_like(g_feat))
    return torch.cat([rel, g_feat], dim=-1)


def ball_group(xyz, features, centers, radius: float, nsample: int) -> torch.Tensor:
    """Fused bucketed ball query + group -> (B, K, M, 3 + C) f32.

    Launches the CUDA kernel for CUDA tensors; CPU tensors take
    :func:`ball_group_plain`.
    """
    tensors = [xyz, centers] + ([] if features is None else [features])
    if xyz.dim() != 3 or xyz.shape[-1] != 3 or centers.dim() != 3 or centers.shape[-1] != 3:
        raise ValueError("ball_group expects xyz (B, N, 3) and centers (B, M, 3)")
    if centers.shape[0] != xyz.shape[0]:
        raise ValueError("xyz and centers differ in batch size")
    if features is not None and (features.dim() != 3 or features.shape[:2] != xyz.shape[:2]):
        raise ValueError("features must be (B, N, C) beside xyz (B, N, 3)")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("ball_group expects float32 tensors")
    if nsample < 1 or radius <= 0:
        raise ValueError("ball_group needs nsample >= 1 and radius > 0")
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"ball_group tensors lie on several devices: {devices}")
    device = xyz.device
    if device.type == "cpu":
        return ball_group_plain(xyz, features, centers, radius, nsample)
    if device.type != "cuda":
        raise ValueError(f"ball_group runs on cuda or cpu tensors, got {device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ball_group expects contiguous tensors")
    B, N, _ = xyz.shape
    M = centers.shape[1]
    C = 0 if features is None else features.shape[-1]
    pick = torch.empty((B, nsample, M), dtype=torch.int32, device=device)
    out = torch.empty((B, nsample, M, 3 + C), dtype=torch.float32, device=device)
    lib = _build.load("ball_group", _SIGNATURES)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.ov3_ball_group(
            xyz.data_ptr(), None if features is None else features.data_ptr(),
            centers.data_ptr(), B, N, M, nsample, C, _f32(radius * radius), _f32(1.0 / radius),
            pick.data_ptr(), out.data_ptr(), stream)
    _build.check(lib, status, "ball_group")
    ball_group.launches += 1
    return out


ball_group.launches = 0

_SIGNATURES = {
    "ov3_ball_group": (
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
           ctypes.c_void_p],
        ctypes.c_int,
    ),
}
