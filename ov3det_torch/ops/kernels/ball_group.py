"""Bucketed ball query + grouping: the CUDA kernel's wrapper and its plain
version.

The kernel (`ov3det_torch/csrc/ball_group.cu`) replaces the Pallas TPU
kernel `_kernel` (`ov3det/ops/pallas/ball_group_kernel.py:45`).  The point
axis is split into K contiguous buckets of Nb = ceil(N / K); slot k takes
bucket k's first point with d2 < r^2 (direct subtraction), empty slots copy
the first non-empty bucket's pick, an empty ball falls back to the center.
Output (B, K, M, 3 + C): relative xyz over the radius and the raw
features, neighbour-major.
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


def bucket_picks(xyz: torch.Tensor, centers: torch.Tensor, radius: float,
                 nsample: int) -> tuple[torch.Tensor, torch.Tensor]:
    """First in-radius point of each bucket, one bucket at a time.

    Returns (pick (B, M, K) int64 global point index, has (B, M, K) bool);
    pick is 0 where has is false.  Never builds the (B, M, N) distances.
    """
    B, N, _ = xyz.shape
    K = nsample
    Nb = -(-N // K)
    r2 = torch.tensor(_f32(radius * radius), dtype=torch.float32, device=xyz.device)
    cx, cy, cz = (centers[..., i, None] for i in range(3))  # (B, M, 1)
    picks, hits = [], []
    for k in range(K):
        pts = xyz[:, k * Nb:min((k + 1) * Nb, N)]  # (B, <=Nb, 3); padding is never in a ball
        if pts.shape[1] == 0:
            picks.append(torch.zeros(centers.shape[:2], dtype=torch.int64, device=xyz.device))
            hits.append(torch.zeros(centers.shape[:2], dtype=torch.bool, device=xyz.device))
            continue
        dx = cx - pts[:, None, :, 0]
        dy = cy - pts[:, None, :, 1]
        dz = cz - pts[:, None, :, 2]
        in_ball = ((dx * dx + dy * dy) + dz * dz) < r2  # (B, M, nb)
        first = torch.argmax(in_ball.to(torch.uint8), dim=-1)  # first hit
        picks.append(first + k * Nb)
        hits.append(in_ball.any(dim=-1))
    return torch.stack(picks, dim=-1), torch.stack(hits, dim=-1)


def ball_group_plain(xyz, features, centers, radius: float, nsample: int) -> torch.Tensor:
    """Plain PyTorch bucketed ball-group, the same function as the kernel.

    xyz (B, N, 3) f32, features (B, N, C) f32 or None, centers (B, M, 3) f32
    -> (B, K, M, 3 + C) f32.
    """
    B, N, _ = xyz.shape
    M = centers.shape[1]
    pick, has = bucket_picks(xyz, centers, radius, nsample)  # (B, M, K)
    any_hit = has.any(dim=-1, keepdim=True)
    first_bucket = torch.argmax(has.to(torch.uint8), dim=-1, keepdim=True)
    src = torch.where(has, pick, torch.gather(pick, -1, first_bucket))
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
