"""Bucketed ball query + grouping, and the pick pass of its feature
gradient: the CUDA kernels' wrappers and their plain versions.

The kernels (`ov3det_torch/csrc/ball_group.cu`) replace the Pallas TPU
kernel `_kernel` (`ov3det/ops/pallas/ball_group_kernel.py:45`).  The point
axis is split into K contiguous buckets of Nb = ceil(N / K); slot k takes
bucket k's first point with d2 < r^2 (direct subtraction), empty slots copy
the first non-empty bucket's pick, an empty ball falls back to the center.
Output (B, K, M, 3 + C): relative xyz over the radius and the raw
features, neighbour-major.

The source holds two designs of the forward.  `ball_group` calls the
source's route, which launches the tile design (`ball_group_tile<fill>`:
one CTA for each scene and tile of centers, the buckets staged in shared
memory, picks and fill in one launch) for K <= MAX_SLOTS and the first
design (one warp a (center, bucket), then one thread a center) above it;
the private `_impl="first"` keeps a CUDA call on the first design, the
yardstick the on-card check times beside the tile design.

`BallGroup` is the custom VJP of `ball_group_pallas`
(`ball_group_kernel.py:174-241`): the forward is the kernel (or its plain
version); the backward, `feature_grad`, is the port of `_bwd`
(`:207-238`): the pick pass `slot_sources` (`ball_group_tile<sources>` on
the card) and a scatter-add of the output's feature cotangent onto the
picked points with `index_add_`, the library scatter that XLA's
`.at[].add` is in JAX.  It recomputes the picks as `bucket_picks` of the
JAX package does (`ov3det/ops/pointcloud.py:222-244`), with the expanded,
clamped distance of `_pairwise_d2` (`:156-165`) and not the forward's
direct subtraction, so at the r^2 boundary the gradient can land on a point
the forward did not pick, as it does in JAX.  xyz and the centers get no
gradient.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from ov3det_torch.ops.kernels import _build

SOURCE = "ov3det_torch/csrc/ball_group.cu"
REPLACES = "ov3det/ops/pallas/ball_group_kernel.py:45"
# the pick pass replaces the recomputation of the picks in the custom VJP
# `_bwd` (XLA in JAX, not Pallas)
SOURCES_REPLACES = "ov3det/ops/pallas/ball_group_kernel.py:207"


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


def slot_sources_plain(xyz, centers, radius: float, nsample: int) -> torch.Tensor:
    """Plain PyTorch pick pass of the feature gradient, the same function as
    the kernel's: (B, K, M) int32, each slot's effective source point (the
    TPU's `eff_pick` of `_bwd`, `ball_group_kernel.py:225-231`, as a global
    index) from the expanded-distance picks, -1 throughout an empty ball."""
    src, any_hit = _slot_sources(*bucket_picks_expanded(xyz, centers, radius, nsample))
    return torch.where(any_hit, src, -1).transpose(1, 2).to(torch.int32).contiguous()


def _scatter(src: torch.Tensor, grad_out: torch.Tensor, N: int, num_channels: int) -> torch.Tensor:
    """Sum the feature cotangent grad_out[..., 3:] (B, K, M, 3 + C) onto the
    points `src` (B, K, M) names, in the cotangent's own order (no
    transpose, no copy); the rows of empty balls (-1) go to a spare row past
    the last point, which is dropped."""
    B = src.shape[0]
    rows = src.long() + (torch.arange(B, device=src.device) * N)[:, None, None]
    rows = torch.where(src >= 0, rows, B * N).reshape(-1)
    out = torch.zeros(B * N + 1, num_channels, dtype=torch.float32, device=src.device)
    out.index_add_(0, rows, grad_out[..., 3:].float().reshape(-1, num_channels))
    return out[:B * N].view(B, N, num_channels)


def feature_grad(xyz, centers, radius: float, nsample: int, grad_out: torch.Tensor,
                 num_channels: int) -> torch.Tensor:
    """The feature cotangent of the ball-group, `_bwd` of
    `ball_group_kernel.py:207-238`: (B, N, C) from the output's cotangent
    grad_out (B, K, M, 3 + C).  The picks come from :func:`slot_sources` (the
    kernel for CUDA tensors); an empty slot takes the first non-empty
    bucket's pick; an empty ball passes no gradient; the rest is summed onto
    the picked points with `index_add_` (XLA's scatter-add in JAX)."""
    return _scatter(slot_sources(xyz, centers, radius, nsample), grad_out, xyz.shape[1],
                    num_channels)


def feature_grad_plain(xyz, centers, radius: float, nsample: int, grad_out: torch.Tensor,
                       num_channels: int) -> torch.Tensor:
    """:func:`feature_grad` with the plain pick pass on any device."""
    return _scatter(slot_sources_plain(xyz, centers, radius, nsample), grad_out, xyz.shape[1],
                    num_channels)


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


# `kMaxK` of csrc/ball_group.cu: the tile design keeps K x TM picks in shared
# memory and takes at most this many slots; the source takes a larger K to
# the first design, which needs a global pick scratch
MAX_SLOTS = 256


def _on_cuda(xyz, features, centers, radius: float, nsample: int, what: str) -> bool:
    """Validate the operands; True when they lie on a CUDA device (a kernel
    runs), False on the CPU (the plain version runs)."""
    tensors = [xyz, centers] + ([] if features is None else [features])
    if xyz.dim() != 3 or xyz.shape[-1] != 3 or centers.dim() != 3 or centers.shape[-1] != 3:
        raise ValueError(f"{what} expects xyz (B, N, 3) and centers (B, M, 3)")
    if centers.shape[0] != xyz.shape[0]:
        raise ValueError("xyz and centers differ in batch size")
    if features is not None and (features.dim() != 3 or features.shape[:2] != xyz.shape[:2]):
        raise ValueError("features must be (B, N, C) beside xyz (B, N, 3)")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"{what} expects float32 tensors")
    if nsample < 1 or radius <= 0:
        raise ValueError(f"{what} needs nsample >= 1 and radius > 0")
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{what} tensors lie on several devices: {devices}")
    device = xyz.device
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu tensors, got {device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what} expects contiguous tensors")
    return True


def _launch(entry: str, device: torch.device, *args) -> None:
    """Call the C entry point `entry(*args, stream)` of csrc/ball_group.cu on
    the current stream of `device`; tensors among `args` pass as pointers.
    Raises if the launch fails."""
    lib = _build.load("ball_group", _SIGNATURES)
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(device):
        status = getattr(lib, entry)(*ptrs, torch.cuda.current_stream().cuda_stream)
    _build.check(lib, status, entry)


def ball_group(xyz, features, centers, radius: float, nsample: int,
               _impl: Optional[str] = None) -> torch.Tensor:
    """Fused bucketed ball query + group -> (B, K, M, 3 + C) f32.

    Launches the CUDA kernel for CUDA tensors, the design the source's
    route gives the shape: the tile design (`ball_group_tile`), or the first
    design for K > MAX_SLOTS; CPU tensors take :func:`ball_group_plain`.  The private `_impl =
    "first"` keeps a CUDA call on the first design, for timing and
    comparison on one card.  Every launch counts in `ball_group.launches`.
    """
    on_cuda = _on_cuda(xyz, features, centers, radius, nsample, "ball_group")
    if _impl not in (None, "first"):
        raise ValueError(f"ball_group: _impl is None (the route) or 'first', got {_impl!r}")
    if not on_cuda:
        if _impl is not None:
            raise ValueError("ball_group: _impl chooses between CUDA kernels; these tensors lie on "
                             "the CPU")
        return ball_group_plain(xyz, features, centers, radius, nsample)
    B, N, _ = xyz.shape
    M = centers.shape[1]
    C = 0 if features is None else features.shape[-1]
    r2, inv_r = _f32(radius * radius), _f32(1.0 / radius)
    out = torch.empty((B, nsample, M, 3 + C), dtype=torch.float32, device=xyz.device)
    # the first design's picks go through a global scratch
    pick = (torch.empty((B, nsample, M), dtype=torch.int32, device=xyz.device)
            if _impl == "first" or nsample > MAX_SLOTS else None)
    _launch("ov3_ball_group_first" if _impl == "first" else "ov3_ball_group", xyz.device, xyz,
            features, centers, B, N, M, nsample, C, r2, inv_r, pick, out)
    ball_group.launches += 1
    return out


ball_group.launches = 0


def slot_sources(xyz, centers, radius: float, nsample: int) -> torch.Tensor:
    """The feature gradient's pick pass -> (B, K, M) int32: each slot's
    effective source point by the expanded distance, -1 throughout an empty
    ball.

    Launches `ball_group_tile<sources>` for CUDA tensors (counted in
    `slot_sources.launches`); CPU tensors take :func:`slot_sources_plain`.
    The source refuses K > MAX_SLOTS on the card, and the call raises.
    """
    if not _on_cuda(xyz, None, centers, radius, nsample, "slot_sources"):
        return slot_sources_plain(xyz, centers, radius, nsample)
    B, N, _ = xyz.shape
    M = centers.shape[1]
    src = torch.empty((B, nsample, M), dtype=torch.int32, device=xyz.device)
    _launch("ov3_ball_group_sources", xyz.device, xyz, centers, B, N, M, nsample,
            _f32(radius * radius), src)
    slot_sources.launches += 1
    return src


slot_sources.launches = 0

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "ov3_ball_group": ([_P] * 3 + [_I] * 5 + [_F, _F, _P, _P, _P], ctypes.c_int),
    "ov3_ball_group_first": ([_P] * 3 + [_I] * 5 + [_F, _F, _P, _P, _P], ctypes.c_int),
    "ov3_ball_group_sources": ([_P] * 2 + [_I] * 4 + [_F, _P, _P], ctypes.c_int),
}

