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
(`:207-238`): the picks, then the scatter-add of the output's feature
cotangent onto the picked points that XLA's `.at[].add` is in JAX.  On the
card that is two launches of `csrc/feature_grad.cu`: `sources_map`
(`feature_sources_map`, a cluster of CTAs a scene: the picks and the
inverse map by a stable counting sort), then `feature_sum` (each point's
rows summed in slot order); where `sources_map` does not fit the shape, the
pick pass `slot_sources` (`ball_group_tile<sources>` of
`csrc/ball_group.cu`) and `feature_scatter` (`feature_map`, then
`feature_sum`) take it.  On the CPU the plain pick pass and `_scatter`, an
accumulating `index_put_`; all sum each point's slots in ascending slot
order from 0, the same bits every run.  It recomputes the picks as `bucket_picks` of the
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
SCATTER_SOURCE = "ov3det_torch/csrc/feature_grad.cu"
# the sum replaces the custom VJP `_bwd`'s `.at[].add` (XLA in JAX, not
# Pallas); `feature_sources_map` its picks (:207-231) and the indices of the
# `.at[].add` (:235)
SCATTER_REPLACES = "ov3det/ops/pallas/ball_group_kernel.py:235 (_bwd's .at[].add, XLA, not Pallas)"
SOURCES_MAP_REPLACES = ("ov3det/ops/pallas/ball_group_kernel.py:207 (_bwd's picks and its .at[].add's "
                        "indices, XLA, not Pallas)")
# `kHeavy` of csrc/feature_grad.cu: the map puts a point with more than
# MAP_HEAVY times the mean number of slots first in the work records
MAP_HEAVY = 4


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
    """Plain PyTorch scatter of the feature gradient: sum the feature
    cotangent grad_out[..., 3:] (B, K, M, 3 + C) onto the points `src`
    (B, K, M) names, in the cotangent's own order (no transpose, no copy);
    the rows of empty balls (-1) go to a spare row past the last point,
    which is dropped.  The CPU's path and the kernels' oracle on the card."""
    B = src.shape[0]
    rows = src.long() + (torch.arange(B, device=src.device) * N)[:, None, None]
    rows = torch.where(src >= 0, rows, B * N).reshape(-1)
    out = torch.zeros(B * N + 1, num_channels, dtype=torch.float32, device=src.device)
    # an accumulating index_put_ sums each point's slots in their order (a
    # stable sort on CUDA), so the gradient is the same bits every run;
    # index_add_'s atomics order them as the card schedules them
    out.index_put_((rows,), grad_out[..., 3:].float().reshape(-1, num_channels), accumulate=True)
    return out[:B * N].view(B, N, num_channels)


def _runs_kernel(device: torch.device, what: str) -> bool:
    """True for a CUDA device (a kernel runs), False for the CPU (the plain
    version runs); raises for any other device."""
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu tensors, got {device}")
    return True


def _fg_launch(entry: str, device: torch.device, *args) -> None:
    """Call the C entry point `entry(*args, stream)` of csrc/feature_grad.cu
    on the current stream of `device`; tensors among `args` pass as
    pointers.  Raises if the launch fails."""
    lib = _build.load("feature_grad", _SCATTER_SIGNATURES)
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(device):
        status = getattr(lib, entry)(*ptrs, torch.cuda.current_stream().cuda_stream)
    _build.check(lib, status, entry)


def _map_warps(entry: str, device: torch.device, *dims) -> int:
    """The warps of a CTA that the route `entry` of csrc/feature_grad.cu
    gives these dimensions on `device`'s card, 0 where its kernel does not
    take them."""
    lib = _build.load("feature_grad", _SCATTER_SIGNATURES)
    warps = ctypes.c_int()
    with torch.cuda.device(device):
        status = getattr(lib, entry)(*dims, ctypes.byref(warps))
    _build.check(lib, status, entry)
    return warps.value


def _inverse_map(src: torch.Tensor, N: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The inverse map of sources (B, K, M) int32 as the kernels write it:
    list (B, K * M) int32, each scene's slot indices by point and then slot
    (-1 past the named ones, which the kernels leave unwritten), and work
    (B, N, 4) int32, one record {point, first, end, 0} a point, the points
    named more than MAP_HEAVY times the mean first, each group in point
    order."""
    B = src.shape[0]
    keys = src.reshape(B, -1).long()
    valid = keys >= 0
    order = torch.sort(torch.where(valid, keys, N), dim=1, stable=True).indices
    lst = torch.where(torch.gather(valid, 1, order), order, -1)
    count = torch.zeros(B, N + 1, dtype=torch.int64, device=src.device)
    count = count.scatter_add_(1, torch.where(valid, keys, N), torch.ones_like(keys))[:, :N]
    start = torch.cumsum(count, 1) - count
    heavy = count * N > MAP_HEAVY * count.sum(1, keepdim=True)
    points = torch.sort((~heavy).to(torch.int32), dim=1, stable=True).indices
    work = torch.stack([points, start.gather(1, points), (start + count).gather(1, points),
                        torch.zeros_like(points)], dim=-1)
    return lst.to(torch.int32), work.to(torch.int32)


def sources_map_plain(xyz, centers, radius: float, nsample: int) -> tuple:
    """Plain PyTorch version of `feature_sources_map`: (src (B, K, M) int32
    as :func:`slot_sources_plain` gives it, list (B, K * M) int32 and work
    (B, N, 4) int32 as :func:`_inverse_map` gives them)."""
    src = slot_sources_plain(xyz, centers, radius, nsample)
    return (src, *_inverse_map(src, xyz.shape[1]))


def sources_map(xyz, centers, radius: float, nsample: int) -> tuple:
    """The feature gradient's picks and their inverse map in one launch ->
    (src (B, K, M) int32: each slot's effective source by the expanded
    distance, -1 throughout an empty ball; list (B, K * M) int32; work
    (B, N, 4) int32), what `feature_sum` reads.

    Launches `feature_sources_map` for CUDA tensors (counted in
    `sources_map.launches`); the list past each scene's named slots is left
    unwritten.  CPU tensors take :func:`sources_map_plain`.  The card
    refuses a shape the kernel does not fit (more than 65536 slots a scene,
    or more shared memory than a CTA has: `fits_sources_map`)."""
    if not _on_cuda(xyz, None, centers, radius, nsample, "sources_map"):
        return sources_map_plain(xyz, centers, radius, nsample)
    B, N, _ = xyz.shape
    M = centers.shape[1]
    if not fits_sources_map(N, M, nsample, xyz.device):
        raise ValueError(f"sources_map kernel: {nsample} x {M} slots and {N} points a scene do not "
                         "fit it (at most 65536 slots, and its picks and histogram in shared "
                         "memory)")
    src = torch.empty((B, nsample, M), dtype=torch.int32, device=xyz.device)
    lst = torch.empty((B, nsample * M), dtype=torch.int32, device=xyz.device)
    work = torch.empty((B, N, 4), dtype=torch.int32, device=xyz.device)
    _fg_launch("ov3_sources_map", xyz.device, xyz, centers, B, N, M, nsample,
               _f32(radius * radius), src, lst, work)
    sources_map.launches += 1
    return src, lst, work


sources_map.launches = 0


def fits_sources_map(N: int, M: int, nsample: int, device: torch.device) -> bool:
    """Whether `feature_sources_map` takes this shape on `device`'s card (the
    route of csrc/feature_grad.cu, `ov3_sources_map_warps`): by the shape
    alone."""
    return _map_warps("ov3_sources_map_warps", device, N, M, nsample) > 0


def _check_sum_operands(grad_out: torch.Tensor, shape: tuple, N: int, num_channels: int,
                        what: str) -> None:
    if tuple(grad_out.shape) != (*shape, 3 + num_channels) or grad_out.dtype != torch.float32:
        raise TypeError(f"{what} expects a (B, K, M, 3 + C) f32 cotangent beside sources "
                        f"{tuple(shape)} and C = {num_channels}, got {tuple(grad_out.shape)} "
                        f"{grad_out.dtype}")
    if N < 1 or num_channels < 1:
        raise ValueError(f"{what} needs N >= 1 and C >= 1, got {N}, {num_channels}")


def feature_sum_plain(grad_out: torch.Tensor, lst: torch.Tensor, work: torch.Tensor, N: int,
                      num_channels: int) -> torch.Tensor:
    """Plain PyTorch version of `feature_sum`: each point's cotangent rows
    grad_out[..., 3:] (B, K, M, 3 + C) summed from 0 in list order (an
    accumulating `index_put_`; the list's unnamed tail goes to a spare row,
    dropped), by the list (B, K * M) and the work records (B, N, 4) of the
    inverse map -> (B, N, C) f32.  Shapes alone decide its work: a CUDA
    graph can hold it."""
    B, KM = lst.shape
    C = num_channels
    scene = torch.arange(B, device=lst.device)[:, None]
    count = torch.zeros(B, N, dtype=torch.int64, device=lst.device)
    count = count.scatter_(1, work[..., 0].long(), (work[..., 2] - work[..., 1]).long())
    place = torch.arange(KM, device=lst.device).expand(B, KM).contiguous()
    point = torch.searchsorted(torch.cumsum(count, 1), place, right=True)  # N past the named
    named = point < N
    rows = (torch.where(named, lst.long(), 0) + KM * scene).reshape(-1)
    index = torch.where(named, point + N * scene, B * N).reshape(-1)
    out = torch.zeros(B * N + 1, C, dtype=torch.float32, device=lst.device)
    out.index_put_((index,), grad_out.reshape(B * KM, 3 + C)[rows, 3:], accumulate=True)
    return out[:B * N].view(B, N, C)


def feature_sum(grad_out: torch.Tensor, lst: torch.Tensor, work: torch.Tensor, N: int,
                num_channels: int) -> torch.Tensor:
    """The sum of the feature gradient over an inverse map (`sources_map`'s
    list and work records): the cotangent (B, K, M, 3 + C) f32 -> (B, N, C)
    f32, each point's slots summed from 0 in list order.

    Launches `feature_sum` of `csrc/feature_grad.cu` for CUDA tensors
    (counted in `feature_sum.launches`; the cotangent read in place); CPU
    tensors take :func:`feature_sum_plain`, the same bits."""
    C = num_channels
    if grad_out.dim() != 4:
        raise TypeError(f"feature_sum expects a (B, K, M, 3 + C) cotangent, got "
                        f"{tuple(grad_out.shape)}")
    B, K, M = grad_out.shape[:3]
    if tuple(lst.shape) != (B, K * M) or lst.dtype != torch.int32 or \
            tuple(work.shape) != (B, N, 4) or work.dtype != torch.int32:
        raise TypeError(f"feature_sum expects an int32 list {(B, K * M)} and work records "
                        f"{(B, N, 4)}, got {tuple(lst.shape)} {lst.dtype} and "
                        f"{tuple(work.shape)} {work.dtype}")
    _check_sum_operands(grad_out, (B, K, M), N, C, "feature_sum")
    if len({grad_out.device, lst.device, work.device}) != 1:
        raise ValueError(f"feature_sum operands on several devices: {grad_out.device}, "
                         f"{lst.device}, {work.device}")
    if not _runs_kernel(lst.device, "feature_sum"):
        return feature_sum_plain(grad_out, lst, work, N, C)
    out = torch.empty((B, N, C), dtype=torch.float32, device=lst.device)
    _fg_launch("ov3_feature_sum", lst.device, grad_out.contiguous(), B, N, K * M, C,
               lst.contiguous(), work.contiguous(), out)
    feature_sum.launches += 1
    return out


feature_sum.launches = 0


def feature_scatter(src: torch.Tensor, grad_out: torch.Tensor, N: int,
                    num_channels: int) -> torch.Tensor:
    """The scatter of the feature gradient on any sources: sources (B, K, M)
    int32 (-1 throughout an empty ball) and the cotangent (B, K, M, 3 + C)
    f32 -> (B, N, C) f32, each point's slots summed from 0 in ascending slot
    order k * M + m.

    For CUDA tensors, the two launches of `csrc/feature_grad.cu`
    (`feature_map`, then `feature_sum`), counted once a call in
    `feature_scatter.launches`; the cotangent is read in place.  CPU tensors
    take :func:`_scatter`, the same bits.  The card refuses more than 65536
    slots a scene and a point axis whose map does not fit shared memory."""
    C = num_channels
    if src.dim() != 3 or src.dtype != torch.int32:
        raise TypeError(f"feature_scatter expects (B, K, M) int32 sources, got "
                        f"{tuple(src.shape)} {src.dtype}")
    _check_sum_operands(grad_out, tuple(src.shape), N, C, "feature_scatter")
    if src.device != grad_out.device:
        raise ValueError(f"feature_scatter operands on several devices: {src.device}, "
                         f"{grad_out.device}")
    if not _runs_kernel(src.device, "feature_scatter"):
        return _scatter(src, grad_out, N, C)
    B, K, M = src.shape
    KM = K * M
    if not _map_warps("ov3_feature_map_warps", src.device, N, KM):
        raise ValueError(f"feature_scatter kernel: {KM} slots and {N} points a scene do not fit "
                         "its map (at most 65536 slots, and a histogram of the points in shared "
                         "memory)")
    slots = torch.empty((B, KM), dtype=torch.int32, device=src.device)
    work = torch.empty((B, N, 4), dtype=torch.int32, device=src.device)
    out = torch.empty((B, N, C), dtype=torch.float32, device=src.device)
    _fg_launch("ov3_feature_scatter", src.device, src.contiguous(), grad_out.contiguous(), B, N,
               KM, C, slots, work, out)
    feature_scatter.launches += 1
    return out


feature_scatter.launches = 0


def feature_grad(xyz, centers, radius: float, nsample: int, grad_out: torch.Tensor,
                 num_channels: int) -> torch.Tensor:
    """The feature cotangent of the ball-group, `_bwd` of
    `ball_group_kernel.py:207-238`: (B, N, C) from the output's cotangent
    grad_out (B, K, M, 3 + C).  The picks by the expanded distance; an empty
    slot takes the first non-empty bucket's pick; an empty ball passes no
    gradient; the rest is summed onto the picked points (XLA's scatter-add
    in JAX).  For CUDA tensors :func:`sources_map` then :func:`feature_sum`,
    two launches, or, where `sources_map` does not fit the shape,
    :func:`slot_sources` then :func:`feature_scatter`; CPU tensors take the
    plain pick pass and :func:`_scatter`."""
    N = xyz.shape[1]
    if _on_cuda(xyz, None, centers, radius, nsample, "feature_grad") and \
            fits_sources_map(N, centers.shape[1], nsample, xyz.device):
        _, lst, work = sources_map(xyz, centers, radius, nsample)
        return feature_sum(grad_out, lst, work, N, num_channels)
    return feature_scatter(slot_sources(xyz, centers, radius, nsample), grad_out, N, num_channels)


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
    if not _runs_kernel(xyz.device, what):
        return False
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


def slot_sources(xyz, centers, radius: float, nsample: int,
                 _impl: Optional[str] = None) -> torch.Tensor:
    """The feature gradient's pick pass -> (B, K, M) int32: each slot's
    effective source point by the expanded distance, -1 throughout an empty
    ball.

    For CUDA tensors the source of :func:`sources_map` where that kernel
    takes the shape (its launch counted there), else
    `ball_group_tile<sources>` of csrc/ball_group.cu, the first design
    (counted in `slot_sources.launches`; the source refuses K > MAX_SLOTS,
    and the call raises).  The private `_impl = "first"` keeps a CUDA call on
    the first design, for timing and comparison on one card.  CPU tensors
    take :func:`slot_sources_plain`.
    """
    on_cuda = _on_cuda(xyz, None, centers, radius, nsample, "slot_sources")
    if _impl not in (None, "first"):
        raise ValueError(f"slot_sources: _impl is None (the route) or 'first', got {_impl!r}")
    if not on_cuda:
        if _impl is not None:
            raise ValueError("slot_sources: _impl chooses between CUDA kernels; these tensors lie "
                             "on the CPU")
        return slot_sources_plain(xyz, centers, radius, nsample)
    B, N, _ = xyz.shape
    M = centers.shape[1]
    if _impl is None and fits_sources_map(N, M, nsample, xyz.device):
        return sources_map(xyz, centers, radius, nsample)[0]
    src = torch.empty((B, nsample, M), dtype=torch.int32, device=xyz.device)
    _launch("ov3_ball_group_sources", xyz.device, xyz, centers, B, N, M, nsample,
            _f32(radius * radius), src)
    slot_sources.launches += 1
    return src


slot_sources.launches = 0

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SCATTER_SIGNATURES = {
    "ov3_feature_map_warps": ([_I, _I, ctypes.POINTER(_I)], _I),
    "ov3_sources_map_warps": ([_I, _I, _I, ctypes.POINTER(_I)], _I),
    "ov3_sources_map": ([_P, _P] + [_I] * 4 + [_F, _P, _P, _P, _P], _I),
    "ov3_feature_map": ([_P, _I, _I, _I, _P, _P, _P], _I),
    "ov3_feature_sum": ([_P, _I, _I, _I, _I, _P, _P, _P, _P], _I),
    "ov3_feature_scatter": ([_P, _P, _I, _I, _I, _I, _P, _P, _P, _P], _I),
}
_SIGNATURES = {
    "ov3_ball_group": ([_P] * 3 + [_I] * 5 + [_F, _F, _P, _P, _P], ctypes.c_int),
    "ov3_ball_group_first": ([_P] * 3 + [_I] * 5 + [_F, _F, _P, _P, _P], ctypes.c_int),
    "ov3_ball_group_sources": ([_P] * 2 + [_I] * 4 + [_F, _P, _P], ctypes.c_int),
}

