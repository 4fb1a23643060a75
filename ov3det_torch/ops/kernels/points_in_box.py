"""The parse's empty-box test: the CUDA kernel's wrapper and its plain version.

The kernel (`ov3det_torch/csrc/points_in_box.cu`) replaces
`points_in_box_counts` (`ov3det/eval/parse.py:28-48`), which XLA runs on the
TPU (not a Pallas kernel): the count of scene points inside each predicted
box, a point being inside when its projections on the box's three edges at
corner 0 lie within [-eps, |edge|^2 + eps].  One launch a parse, with no
temporary in device memory, of one of two designs: `points_in_box_cluster`
(a thread-block cluster of CTAs a scene and tile of 16 boxes, each CTA a
contiguous slice of the points staged by cp.async, a thread 4 boxes in
registers, the partial counts summed by DSMEM in the leader CTA), the route
for every call; and the first design, `points_in_box_kernel` (a CTA a scene
and 8 boxes, a thread one box), which the private `_impl="first"` keeps
reachable on the card as a yardstick.

The plain version (`points_in_box_plain`) is the same function with torch
ops in the kernel's operation order, every product and sum rounded on its
own ((r0*e0 + r1*e1) + r2*e2, no matmul and no `.sum` over the three axes,
whose order a library chooses), chunked over the boxes so that the (B,
chunk, N) temporaries stay near `PLAIN_ELEMENTS`: the CPU path, and the
kernel's oracle on the card.  Both give (B, K) int32 counts, the dtype of
the JAX function's.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from ov3det_torch.ops.kernels import _build

SOURCE = "ov3det_torch/csrc/points_in_box.cu"
REPLACES = "ov3det/eval/parse.py:28 (points_in_box_counts: XLA, not Pallas)"
EPS = float(np.float32(1e-6))  # the faces' margin, as the JAX code's weak float becomes f32
# the routed design's split (csrc/points_in_box.cu), mirrored by the CPU
# tests' emulation: boxes a CTA (kClusterTile), a thread's boxes
# (kBoxesPerThread), the points a CTA of the cluster takes at the fewest
# (kSliceMin) and at most (kMaxCluster) CTAs a cluster
CLUSTER_TILE = 16
BOXES_PER_THREAD = 4
SLICE_MIN = 512
MAX_CLUSTER = 8
# the (B, chunk, N) temporaries of the plain version hold at most about this
# many elements: 8 x 40 000 points take chunks of 26 boxes
PLAIN_ELEMENTS = 1 << 23


def _check(points: torch.Tensor, corners: torch.Tensor) -> None:
    if points.dim() != 3 or points.shape[-1] != 3 or points.dtype != torch.float32:
        raise ValueError(f"points_in_box expects (B, N, 3) f32 points, got {tuple(points.shape)} "
                         f"{points.dtype}")
    if (corners.dim() != 4 or corners.shape[0] != points.shape[0] or corners.shape[2:] != (8, 3)
            or corners.dtype != torch.float32):
        raise ValueError(f"points_in_box expects (B, K, 8, 3) f32 corners beside points "
                         f"{tuple(points.shape)}, got {tuple(corners.shape)} {corners.dtype}")
    if points.shape[0] < 1 or corners.shape[1] < 1:
        raise ValueError(f"points_in_box needs a scene and a box, got {tuple(corners.shape)}")
    if points.device != corners.device:
        raise ValueError(f"points_in_box operands on several devices: {points.device}, "
                         f"{corners.device}")


def points_in_box_plain(points: torch.Tensor, corners: torch.Tensor,
                        chunk: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch empty-box test: points (B, N, 3) upright-depth, corners
    (B, K, 8, 3) camera coordinates -> (B, K) int32 counts of the points
    inside each box, `chunk` boxes at a time (default: as many as keep the
    temporaries near `PLAIN_ELEMENTS`)."""
    B, N, _ = points.shape
    K = corners.shape[1]
    if chunk is None:
        chunk = max(1, PLAIN_ELEMENTS // max(1, B * N))
    # the box in depth coordinates (x, z, -y), its origin at corner 0 and
    # its edges to corners 1, 3 and 4
    depth = torch.stack([corners[..., 0], corners[..., 2], -corners[..., 1]], dim=-1)
    origin = depth[:, :, 0]  # (B, K, 3)
    edges = [depth[:, :, j] - origin for j in (1, 3, 4)]  # (B, K, 3) each
    his = [((e[..., 0] * e[..., 0] + e[..., 1] * e[..., 1]) + e[..., 2] * e[..., 2]) + EPS
           for e in edges]  # (B, K) each
    counts = []
    for k in range(0, K, chunk):
        box = slice(k, k + chunk)
        rel = [points[:, None, :, a] - origin[:, box, a, None] for a in range(3)]  # (B, c, N)
        inside = None
        for e, hi in zip(edges, his):
            e = e[:, box, :, None]
            proj = (rel[0] * e[:, :, 0] + rel[1] * e[:, :, 1]) + rel[2] * e[:, :, 2]
            face = (proj >= -EPS) & (proj <= hi[:, box, None])
            inside = face if inside is None else inside & face
        counts.append(inside.sum(dim=-1, dtype=torch.int32))
    return torch.cat(counts, dim=1)


def cluster_size_for(N: int) -> int:
    """CTAs of the routed design's cluster for N points (`cluster_size_for`
    of csrc/points_in_box.cu): one a `SLICE_MIN` points, 1 to
    `MAX_CLUSTER`."""
    return 1 if N <= SLICE_MIN else min(-(-N // SLICE_MIN), MAX_CLUSTER)


def _entry(impl: Optional[str], on_cuda: bool) -> str:
    """The C entry point for the private `_impl` argument: None is the
    routed design, "first" the first design."""
    if impl is None:
        return "ov3_points_in_box"
    if impl != "first":
        raise ValueError(f"points_in_box: _impl is None (the routed design) or 'first', got "
                         f"{impl!r}")
    if not on_cuda:
        raise ValueError("points_in_box: _impl chooses between CUDA kernels; these tensors lie "
                         "on the CPU")
    return "ov3_points_in_box_first"


def points_in_box(points: torch.Tensor, corners: torch.Tensor,
                  _impl: Optional[str] = None) -> torch.Tensor:
    """Count the points inside each box: points (B, N, 3) f32 upright-depth,
    corners (B, K, 8, 3) f32 camera coordinates -> (B, K) int32.

    CUDA tensors launch the kernel, one launch for the batch with no host
    wait, of the routed design or, with `_impl="first"`, of the first
    design, counted in `points_in_box.launches` either way; a failed launch
    raises.  CPU tensors take :func:`points_in_box_plain`."""
    _check(points, corners)
    entry = _entry(_impl, points.device.type == "cuda")
    if points.device.type == "cpu":
        return points_in_box_plain(points, corners)
    if points.device.type != "cuda":
        raise ValueError(f"points_in_box runs on cuda or cpu tensors, got {points.device}")
    B, N, _ = points.shape
    K = corners.shape[1]
    counts = torch.empty((B, K), dtype=torch.int32, device=points.device)
    lib = _build.load("points_in_box", _SIGNATURES)
    with torch.cuda.device(points.device):
        points, corners = points.contiguous(), corners.contiguous()
        status = getattr(lib, entry)(points.data_ptr(), corners.data_ptr(), B, N, K,
                                     ctypes.c_float(EPS), counts.data_ptr(),
                                     torch.cuda.current_stream().cuda_stream)
    _build.check(lib, status, "points_in_box")
    points_in_box.launches += 1
    return counts


points_in_box.launches = 0

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {name: ([_P, _P, _I, _I, _I, ctypes.c_float, _P, _P], _I)
               for name in ("ov3_points_in_box", "ov3_points_in_box_first")}
