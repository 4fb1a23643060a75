"""The first-K ball query: the CUDA kernel's wrapper and its plain version.

The kernel (`ov3det_torch/csrc/first_k.cu`) replaces `ball_query(method=
"first_k")` (`ov3det/ops/pointcloud.py:168-225`), a top_k over index scores
that XLA runs on the TPU (not a Pallas kernel): for each center the first
`nsample` points in index order whose squared distance, in the expanded,
clamped form of `_pairwise_d2` (`:156-165`), lies below r^2, the tail past
the ball's count filled with its first hit, an empty ball all 0 (as JAX's
top_k leaves it).  One warp tests a few centers against the points in index
order and stops at their nsample-th hit; one launch for all centers.

The plain version (`first_k_plain`) finds the hits as the `nsample`
smallest int32 index scores (`torch.topk`), the centers in chunks so that
the (B, chunk, N) distances stay near `FIRST_K_ELEMENTS`: the CPU path, and
the kernel's oracle on the card.  Both take nsample up to `MAX_NSAMPLE` (the
kernel keeps a tile's picks in shared memory) and at most N, and return
(B, M, nsample) int64 indices.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ov3det_torch.ops.kernels import _build
from ov3det_torch.ops.kernels.ball_group import _d2_expanded

SOURCE = "ov3det_torch/csrc/first_k.cu"
REPLACES = ('ov3det/ops/pointcloud.py:168 (ball_query method="first_k": top_k over index '
            'scores, XLA, not Pallas)')
MAX_NSAMPLE = 128  # kMaxSample of csrc/first_k.cu
# the (B, chunk, N) distances and scores of the plain version hold at most
# about this many elements: 8 x 40 000 points take chunks of 104 centers
FIRST_K_ELEMENTS = 1 << 25


def _r2(radius: float) -> float:
    """The f32 value of radius^2, as the JAX code's weak float becomes f32."""
    return float(np.float32(radius * radius))


def _check(xyz: torch.Tensor, centers: torch.Tensor, radius: float, nsample: int) -> None:
    if xyz.dim() != 3 or xyz.shape[-1] != 3 or centers.dim() != 3 or centers.shape[-1] != 3:
        raise ValueError(f"first_k expects xyz (B, N, 3) and centers (B, M, 3), got "
                         f"{tuple(xyz.shape)} and {tuple(centers.shape)}")
    if centers.shape[0] != xyz.shape[0] or xyz.shape[0] < 1 or centers.shape[1] < 1:
        raise ValueError(f"first_k needs scenes and centers, one set a scene: xyz "
                         f"{tuple(xyz.shape)}, centers {tuple(centers.shape)}")
    if xyz.dtype != torch.float32 or centers.dtype != torch.float32:
        raise TypeError(f"first_k expects float32 tensors, got {xyz.dtype} and {centers.dtype}")
    if not 1 <= nsample <= min(MAX_NSAMPLE, xyz.shape[1]):
        raise ValueError(f"first_k takes 1 <= nsample <= min({MAX_NSAMPLE}, N = {xyz.shape[1]}) "
                         f"(the kernel keeps {MAX_NSAMPLE} picks a center in shared memory), got "
                         f"{nsample}")
    if xyz.device != centers.device:
        raise ValueError(f"first_k operands on several devices: {xyz.device}, {centers.device}")


def first_k_plain(xyz: torch.Tensor, centers: torch.Tensor, radius: float,
                  nsample: int) -> torch.Tensor:
    """Plain PyTorch first-K query: xyz (B, N, 3), centers (B, M, 3) f32 ->
    (B, M, nsample) int64, the centers in chunks of about `FIRST_K_ELEMENTS`
    (B, chunk, N) distances."""
    B, N, _ = xyz.shape
    M = centers.shape[1]
    # device scalars filled on the device (no copy from the host: a CUDA
    # graph captures the first-K request too)
    r2 = torch.full((), _r2(radius), dtype=torch.float32, device=xyz.device)
    past = torch.full((), N, dtype=torch.int32, device=xyz.device)
    order = torch.arange(N, dtype=torch.int32, device=xyz.device)
    chunk = max(1, FIRST_K_ELEMENTS // max(1, B * N))
    out = []
    for m in range(0, M, chunk):
        in_ball = _d2_expanded(centers[:, m:m + chunk])(xyz) < r2  # (B, m, N)
        # in-ball points score their index, the others N: the nsample
        # smallest scores are the first hits, ascending
        scores = torch.where(in_ball, order, past)
        first = torch.topk(scores, nsample, dim=-1, largest=False, sorted=True).values
        count = in_ball.sum(-1, keepdim=True)
        head = torch.where(count > 0, first[..., :1], torch.zeros_like(first[..., :1]))
        slot = torch.arange(nsample, device=xyz.device)
        out.append(torch.where(slot < count, first, head).long())
    return torch.cat(out, dim=1)


def first_k(xyz: torch.Tensor, centers: torch.Tensor, radius: float, nsample: int) -> torch.Tensor:
    """First-K fixed-radius neighbourhoods: xyz (B, N, 3), centers (B, M, 3)
    f32 -> (B, M, nsample) int64 indices into xyz.

    CUDA tensors launch the kernel, one launch for all centers with no host
    wait, counted in `first_k.launches`; a failed launch raises.  CPU
    tensors take :func:`first_k_plain`, whose chunks of centers are a CPU
    memory measure (the kernel holds no such temporary).  nsample is
    checked on both routes."""
    _check(xyz, centers, radius, nsample)
    if xyz.device.type == "cpu":
        return first_k_plain(xyz, centers, radius, nsample)
    if xyz.device.type != "cuda":
        raise ValueError(f"first_k runs on cuda or cpu tensors, got {xyz.device}")
    B, N, _ = xyz.shape
    M = centers.shape[1]
    out = torch.empty((B, M, nsample), dtype=torch.int64, device=xyz.device)
    lib = _build.load("first_k", _SIGNATURES)
    with torch.cuda.device(xyz.device):
        xyz, centers = xyz.contiguous(), centers.contiguous()
        status = lib.ov3_first_k(xyz.data_ptr(), centers.data_ptr(), B, N, M, nsample,
                                 ctypes.c_float(_r2(radius)), out.data_ptr(),
                                 torch.cuda.current_stream().cuda_stream)
    _build.check(lib, status, "first_k")
    first_k.launches += 1
    return out


first_k.launches = 0

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"ov3_first_k": ([_P, _P, _I, _I, _I, _I, ctypes.c_float, _P, _P], _I)}
