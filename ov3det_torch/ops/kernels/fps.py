"""Furthest-point sampling: the CUDA kernel's wrapper and its plain version.

The kernel (`ov3det_torch/csrc/fps.cu`) replaces the Pallas TPU kernel
`_fps_kernel` (`ov3det/ops/pallas/fps_kernel.py:25`).  Semantics: exact
greedy FPS, seed index 0, ties to the lowest index.
"""
from __future__ import annotations

import ctypes

import torch

from ov3det_torch.ops.kernels import _build

SOURCE = "ov3det_torch/csrc/fps.cu"
REPLACES = "ov3det/ops/pallas/fps_kernel.py:25"


def fps_plain(xyz: torch.Tensor, num_samples: int) -> torch.Tensor:
    """Plain PyTorch FPS: (B, N, 3) f32 -> (B, num_samples) int64.

    The loop of `ov3det/ops/pointcloud.py:134-148` with shards=1, with d2
    written as (dx*dx + dy*dy) + dz*dz like the kernels.
    """
    B, N, _ = xyz.shape
    rows = torch.arange(B, device=xyz.device)
    inds = torch.zeros((B, num_samples), dtype=torch.int64, device=xyz.device)
    min_d2 = torch.full((B, N), 1e10, dtype=torch.float32, device=xyz.device)
    last = xyz[:, 0, :]
    for i in range(1, num_samples):
        d = xyz - last[:, None, :]
        dx, dy, dz = d.unbind(-1)
        d2 = (dx * dx + dy * dy) + dz * dz
        min_d2 = torch.minimum(min_d2, d2)
        nxt = torch.argmax(min_d2, dim=-1)  # first maximum: ties to the lowest index
        inds[:, i] = nxt
        last = xyz[rows, nxt]
    return inds


def fps(xyz: torch.Tensor, num_samples: int) -> torch.Tensor:
    """(B, N, 3) f32 -> (B, num_samples) int64 indices.

    Launches the CUDA kernel for a CUDA tensor; a CPU tensor takes
    :func:`fps_plain`.
    """
    if xyz.dim() != 3 or xyz.shape[-1] != 3:
        raise ValueError(f"fps expects (B, N, 3) points, got {tuple(xyz.shape)}")
    if xyz.dtype != torch.float32:
        raise TypeError(f"fps expects float32 points, got {xyz.dtype}")
    if num_samples < 1:
        raise ValueError(f"num_samples must be >= 1, got {num_samples}")
    if xyz.device.type == "cpu":
        return fps_plain(xyz, num_samples)
    if xyz.device.type != "cuda":
        raise ValueError(f"fps runs on cuda or cpu tensors, got {xyz.device}")
    if not xyz.is_contiguous():
        raise ValueError("fps expects a contiguous tensor")
    B, N, _ = xyz.shape
    lib = _lib()
    if N > lib.ov3_fps_max_points():
        raise ValueError(f"fps kernel takes at most {lib.ov3_fps_max_points()} points, got {N}")
    out = torch.empty((B, num_samples), dtype=torch.int64, device=xyz.device)
    with torch.cuda.device(xyz.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.ov3_fps(xyz.data_ptr(), B, N, num_samples, out.data_ptr(), stream)
    _build.check(lib, status, "fps")
    fps.launches += 1
    return out


fps.launches = 0


_SIGNATURES = {
    "ov3_fps": ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                 ctypes.c_void_p, ctypes.c_void_p], ctypes.c_int),
    "ov3_fps_max_points": ([], ctypes.c_int),
}


def _lib() -> ctypes.CDLL:
    return _build.load("fps", _SIGNATURES)
