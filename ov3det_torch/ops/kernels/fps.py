"""Furthest-point sampling: the CUDA kernel's wrapper and its plain version.

The kernel (`ov3det_torch/csrc/fps.cu`) replaces the Pallas TPU kernel
`_fps_kernel` (`ov3det/ops/pallas/fps_kernel.py:25`).  Semantics: exact
greedy FPS, seed index 0, ties to the lowest index.

The source holds two designs.  `fps` launches the one written for this
card: a thread-block cluster per scene, whose size depends on N alone
(`cluster_size`, mirrored from `cluster_size_for` of the source), points in
registers, an integer argmax by warp `redux` and one exchange through
distributed shared memory (`st.async` onto an mbarrier) a step.  The first
design (one CTA of 1024 threads a scene) stays as the yardstick: the
private `_impl="first"` keeps a CUDA call on it, so that the two can be
timed and compared on one card.  Both count in `fps.launches`.
"""
from __future__ import annotations

import ctypes
from typing import Optional

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


# `cluster_size_for` of csrc/fps.cu: scenes of up to this many points take one
# CTA and a cluster of 4, larger ones a cluster of 8
_CLUSTER_STEPS = ((1024, 1), (8192, 4))
_CLUSTER_LARGEST = 8
CLUSTER_THREADS = 256  # threads of a CTA of the cluster design


def cluster_size(num_points: int) -> int:
    """CTAs per scene that `fps` launches for scenes of `num_points` points."""
    for limit, size in _CLUSTER_STEPS:
        if num_points <= limit:
            return size
    return _CLUSTER_LARGEST


def _entry(impl: Optional[str], on_cuda: bool) -> str:
    """The C entry point for the private `_impl` argument: None is the route
    by N, "first" the first design whatever N."""
    if impl is None:
        return "ov3_fps"
    if impl != "first":
        raise ValueError(f"fps: _impl is None (the route by N) or 'first', got {impl!r}")
    if not on_cuda:
        raise ValueError("fps: _impl chooses between CUDA kernels; this tensor lies on the CPU")
    return "ov3_fps_first"


def _on_cuda(xyz: torch.Tensor, num_samples: int) -> bool:
    """Validate the operands; True when the cloud lies on a CUDA device (a
    kernel runs), False on the CPU (the plain version runs)."""
    if xyz.dim() != 3 or xyz.shape[-1] != 3:
        raise ValueError(f"fps expects (B, N, 3) points, got {tuple(xyz.shape)}")
    if xyz.dtype != torch.float32:
        raise TypeError(f"fps expects float32 points, got {xyz.dtype}")
    if num_samples < 1:
        raise ValueError(f"num_samples must be >= 1, got {num_samples}")
    if xyz.device.type == "cpu":
        return False
    if xyz.device.type != "cuda":
        raise ValueError(f"fps runs on cuda or cpu tensors, got {xyz.device}")
    if not xyz.is_contiguous():
        raise ValueError("fps expects a contiguous tensor")
    return True


def _launch(xyz: torch.Tensor, num_samples: int, entry: str, *extra: int) -> torch.Tensor:
    """Run the C entry point `entry(xyz, B, N, K, *extra, out, stream)` on a
    validated CUDA cloud."""
    B, N, _ = xyz.shape
    lib = _lib()
    if N > lib.ov3_fps_max_points():
        raise ValueError(f"fps kernel takes at most {lib.ov3_fps_max_points()} points, got {N}")
    out = torch.empty((B, num_samples), dtype=torch.int64, device=xyz.device)
    with torch.cuda.device(xyz.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = getattr(lib, entry)(xyz.data_ptr(), B, N, num_samples, *extra, out.data_ptr(),
                                     stream)
    _build.check(lib, status, "fps")
    return out


def fps(xyz: torch.Tensor, num_samples: int, _impl: Optional[str] = None) -> torch.Tensor:
    """(B, N, 3) f32 -> (B, num_samples) int64 indices.

    Launches the CUDA kernel for a CUDA tensor; a CPU tensor takes
    :func:`fps_plain`.
    """
    on_cuda = _on_cuda(xyz, num_samples)
    entry = _entry(_impl, on_cuda)
    if not on_cuda:
        return fps_plain(xyz, num_samples)
    out = _launch(xyz, num_samples, entry)
    fps.launches += 1
    return out


fps.launches = 0


def plan(batch: int, num_points: int) -> dict:
    """What `fps` launches for `batch` scenes of `num_points` points on the
    current card: the cluster size, the CTAs of the launch, the threads of a
    CTA and how many such clusters the card holds at once.  Raises if the
    card cannot schedule the cluster at all."""
    lib = _lib()
    got = (ctypes.c_int * 4)()
    _build.check(lib, lib.ov3_fps_plan(batch, num_points, got), "fps plan")
    if got[0] != cluster_size(num_points):
        raise RuntimeError(f"fps: the source routes N={num_points} to a cluster of {got[0]}, "
                           f"this module to {cluster_size(num_points)}")
    return dict(cluster=got[0], ctas=got[1], threads=got[2], clusters_at_once=got[3])


def chain(batch: int, num_samples: int, cluster: int, device) -> torch.Tensor:
    """Launches the chain alone: `num_samples - 1` steps of the cluster
    design's reductions, exchange and wait on no points, for `batch`
    clusters of `cluster` CTAs.  A measuring aid (its time is the floor of a
    call with that many samples); it counts no launch.  Returns the (batch,
    num_samples) zeros the kernel wrote."""
    lib = _lib()
    out = torch.empty((batch, num_samples), dtype=torch.int64, device=device)
    origin = torch.zeros(3, dtype=torch.float32, device=device)  # point 0 of every "scene"
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.ov3_fps_chain(origin.data_ptr(), batch, num_samples, cluster,
                                   out.data_ptr(), stream)
    _build.check(lib, status, "fps chain")
    return out


def with_cluster(xyz: torch.Tensor, num_samples: int, cluster: int) -> torch.Tensor:
    """The cluster design with `cluster` CTAs a scene instead of the route's:
    a measuring aid for choosing the route; it counts no launch."""
    if not _on_cuda(xyz, num_samples):
        raise ValueError("fps: a cluster size applies to CUDA tensors only")
    return _launch(xyz, num_samples, "ov3_fps_cluster", cluster)


_FPS_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p]
_SIGNATURES = {
    "ov3_fps": (_FPS_ARGS, ctypes.c_int),
    "ov3_fps_first": (_FPS_ARGS, ctypes.c_int),
    "ov3_fps_cluster": ([ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2,
                        ctypes.c_int),
    "ov3_fps_chain": ([ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2,
                      ctypes.c_int),
    "ov3_fps_plan": ([ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)], ctypes.c_int),
    "ov3_fps_max_points": ([], ctypes.c_int),
}


def _lib() -> ctypes.CDLL:
    return _build.load("fps", _SIGNATURES)
