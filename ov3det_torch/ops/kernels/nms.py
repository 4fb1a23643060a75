"""Greedy NMS keep masks: the CUDA kernel's wrapper and its plain version.

The kernel (`ov3det_torch/csrc/nms.cu`) is the counterpart of
`_greedy_suppress` (`ov3det/geometry/nms.py:38-61`), a `lax.fori_loop` that
XLA runs on the TPU (not a Pallas kernel), with the overlap matrix of
`_aabb_overlap_matrix` (`:21-35`) built inside it, one launch for a whole
batch.  Two designs compute it: `nms_cluster_kernel` (a thread-block
cluster of `cluster_size_for(K)` CTAs a scene, the suppression bitmask in
rank order, a greedy pass that steps through the kept boxes alone) for
every K, and the first design, `nms_kernel` (one CTA a scene), which the
private `_impl="first"` keeps reachable on the card as a yardstick.

The plain version (`nms_plain`) builds the (B, K, K) overlap with torch ops
and runs JAX's K rounds of argmax and suppression for the whole batch: the
CPU path, and the kernel's oracle on the card.  Both keep exactly the same
boxes: the kernel computes each overlap in the plain version's operation
order with no contracted multiply-adds, NaN propagating through the min,
max and clamps as in torch, and its greedy pass visits the boxes in the
order the rounds' argmax picks them (NaN first, then descending score, ties
to the lowest index).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ov3det_torch.ops.kernels import _build

SOURCE = "ov3det_torch/csrc/nms.cu"
REPLACES = "ov3det/geometry/nms.py:38 (_greedy_suppress: lax.fori_loop, XLA, not Pallas)"
MAX_K = 1024  # boxes a scene the kernel holds in shared memory (csrc/nms.cu kMaxK)
MAX_CLUSTER = 8  # CTAs a scene of the cluster design (kMaxCluster): the portable limit
THREADS = 256  # a CTA's threads (kThreads)

_NEG_INF = -1e30


def _aabb_overlap_matrix(mins: torch.Tensor, maxs: torch.Tensor, old_type: bool) -> torch.Tensor:
    """(B, K, D) mins / maxs, D = 2 or 3 -> (B, K, K) pairwise overlap: IoU,
    or with `old_type` the intersection over the other (column) box's
    volume (`ov3det/geometry/nms.py:21-35`).  Products run left to right."""
    inter = torch.clamp(
        torch.minimum(maxs[:, :, None, :], maxs[:, None, :, :])
        - torch.maximum(mins[:, :, None, :], mins[:, None, :, :]),
        min=0.0,
    )
    ext = maxs - mins
    inter_vol, vol = inter[..., 0], ext[..., 0]
    for d in range(1, mins.shape[-1]):
        inter_vol = inter_vol * inter[..., d]
        vol = vol * ext[..., d]
    if old_type:
        return inter_vol / torch.clamp(vol[:, None, :], min=1e-12)
    union = vol[:, :, None] + vol[:, None, :] - inter_vol
    return inter_vol / torch.clamp(union, min=1e-12)


def nms_plain(boxes: torch.Tensor, scores: torch.Tensor, threshold: float, valid: torch.Tensor,
              classes: Optional[torch.Tensor] = None, old_type: bool = False) -> torch.Tensor:
    """Plain PyTorch greedy NMS over a batch: boxes (B, K, 2D) [mins, maxs],
    scores (B, K), valid (B, K) bool, classes (B, K) or None (class-agnostic)
    -> (B, K) bool keep mask.  JAX's K rounds: the argmax of the alive
    scores (NaN first, ties to the lowest index) is kept when its score
    exceeds -5e29, and the boxes it overlaps by more than `threshold` (of
    its class, with `classes`) die with it; an invalid box is never kept."""
    B, K = scores.shape
    D = boxes.shape[-1] // 2
    overlap = _aabb_overlap_matrix(boxes[..., :D], boxes[..., D:], old_type)
    if classes is not None:
        overlap = overlap * (classes[:, :, None] == classes[:, None, :])
    suppresses = overlap > threshold  # (B, K, K)
    rows = torch.arange(B, device=scores.device)
    keep = torch.zeros_like(valid)
    alive = valid.clone()
    neg = torch.full_like(scores, _NEG_INF)
    for _ in range(K):
        masked = torch.where(alive, scores, neg)
        i = torch.argmax(masked, dim=1)  # (B,)
        has = masked[rows, i] > _NEG_INF / 2
        keep[rows, i] |= has
        alive &= ~(suppresses[rows, i] & has[:, None])
        alive[rows, i] = False
    return keep


def cluster_size_for(K: int) -> int:
    """The cluster design's CTAs a scene for K boxes (`cluster_size_for` of
    csrc/nms.cu): one a 32 boxes, at most `MAX_CLUSTER`."""
    return -(-K // 32) if K <= 32 * MAX_CLUSTER else MAX_CLUSTER


def rank_threads_for(per_cta: int) -> int:
    """Threads that count one box's rank together (`rank_threads_for`): the
    largest power of two up to 32 such that a CTA's `per_cta` boxes take at
    most its threads."""
    t = 32
    while t > 1 and t * per_cta > THREADS:
        t >>= 1
    return t


def _entry(impl: Optional[str], on_cuda: bool) -> str:
    """The C entry point for the private `_impl` argument: None is the
    cluster design, "first" the first design."""
    if impl is None:
        return "ov3_nms"
    if impl != "first":
        raise ValueError(f"nms: _impl is None (the cluster design) or 'first', got {impl!r}")
    if not on_cuda:
        raise ValueError("nms: _impl chooses between CUDA kernels; these tensors lie on the CPU")
    return "ov3_nms_first"


def _check(boxes, scores, valid, classes) -> None:
    if boxes.dim() != 3 or boxes.shape[-1] not in (4, 6) or boxes.dtype != torch.float32:
        raise ValueError(f"nms expects (B, K, 4) or (B, K, 6) f32 boxes, got "
                         f"{tuple(boxes.shape)} {boxes.dtype}")
    B, K = boxes.shape[:2]
    if tuple(scores.shape) != (B, K) or scores.dtype != torch.float32:
        raise ValueError(f"nms expects (B, K) f32 scores, got {tuple(scores.shape)} {scores.dtype}")
    if tuple(valid.shape) != (B, K) or valid.dtype != torch.bool:
        raise ValueError(f"nms expects a (B, K) bool valid mask, got {tuple(valid.shape)} "
                         f"{valid.dtype}")
    operands = [boxes, scores, valid]
    if classes is not None:
        if tuple(classes.shape) != (B, K) or classes.dtype != torch.int64:
            raise ValueError(f"nms expects (B, K) int64 classes, got {tuple(classes.shape)} "
                             f"{classes.dtype}")
        operands.append(classes)
    devices = {t.device for t in operands}
    if len(devices) != 1:
        raise ValueError(f"nms operands on several devices: {devices}")


def nms_keep(boxes: torch.Tensor, scores: torch.Tensor, threshold: float, valid: torch.Tensor,
             classes: Optional[torch.Tensor] = None, old_type: bool = False,
             _impl: Optional[str] = None) -> torch.Tensor:
    """Greedy NMS over a batch: boxes (B, K, 4) or (B, K, 6) f32 [mins,
    maxs], scores (B, K) f32, valid (B, K) bool, classes (B, K) int64 for
    the class-aware variant or None -> (B, K) bool keep mask.

    CUDA tensors launch the kernel (K up to `MAX_K`; a larger K raises),
    one launch for the batch with no host wait, of the cluster design or,
    with `_impl="first"`, of the first design; CPU tensors take
    :func:`nms_plain`."""
    _check(boxes, scores, valid, classes)
    entry = _entry(_impl, boxes.device.type == "cuda")
    if boxes.device.type == "cpu":
        return nms_plain(boxes, scores, threshold, valid, classes, old_type)
    if boxes.device.type != "cuda":
        raise ValueError(f"nms runs on cuda or cpu tensors, got {boxes.device}")
    B, K = scores.shape
    if K > MAX_K:
        raise ValueError(f"nms kernel holds at most {MAX_K} boxes a scene in shared memory, got {K}")
    keep = torch.empty((B, K), dtype=torch.bool, device=boxes.device)
    lib = _lib()
    with torch.cuda.device(boxes.device):
        boxes, scores = boxes.contiguous(), scores.contiguous()
        live = valid.contiguous().view(torch.uint8)
        cls = classes.contiguous() if classes is not None else None
        stream = torch.cuda.current_stream().cuda_stream
        status = getattr(lib, entry)(boxes.data_ptr(), scores.data_ptr(),
                                     cls.data_ptr() if cls is not None else None,
                                     live.data_ptr(), B, K, boxes.shape[-1] // 2,
                                     ctypes.c_float(threshold), int(old_type), keep.data_ptr(),
                                     stream)
    _build.check(lib, status, "nms")
    nms_keep.launches += 1
    return keep


nms_keep.launches = 0

_SIGNATURES = {
    name: ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int]
           + [ctypes.c_void_p] * 2, ctypes.c_int)
    for name in ("ov3_nms", "ov3_nms_first")
}


def _lib() -> ctypes.CDLL:
    return _build.load("nms", _SIGNATURES)
