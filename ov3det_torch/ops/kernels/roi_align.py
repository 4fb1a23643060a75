"""The teacher's RoIAlign: the CUDA kernel's wrapper.

The kernel (`ov3det_torch/csrc/roi_align.cu`) replaces `roi_align_batched`
(`ov3det/ops/roi_align.py:83-151`), which XLA runs on the TPU as two batched
contractions (not a Pallas kernel); in the reference it is detectron2's
ROIAlign CUDA kernel.  The routed design (`roi_align_rows`): a CTA a
(region, slice of `GROUPS` x 8 channels), a thread an output column and 8
channels, walking the output rows in order; it forms each column's
contribution cols[j, h] of a live map row once (its at most 4 source pixels
read from the feature map, which stays in L2, by 16-byte loads), keeps the
last `RING` it formed in shared memory, and adds each output row's at most 4
live rows from there: no intermediate in device memory, and no map row's
columns formed again for the next output row.  The first design
(`roi_align_kernel`, a CTA a region and output row, forming each output
row's columns itself), which the private `_impl="first"` keeps, is the
yardstick.  Both sum in the order of `ops/roi_align.roi_align_plain`, every
product and sum rounded on its own, so the three agree bit for bit (NaN rows
included).

`roi_align` takes f32 or bf16 features (B, H, W, C) and f32 boxes (R, 4);
the region's image is `box_index[r]`, or r // per_image when `box_index` is
None (the batched form, with no index tensor).  CUDA tensors launch the
kernel, one launch a call with no host wait, counted in `roi_align.launches`
whichever design runs; CPU tensors take `roi_align_plain`.  The kernel takes C a multiple of 8,
16-byte aligned features, output sizes up to `MAX_OUTPUT` and sampling
ratio 2 (the only one either package calls); any other call raises.  A
region whose image index lies outside [0, B) comes out NaN on the card.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ov3det_torch.ops.kernels import _build

SOURCE = "ov3det_torch/csrc/roi_align.cu"
REPLACES = "ov3det/ops/roi_align.py:83 (roi_align_batched: XLA, not Pallas)"
MAX_OUTPUT = 18  # kMaxOutput of csrc/roi_align.cu: the pooler's 18 x 18
SAMPLING_RATIO = 2
# csrc/roi_align.cu, the routed design: kGroups (channel groups of 8 a CTA),
# kRing (map rows a thread keeps formed)
GROUPS = 16
RING = 4
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(features: torch.Tensor, boxes: torch.Tensor, box_index: Optional[torch.Tensor],
           output_size: int, sampling_ratio: int, per_image: Optional[int]) -> None:
    """The checks on either device."""
    if features.dim() != 4 or features.dtype not in _DTYPES:
        raise ValueError(f"roi_align expects (B, H, W, C) f32 or bf16 features, got "
                         f"{tuple(features.shape)} {features.dtype}")
    if boxes.dim() != 2 or boxes.shape[1] != 4 or not boxes.dtype.is_floating_point:
        raise ValueError(f"roi_align expects (R, 4) float boxes, got {tuple(boxes.shape)} "
                         f"{boxes.dtype}")
    if sampling_ratio != SAMPLING_RATIO:
        raise ValueError(f"roi_align: sampling_ratio {SAMPLING_RATIO} only, got {sampling_ratio}")
    if output_size < 1:
        raise ValueError(f"roi_align: output_size must be positive, got {output_size}")
    if box_index is None:
        if per_image is None or per_image < 1:
            raise ValueError("roi_align: without box_index, per_image (regions an image) must "
                             f"be positive, got {per_image}")
        if boxes.shape[0] != features.shape[0] * per_image:
            raise ValueError(f"roi_align: {boxes.shape[0]} boxes for {features.shape[0]} images "
                             f"of {per_image}")
    elif (box_index.shape != boxes.shape[:1] or box_index.dtype.is_floating_point
          or box_index.dtype == torch.bool):
        raise ValueError(f"roi_align expects an integer (R,) box_index beside {boxes.shape[0]} "
                         f"boxes, got {tuple(box_index.shape)} {box_index.dtype}")
    devices = {features.device, boxes.device} | ({box_index.device} if box_index is not None
                                                 else set())
    if len(devices) > 1:
        raise ValueError(f"roi_align operands on several devices: {sorted(map(str, devices))}")


def check_kernel_args(features: torch.Tensor, output_size: int) -> None:
    """What the kernel takes beyond `_check`: C a multiple of 8 (16-byte
    loads of 8 channels), output sizes up to MAX_OUTPUT, a 16-byte aligned
    map."""
    C = features.shape[-1]
    if C % 8 != 0 or C < 8:
        raise ValueError(f"roi_align: the kernel takes C a multiple of 8, got {C}")
    if output_size > MAX_OUTPUT:
        raise ValueError(f"roi_align: the kernel takes output sizes up to {MAX_OUTPUT}, got "
                         f"{output_size}")
    if features.data_ptr() % 16 != 0:
        raise ValueError("roi_align: the kernel reads 16-byte aligned features")


def _entry(impl: Optional[str], on_cuda: bool) -> str:
    """The C entry point for the private `_impl` argument: None is the
    routed design, "first" the first design."""
    if impl is None:
        return "ov3_roi_align"
    if impl != "first":
        raise ValueError(f"roi_align: _impl is None (the routed design) or 'first', got {impl!r}")
    if not on_cuda:
        raise ValueError("roi_align: _impl chooses between CUDA kernels; these tensors lie on the "
                         "CPU")
    return "ov3_roi_align_first"


def roi_align(features: torch.Tensor, boxes: torch.Tensor, box_index: Optional[torch.Tensor],
              spatial_scale: float, output_size: int, sampling_ratio: int = SAMPLING_RATIO,
              per_image: Optional[int] = None, _impl: Optional[str] = None) -> torch.Tensor:
    """RoIAlign (aligned=True): features (B, H, W, C), boxes (R, 4)
    [x1, y1, x2, y2] in input pixels, box_index (R,) or None (region r reads
    image r // per_image) -> (R, out, out, C) in the feature dtype; on CUDA
    tensors the routed design or, with `_impl="first"`, the first."""
    _check(features, boxes, box_index, output_size, sampling_ratio, per_image)
    entry = _entry(_impl, features.device.type == "cuda")
    if features.device.type == "cpu":
        from ov3det_torch.ops.roi_align import roi_align_plain

        return roi_align_plain(features, boxes, box_index, spatial_scale, output_size,
                               sampling_ratio, per_image)
    if features.device.type != "cuda":
        raise ValueError(f"roi_align runs on cuda or cpu tensors, got {features.device}")
    B, H, W, C = features.shape
    R = boxes.shape[0]
    out = torch.empty((R, output_size, output_size, C), dtype=features.dtype,
                      device=features.device)
    with torch.cuda.device(features.device):
        features = features.contiguous()
        check_kernel_args(features, output_size)
        boxes = boxes.float().contiguous()
        if boxes.data_ptr() % 16 != 0:  # the kernel reads a box as one float4
            boxes = boxes.clone()
        index = None if box_index is None else box_index.long().contiguous()
        if R == 0:
            return out
        lib = _build.load("roi_align", _SIGNATURES)
        status = getattr(lib, entry)(
            features.data_ptr(), boxes.data_ptr(), 0 if index is None else index.data_ptr(),
            per_image or 0, B, H, W, C, R, output_size, ctypes.c_float(spatial_scale),
            _DTYPES[features.dtype], out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _build.check(lib, status, "roi_align")
    roi_align.launches += 1
    return out


roi_align.launches = 0

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {name: ([_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _I, _P, _P], _I)
               for name in ("ov3_roi_align", "ov3_roi_align_first")}
