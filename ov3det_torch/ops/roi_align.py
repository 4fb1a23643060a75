"""RoIAlign with detectron2's ROIAlignV2 semantics (aligned=True).

A copy of `ov3det/ops/roi_align.py`, which replaces the ROIAlign CUDA kernel
of RegionCLIP's RoI head (reference models/model_regionclip.py:15-22) with
plain XLA.  Each output cell averages a fixed s x s grid of bilinear taps
(sampling_ratio s = 2), with the half-pixel shift of aligned=True and taps
clipped to [0, size - 1].  As JAX's `roi_align_batched` does, the two image
axes are separable: out[i, j] = sum_h wy[i, h] sum_w wx[j, w] F[h, w], where
wx[j, w] is the mean over the row's two taps of the tent 1 - |tap - w|,
built in f32 and cast to the feature dtype.

Three forms of that one function:
  * `roi_align` (the generic (R, 4) boxes + image index form) and
    `roi_align_batched` (the (B, Q, 4) form the teacher uses): CUDA tensors
    launch the kernel (`ops/kernels/roi_align.py`, `csrc/roi_align.cu`),
    CPU tensors take `roi_align_plain`;
  * `roi_align_plain`: gathers in a fixed order, the kernel's oracle.  The
    two taps of a row reach at most four pixels of an axis (`_axis_slots`);
    cols[j, h] = the sum over the row's pixels w of non-zero weight, in
    ascending w, of wx[j, w] * F[h, w], each product and each sum rounded
    in f32 on its own, then rounded to the feature dtype as the first
    contraction's result is; out[i, j] the same over the rows h of wy[i].
    A row whose tap is NaN gives NaN;
  * `roi_align_einsum`: the two contractions over the whole axes (the path
    before the kernel), kept for the tests and as the kernel's yardstick.
    It differs from the others where an infinite feature meets a zero
    weight (0 * inf = NaN there, a skipped pixel here); the trunk's ReLU
    outputs are finite.
"""
from __future__ import annotations

import torch

from ov3det_torch.ops.kernels import roi_align as _kernel


def _tap_coords(lo: torch.Tensor, bin_size: torch.Tensor, output_size: int, s: int) -> torch.Tensor:
    """lo + (o + (t + 0.5) / s) * bin -> (..., out, s)."""
    o = torch.arange(output_size, dtype=torch.float32, device=lo.device)
    frac = (torch.arange(s, dtype=torch.float32, device=lo.device) + 0.5) / s
    return lo[..., None, None] + (o[:, None] + frac[None, :]) * bin_size[..., None, None]


def _box_axes(boxes: torch.Tensor, spatial_scale: float, output_size: int) -> tuple:
    """(..., 4) boxes -> (x1, bin_w, y1, bin_h) in feature pixels, f32."""
    scaled = boxes.float() * spatial_scale
    x1, y1 = scaled[..., 0] - 0.5, scaled[..., 1] - 0.5
    x2, y2 = scaled[..., 2] - 0.5, scaled[..., 3] - 0.5
    # a divisor tensor: PyTorch's CUDA division by a Python number multiplies
    # by its rounded reciprocal, which is not the kernel's (nor JAX's) quotient
    out = torch.full_like(x1, float(output_size))
    bin_w = torch.clamp(x2 - x1, min=1e-6) / out
    bin_h = torch.clamp(y2 - y1, min=1e-6) / out
    return x1, bin_w, y1, bin_h


def _axis_slots(lo: torch.Tensor, bin_size: torch.Tensor, size: int, output_size: int) -> tuple:
    """The pixels one axis's rows read, sampling_ratio 2: (R,) lo and bin ->
    (pixel (R, out, 4) int64, weight (R, out, 4) f32, live (R, out, 4),
    nan (R, out)).  Slots are b0, b0 + 1, p, p + 1 with b the floors of the
    two clipped taps and p = max(b1, b0 + 2), so ascending and distinct; a
    slot is live inside the axis where its weight, the mean of the two
    taps' tents as `_interp` forms it, is not 0.  Pixels are clamped into
    the axis so that a dead slot still indexes."""
    taps = torch.clamp(_tap_coords(lo, bin_size, output_size, 2), 0.0, size - 1.0)  # (R, out, 2)
    nan = taps.isnan().any(dim=-1)
    taps = torch.where(taps.isnan(), torch.zeros_like(taps), taps)
    base = torch.floor(taps).long()
    b0, b1 = base[..., 0], base[..., 1]
    p = torch.maximum(b1, b0 + 2)
    pixel = torch.stack([b0, b0 + 1, p, p + 1], dim=-1)
    hat = torch.clamp(1.0 - (taps[..., None, :] - pixel[..., None].float()).abs(), min=0.0)
    weight = (hat[..., 0] + hat[..., 1]) / 2
    live = (pixel <= size - 1) & (weight > 0)
    return torch.clamp(pixel, max=size - 1), weight, live, nan


def roi_align_plain(features: torch.Tensor, boxes: torch.Tensor,
                    box_index: torch.Tensor | None, spatial_scale: float, output_size: int,
                    sampling_ratio: int = 2, per_image: int | None = None) -> torch.Tensor:
    """Plain PyTorch RoIAlign, sampling_ratio 2: features (B, H, W, C),
    boxes (R, 4) [x1, y1, x2, y2] in input pixels, box_index (R,) the image
    of each box, or None for r // per_image -> (R, out, out, C) in the
    feature dtype, every sum in the kernel's order (the module docstring)."""
    if sampling_ratio != 2:
        raise ValueError(f"roi_align: sampling_ratio 2 only, got {sampling_ratio}")
    B, H, W, C = features.shape
    R, P = boxes.shape[0], output_size
    dtype = features.dtype
    if box_index is None:
        box_index = torch.arange(R, device=boxes.device) // per_image
    x1, bin_w, y1, bin_h = _box_axes(boxes, spatial_scale, P)
    px, wx, vx, nan_x = _axis_slots(x1, bin_w, W, P)
    py, wy, vy, nan_y = _axis_slots(y1, bin_h, H, P)
    wx, wy = wx.to(dtype).float(), wy.to(dtype).float()
    b = box_index.long()[:, None, None]
    out = torch.zeros((R, P, P, C), dtype=torch.float32, device=features.device)
    for ky in range(4):
        rows = py[:, :, ky, None]  # (R, out_i, 1)
        col = torch.zeros_like(out)
        for kx in range(4):
            g = features[b, rows, px[:, None, :, kx]].float()  # (R, out_i, out_j, C)
            col = torch.where(vx[:, None, :, kx, None], col + wx[:, None, :, kx, None] * g, col)
        col = col.to(dtype).float()
        out = torch.where(vy[:, :, None, ky, None], out + wy[:, :, None, ky, None] * col, out)
    nan = (nan_y[:, :, None] | nan_x[:, None, :])[..., None]
    return torch.where(nan, torch.full_like(out, float("nan")), out).to(dtype)


def _interp(lo: torch.Tensor, bin_size: torch.Tensor, size: int, output_size: int,
            s: int) -> torch.Tensor:
    """The (B, Q, out, size) interpolation weights of one image axis: the
    mean over the s taps of the tent 1 - |tap - h| at clipped taps (at a
    clamped border the tent reproduces bilinear sampling's corner
    duplication)."""
    taps = torch.clamp(_tap_coords(lo, bin_size, output_size, s), 0.0, size - 1.0)
    grid = torch.arange(size, dtype=torch.float32, device=lo.device)
    hat = torch.clamp(1.0 - (taps[..., None] - grid).abs(), min=0.0)
    return hat.mean(dim=3)


def roi_align_einsum(features: torch.Tensor, boxes: torch.Tensor, spatial_scale: float,
                     output_size: int, sampling_ratio: int = 2) -> torch.Tensor:
    """The (B, Q, 4) form as two batched contractions, out = Wy . F . Wx^T
    a region, the image's W axis first (the intermediate carries H, 33 at
    the teacher's 530 x 730 canvas, against W = 45); each accumulates in f32
    and its result is cast to the feature dtype -> (B, Q, out, out, C)."""
    B, H, W, C = features.shape
    dtype = features.dtype
    x1, bin_w, y1, bin_h = _box_axes(boxes, spatial_scale, output_size)
    wy = _interp(y1, bin_h, H, output_size, sampling_ratio).to(dtype)
    wx = _interp(x1, bin_w, W, output_size, sampling_ratio).to(dtype)
    cols = torch.einsum("bqjw,bhwc->bqjhc", wx, features)
    return torch.einsum("bqih,bqjhc->bqijc", wy, cols)


def roi_align(features: torch.Tensor, boxes: torch.Tensor, box_batch_idx: torch.Tensor,
              spatial_scale: float, output_size: int, sampling_ratio: int = 2) -> torch.Tensor:
    """features (B, H, W, C), boxes (R, 4) [x1, y1, x2, y2] in input pixels,
    box_batch_idx (R,) -> (R, out, out, C): the kernel on CUDA tensors,
    `roi_align_plain` on CPU ones."""
    return _kernel.roi_align(features, boxes, box_batch_idx, spatial_scale, output_size,
                             sampling_ratio)


def roi_align_batched(features: torch.Tensor, boxes: torch.Tensor, spatial_scale: float,
                      output_size: int, sampling_ratio: int = 2) -> torch.Tensor:
    """features (B, H, W, C), boxes (B, Q, 4) [x1, y1, x2, y2] in input
    pixels -> (B, Q, out, out, C) in the feature dtype.  Every region reads
    its own image's feature map (region r of the flattened boxes reads
    image r // Q): no per-region copy of the map."""
    B, Q = boxes.shape[:2]
    out = _kernel.roi_align(features, boxes.reshape(B * Q, 4), None, spatial_scale, output_size,
                            sampling_ratio, per_image=Q)
    return out.reshape(B, Q, *out.shape[1:])
