"""RoIAlign with detectron2's ROIAlignV2 semantics (aligned=True).

A copy of `ov3det/ops/roi_align.py`, which replaces the ROIAlign CUDA kernel
of RegionCLIP's RoI head (reference models/model_regionclip.py:15-22) with
plain XLA; here it is plain PyTorch on either device.  Each output cell
averages a fixed s x s grid of bilinear taps (sampling_ratio s = 2), with
the half-pixel shift of aligned=True and taps clipped to [0, size - 1].

Two forms, numerically the same function:
  * `roi_align`: the generic (R, 4) boxes + image index form, by gathers;
  * `roi_align_batched`: the (B, Q, 4) form the teacher uses, as separable
    interpolation matrices, out = Wy . F . Wx^T per region: two batched
    contractions instead of per-pixel gathers, W contracted first.  The
    tent weights are built in f32 and cast to the feature dtype; each
    contraction accumulates in f32 (bf16 products on the card accumulate in
    f32) and its result is cast to the feature dtype.
"""
from __future__ import annotations

import torch


def _bilinear(feat: torch.Tensor, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """feat (H, W, C); y, x (...,) fractional pixel coordinates -> (..., C)."""
    H, W, _ = feat.shape
    y = torch.clamp(y, 0.0, H - 1.0)
    x = torch.clamp(x, 0.0, W - 1.0)
    y0 = torch.floor(y).long()
    x0 = torch.floor(x).long()
    y1 = torch.clamp(y0 + 1, max=H - 1)
    x1 = torch.clamp(x0 + 1, max=W - 1)
    wy = (y - y0)[..., None]
    wx = (x - x0)[..., None]
    return (feat[y0, x0] * (1 - wy) * (1 - wx) + feat[y0, x1] * (1 - wy) * wx
            + feat[y1, x0] * wy * (1 - wx) + feat[y1, x1] * wy * wx)


def _tap_coords(lo: torch.Tensor, bin_size: torch.Tensor, output_size: int, s: int) -> torch.Tensor:
    """lo + (o + (t + 0.5) / s) * bin -> (..., out, s)."""
    o = torch.arange(output_size, dtype=torch.float32, device=lo.device)
    frac = (torch.arange(s, dtype=torch.float32, device=lo.device) + 0.5) / s
    return lo[..., None, None] + (o[:, None] + frac[None, :]) * bin_size[..., None, None]


def roi_align(features: torch.Tensor, boxes: torch.Tensor, box_batch_idx: torch.Tensor,
              spatial_scale: float, output_size: int, sampling_ratio: int = 2) -> torch.Tensor:
    """features (B, H, W, C), boxes (R, 4) [x1, y1, x2, y2] in input pixels,
    box_batch_idx (R,) -> (R, out, out, C)."""
    scaled = boxes * spatial_scale
    x1, y1 = scaled[:, 0] - 0.5, scaled[:, 1] - 0.5
    x2, y2 = scaled[:, 2] - 0.5, scaled[:, 3] - 0.5
    bin_w = torch.clamp(x2 - x1, min=1e-6) / output_size
    bin_h = torch.clamp(y2 - y1, min=1e-6) / output_size
    s = sampling_ratio
    ys = _tap_coords(y1, bin_h, output_size, s)  # (R, out, s)
    xs = _tap_coords(x1, bin_w, output_size, s)
    out = []
    for r in range(boxes.shape[0]):
        shape = (output_size, s, output_size, s)
        yy = ys[r][:, :, None, None].expand(shape)
        xx = xs[r][None, None, :, :].expand(shape)
        vals = _bilinear(features[box_batch_idx[r]], yy, xx)  # (out, s, out, s, C)
        out.append(vals.mean(dim=(1, 3)))
    return torch.stack(out)


def _interp(lo: torch.Tensor, bin_size: torch.Tensor, size: int, output_size: int,
            s: int) -> torch.Tensor:
    """The (B, Q, out, size) interpolation weights of one image axis: the
    mean over the s taps of the tent 1 - |tap - h| at clipped taps (at a
    clamped border the tent reproduces `_bilinear`'s corner duplication)."""
    taps = torch.clamp(_tap_coords(lo, bin_size, output_size, s), 0.0, size - 1.0)
    grid = torch.arange(size, dtype=torch.float32, device=lo.device)
    hat = torch.clamp(1.0 - (taps[..., None] - grid).abs(), min=0.0)
    return hat.mean(dim=3)


def roi_align_batched(features: torch.Tensor, boxes: torch.Tensor, spatial_scale: float,
                      output_size: int, sampling_ratio: int = 2) -> torch.Tensor:
    """features (B, H, W, C), boxes (B, Q, 4) [x1, y1, x2, y2] in input
    pixels -> (B, Q, out, out, C) in the feature dtype.  Every region reads
    its own image's feature map: no per-region copy of the map."""
    B, H, W, C = features.shape
    dtype = features.dtype
    scaled = boxes.float() * spatial_scale
    x1, y1 = scaled[..., 0] - 0.5, scaled[..., 1] - 0.5
    x2, y2 = scaled[..., 2] - 0.5, scaled[..., 3] - 0.5
    bin_w = torch.clamp(x2 - x1, min=1e-6) / output_size
    bin_h = torch.clamp(y2 - y1, min=1e-6) / output_size
    wy = _interp(y1, bin_h, H, output_size, sampling_ratio).to(dtype)
    wx = _interp(x1, bin_w, W, output_size, sampling_ratio).to(dtype)
    # contract the image's W axis first: the intermediate carries H (34 at
    # the teacher's 530 x 730 canvas, against W = 46)
    cols = torch.einsum("bqjw,bhwc->bqjhc", wx, features)
    return torch.einsum("bqih,bqjhc->bqijc", wy, cols)
