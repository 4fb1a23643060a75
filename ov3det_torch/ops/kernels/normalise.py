"""The teacher's input normalisation: the CUDA kernel's wrapper and its plain
version.

`normalise` launches `ov3det_torch/csrc/normalise.cu`'s pass, the
counterpart of `(images - _PIXEL_MEAN) * (1.0 / _PIXEL_STD)` and the cast
to the compute dtype (`ov3det/models/regionclip.py:91-93`: XLA, not a
Pallas kernel): (B, H, W, 3) uint8 or f32 canvases in, (B, H, W, 3) bf16
(or f32) out, each value `(x - mean[c]) * inv_std[c]` in f32 with each
operation rounded, then rounded to nearest even into the output dtype.  The
kernel takes 16 values a thread (a 16-byte load of uint8, 16-byte stores),
the channel of each value its flat index mod 3 (`pieces`); a canvas view
off a 16-byte boundary takes a load a value (`normalise_launch`).  One
launch a call with no host wait, counted in `normalise.launches`.

`normalise_plain` is the expression as torch ops in the same order: the
CPU path and the kernel's oracle on the card, which the kernel equals bit
for bit.  A CUDA tensor never takes it through the wrapper: the wrapper
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ov3det_torch.ops.kernels import _build

SOURCE = "ov3det_torch/csrc/normalise.cu"
REPLACES = ("ov3det/models/regionclip.py:91 (RegionCLIPTeacher: (images - _PIXEL_MEAN) * "
            "(1 / _PIXEL_STD) and the cast to the compute dtype, XLA, not Pallas)")
VEC = 16  # values a thread's piece, mirrored from `kVec` of the source
_IN_DTYPES = (torch.uint8, torch.float32)
_OUT_DTYPES = (torch.bfloat16, torch.float32)


def normalise_plain(images: torch.Tensor, mean: torch.Tensor, inv_std: torch.Tensor,
                    out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """(images.float() - mean) * inv_std, cast to `out_dtype` (None: f32)."""
    x = (images.float() - mean) * inv_std
    return x if out_dtype in (None, torch.float32) else x.to(out_dtype)


def normalise_launch(images: torch.Tensor) -> dict:
    """The launch `ov3_normalise` makes for `images`: `pieces` of VEC values
    (the value at flat index i of channel i mod 3), `tail` values past the
    last piece, and whether the canvas starts on a 16-byte boundary
    (`aligned`: 16-byte loads, else a load a value)."""
    n = images.numel()
    return dict(pieces=n // VEC, tail=n % VEC, aligned=images.data_ptr() % 16 == 0)


def normalise(images: torch.Tensor, mean: torch.Tensor, inv_std: torch.Tensor,
              out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """:func:`normalise_plain`'s function: images (B, H, W, 3) uint8 or f32
    in [0, 255], mean and inv_std (3,) f32 -> (B, H, W, 3) in `out_dtype`
    (bf16, or f32 when None).  CUDA tensors launch the kernel; CPU tensors
    take the plain version."""
    if images.dim() != 4 or images.shape[-1] != 3:
        raise ValueError(f"normalise expects (B, H, W, 3) canvases, got {tuple(images.shape)}")
    if out_dtype not in (None, *_OUT_DTYPES):
        raise ValueError(f"normalise writes bf16 or f32, got {out_dtype}")
    if images.device.type == "cpu":
        return normalise_plain(images, mean, inv_std, out_dtype)
    if images.device.type != "cuda":
        raise ValueError(f"normalise runs on cuda or cpu tensors, got {images.device}")
    out_dtype = out_dtype or torch.float32
    n = images.numel()
    if images.dtype not in _IN_DTYPES or n >= 2 ** 31:
        raise ValueError(f"normalise: the kernel takes uint8 or f32 canvases of fewer than 2^31 "
                         f"values, got {tuple(images.shape)} {images.dtype}")
    for name, t in (("mean", mean), ("inv_std", inv_std)):
        if tuple(t.shape) != (3,) or t.dtype != torch.float32 or t.device != images.device:
            raise ValueError(f"normalise expects {name} (3,) f32 on {images.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    images, mean, inv_std = images.contiguous(), mean.contiguous(), inv_std.contiguous()
    if images.dtype == torch.float32 and images.data_ptr() % 4:
        raise ValueError("normalise: an f32 canvas must start on a 4-byte boundary")
    out = torch.empty(images.shape, dtype=out_dtype, device=images.device)
    if n == 0:
        return out
    lib = _build.load("normalise", _SIGNATURES)
    with torch.cuda.device(images.device):
        status = lib.ov3_normalise(images.data_ptr(), mean.data_ptr(), inv_std.data_ptr(),
                                   out.data_ptr(), n, int(images.dtype == torch.float32),
                                   int(out_dtype == torch.float32),
                                   torch.cuda.current_stream().cuda_stream)
    _build.check(lib, status, "normalise")
    normalise.launches += 1
    return out


normalise.launches = 0

_SIGNATURES = {"ov3_normalise": ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
                                 ctypes.c_int)}
