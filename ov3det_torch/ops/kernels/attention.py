"""Attention forward: the CUDA kernel's wrapper and its plain version.

The kernel (`ov3det_torch/csrc/attention_fwd.cu`) replaces the Pallas TPU
kernel `_fwd_kernel` (`ov3det/ops/pallas/attention_kernel.py:106`) as
`_attn_fwd` calls it on the main path: no dropout, no radius bias.
q (BH, NQ, D), k and v (BH, NK, D) -> (out (BH, NQ, D) in q's dtype,
lse (BH, NQ, 1) f32).  Scores and softmax are f32 whatever the input type.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ov3det_torch.ops.kernels import _build

SOURCE = "ov3det_torch/csrc/attention_fwd.cu"
REPLACES = "ov3det/ops/pallas/attention_kernel.py:106"

_HEAD_DIMS = (16, 32, 64)  # head widths the kernel is instantiated for
_TILE = 64  # NQ and NK must be multiples of the kernel's row and key tiles


def _scale(D: int) -> float:
    """f32 value of 1/sqrt(D), as the TPU kernel multiplies the scores."""
    return float(np.float32(1.0 / math.sqrt(D)))


def attention_fwd_plain(q, k, v) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the TPU kernel's forward
    (attention_kernel.py:106-127): f32 scores and softmax, the normalised
    probabilities cast to v's dtype before the PV product, f32 accumulation,
    output in q's dtype, row log-sum-exp in f32."""
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * _scale(q.shape[-1])
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(dim=-1, keepdim=True)
    lse = m + torch.log(l)
    a = (e / l).to(v.dtype).float()
    out = torch.matmul(a, v.float()).to(q.dtype)
    return out, lse


def attention_fwd(q, k, v) -> tuple[torch.Tensor, torch.Tensor]:
    """softmax(q k^T / sqrt(D)) v and the row LSE; see the module docstring.

    Launches the CUDA kernel for CUDA tensors (bf16 on the tensor cores,
    f32 with plain FMA); CPU tensors take :func:`attention_fwd_plain`.
    """
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("attention_fwd expects (BH, N, D) tensors")
    BH, NQ, D = q.shape
    NK = k.shape[1]
    if k.shape != (BH, NK, D) or v.shape != (BH, NK, D):
        raise ValueError(f"shapes differ: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("attention_fwd expects q, k, v all bfloat16 or all float32")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v lie on different devices")
    if q.device.type == "cpu":
        return attention_fwd_plain(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"attention_fwd runs on cuda or cpu tensors, got {q.device}")
    if D not in _HEAD_DIMS or NQ % _TILE or NK % _TILE:
        raise ValueError(
            f"attention kernel takes D in {_HEAD_DIMS} and NQ, NK multiples of "
            f"{_TILE}; got D={D}, NQ={NQ}, NK={NK}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in (q, k, v)):
        raise ValueError("attention_fwd expects contiguous tensors on 16-byte boundaries")
    out = torch.empty_like(q)
    lse = torch.empty((BH, NQ, 1), dtype=torch.float32, device=q.device)
    lib = _build.load("attention_fwd", _SIGNATURES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.ov3_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), BH, NQ, NK, D,
            int(q.dtype == torch.bfloat16), _scale(D), out.data_ptr(), lse.data_ptr(),
            stream)
    _build.check(lib, status, "attention_fwd")
    attention_fwd.launches += 1
    return out, lse


attention_fwd.launches = 0

_SIGNATURES = {
    "ov3_attention_fwd": (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p],
        ctypes.c_int,
    ),
}
