"""Fused attention: the CUDA kernels' wrappers, their plain versions, and
the autograd function that joins them.

The kernels replace the Pallas TPU kernels of
`ov3det/ops/pallas/attention_kernel.py` as `_attn` / `_attn_bwd` call them,
with both options, attention-weight dropout and the radius bias:
  * `attention_fwd` (`csrc/attention_fwd.cu`) replaces `_fwd_kernel`:
    q (BH, NQ, D), k and v (BH, NK, D) -> (out (BH, NQ, D) in q's dtype,
    lse (BH, NQ, 1) f32);
  * `attention_dq` and `attention_dkv` (`csrc/attention_bwd.cu`) replace
    `_dq_kernel` and `_dkv_kernel`: dq, and dk with dv, from the saved LSE
    and delta = rowsum(dO * out).
Scores and softmax are f32 whatever the input type.  Dropout zeroes a
probability where the hash of (seed, bh, row, col) of `_drop_mask`
(`attention_kernel.py:48-72`) is below min(int(p 2^32), 2^32 - 1) and
scales the rest by f32 1 / (1 - p), so the forward and both backward
kernels regenerate the same mask from indices alone.  `seed` is an int32
tensor of one element on the tensors' device (the kernels read it there;
no host sync).

The radius bias of `_radius_bias` (`attention_kernel.py:84-103`), the
masked encoder's geometric mask: `radius = (q_xyz, k_xyz, r2)` with f32
point coordinates (B, NQ, 3) and (B, NK, 3), shared by the H = BH / B heads
of a batch row (the JAX wrapper repeats them to (BH, N, 3); here the kernels
index the batch row as bh / H), and the squared radius r2.  Each scaled
score gets 0 added where d2 < f32(r2) and -1e9 elsewhere, d2 in the
expanded form without a clamp, (|q|^2 - 2 q.k) + |k|^2, each term rounded
in that order (`radius_mask`); the kernels compute it with the same
roundings, so their mask equals the plain version's bit for bit.  It is
not the ball-group's direct subtraction.

Each wrapper launches its kernel for CUDA tensors and counts the launch in
`.launches`, or in `.radius_launches` for the variant with the radius bias;
CPU tensors take the plain version, and a CUDA tensor never does.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import numpy as np
import torch

from ov3det_torch.ops.kernels import _build

SOURCE = "ov3det_torch/csrc/attention_fwd.cu"
REPLACES = "ov3det/ops/pallas/attention_kernel.py:106"
BWD_SOURCE = "ov3det_torch/csrc/attention_bwd.cu"
DQ_REPLACES = "ov3det/ops/pallas/attention_kernel.py:130"
DKV_REPLACES = "ov3det/ops/pallas/attention_kernel.py:155"
# where each TPU kernel adds `_radius_bias`, which the radius variants replace
FWD_RADIUS_REPLACES = "ov3det/ops/pallas/attention_kernel.py:112"
DQ_RADIUS_REPLACES = "ov3det/ops/pallas/attention_kernel.py:136"
DKV_RADIUS_REPLACES = "ov3det/ops/pallas/attention_kernel.py:173"

_HEAD_DIMS = (16, 32, 64)  # head widths the kernels are instantiated for
_TILE = 64  # NQ and NK must be multiples of the kernels' row and key tiles
_RADIUS_NEG = -1e9  # the radius bias outside the radius, `_NEG` of the TPU kernel
_MASK32 = 0xFFFFFFFF
_HASH = (0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35, 0x27D4EB2F)  # seed, bh, row, col


def _scale(D: int) -> float:
    """f32 value of 1/sqrt(D), as the TPU kernel multiplies the scores."""
    return float(np.float32(1.0 / math.sqrt(D)))


def dropout_params(rate: float) -> tuple[float, int]:
    """(keep_scale, threshold) of the TPU kernels: f32(1 / (1 - p)) and
    min(int(p * 2^32), 2^32 - 1)."""
    return float(np.float32(1.0 / (1.0 - rate))), min(int(rate * 2 ** 32), 2 ** 32 - 1)


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for int64 a in [0, 2^32) and a 32-bit constant,
    multiplied in 16-bit halves so that no int64 product overflows."""
    lo, hi = c & 0xFFFF, c >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _MASK32


def drop_mask(seed: torch.Tensor, BH: int, NQ: int, NK: int, rate: float) -> torch.Tensor:
    """The (BH, NQ, NK) f32 dropout mask of `_drop_mask`: 0 where dropped,
    f32(1 / (1 - p)) where kept.  seed: int32 tensor of one element."""
    keep_scale, threshold = dropout_params(rate)
    dev = seed.device
    idx = lambda n: torch.arange(n, dtype=torch.int64, device=dev)  # noqa: E731
    s = seed.reshape(()).to(torch.int64) & _MASK32  # two's complement -> uint32
    h = (_mul32(s, _HASH[0]) + _mul32(idx(BH), _HASH[1])[:, None, None]
         + _mul32(idx(NQ), _HASH[2])[None, :, None] + _mul32(idx(NK), _HASH[3])[None, None, :])
    h = h & _MASK32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return torch.where(h >= threshold, keep_scale, 0.0).to(torch.float32)


def _f32(x: float) -> float:
    return float(np.float32(x))


def _sq3(p: torch.Tensor) -> torch.Tensor:
    """(x*x + y*y) + z*z of (..., 3) points, one rounding per operation."""
    return (p[..., 0] * p[..., 0] + p[..., 1] * p[..., 1]) + p[..., 2] * p[..., 2]


def radius_mask(q_xyz: torch.Tensor, k_xyz: torch.Tensor, r2: float) -> torch.Tensor:
    """(B, NQ, NK) bool, True inside the radius: d2 < f32(r2) with d2 the
    expanded form of `_radius_bias`, (|q|^2 - 2 q.k) + |k|^2 in f32, written
    as single elementwise operations (no matmul, no fused multiply-add) in
    the order the kernels use."""
    q = q_xyz.float()[:, :, None, :]
    k = k_xyz.float()[:, None, :, :]
    dot = (q[..., 0] * k[..., 0] + q[..., 1] * k[..., 1]) + q[..., 2] * k[..., 2]
    d2 = (_sq3(q_xyz.float())[:, :, None] - 2.0 * dot) + _sq3(k_xyz.float())[:, None, :]
    return d2 < _f32(r2)


def _scores(q, k, radius=None):
    """f32 scaled scores (BH, NQ, NK), plus the radius bias when `radius`
    is given."""
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * _scale(q.shape[-1])
    if radius is not None:
        q_xyz, k_xyz, r2 = radius
        B = q_xyz.shape[0]
        bias = torch.where(radius_mask(q_xyz, k_xyz, r2), 0.0, _RADIUS_NEG)
        s = (s.view(B, -1, *s.shape[1:]) + bias[:, None]).view(s.shape)
    return s


def attention_fwd_plain(q, k, v, dropout_rate: float = 0.0, seed=None, radius=None):
    """Plain PyTorch version of the TPU kernel's forward
    (attention_kernel.py:106-127): f32 scores [+ radius bias] and softmax,
    the LSE from the unmasked probabilities, the dropout mask applied to the
    normalised probabilities, which are cast to v's dtype before the PV
    product; f32 accumulation, output in q's dtype."""
    s = _scores(q, k, radius)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(dim=-1, keepdim=True)
    lse = m + torch.log(l)
    a = e / l
    if dropout_rate > 0.0:
        a = a * drop_mask(seed, *s.shape, dropout_rate)
    out = torch.matmul(a.to(v.dtype).float(), v.float()).to(q.dtype)
    return out, lse


def _probs_and_dp(q, k, v, do, lse, dropout_rate, seed, radius):
    """e = exp(s - lse) and dP = dO v^T (masked), both f32, and the mask."""
    e = torch.exp(_scores(q, k, radius) - lse)
    dp = torch.matmul(do.float(), v.float().transpose(1, 2))
    mask = None
    if dropout_rate > 0.0:
        mask = drop_mask(seed, *e.shape, dropout_rate)
        dp = dp * mask
    return e, dp, mask


def attention_dq_plain(q, k, v, do, lse, delta, dropout_rate: float = 0.0, seed=None,
                       radius=None):
    """Plain version of `_dq_kernel` (attention_kernel.py:130-152):
    dq = (e * (mask * dO v^T - delta) * scale) k, ds cast to k's dtype
    before the product, f32 accumulation, dq in q's dtype."""
    e, dp, _ = _probs_and_dp(q, k, v, do, lse, dropout_rate, seed, radius)
    ds = e * (dp - delta) * _scale(q.shape[-1])
    return torch.matmul(ds.to(k.dtype).float(), k.float()).to(q.dtype)


def attention_dkv_plain(q, k, v, do, lse, delta, dropout_rate: float = 0.0, seed=None,
                        radius=None):
    """Plain version of `_dkv_kernel` (attention_kernel.py:155-201):
    dv = (e * mask)^T dO with e * mask cast to dO's dtype, dk = ds^T q with
    ds cast to q's dtype; f32 accumulation, outputs in k's and v's dtypes."""
    e, dp, mask = _probs_and_dp(q, k, v, do, lse, dropout_rate, seed, radius)
    a = e if mask is None else e * mask
    ds = e * (dp - delta) * _scale(q.shape[-1])
    dv = torch.matmul(a.to(do.dtype).float().transpose(1, 2), do.float()).to(v.dtype)
    dk = torch.matmul(ds.to(q.dtype).float().transpose(1, 2), q.float()).to(k.dtype)
    return dk, dv


def _check(name: str, q, k, v, extra=()) -> bool:
    """Validate the operands; True when they lie on a CUDA device (the
    kernel runs), False on the CPU (the plain version runs)."""
    if any(t.dim() != 3 for t in (q, k, v, *extra)):
        raise ValueError(f"{name} expects (BH, N, D) tensors")
    BH, NQ, D = q.shape
    NK = k.shape[1]
    if k.shape != (BH, NK, D) or v.shape != (BH, NK, D) or any(t.shape != q.shape for t in extra):
        raise ValueError(f"{name}: shapes differ: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    tensors = (q, k, v, *extra)
    if len({t.dtype for t in tensors}) != 1 or q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} expects its tensors all bfloat16 or all float32")
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{name}: the tensors lie on different devices")
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, got {q.device}")
    if D not in _HEAD_DIMS or NQ % _TILE or NK % _TILE:
        raise ValueError(
            f"{name} kernel takes D in {_HEAD_DIMS} and NQ, NK multiples of "
            f"{_TILE}; got D={D}, NQ={NQ}, NK={NK}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in tensors):
        raise ValueError(f"{name} expects contiguous tensors on 16-byte boundaries")
    return True


def _dropout_args(dropout_rate: float, seed: Optional[torch.Tensor], device) -> list:
    """(on, seed pointer, keep_scale, threshold) for the C entry points."""
    if dropout_rate <= 0.0:
        return [0, None, 1.0, 0]
    if seed is None or seed.dtype != torch.int32 or seed.numel() != 1 or seed.device != device:
        raise ValueError("dropout needs an int32 seed tensor of one element on the tensors' device")
    keep_scale, threshold = dropout_params(dropout_rate)
    return [1, seed.data_ptr(), keep_scale, threshold]


def _radius_args(name: str, q, NK: int, radius) -> list:
    """(qxyz pointer, kxyz pointer, r2, heads) for the C entry points; null
    pointers without the radius."""
    if radius is None:
        return [None, None, 0.0, 0]
    q_xyz, k_xyz, r2 = radius
    BH, NQ, _ = q.shape
    B = q_xyz.shape[0]
    if (q_xyz.shape != (B, NQ, 3) or k_xyz.shape != (B, NK, 3) or B == 0 or BH % B
            or any(t.dtype != torch.float32 or t.device != q.device or not t.is_contiguous()
                   for t in (q_xyz, k_xyz))):
        raise ValueError(f"{name}: the radius takes contiguous f32 (B, NQ, 3) and (B, NK, 3) "
                         f"points on the tensors' device, with BH a multiple of B")
    return [q_xyz.data_ptr(), k_xyz.data_ptr(), _f32(r2), BH // B]


def _count(wrapper, radius) -> None:
    if radius is None:
        wrapper.launches += 1
    else:
        wrapper.radius_launches += 1


def _row_stats_ok(name, q, *stats):
    BH, NQ, _ = q.shape
    for t in stats:
        if t.shape != (BH, NQ, 1) or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name}: lse and delta must be contiguous f32 (BH, NQ, 1)")


def attention_fwd(q, k, v, dropout_rate: float = 0.0, seed=None, radius=None):
    """softmax(q k^T / sqrt(D) [+ radius bias]) [dropout] v and the row LSE;
    see the module docstring.  bf16 runs on the tensor cores, f32 with plain
    FMA."""
    if not _check("attention_fwd", q, k, v):
        return attention_fwd_plain(q, k, v, dropout_rate, seed, radius)
    BH, NQ, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((BH, NQ, 1), dtype=torch.float32, device=q.device)
    drop = _dropout_args(dropout_rate, seed, q.device)
    rad = _radius_args("attention_fwd", q, k.shape[1], radius)
    lib = _build.load("attention_fwd", _FWD_SIGNATURES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.ov3_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), BH, NQ, k.shape[1], D,
            int(q.dtype == torch.bfloat16), _scale(D), *drop, *rad, out.data_ptr(),
            lse.data_ptr(), stream)
    _build.check(lib, status, "attention_fwd")
    _count(attention_fwd, radius)
    return out, lse


def attention_dq(q, k, v, do, lse, delta, dropout_rate: float = 0.0, seed=None, radius=None):
    """dq of the fused attention (BH, NQ, D), in q's dtype."""
    if not _check("attention_dq", q, k, v, (do,)):
        return attention_dq_plain(q, k, v, do, lse, delta, dropout_rate, seed, radius)
    _row_stats_ok("attention_dq", q, lse, delta)
    BH, NQ, D = q.shape
    dq = torch.empty_like(q)
    drop = _dropout_args(dropout_rate, seed, q.device)
    rad = _radius_args("attention_dq", q, k.shape[1], radius)
    lib = _build.load("attention_bwd", _BWD_SIGNATURES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.ov3_attention_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), BH, NQ, k.shape[1], D, int(q.dtype == torch.bfloat16), _scale(D),
            *drop, *rad, dq.data_ptr(), stream)
    _build.check(lib, status, "attention_dq")
    _count(attention_dq, radius)
    return dq


def attention_dkv(q, k, v, do, lse, delta, dropout_rate: float = 0.0, seed=None, radius=None):
    """(dk, dv) of the fused attention (BH, NK, D), in k's and v's dtype."""
    if not _check("attention_dkv", q, k, v, (do,)):
        return attention_dkv_plain(q, k, v, do, lse, delta, dropout_rate, seed, radius)
    _row_stats_ok("attention_dkv", q, lse, delta)
    BH, NQ, D = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    drop = _dropout_args(dropout_rate, seed, q.device)
    rad = _radius_args("attention_dkv", q, k.shape[1], radius)
    lib = _build.load("attention_bwd", _BWD_SIGNATURES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.ov3_attention_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), BH, NQ, k.shape[1], D, int(q.dtype == torch.bfloat16), _scale(D),
            *drop, *rad, dk.data_ptr(), dv.data_ptr(), stream)
    _build.check(lib, status, "attention_dkv")
    _count(attention_dkv, radius)
    return dk, dv


for _wrapper in (attention_fwd, attention_dq, attention_dkv):
    _wrapper.launches = 0
    _wrapper.radius_launches = 0


class FusedAttention(torch.autograd.Function):
    """The custom VJP `_attn` / `_attn_bwd` (attention_kernel.py:212-332):
    the forward saves q, k, v, out, lse, the seed and the points of the
    radius; the backward takes delta = rowsum(dO * out) in f32 and runs dq
    and dk/dv.  The points and r2 get no gradient.  Each wrapper picks its
    kernel or, for CPU tensors, its plain version."""

    @staticmethod
    def forward(ctx, q, k, v, seed, dropout_rate: float, q_xyz, k_xyz, r2):
        radius = None if q_xyz is None else (q_xyz, k_xyz, r2)
        out, lse = attention_fwd(q, k, v, dropout_rate, seed, radius)
        ctx.save_for_backward(q, k, v, out, lse, seed, q_xyz, k_xyz)
        ctx.dropout_rate = dropout_rate
        ctx.r2 = r2
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse, seed, q_xyz, k_xyz = ctx.saved_tensors
        rate = ctx.dropout_rate
        radius = None if q_xyz is None else (q_xyz, k_xyz, ctx.r2)
        do = g.to(q.dtype).contiguous()
        delta = (do.float() * out.float()).sum(-1, keepdim=True)
        dq = attention_dq(q, k, v, do, lse, delta, rate, seed, radius)
        dk, dv = attention_dkv(q, k, v, do, lse, delta, rate, seed, radius)
        return dq, dk, dv, None, None, None, None, None


def fused_attention(q, k, v, dropout_rate: float = 0.0, seed: Optional[torch.Tensor] = None,
                    radius=None):
    """Differentiable fused attention on (BH, N, D) tensors.  With dropout,
    `seed` is the int32 one-element tensor of the hash; without, it may be
    None.  `radius` is None or (q_xyz (B, NQ, 3), k_xyz (B, NK, 3), r2) (see
    the module docstring)."""
    if dropout_rate > 0.0 and seed is None:
        raise ValueError("dropout needs a seed tensor")
    q_xyz, k_xyz, r2 = (None, None, None) if radius is None else radius
    if radius is not None:
        q_xyz, k_xyz = (t.detach().float().contiguous() for t in (q_xyz, k_xyz))
    return FusedAttention.apply(q, k, v, seed, float(dropout_rate), q_xyz, k_xyz, r2)


_DROP_ARGS = [ctypes.c_int, ctypes.c_void_p, ctypes.c_float, ctypes.c_uint]
_RADIUS_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float, ctypes.c_int]
_FWD_SIGNATURES = {
    "ov3_attention_fwd": (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_float] + _DROP_ARGS
        + _RADIUS_ARGS + [ctypes.c_void_p] * 3,
        ctypes.c_int,
    ),
}
_BWD_HEAD = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_float] + _DROP_ARGS
             + _RADIUS_ARGS)
_BWD_SIGNATURES = {
    "ov3_attention_dq": (_BWD_HEAD + [ctypes.c_void_p] * 2, ctypes.c_int),
    "ov3_attention_dkv": (_BWD_HEAD + [ctypes.c_void_p] * 3, ctypes.c_int),
}
