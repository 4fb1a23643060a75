"""The set abstraction's shared MLP after each `Dense`: training-mode
BatchNorm, the ReLU and, at the last width, the max-pool over the slots.  The
CUDA kernels' wrappers and their plain versions.

Counterpart of flax `nn.BatchNorm` (training and eval), `nn.relu` and
`jnp.max` over the slots in `ov3det/models/pointnet.py:77-86` (XLA in JAX,
which fuses the statistics and the normalise / ReLU / max passes; not a
Pallas kernel).  `ov3det_torch/csrc/bn_relu.cu` holds four kernels, each on
the channel-last (P, C) `Dense` output y (bf16, or f32 in the f32 configs; C
a multiple of 8 up to 1024):

  * `bn_stats`: sum y and sum y^2 of each channel in f32, (2, C), in a fixed
    order (a partial sum a CTA, then the partials in block order): two
    launches give the same bits;
  * `bn_relu_apply`: relu(((y - mean) * scale) + bias), each operation
    rounded as the plain version's torch ops round it, scale = rsqrt(var +
    eps) * weight formed by the caller with the plain version's expression;
    y's dtype out at a hidden width, the max over the slot axis (1, the
    bucketed ball-group's, or 2, the first-K layout's) as (B, M, C) f32 at
    the last;
  * `bn_relu_grad_sums`: sum g and sum g * xhat of each channel, g the
    ReLU-masked incoming gradient (at the pooled width, grad / ties at each
    slot whose value equals the max: q, returned too) and xhat = (y - mean)
    * rsqrt(var + eps).  They are dbias and dweight;
  * `bn_relu_grad_apply`: dy = scale * (g - sum g / P - xhat * sum(g xhat) /
    P) in f32 (the last term dropped where the variance was clamped), in y's
    dtype: training mode's backward.

`models/pointnet.py` chains them (`BnRelu`).  Each wrapper takes its plain
version for CPU tensors (the `*_plain` functions: the kernels' arithmetic as
torch ops, the tests' transcription and the card's oracle) and launches its
kernel for CUDA tensors or raises; each counts its launches in `.launches`
(`bn_stats` and `bn_relu_grad_sums` are two kernels a launch: the partial
sums and their finish).  No host wait, no workspace but torch's allocator:
CUDA graphs capture every launch.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ov3det_torch.ops.kernels import _build

SOURCE = "ov3det_torch/csrc/bn_relu.cu"
_WHAT = "ov3det/models/pointnet.py:77 (PointnetSAModule: flax nn.BatchNorm, nn.relu, jnp.max"
STATS_REPLACES = f"{_WHAT}: the batch statistics, XLA, not Pallas)"
APPLY_REPLACES = f"{_WHAT}: the normalise, the ReLU and the max-pool, XLA, not Pallas)"
GRAD_SUMS_REPLACES = f"{_WHAT}: the VJP's per-channel sums, XLA, not Pallas)"
GRAD_APPLY_REPLACES = f"{_WHAT}: the VJP's input gradient, XLA, not Pallas)"
VEC = 8  # channels a thread's piece, mirrored from `kVec` of the source
MAX_C = 1024  # mirrored from `kMaxC`
THREADS = 256  # mirrored from `kThreads`
STAT_CTAS_PER_SM = 4  # the sums' grid: CTAs an SM
STAT_MIN_PASSES = 8  # and at least this many passes of a CTA's rows each
_DTYPES = (torch.bfloat16, torch.float32)


# ------------------------------------------------------------ plain versions
def bn_stats_plain(y: torch.Tensor) -> torch.Tensor:
    """(2, C) f32: sum y and sum y^2 of each channel over all other axes."""
    x = y.float().reshape(-1, y.shape[-1])
    return torch.stack([x.sum(0), (x * x).sum(0)])


def _values(y: torch.Tensor, mean, scale, bias) -> torch.Tensor:
    return torch.relu((y.float() - mean) * scale + bias)


def bn_relu_apply_plain(y: torch.Tensor, mean: torch.Tensor, scale: torch.Tensor,
                        bias: torch.Tensor, pool_axis: Optional[int] = None) -> torch.Tensor:
    """relu((y - mean) * scale + bias) in f32: y's dtype out, or the max over
    `pool_axis` in f32."""
    r = _values(y, mean, scale, bias)
    return r.to(y.dtype) if pool_axis is None else r.amax(dim=pool_axis)


def bn_relu_grad_sums_plain(y: torch.Tensor, grad: torch.Tensor, mean: torch.Tensor,
                            scale: torch.Tensor, bias: torch.Tensor, s: torch.Tensor,
                            pool_axis: Optional[int] = None,
                            pooled: Optional[torch.Tensor] = None) -> tuple:
    """(sums (2, C) f32: sum g and sum g * xhat; q) where g is `grad` masked
    where the value is <= 0.  At the pooled width `grad` is the pooled
    output's (B, M, C) gradient and q = grad / ties (ties: the slots whose
    value equals `pooled`), (B, M, C) f32; each slot takes q at a tie, so a
    unit adds ties * q and q * (xhat summed over its ties), where the max is
    not <= 0 (a NaN max has no tie: NaN).  q is None at a hidden width."""
    r = _values(y, mean, scale, bias)
    xh = (y.float() - mean) * s
    if pool_axis is None:
        g = torch.where(r <= 0, 0.0, grad.float())
        dims = tuple(range(y.dim() - 1))
        return torch.stack([g.sum(dims), (g * xh).sum(dims)]), None
    tie = r == pooled.unsqueeze(pool_axis)
    ties = tie.sum(pool_axis).float()
    q = grad / ties
    tied_xh = torch.where(tie, xh, 0.0).sum(pool_axis)
    live = ~(pooled <= 0)
    sums = torch.stack([torch.where(live, ties * q, 0.0).sum((0, 1)),
                        torch.where(live, q * tied_xh, 0.0).sum((0, 1))])
    return sums, q


def bn_relu_grad_apply_plain(y: torch.Tensor, grad: torch.Tensor, mean: torch.Tensor,
                             scale: torch.Tensor, bias: torch.Tensor, s: torch.Tensor,
                             sums: torch.Tensor, count, var_raw: torch.Tensor,
                             pool_axis: Optional[int] = None,
                             pooled: Optional[torch.Tensor] = None,
                             q: Optional[torch.Tensor] = None) -> torch.Tensor:
    """dy in y's dtype: scale * (g - sum g / count - xhat * sum(g xhat) /
    count), the last term 0 where var_raw < 0 (the clamp's backward).  At
    the pooled width g is
    q where the slot's value equals `pooled`, masked where it is <= 0
    (torch's `(grad / ties) * (value == max)`, then the ReLU's mask)."""
    r = _values(y, mean, scale, bias)
    xh = (y.float() - mean) * s
    if pool_axis is None:
        g = torch.where(r <= 0, 0.0, grad.float())
    else:
        g = torch.where(r <= 0, 0.0, q.unsqueeze(pool_axis)
                        * (r == pooled.unsqueeze(pool_axis)).float())
    c1 = sums[0] / count
    c2 = torch.where(var_raw >= 0, sums[1] / count, 0.0)
    return (scale * ((g - c1) - xh * c2)).to(y.dtype)


# ----------------------------------------------------------------- launches
def _check(y: torch.Tensor, pool_axis: Optional[int], what: str) -> None:
    C = y.shape[-1]
    if y.dtype not in _DTYPES or C % VEC or not VEC <= C <= MAX_C:
        raise ValueError(f"{what}: the kernel takes bf16 or f32 with C a multiple of {VEC} up "
                         f"to {MAX_C}, got {tuple(y.shape)} {y.dtype}")
    if pool_axis not in (None, 1, 2) or (pool_axis is not None and y.dim() != 4):
        raise ValueError(f"{what}: the slot axis is 1 or 2 of a (B, ., ., C) tensor, got axis "
                         f"{pool_axis} of {tuple(y.shape)}")
    if y.numel() == 0:
        raise ValueError(f"{what}: an empty tensor {tuple(y.shape)}")


def _ready(t: torch.Tensor) -> torch.Tensor:
    """Contiguous and 16-byte aligned (a copy only where it is not)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _vec(t: torch.Tensor, C: int, dev: torch.device, what: str) -> torch.Tensor:
    if tuple(t.shape) != (C,) or t.dtype != torch.float32 or t.device != dev:
        raise ValueError(f"{what}: per-channel vectors are ({C},) f32 on {dev}, got "
                         f"{tuple(t.shape)} {t.dtype} on {t.device}")
    return t.contiguous()


def _device(y: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor; False for a CPU one; raises otherwise."""
    if y.device.type == "cpu":
        return False
    if y.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu tensors, got {y.device}")
    return True


def _pooled_shape(y: torch.Tensor, pool_axis: int) -> tuple:
    """(B, K, M, C, sB, sK, sM) of a contiguous (B, ., ., C) y."""
    B, D1, D2, C = y.shape
    if pool_axis == 1:
        return B, D1, D2, C, D1 * D2 * C, D2 * C, C
    return B, D2, D1, C, D1 * D2 * C, C, D2 * C


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def stat_blocks(units: int, C: int, sms: int, passes: int = STAT_MIN_PASSES) -> tuple:
    """(CTAs, units a CTA) of the sums' grid: STAT_CTAS_PER_SM CTAs an SM,
    fewer when a CTA would take fewer than `passes` passes of the units it
    holds at once (THREADS / (C / VEC)): rows, or at the pooled width (B, M)
    units of K slots each, which take one pass at least."""
    at_once = THREADS // (C // VEC)
    blocks = max(1, min(sms * STAT_CTAS_PER_SM, -(-units // (at_once * passes))))
    return blocks, -(-units // blocks)


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _f32(y: torch.Tensor) -> int:
    return int(y.dtype == torch.float32)


def bn_stats(y: torch.Tensor) -> torch.Tensor:
    """:func:`bn_stats_plain`'s function: y (..., C) -> (2, C) f32."""
    if not _device(y, "bn_stats"):
        return bn_stats_plain(y)
    _check(y, None, "bn_stats")
    y = _ready(y)
    C = y.shape[-1]
    rows = y.numel() // C
    blocks, per_blk = stat_blocks(rows, C, _sms(y.device.index or 0))
    partial = torch.empty((blocks, 2, C), dtype=torch.float32, device=y.device)
    out = torch.empty((2, C), dtype=torch.float32, device=y.device)
    lib = _lib()
    with torch.cuda.device(y.device):
        status = lib.ov3_bn_stats(y.data_ptr(), rows, C, _f32(y), blocks, per_blk,
                                  partial.data_ptr(), out.data_ptr(), _stream())
    _build.check(lib, status, "bn_stats")
    bn_stats.launches += 1
    return out


def bn_relu_apply(y: torch.Tensor, mean: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  pool_axis: Optional[int] = None) -> torch.Tensor:
    """:func:`bn_relu_apply_plain`'s function."""
    if not _device(y, "bn_relu_apply"):
        return bn_relu_apply_plain(y, mean, scale, bias, pool_axis)
    _check(y, pool_axis, "bn_relu_apply")
    y = _ready(y)
    C = y.shape[-1]
    mean, scale, bias = (_vec(t, C, y.device, "bn_relu_apply") for t in (mean, scale, bias))
    lib = _lib()
    with torch.cuda.device(y.device):
        if pool_axis is None:
            out = torch.empty_like(y)
            status = lib.ov3_bn_relu_apply(y.data_ptr(), y.numel() // C, C, _f32(y),
                                           mean.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                                           out.data_ptr(), _stream())
        else:
            B, K, M, _, sB, sK, sM = _pooled_shape(y, pool_axis)
            out = torch.empty((B, M, C), dtype=torch.float32, device=y.device)
            status = lib.ov3_bn_relu_apply_pooled(y.data_ptr(), B, K, M, C, sB, sK, sM, _f32(y),
                                                  mean.data_ptr(), scale.data_ptr(),
                                                  bias.data_ptr(), out.data_ptr(), _stream())
    _build.check(lib, status, "bn_relu_apply")
    bn_relu_apply.launches += 1
    return out


def bn_relu_grad_sums(y: torch.Tensor, grad: torch.Tensor, mean: torch.Tensor,
                      scale: torch.Tensor, bias: torch.Tensor, s: torch.Tensor,
                      pool_axis: Optional[int] = None,
                      pooled: Optional[torch.Tensor] = None) -> tuple:
    """:func:`bn_relu_grad_sums_plain`'s function: (sums (2, C), q or None)."""
    if not _device(y, "bn_relu_grad_sums"):
        return bn_relu_grad_sums_plain(y, grad, mean, scale, bias, s, pool_axis, pooled)
    _check(y, pool_axis, "bn_relu_grad_sums")
    y = _ready(y)
    C = y.shape[-1]
    mean, scale, bias, s = (_vec(t, C, y.device, "bn_relu_grad_sums")
                            for t in (mean, scale, bias, s))
    sms = _sms(y.device.index or 0)
    out = torch.empty((2, C), dtype=torch.float32, device=y.device)
    lib = _lib()
    with torch.cuda.device(y.device):
        if pool_axis is None:
            grad = _ready(grad.to(y.dtype))
            if grad.shape != y.shape:
                raise ValueError(f"bn_relu_grad_sums: grad {tuple(grad.shape)} for y "
                                 f"{tuple(y.shape)}")
            rows = y.numel() // C
            blocks, per_blk = stat_blocks(rows, C, sms)
            partial = torch.empty((blocks, 2, C), dtype=torch.float32, device=y.device)
            q = None
            status = lib.ov3_bn_grad_sums(y.data_ptr(), grad.data_ptr(), rows, C, _f32(y),
                                          mean.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                                          s.data_ptr(), blocks, per_blk, partial.data_ptr(),
                                          out.data_ptr(), _stream())
        else:
            B, K, M, _, sB, sK, sM = _pooled_shape(y, pool_axis)
            grad, pooled = (_ready(t.float()) for t in (grad, pooled))
            if grad.shape != (B, M, C) or pooled.shape != (B, M, C):
                raise ValueError(f"bn_relu_grad_sums: pooled {tuple(pooled.shape)} and grad "
                                 f"{tuple(grad.shape)} for y {tuple(y.shape)}, axis {pool_axis}")
            blocks, per_blk = stat_blocks(B * M, C, sms, passes=1)
            partial = torch.empty((blocks, 2, C), dtype=torch.float32, device=y.device)
            q = torch.empty((B, M, C), dtype=torch.float32, device=y.device)
            status = lib.ov3_bn_grad_sums_pooled(
                y.data_ptr(), pooled.data_ptr(), grad.data_ptr(), q.data_ptr(), B, K, M, C, sB,
                sK, sM, _f32(y), mean.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                s.data_ptr(), blocks, per_blk, partial.data_ptr(), out.data_ptr(), _stream())
    _build.check(lib, status, "bn_relu_grad_sums")
    bn_relu_grad_sums.launches += 1
    return out, q


def bn_relu_grad_apply(y: torch.Tensor, grad: torch.Tensor, mean: torch.Tensor,
                       scale: torch.Tensor, bias: torch.Tensor, s: torch.Tensor,
                       sums: torch.Tensor, count, var_raw: torch.Tensor,
                       pool_axis: Optional[int] = None, pooled: Optional[torch.Tensor] = None,
                       q: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`bn_relu_grad_apply_plain`'s function; `count` a float or a (1,)
    f32 tensor on the device (the count all-reduced over a data group)."""
    if not _device(y, "bn_relu_grad_apply"):
        return bn_relu_grad_apply_plain(y, grad, mean, scale, bias, s, sums, count, var_raw,
                                        pool_axis, pooled, q)
    _check(y, pool_axis, "bn_relu_grad_apply")
    y = _ready(y)
    C = y.shape[-1]
    mean, scale, bias, s = (_vec(t, C, y.device, "bn_relu_grad_apply")
                            for t in (mean, scale, bias, s))
    sums = sums.contiguous()
    if tuple(sums.shape) != (2, C) or sums.dtype != torch.float32:
        raise ValueError(f"bn_relu_grad_apply: sums are (2, {C}) f32, got {tuple(sums.shape)}")
    var_raw = _vec(var_raw, C, y.device, "bn_relu_grad_apply")
    if isinstance(count, torch.Tensor):
        count_host, count_dev = 0.0, count.float().contiguous()
        count_ptr = count_dev.data_ptr()
    else:
        count_host, count_ptr = float(count), None
    dy = torch.empty_like(y)
    lib = _lib()
    with torch.cuda.device(y.device):
        if pool_axis is None:
            grad = _ready(grad.to(y.dtype))
            if grad.shape != y.shape:
                raise ValueError(f"bn_relu_grad_apply: grad {tuple(grad.shape)} for y "
                                 f"{tuple(y.shape)}")
            status = lib.ov3_bn_grad_apply(y.data_ptr(), grad.data_ptr(), y.numel() // C, C,
                                           _f32(y), mean.data_ptr(), scale.data_ptr(),
                                           bias.data_ptr(), s.data_ptr(), sums.data_ptr(),
                                           count_host, count_ptr, var_raw.data_ptr(),
                                           dy.data_ptr(), _stream())
        else:
            B, K, M, _, sB, sK, sM = _pooled_shape(y, pool_axis)
            pooled, q = (_ready(t.float()) for t in (pooled, q))
            if pooled.shape != (B, M, C) or q.shape != (B, M, C):
                raise ValueError(f"bn_relu_grad_apply: pooled {tuple(pooled.shape)} and q "
                                 f"{tuple(q.shape)} for y {tuple(y.shape)}, axis {pool_axis}")
            status = lib.ov3_bn_grad_apply_pooled(
                y.data_ptr(), pooled.data_ptr(), q.data_ptr(), B, K, M, C, sB, sK, sM, _f32(y),
                mean.data_ptr(), scale.data_ptr(), bias.data_ptr(), s.data_ptr(),
                sums.data_ptr(), count_host, count_ptr, var_raw.data_ptr(), dy.data_ptr(),
                _stream())
    _build.check(lib, status, "bn_relu_grad_apply")
    bn_relu_grad_apply.launches += 1
    return dy


bn_stats.launches = 0
bn_relu_apply.launches = 0
bn_relu_grad_sums.launches = 0
bn_relu_grad_apply.launches = 0


def _lib() -> ctypes.CDLL:
    return _build.load("bn_relu", _SIGNATURES)


_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
_SIGNATURES = {
    "ov3_bn_stats": ([_P, _L, _I, _I, _I, _L, _P, _P, _P], _I),
    "ov3_bn_relu_apply": ([_P, _L, _I, _I, _P, _P, _P, _P, _P], _I),
    "ov3_bn_relu_apply_pooled": ([_P, _I, _I, _I, _I, _L, _L, _L, _I, _P, _P, _P, _P, _P], _I),
    "ov3_bn_grad_sums": ([_P, _P, _L, _I, _I, _P, _P, _P, _P, _I, _L, _P, _P, _P], _I),
    "ov3_bn_grad_sums_pooled": ([_P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _L, _I, _P, _P, _P, _P,
                                 _I, _L, _P, _P, _P], _I),
    "ov3_bn_grad_apply": ([_P, _P, _L, _I, _I, _P, _P, _P, _P, _P, _F, _P, _P, _P, _P], _I),
    "ov3_bn_grad_apply_pooled": ([_P, _P, _P, _I, _I, _I, _I, _L, _L, _L, _I, _P, _P, _P, _P,
                                  _P, _F, _P, _P, _P, _P], _I),
}
