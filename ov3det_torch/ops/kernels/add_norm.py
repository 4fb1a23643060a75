"""The transformer's pre-norm "add & norm": x_new = x + dropout(branch), then
y = LayerNorm(x_new), forward and backward.  The CUDA kernels' wrappers and
their plain versions.

Counterpart of flax `nn.LayerNorm(epsilon=1e-5)` and the residual
`x + nn.Dropout(rate)(branch)` in front of it in
`ov3det/models/transformer.py:179-191`, `:275-294` and `:314-322` (XLA in
JAX, not a Pallas kernel).  `ov3det_torch/csrc/add_norm.cu` holds two
kernels on row-major (rows, C) tensors, C a multiple of 8 up to 768 (C 256,
every detector path's width, one piece a lane; a generic instantiation for
the others):

  * `add_norm` (`add_norm_fwd`): the optional prologue x_new = x +
    where(keep, branch / keep_prob, 0) (f32; flax's division: the IEEE
    quotient by the keep probability rounded to branch's dtype, rounded to
    branch's dtype, `dropped`), then each row's mean, the fast variance
    var_raw = mean(x^2) - mean^2 clamped at 0, r = rsqrt(var + eps) and y =
    (x - mean) * (r * weight) + bias in f32, each operation rounded as the
    plain version's torch ops round it.  Returns x_new, y and the rows'
    (mean, r, var_raw) as (3, rows) f32 for the backward;
  * `add_norm_grad` (`add_norm_bwd`, one kernel a launch): dx = r * ((gw -
    mean(gw)) - xhat * mean(gw * xhat)) with gw = dy * weight and xhat = (x -
    mean) * r, the last term dropped where var_raw < 0 (torch.clamp's
    backward), plus x_new's own gradient, in x's dtype; dbranch =
    where(keep, dx in branch's dtype, 0) / keep_prob in autograd's order, the
    same division; and dweight = sum dy * xhat, dbias = sum dy over the rows:
    each CTA's partial row, then, in the same cooperative launch, after a
    grid barrier, each CTA's share of the columns over all the rows in a
    fixed order (no float atomics: two launches give the same bits).

x is f32 or bf16, branch bf16 or f32, x_new always f32: a bf16 x takes an
f32 branch only (the module would keep a bf16 sum of two bf16 tensors, which
no path of the port forms: the residual stream is f32).  `models/mlp.py`
chains them (`AddNorm`).  Each wrapper takes its plain version for CPU
tensors (the `*_plain` functions, the tests' transcription and the card's
oracle) and launches its kernel for CUDA tensors or raises; each counts its
launches in `.launches`.  No host wait, no workspace but torch's allocator
and the divisors made once a device before any capture:
CUDA graphs capture every launch.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from ov3det_torch.ops.kernels import _build

SOURCE = "ov3det_torch/csrc/add_norm.cu"
_WHAT = ("ov3det/models/transformer.py:179 (the encoder and decoder layers' flax nn.LayerNorm "
         "and the residual x + nn.Dropout(.) before it, and the decoder's final norm")
REPLACES = f"{_WHAT}: the add and the norm, XLA, not Pallas)"
GRAD_REPLACES = f"{_WHAT}: their VJP, XLA, not Pallas)"
VEC = 8  # channels a lane's piece, mirrored from `kVec` of the source
MAX_C = 768  # mirrored from `kMaxC`
THREADS = 256  # mirrored from `kThreads`
WARPS = THREADS // 32
WIDE_C = 256  # the width with an instantiation of its own, mirrored from `kWideC`
BWD_CTAS_WIDE = 2  # the backward's CTAs an SM at WIDE_C (`kBwdCtasWide`) ...
BWD_CTAS_GENERIC = 1  # ... and at the other widths (`kBwdCtasGeneric`)
_DTYPES = (torch.bfloat16, torch.float32)


# ------------------------------------------------------------ plain versions
def divisor(keep_prob: float, dtype: torch.dtype) -> float:
    """flax `nn.Dropout`'s divisor for an input of `dtype`: the keep
    probability rounded to that dtype (a weak-typed Python float takes the
    input's dtype: 0.9 is 0.8984375 in bf16)."""
    return torch.tensor(keep_prob, dtype=dtype).item()


def reciprocal(keep_prob: float) -> float:
    """The f32 reciprocal of the bf16 keep probability (`divisor`).  For every
    bf16 value x, x times it rounded to bf16 is x / divisor rounded to bf16:
    the product lies within two f32 ulps of the quotient, which is never
    that close to a bf16 rounding boundary (tests/test_torch_add_norm.py
    holds every bf16 x against every bf16 divisor in [0.5, 1])."""
    return float(np.float32(1.0) / np.float32(divisor(keep_prob, torch.bfloat16)))


_DIVISORS: dict = {}  # (device, dtype, keep_prob) -> the divisor as a 0-dim tensor there


def _divisor_of(t: torch.Tensor, keep_prob: float):
    """`divisor` for t's dtype: a Python float on the CPU, where torch divides
    by it; on the card a 0-dim tensor of t's dtype on t's device (torch
    divides by a CPU scalar as the product by its reciprocal there), made at
    the first call on a device and dtype, outside any CUDA graph capture."""
    if t.device.type == "cpu":
        return divisor(keep_prob, t.dtype)
    key = (t.device, t.dtype, keep_prob)
    d = _DIVISORS.get(key)
    if d is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"dropout: the divisor of {keep_prob} in {t.dtype} on {t.device} "
                               "is made by an eager call before a CUDA graph captures one")
        d = _DIVISORS[key] = torch.full((), divisor(keep_prob, t.dtype), dtype=t.dtype,
                                        device=t.device)
    return d


def dropped(branch: torch.Tensor, keep: Optional[torch.Tensor], keep_prob: float) -> torch.Tensor:
    """flax `nn.Dropout` given its mask: where(keep, branch / keep_prob, 0) in
    branch's dtype, the quotient the IEEE one by the keep probability rounded
    to branch's dtype (`divisor`), rounded to branch's dtype, on either
    device (a bf16 branch times `reciprocal`, one scalar product with the
    same bits; an f32 one divided); branch itself without a mask.  Its
    autograd VJP is the same quotient of the incoming gradient, as flax's."""
    if keep is None:
        return branch
    if branch.dtype == torch.bfloat16:
        return torch.where(keep, branch * reciprocal(keep_prob), 0.0)
    return torch.where(keep, branch / _divisor_of(branch, keep_prob), 0.0)


def layer_norm_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     eps: float) -> tuple:
    """The module expression of `models.mlp.LayerNorm` (its CPU path) on
    x.float(): (y, stats), stats the rows' (mean, r = rsqrt(var + eps),
    var_raw) as (3, rows) f32."""
    h = x.float()
    mean = h.mean(dim=-1, keepdim=True)
    var_raw = (h * h).mean(dim=-1, keepdim=True) - mean * mean
    r = torch.rsqrt(torch.clamp(var_raw, min=0.0) + eps)
    y = (h - mean) * (r * weight) + bias
    return y, torch.stack([mean, r, var_raw]).reshape(3, -1)


def add_norm_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float,
                   branch: Optional[torch.Tensor] = None, keep: Optional[torch.Tensor] = None,
                   keep_prob: float = 1.0) -> tuple:
    """(x_new, y, stats): x_new = x + dropped(branch) (None without a branch),
    then `layer_norm_plain` of x_new (of x without a branch)."""
    x_new = None if branch is None else x + dropped(branch, keep, keep_prob)
    y, stats = layer_norm_plain(x if x_new is None else x_new, weight, bias, eps)
    return x_new, y, stats


def _row_stats(stats: torch.Tensor, shape) -> tuple:
    return tuple(s.reshape(*shape[:-1], 1) for s in stats)


def add_norm_grad_plain(x: torch.Tensor, grad_y: torch.Tensor, stats: torch.Tensor,
                        weight: torch.Tensor, dx_dtype: torch.dtype,
                        grad_res: Optional[torch.Tensor] = None,
                        branch_dtype: Optional[torch.dtype] = None,
                        keep: Optional[torch.Tensor] = None, keep_prob: float = 1.0) -> tuple:
    """(dx, dbranch): x is what the norm read (x_new with a branch); dx =
    r * ((gw - sum gw / C) - xhat * sum(gw xhat) / C), the last term 0 where
    var_raw < 0, plus `grad_res`, in `dx_dtype`; with `branch_dtype`,
    dbranch = `dropped` of that sum in branch's dtype, the VJP of x +
    dropped(branch) (else None)."""
    mean, r, var_raw = _row_stats(stats, x.shape)
    C = x.shape[-1]
    xh = (x.float() - mean) * r
    gw = grad_y.float() * weight
    c1 = gw.sum(dim=-1, keepdim=True) / C
    c2 = torch.where(var_raw >= 0, (gw * xh).sum(dim=-1, keepdim=True) / C, 0.0)
    dx = r * ((gw - c1) - xh * c2)
    if grad_res is not None:
        dx = dx + grad_res.float()
    dbranch = None
    if branch_dtype is not None:
        dbranch = dropped(dx.to(branch_dtype), keep, keep_prob)
    return dx.to(dx_dtype), dbranch


def add_norm_param_grads_plain(x: torch.Tensor, grad_y: torch.Tensor,
                               stats: torch.Tensor) -> torch.Tensor:
    """(2, C) f32: dweight = sum dy * xhat and dbias = sum dy over the rows."""
    mean, r, _ = _row_stats(stats, x.shape)
    C = x.shape[-1]
    xh = ((x.float() - mean) * r).reshape(-1, C)
    g = grad_y.float().reshape(-1, C)
    return torch.stack([(g * xh).sum(0), g.sum(0)])


# ----------------------------------------------------------------- launches
def _device(x: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor; False for a CPU one; raises otherwise."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu tensors, got {x.device}")
    return True


def _check(x: torch.Tensor, branch: Optional[torch.Tensor], what: str) -> None:
    C = x.shape[-1] if x.dim() else 0
    if x.dtype not in _DTYPES or C % VEC or not VEC <= C <= MAX_C or x.numel() == 0:
        raise ValueError(f"{what}: the kernel takes bf16 or f32 rows with C a multiple of {VEC} "
                         f"up to {MAX_C}, got {tuple(x.shape)} {x.dtype}")
    if branch is None:
        return
    if branch.dtype not in _DTYPES or branch.shape != x.shape:
        raise ValueError(f"{what}: branch {tuple(branch.shape)} {branch.dtype} for x "
                         f"{tuple(x.shape)} {x.dtype}")
    if x.dtype == torch.bfloat16 and branch.dtype == torch.bfloat16:
        raise ValueError(f"{what}: a bf16 x takes an f32 branch only (x_new is f32)")


def _ready(t: torch.Tensor) -> torch.Tensor:
    """Contiguous and 16-byte aligned (a copy only where it is not)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _like(t: Optional[torch.Tensor], x: torch.Tensor, dtype, what: str,
          name: str) -> Optional[torch.Tensor]:
    if t is None:
        return None
    if t.shape != x.shape or t.dtype != dtype or t.device != x.device:
        raise ValueError(f"{what}: {name} is {tuple(x.shape)} {dtype} on {x.device}, got "
                         f"{tuple(t.shape)} {t.dtype} on {t.device}")
    return _ready(t)


def _vec(t: torch.Tensor, C: int, dev: torch.device, what: str) -> torch.Tensor:
    if tuple(t.shape) != (C,) or t.dtype != torch.float32 or t.device != dev:
        raise ValueError(f"{what}: weight and bias are ({C},) f32 on {dev}, got "
                         f"{tuple(t.shape)} {t.dtype} on {t.device}")
    return _ready(t.detach())


def _f32(t: torch.Tensor) -> int:
    return int(t.dtype == torch.float32)


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def grad_blocks(rows: int, sms: int, C: int) -> tuple:
    """(CTAs, rows a CTA) of the backward's grid: one wave of the CTAs its
    launch bounds keep resident (BWD_CTAS_WIDE an SM at C WIDE_C, else
    BWD_CTAS_GENERIC), which its cooperative launch must hold resident at
    once, each warp the fewest rows that covers `rows`, a row a warp where
    the rows are few."""
    ctas = BWD_CTAS_WIDE if C == WIDE_C else BWD_CTAS_GENERIC
    per_warp = -(-rows // (sms * ctas * WARPS))
    per_blk = per_warp * WARPS
    return -(-rows // per_blk), per_blk


def add_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float,
             branch: Optional[torch.Tensor] = None, keep: Optional[torch.Tensor] = None,
             keep_prob: float = 1.0) -> tuple:
    """:func:`add_norm_plain`'s function: (x_new or None, y, stats)."""
    if not _device(x, "add_norm"):
        return add_norm_plain(x, weight, bias, eps, branch, keep, keep_prob)
    _check(x, branch, "add_norm")
    if keep is not None and branch is None:
        raise ValueError("add_norm: a keep mask without a branch")
    x = _ready(x)
    C = x.shape[-1]
    rows = x.numel() // C
    branch = None if branch is None else _like(branch, x, branch.dtype, "add_norm", "branch")
    keep = _like(keep, x, torch.bool, "add_norm", "keep")
    weight, bias = (_vec(t, C, x.device, "add_norm") for t in (weight, bias))
    y = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    x_new = None if branch is None else torch.empty_like(y)
    stats = torch.empty((3, rows), dtype=torch.float32, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        status = lib.ov3_add_norm_fwd(
            x.data_ptr(), _f32(x), None if branch is None else branch.data_ptr(),
            0 if branch is None else _f32(branch), None if keep is None else keep.data_ptr(),
            1.0 if branch is None else divisor(keep_prob, branch.dtype), weight.data_ptr(),
            bias.data_ptr(), eps, rows, C,
            None if x_new is None else x_new.data_ptr(), y.data_ptr(), stats.data_ptr(),
            _stream())
    _build.check(lib, status, "add_norm")
    add_norm.launches += 1
    return x_new, y, stats


def add_norm_grad(x: torch.Tensor, grad_y: torch.Tensor, stats: torch.Tensor,
                  weight: torch.Tensor, dx_dtype: torch.dtype,
                  grad_res: Optional[torch.Tensor] = None,
                  branch_dtype: Optional[torch.dtype] = None,
                  keep: Optional[torch.Tensor] = None, keep_prob: float = 1.0) -> tuple:
    """(dx, dbranch, sums): :func:`add_norm_grad_plain`'s (dx, dbranch) and
    :func:`add_norm_param_grads_plain`'s (2, C) dweight and dbias.  x is what
    the norm read: the f32 x_new with a branch (`branch_dtype` given, with
    `grad_res`), else the input x, whose dtype is `dx_dtype`."""
    if not _device(x, "add_norm_grad"):
        dx, dbranch = add_norm_grad_plain(x, grad_y, stats, weight, dx_dtype, grad_res,
                                          branch_dtype, keep, keep_prob)
        return dx, dbranch, add_norm_param_grads_plain(x, grad_y, stats)
    add = branch_dtype is not None
    if dx_dtype not in _DTYPES or (add and (branch_dtype not in _DTYPES or (
            dx_dtype == branch_dtype == torch.bfloat16))):
        raise ValueError(f"add_norm_grad: dx {dx_dtype} with branch {branch_dtype}")
    if add and (x.dtype != torch.float32 or grad_res is None):
        raise ValueError("add_norm_grad: with a branch, x is the f32 x_new and grad_res is given")
    if not add and (x.dtype != dx_dtype or grad_res is not None or keep is not None):
        raise ValueError("add_norm_grad: without a branch, dx takes x's dtype and there is no "
                         "grad_res or keep mask")
    _check(x, None, "add_norm_grad")
    x = _ready(x)
    C = x.shape[-1]
    rows = x.numel() // C
    grad_y = _like(grad_y.float(), x, torch.float32, "add_norm_grad", "grad_y")
    grad_res = _like(None if grad_res is None else grad_res.float(), x, torch.float32,
                     "add_norm_grad", "grad_res")
    keep = _like(keep, x, torch.bool, "add_norm_grad", "keep")
    weight = _vec(weight, C, x.device, "add_norm_grad")
    if tuple(stats.shape) != (3, rows) or stats.dtype != torch.float32:
        raise ValueError(f"add_norm_grad: stats are (3, {rows}) f32, got {tuple(stats.shape)}")
    stats = stats.contiguous()
    blocks, per_blk = grad_blocks(rows, _sms(x.device.index or 0), C)
    dx = torch.empty(x.shape, dtype=dx_dtype, device=x.device)
    dbranch = None if not add else torch.empty(x.shape, dtype=branch_dtype, device=x.device)
    partial = torch.empty((blocks, 2, C), dtype=torch.float32, device=x.device)
    sums = torch.empty((2, C), dtype=torch.float32, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        status = lib.ov3_add_norm_bwd(
            x.data_ptr(), _f32(dx), grad_y.data_ptr(),
            None if grad_res is None else grad_res.data_ptr(), stats.data_ptr(),
            weight.data_ptr(), int(add), int(add and branch_dtype == torch.float32),
            None if keep is None else keep.data_ptr(),
            1.0 if not add else divisor(keep_prob, branch_dtype), rows, C, dx.data_ptr(),
            None if dbranch is None else dbranch.data_ptr(), blocks, per_blk, partial.data_ptr(),
            sums.data_ptr(), _stream())
    _build.check(lib, status, "add_norm_grad")
    add_norm_grad.launches += 1
    return dx, dbranch, sums


add_norm.launches = 0
add_norm_grad.launches = 0


def _lib() -> ctypes.CDLL:
    return _build.load("add_norm", _SIGNATURES)


_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
_SIGNATURES = {
    "ov3_add_norm_fwd": ([_P, _I, _P, _I, _P, _F, _P, _P, _F, _L, _I, _P, _P, _P, _P], _I),
    "ov3_add_norm_bwd": ([_P, _I, _P, _P, _P, _P, _I, _I, _P, _F, _L, _I, _P, _P, _I, _L, _P, _P,
                          _P], _I),
}
