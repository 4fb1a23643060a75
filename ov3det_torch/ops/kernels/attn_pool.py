"""CLIP's single-query attention pool: the CUDA kernels' wrappers and their
plain versions.

The kernels (`ov3det_torch/csrc/attn_pool.cu`) replace the token work of
`AttentionPool2d.__call__` (`ov3det/models/clip_resnet.py:211-281`), which
XLA runs on the TPU (not a Pallas kernel).  With the key projection folded
through the one query (u_h = K_h q_h), the pool of a region's tokens x_1..x_L
(the res5 map) is two passes:

  * `pool_tokens`: token 0, the mean token: the L tokens summed in f32 in
    index order, divided by L (`__fdiv_rn`), rounded to the token dtype,
    plus pos[0] in the token dtype.  A thread 8 channels of a region.  Its
    plain version takes the same order (a Python loop over the tokens), so
    the two agree bit for bit.
  * `pool_attend`: the logits token_k . u_h / sqrt(hd) over the L + 1
    tokens, softmax in f32 (max-subtract, expf, sum, divide) and
    z[h, c] = sum_k a[h, k] token_k[c] in f32, written in `out_dtype` (the
    v projection's dtype, which its einsum reads).  Tokens 1..L are rebuilt
    on the fly as x_k + pos_k, rounded to the token dtype, token 0 is
    `pool_tokens`'s: neither the (R, L + 1, C) concatenation nor an f32 copy
    of the tokens is stored.  bf16 tokens go to the tensor cores (mma.sync
    m16n8k16, the products of bf16 values exact in f32, the f32 weights of z
    split into three bf16 terms that carry them to 2^-24).  The routed design
    for bf16 tokens (`pool_attend_cluster`, where `cluster_takes`) is a
    thread-block cluster of `CLUSTER` CTAs a region, each holding its slice
    of C / `CLUSTER` channels of all the tokens in shared memory, read from
    device memory once: partial logits of the slice, summed over the
    cluster's shared memory in rank order (every CTA the same f32 logits),
    the softmax, then z of the slice from the resident tokens.  The first
    design (`pool_attend_mma`, a CTA a region streaming channel tiles of the
    tokens through shared memory twice), which the private
    `_impl="first"` keeps, is the yardstick.  f32 tokens take f32
    multiply-adds on either route (`pool_attend_kernel`, the first design:
    the teacher's f32 tower is not the path users run).  Every sum runs in a
    fixed order with no atomics: two launches give the same bits.  Its plain
    version is the einsum and softmax code the module ran before; the
    kernels agree with it within rounding (z within 1 bf16 ulp in bf16, 1e-5
    of the largest value in f32).

The projections (q, the fold u = K_h q_h, v and c) stay library products
outside the kernels, as JAX leaves them to XLA.  CUDA tensors launch the
kernels, one launch a call each with no host wait, counted in
`pool_tokens.launches` and `pool_attend.launches` (either design); CPU
tensors take the plain versions.  The kernels take f32 or bf16 tokens, C a multiple of 8,
16-byte aligned operands, at most `MAX_TOKENS` tokens (the pooled one
included) and `MAX_HEADS` heads; any other call raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from typing import Optional

from ov3det_torch.ops.kernels import _build

SOURCE = "ov3det_torch/csrc/attn_pool.cu"
TOKENS_REPLACES = ("ov3det/models/clip_resnet.py:220 (AttentionPool2d: the mean token, "
                   "XLA, not Pallas)")
ATTEND_REPLACES = ("ov3det/models/clip_resnet.py:267 (AttentionPool2d: the single-query "
                   "attention over the tokens, XLA, not Pallas)")
# csrc/attn_pool.cu: kMaxTokens, kMaxHeads, kTile (channels a stage), kThreads
MAX_TOKENS = 128
MAX_HEADS = 64
TILE = 64
THREADS = 256
# the cluster design: kCluster (CTAs a region), kClusterMaxSlice (channels a
# CTA), kClusterMaxTokens and kClusterMaxHeads (tokens and heads, each
# rounded up to 16, at the most)
CLUSTER = 8
CLUSTER_MAX_SLICE = 320
CLUSTER_MAX_TOKENS = 96
CLUSTER_MAX_HEADS = 48
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def cluster_takes(tokens: int, heads: int, C: int) -> bool:
    """Whether bf16 tokens of this shape (`tokens` = L + 1, the pooled one
    included) run the cluster design (`cluster_takes` of csrc/attn_pool.cu):
    C a multiple of 16 x CLUSTER, at most CLUSTER_MAX_SLICE channels a CTA,
    tokens and heads rounded up to 16 within their limits."""
    return (C % (16 * CLUSTER) == 0 and C // CLUSTER <= CLUSTER_MAX_SLICE
            and _round16(tokens) <= CLUSTER_MAX_TOKENS and _round16(heads) <= CLUSTER_MAX_HEADS)


def _aligned(*tensors: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _check_tokens(x: torch.Tensor, pos0: torch.Tensor) -> None:
    if x.dim() != 3 or x.dtype not in _DTYPES or x.shape[1] < 1:
        raise ValueError(f"pool_tokens expects (R, L, C) f32 or bf16 tokens, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if pos0.shape != x.shape[2:] or pos0.dtype != x.dtype or pos0.device != x.device:
        raise ValueError(f"pool_tokens expects a ({x.shape[2]},) {x.dtype} pos[0] beside the "
                         f"tokens, got {tuple(pos0.shape)} {pos0.dtype} on {pos0.device}")


def pool_tokens_plain(x: torch.Tensor, pos0: torch.Tensor) -> torch.Tensor:
    """(R, L, C) tokens, (C,) pos[0] -> (R, C) token 0 in the token dtype:
    the f32 sum in index order over L, divided by L, rounded, plus pos[0]."""
    acc = torch.zeros((x.shape[0], x.shape[2]), dtype=torch.float32, device=x.device)
    for k in range(x.shape[1]):
        acc = acc + x[:, k].float()
    # a divisor tensor: PyTorch's CUDA division by a Python number multiplies
    # by its rounded reciprocal, which is not the kernel's quotient
    return (acc / torch.full_like(acc, float(x.shape[1]))).to(x.dtype) + pos0


def pool_tokens(x: torch.Tensor, pos0: torch.Tensor) -> torch.Tensor:
    """Token 0 of the pool, the mean token plus pos[0]: x (R, L, C) f32 or
    bf16, pos0 (C,) in its dtype -> (R, C) in its dtype."""
    _check_tokens(x, pos0)
    if x.device.type == "cpu":
        return pool_tokens_plain(x, pos0)
    if x.device.type != "cuda":
        raise ValueError(f"pool_tokens runs on cuda or cpu tensors, got {x.device}")
    R, L, C = x.shape
    out = torch.empty((R, C), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        x, pos0 = x.contiguous(), pos0.contiguous()
        if C % 8 != 0 or not _aligned(x, pos0):
            raise ValueError(f"pool_tokens: the kernel takes C a multiple of 8 (got {C}) and "
                             "16-byte aligned operands")
        if R == 0:
            return out
        lib = _build.load("attn_pool", _SIGNATURES)
        status = lib.ov3_pool_tokens(x.data_ptr(), pos0.data_ptr(), R, L, C, _DTYPES[x.dtype],
                                     out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _build.check(lib, status, "pool_tokens")
    pool_tokens.launches += 1
    return out


pool_tokens.launches = 0


def _check_attend(x, pos, token0, u, head_dim: int, out_dtype) -> None:
    if x.dim() != 3 or x.dtype not in _DTYPES:
        raise ValueError(f"pool_attend expects (R, L, C) f32 or bf16 tokens, got "
                         f"{tuple(x.shape)} {x.dtype}")
    R, L, C = x.shape
    want = {"pos": (pos, (L + 1, C)), "token0": (token0, (R, C))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape or t.dtype != x.dtype:
            raise ValueError(f"pool_attend expects {name} {shape} {x.dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if u.dim() != 3 or u.shape[0] != R or u.shape[2] != C or u.dtype != x.dtype:
        raise ValueError(f"pool_attend expects u (R, heads, C) = ({R}, heads, {C}) {x.dtype}, "
                         f"got {tuple(u.shape)} {u.dtype}")
    if head_dim < 1 or out_dtype not in _DTYPES:
        raise ValueError(f"pool_attend: head_dim {head_dim}, out_dtype {out_dtype}")
    if len({t.device for t in (x, pos, token0, u)}) > 1:
        raise ValueError("pool_attend operands on several devices")


def pool_attend_plain(x: torch.Tensor, pos: torch.Tensor, token0: torch.Tensor, u: torch.Tensor,
                      head_dim: int, out_dtype: torch.dtype) -> torch.Tensor:
    """The pool's attention as einsums: the tokens [token0, x + pos[1:]] in
    the token dtype, the f32 logits over them and u, / sqrt(head_dim), their
    softmax and the attention-weighted f32 sum of the tokens -> (R, heads,
    C) in out_dtype."""
    tokens = torch.cat([token0[:, None], x + pos[None, 1:]], dim=1)
    tokens_f = tokens.float()
    attn = torch.einsum("bkc,bhc->bhk", tokens_f, u.float()) / math.sqrt(head_dim)
    attn = torch.softmax(attn, dim=-1)
    return torch.einsum("bhk,bkc->bhc", attn, tokens_f).to(out_dtype)


def _entry(impl: Optional[str], on_cuda: bool) -> str:
    """The C entry point for the private `_impl` argument: None is the
    routed design, "first" the first design."""
    if impl is None:
        return "ov3_pool_attend"
    if impl != "first":
        raise ValueError(f"pool_attend: _impl is None (the routed design) or 'first', got "
                         f"{impl!r}")
    if not on_cuda:
        raise ValueError("pool_attend: _impl chooses between CUDA kernels; these tensors lie on "
                         "the CPU")
    return "ov3_pool_attend_first"


def pool_attend(x: torch.Tensor, pos: torch.Tensor, token0: torch.Tensor, u: torch.Tensor,
                head_dim: int, out_dtype: torch.dtype, _impl: Optional[str] = None) -> torch.Tensor:
    """The single-query attention of the pool: x (R, L, C) the raw tokens,
    pos (L + 1, C) the positional grid in their dtype, token0 (R, C)
    `pool_tokens`'s, u (R, heads, C) the folded query in their dtype ->
    z (R, heads, C) in out_dtype (f32 or bf16); on CUDA tensors the routed
    design or, with `_impl="first"`, the first."""
    _check_attend(x, pos, token0, u, head_dim, out_dtype)
    entry = _entry(_impl, x.device.type == "cuda")
    if x.device.type == "cpu":
        return pool_attend_plain(x, pos, token0, u, head_dim, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"pool_attend runs on cuda or cpu tensors, got {x.device}")
    R, L, C = x.shape
    heads = u.shape[1]
    z = torch.empty((R, heads, C), dtype=out_dtype, device=x.device)
    with torch.cuda.device(x.device):
        x, pos, token0, u = (t.contiguous() for t in (x, pos, token0, u))
        if L + 1 > MAX_TOKENS or heads > MAX_HEADS or C % 8 != 0 or not _aligned(x, pos, token0, u):
            raise ValueError(f"pool_attend: the kernel takes at most {MAX_TOKENS} tokens (got "
                             f"{L + 1}) and {MAX_HEADS} heads (got {heads}), C a multiple of 8 "
                             f"(got {C}), 16-byte aligned operands")
        if R == 0:
            return z
        lib = _build.load("attn_pool", _SIGNATURES)
        status = getattr(lib, entry)(
            x.data_ptr(), pos.data_ptr(), token0.data_ptr(), u.data_ptr(), R, L + 1, heads, C,
            ctypes.c_float(math.sqrt(head_dim)), _DTYPES[x.dtype], _DTYPES[out_dtype],
            z.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _build.check(lib, status, "pool_attend")
    pool_attend.launches += 1
    return z


pool_attend.launches = 0

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"ov3_pool_tokens": ([_P, _P, _I, _I, _I, _I, _P, _P], _I),
               **{name: ([_P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_float, _I, _I, _P, _P], _I)
                  for name in ("ov3_pool_attend", "ov3_pool_attend_first")},
               "ov3_pool_attend_clusters": ([_I, _I, _I, ctypes.POINTER(_I)], _I)}


def clusters_held(tokens: int, heads: int, C: int) -> int:
    """The clusters of the bf16 cluster design the current card holds at
    once at this shape (cudaOccupancyMaxActiveClusters); CUDA only."""
    lib = _build.load("attn_pool", _SIGNATURES)
    n = _I(0)
    _build.check(lib, lib.ov3_pool_attend_clusters(tokens, heads, C, ctypes.byref(n)),
                 "pool_attend_clusters")
    return n.value
