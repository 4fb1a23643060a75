"""The plain versions of the port's kernels, copied verbatim: the functions
each kernel of `ov3det_torch/ops/kernels/` is held to, and nothing that
launches one.  Each section names the file it was copied from.  Only
torch and numpy are imported: nothing of the port.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def _f32(x: float) -> float:
    """The f32 value of a Python float."""
    return float(np.float32(x))



# ------------------------------------------------------------ ov3det_torch/ops/kernels/fps.py

def fps_plain(xyz: torch.Tensor, num_samples: int) -> torch.Tensor:
    """Plain PyTorch FPS: (B, N, 3) f32 -> (B, num_samples) int64.

    The loop of `ov3det/ops/pointcloud.py:134-148` with shards=1, with d2
    written as (dx*dx + dy*dy) + dz*dz like the kernels.
    """
    B, N, _ = xyz.shape
    rows = torch.arange(B, device=xyz.device)
    inds = torch.zeros((B, num_samples), dtype=torch.int64, device=xyz.device)
    min_d2 = torch.full((B, N), 1e10, dtype=torch.float32, device=xyz.device)
    last = xyz[:, 0, :]
    for i in range(1, num_samples):
        d = xyz - last[:, None, :]
        dx, dy, dz = d.unbind(-1)
        d2 = (dx * dx + dy * dy) + dz * dz
        min_d2 = torch.minimum(min_d2, d2)
        nxt = torch.argmax(min_d2, dim=-1)  # first maximum: ties to the lowest index
        inds[:, i] = nxt
        last = xyz[rows, nxt]
    return inds


# ------------------------------------------------------------ ov3det_torch/ops/kernels/ball_group.py

def _d2_direct(centers: torch.Tensor):
    """pts (B, n, 3) -> (B, M, n) squared distances to `centers` by direct
    subtraction, as the kernel forms them: (dx*dx + dy*dy) + dz*dz."""
    c = [centers[..., i, None] for i in range(3)]  # (B, M, 1) views

    def d2(pts):
        d = [c[i] - pts[:, None, :, i] for i in range(3)]
        return (d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]

    return d2


def _d2_expanded(centers: torch.Tensor):
    """pts (B, n, 3) -> (B, M, n) squared distances to `centers` as
    `_pairwise_d2` of the JAX package forms them (`ov3det/ops/pointcloud.py:
    156-165`): max((|c|^2 + |x|^2) - 2 c.x, 0), each operation rounded on
    its own."""
    c = centers[:, :, None, :]  # (B, M, 1, 3)
    c2 = (c[..., 0] * c[..., 0] + c[..., 1] * c[..., 1]) + c[..., 2] * c[..., 2]

    def d2(pts):
        x = pts[:, None]  # (B, 1, n, 3)
        x2 = (x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1]) + x[..., 2] * x[..., 2]
        cross = (c[..., 0] * x[..., 0] + c[..., 1] * x[..., 1]) + c[..., 2] * x[..., 2]
        return torch.clamp((c2 + x2) - 2.0 * cross, min=0.0)

    return d2


def _first_hits(xyz, centers, radius: float, nsample: int, d2_to):
    """First point of each bucket with d2 < f32(r^2), d2 from
    `d2_to(centers)`, one bucket at a time (the (B, M, N) distances are
    never built).  Returns (pick (B, M, K) int64 global point index, has
    (B, M, K) bool); pick is the bucket's first index where has is false."""
    B, N, _ = xyz.shape
    K = nsample
    Nb = -(-N // K)
    r2 = torch.tensor(_f32(radius * radius), dtype=torch.float32, device=xyz.device)
    d2 = d2_to(centers)
    picks, hits = [], []
    for k in range(K):
        pts = xyz[:, k * Nb:min((k + 1) * Nb, N)]  # (B, <=Nb, 3); padding is never in a ball
        if pts.shape[1] == 0:
            picks.append(torch.zeros(centers.shape[:2], dtype=torch.int64, device=xyz.device))
            hits.append(torch.zeros(centers.shape[:2], dtype=torch.bool, device=xyz.device))
            continue
        in_ball = d2(pts) < r2  # (B, M, nb)
        picks.append(torch.argmax(in_ball.to(torch.uint8), dim=-1) + k * Nb)  # first hit
        hits.append(in_ball.any(dim=-1))
    return torch.stack(picks, dim=-1), torch.stack(hits, dim=-1)


def bucket_picks(xyz, centers, radius: float, nsample: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's picks: the first in-radius point of each bucket, d2 by
    direct subtraction.  Returns (pick, has), (B, M, K) each."""
    return _first_hits(xyz, centers, radius, nsample, _d2_direct)


def bucket_picks_expanded(xyz, centers, radius: float,
                          nsample: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The picks of `bucket_picks` of the JAX package
    (`ov3det/ops/pointcloud.py:222-244`), which its backward recomputes:
    d2 in the expanded, clamped form.  Returns (pick, has) as
    `bucket_picks`."""
    return _first_hits(xyz, centers, radius, nsample, _d2_expanded)


def _slot_sources(pick, has):
    """(B, M, K) point index of each slot: its own pick, or the first
    non-empty bucket's pick for an empty slot; and (B, M, 1) whether the
    ball holds any point."""
    first_bucket = torch.argmax(has.to(torch.uint8), dim=-1, keepdim=True)
    return torch.where(has, pick, torch.gather(pick, -1, first_bucket)), has.any(-1, keepdim=True)


def slot_sources_plain(xyz, centers, radius: float, nsample: int) -> torch.Tensor:
    """Plain PyTorch pick pass of the feature gradient, the same function as
    the kernel's: (B, K, M) int32, each slot's effective source point (the
    TPU's `eff_pick` of `_bwd`, `ball_group_kernel.py:225-231`, as a global
    index) from the expanded-distance picks, -1 throughout an empty ball."""
    src, any_hit = _slot_sources(*bucket_picks_expanded(xyz, centers, radius, nsample))
    return torch.where(any_hit, src, -1).transpose(1, 2).to(torch.int32).contiguous()


def _scatter(src: torch.Tensor, grad_out: torch.Tensor, N: int, num_channels: int) -> torch.Tensor:
    """Plain PyTorch scatter of the feature gradient: sum the feature
    cotangent grad_out[..., 3:] (B, K, M, 3 + C) onto the points `src`
    (B, K, M) names, in the cotangent's own order (no transpose, no copy);
    the rows of empty balls (-1) go to a spare row past the last point,
    which is dropped.  The CPU's path and the kernels' oracle on the card."""
    B = src.shape[0]
    rows = src.long() + (torch.arange(B, device=src.device) * N)[:, None, None]
    rows = torch.where(src >= 0, rows, B * N).reshape(-1)
    out = torch.zeros(B * N + 1, num_channels, dtype=torch.float32, device=src.device)
    # an accumulating index_put_ sums each point's slots in their order (a
    # stable sort on CUDA), so the gradient is the same bits every run;
    # index_add_'s atomics order them as the card schedules them
    out.index_put_((rows,), grad_out[..., 3:].float().reshape(-1, num_channels), accumulate=True)
    return out[:B * N].view(B, N, num_channels)


def ball_group_plain(xyz, features, centers, radius: float, nsample: int) -> torch.Tensor:
    """Plain PyTorch bucketed ball-group, the same function as the kernel.

    xyz (B, N, 3) f32, features (B, N, C) f32 or None, centers (B, M, 3) f32
    -> (B, K, M, 3 + C) f32.
    """
    B, N, _ = xyz.shape
    M = centers.shape[1]
    src, any_hit = _slot_sources(*bucket_picks(xyz, centers, radius, nsample))  # (B, M, K)
    src = src.transpose(1, 2)  # (B, K, M)
    valid = any_hit.transpose(1, 2)[..., None]  # (B, 1, M, 1)
    flat = src.reshape(B, -1)
    g_xyz = torch.gather(xyz, 1, flat[..., None].expand(-1, -1, 3)).reshape(B, nsample, M, 3)
    rel = (g_xyz - centers[:, None]) * torch.tensor(_f32(1.0 / radius), dtype=torch.float32)
    rel = torch.where(valid, rel, torch.zeros_like(rel))
    if features is None:
        return rel
    C = features.shape[-1]
    g_feat = torch.gather(features, 1, flat[..., None].expand(-1, -1, C)).reshape(B, nsample, M, C)
    g_feat = torch.where(valid, g_feat, torch.zeros_like(g_feat))
    return torch.cat([rel, g_feat], dim=-1)


# ------------------------------------------------------------ ov3det_torch/ops/kernels/attention.py

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


# ------------------------------------------------------------ ov3det_torch/ops/kernels/add_norm.py

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


# ------------------------------------------------------------ ov3det_torch/ops/kernels/auction.py

_NEG = -1e18


_CHECK_EVERY = 8  # rounds between host syncs on convergence, in the plain version


def _round(benefit, person2obj, obj2person, price, eps):
    """One Jacobi round of the forward auction (`ov3det/ops/hungarian.py:55-96`)."""
    B, P, O = benefit.shape
    unassigned = person2obj == -1
    values = benefit - price[:, None, :]
    best_obj = torch.argmax(values, dim=-1)
    w1 = values.amax(-1)
    w2 = values.scatter(-1, best_obj[..., None], _NEG).amax(-1)
    bid = torch.gather(price, 1, best_obj) + w1 - w2 + eps

    obj_ids = torch.arange(O, device=benefit.device)
    bids_mat = torch.where(unassigned[:, :, None] & (best_obj[:, :, None] == obj_ids),
                           bid[:, :, None], torch.full_like(benefit, _NEG))
    win_val = bids_mat.amax(1)
    win_person = torch.argmax(bids_mat, dim=1)
    contested = win_val > _NEG / 2
    price = torch.where(contested, win_val, price)

    p_idx = torch.arange(P, device=benefit.device)[None, :]
    held = torch.clamp(person2obj, min=0)
    held_contested = torch.gather(contested, 1, held)
    held_winner = torch.gather(win_person, 1, held)
    evicted = (person2obj >= 0) & held_contested & (held_winner != p_idx)
    won = unassigned & torch.gather(contested, 1, best_obj) & (
        torch.gather(win_person, 1, best_obj) == p_idx)

    person2obj = torch.where(won, best_obj,
                             torch.where(evicted, torch.full_like(person2obj, -1), person2obj))
    obj2person = torch.where(contested, win_person, obj2person)
    return person2obj, obj2person, price


def _auction_phase(benefit, person_live, eps, max_iters: int):
    """One forward auction from zero prices: benefit (B, P, O), person_live
    (B, P), eps (B, 1) -> person2obj (B, P; -1 unassigned, -2 not live),
    obj2person (B, O; -1 free), int64."""
    B, P, O = benefit.shape
    person2obj = torch.where(person_live, -1, -2).to(torch.int64)  # -2: never bids
    obj2person = torch.full((B, O), -1, dtype=torch.int64, device=benefit.device)
    price = torch.zeros((B, O), dtype=torch.float32, device=benefit.device)
    done = 0
    while done < max_iters and bool((person2obj == -1).any()):
        for _ in range(min(_CHECK_EVERY, max_iters - done)):
            person2obj, obj2person, price = _round(benefit, person2obj, obj2person, price, eps)
        done += min(_CHECK_EVERY, max_iters - done)
    return person2obj, obj2person


def auction_phases_plain(benefit, person_live, eps_tight, eps_loose, tight_iters: int,
                         loose_iters: int):
    """Plain PyTorch: the tight phase, then the loose phase for the rows it
    left with an unassigned person (their result is the loose phase's).
    eps_* (B,) f32.  Returns person2obj (B, P), obj2person (B, O), int64."""
    person2obj, obj2person = _auction_phase(benefit, person_live, eps_tight[:, None], tight_iters)
    tight_ok = ~(person2obj == -1).any(1, keepdim=True)
    if not bool(tight_ok.all()):
        p2o_l, o2p_l = _auction_phase(benefit, person_live, eps_loose[:, None], loose_iters)
        person2obj = torch.where(tight_ok, person2obj, p2o_l)
        obj2person = torch.where(tight_ok, obj2person, o2p_l)
    return person2obj, obj2person


def auction_inputs(cost: torch.Tensor, n_persons=None) -> tuple:
    """(benefit (B, P, O) f32, person_live (B, P) bool, span (B,) f32) of
    `auction_lap`: the phases' eps are 2e-4 and 5e-3 of `span`, the range
    of the live persons' benefits that are not NaN (JAX's `nanmax - nanmin`:
    1 where a row has none or the range is NaN, infinities clipped to the
    largest f32, at least 1e-3)."""
    B, P, O = cost.shape
    dev = cost.device
    benefit = -cost.float()
    if n_persons is None:
        n_persons = torch.full((B,), P, dtype=torch.int64, device=dev)
    person_live = torch.arange(P, device=dev)[None, :] < n_persons[:, None]
    seen = person_live[:, :, None] & ~benefit.isnan()
    span = (torch.where(seen, benefit, float("-inf")).amax((1, 2))
            - torch.where(seen, benefit, float("inf")).amin((1, 2)))
    span = torch.where(seen.any((1, 2)), span, torch.full_like(span, float("nan")))
    return benefit, person_live, torch.clamp(torch.nan_to_num(span, nan=1.0), min=1e-3)


def _fallback(person2obj, obj2person):
    """Rank-match any person still unassigned onto the free objects
    (`ov3det/ops/hungarian.py:144-161`) -> the outputs of `auction_lap`."""
    B, P = person2obj.shape
    O = obj2person.shape[1]
    dev = person2obj.device
    leftover = person2obj == -1
    free_obj = obj2person < 0
    person_rank = torch.cumsum(leftover.long(), 1) - 1
    obj_rank = torch.cumsum(free_obj.long(), 1) - 1
    order = torch.argsort(torch.where(free_obj, obj_rank, torch.full_like(obj_rank, O)),
                          dim=1, stable=True)
    fb_obj = torch.gather(order, 1, torch.clamp(person_rank, 0, O - 1))
    person2obj = torch.where(leftover, fb_obj, person2obj)
    p_idx = torch.arange(P, device=dev)[None, :].expand(B, P)
    fb_mark = torch.full((B, O), -1, dtype=torch.int64, device=dev).scatter_reduce(
        1, fb_obj, torch.where(leftover, p_idx, torch.full_like(p_idx, -1)),
        reduce="amax", include_self=True)
    obj2person = torch.where(obj2person >= 0, obj2person, fb_mark)

    obj_assigned = (obj2person >= 0).float()
    return torch.clamp(person2obj, min=0), obj_assigned, torch.clamp(obj2person, min=0)


def auction_lap_plain(cost: torch.Tensor, n_persons=None, tight_iters: int = 500,
                      loose_iters: int = 800):
    """Plain PyTorch `auction_lap`: the span, the phases
    (:func:`auction_phases_plain`) and the fallback as torch ops."""
    benefit, person_live, span = auction_inputs(cost, n_persons)
    person2obj, obj2person = auction_phases_plain(benefit, person_live, span * 2e-4, span * 5e-3,
                                                  tight_iters, loose_iters)
    return _fallback(person2obj, obj2person)


# ------------------------------------------------------------ ov3det_torch/ops/kernels/nms.py

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


# ------------------------------------------------------------ ov3det_torch/ops/kernels/points_in_box.py

EPS = float(np.float32(1e-6))  # the faces' margin, as the JAX code's weak float becomes f32


PLAIN_ELEMENTS = 1 << 23


def points_in_box_plain(points: torch.Tensor, corners: torch.Tensor,
                        chunk: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch empty-box test: points (B, N, 3) upright-depth, corners
    (B, K, 8, 3) camera coordinates -> (B, K) int32 counts of the points
    inside each box, `chunk` boxes at a time (default: as many as keep the
    temporaries near `PLAIN_ELEMENTS`)."""
    B, N, _ = points.shape
    K = corners.shape[1]
    if chunk is None:
        chunk = max(1, PLAIN_ELEMENTS // max(1, B * N))
    # the box in depth coordinates (x, z, -y), its origin at corner 0 and
    # its edges to corners 1, 3 and 4
    depth = torch.stack([corners[..., 0], corners[..., 2], -corners[..., 1]], dim=-1)
    origin = depth[:, :, 0]  # (B, K, 3)
    edges = [depth[:, :, j] - origin for j in (1, 3, 4)]  # (B, K, 3) each
    his = [((e[..., 0] * e[..., 0] + e[..., 1] * e[..., 1]) + e[..., 2] * e[..., 2]) + EPS
           for e in edges]  # (B, K) each
    counts = []
    for k in range(0, K, chunk):
        box = slice(k, k + chunk)
        rel = [points[:, None, :, a] - origin[:, box, a, None] for a in range(3)]  # (B, c, N)
        inside = None
        for e, hi in zip(edges, his):
            e = e[:, box, :, None]
            proj = (rel[0] * e[:, :, 0] + rel[1] * e[:, :, 1]) + rel[2] * e[:, :, 2]
            face = (proj >= -EPS) & (proj <= hi[:, box, None])
            inside = face if inside is None else inside & face
        counts.append(inside.sum(dim=-1, dtype=torch.int32))
    return torch.cat(counts, dim=1)


# ------------------------------------------------------------ ov3det_torch/ops/roi_align.py

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


# ------------------------------------------------------------ ov3det_torch/ops/kernels/attn_pool.py

def pool_tokens_plain(x: torch.Tensor, pos0: torch.Tensor) -> torch.Tensor:
    """(R, L, C) tokens, (C,) pos[0] -> (R, C) token 0 in the token dtype:
    the f32 sum in index order over L, divided by L, rounded, plus pos[0]."""
    acc = torch.zeros((x.shape[0], x.shape[2]), dtype=torch.float32, device=x.device)
    for k in range(x.shape[1]):
        acc = acc + x[:, k].float()
    # a divisor tensor: PyTorch's CUDA division by a Python number multiplies
    # by its rounded reciprocal, which is not the kernel's quotient
    return (acc / torch.full_like(acc, float(x.shape[1]))).to(x.dtype) + pos0


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


# ------------------------------------------------------------ ov3det_torch/ops/kernels/quant_conv.py

def im2col_int8(xq: torch.Tensor, kernel_size: int, padding: int) -> torch.Tensor:
    """(B, H, W, C) int8 -> (B * H * W, k * k * C), stride 1, K in (kh, kw,
    C) order, zero padding (the quantized zero)."""
    B, H, W, C = xq.shape
    if kernel_size == 1:
        return xq.reshape(B * H * W, C)
    p = padding
    xp = F.pad(xq, (0, 0, p, p, p, p))
    Ho, Wo = H + 2 * p - kernel_size + 1, W + 2 * p - kernel_size + 1
    views = [xp[:, i:i + Ho, j:j + Wo, :] for i in range(kernel_size) for j in range(kernel_size)]
    return torch.stack(views, dim=3).reshape(B * Ho * Wo, kernel_size * kernel_size * C)


def int8_conv(xq: torch.Tensor, kernel_q: torch.Tensor, kernel_size: int,
              padding: int) -> torch.Tensor:
    """Exact int32 conv of int8 (B, H, W, C) with the int8 (C_out, K) kernel
    -> (B, H', W', C_out), as `torch._int_mm(im2col, kernel_q.t())`.  On the
    card `_int_mm` takes more than 16 rows and K, C_out multiples of 8: the
    trunk's channels are, and fewer rows are padded with zero rows."""
    B = xq.shape[0]
    a = im2col_int8(xq, kernel_size, padding).contiguous()
    M = a.shape[0]
    if a.is_cuda and M <= 16:
        a = F.pad(a, (0, 0, 0, 17 - M))
    y = torch._int_mm(a, kernel_q.t())[:M]
    Ho = xq.shape[1] + 2 * padding - kernel_size + 1
    return y.view(B, Ho, -1, kernel_q.shape[0])


def avg_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    """flax `nn.avg_pool(x, (k, k), strides=(k, k))` (VALID) on (B, H, W, C),
    as `F.avg_pool2d` on the channels-last NCHW view: the k * k values summed
    in f32, row by row, then divided, rounded once to x's dtype."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), k, k).permute(0, 2, 3, 1)


# ------------------------------------------------------------ ov3det_torch/ops/kernels/normalise.py

def normalise_plain(images: torch.Tensor, mean: torch.Tensor, inv_std: torch.Tensor,
                    out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """(images.float() - mean) * inv_std, cast to `out_dtype` (None: f32)."""
    x = (images.float() - mean) * inv_std
    return x if out_dtype in (None, torch.float32) else x.to(out_dtype)
