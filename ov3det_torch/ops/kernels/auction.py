"""The matcher's forward auction on the device: the CUDA kernels' wrappers
and their plain versions.

`auction_lap` is the counterpart of `auction_lap` of
`ov3det/ops/hungarian.py:106-161` (XLA compiles it into one program on the
TPU; not a Pallas kernel): the span of the benefit and the phases' eps, the
two `lax.while_loop` phases of `_auction_phase` (`:40-105`), and the
rank-matching fallback.  For CUDA tensors it is one launch of
`auction_lap_kernel` (`ov3det_torch/csrc/auction.cu`): one CTA a row, the
cost read through its strides and negated into shared memory while the span
is reduced, every round on the device with each object's winner taken by a
64-bit key-max, the fallback in the CTA, the three outputs written at once;
counted in `auction_lap.launches`.  The private `_impl="first"` keeps a
CUDA call on the first design: the span and the fallback as torch ops around
`auction_phases` (`auction_kernel`: the phases alone, one CTA a row),
counted in `auction_phases.launches`.

A round is `_round` to the bit; a row stops when no person is unassigned (a
round on such a row changes nothing, so this gives JAX's batch-wide loop's
result) or at the round cap; a row the tight phase leaves unconverged runs
the loose phase and takes its result.

The plain version (`auction_lap_plain`: `auction_inputs`, then
`auction_phases_plain`, whose rounds run as torch ops in blocks of
`_CHECK_EVERY` with one host sync a block on convergence, then the torch
fallback) is the CPU path and the kernels' oracle on the card.
"""
from __future__ import annotations

import ctypes
import torch

from ov3det_torch.ops.kernels import _build

SOURCE = "ov3det_torch/csrc/auction.cu"
REPLACES = ("ov3det/ops/hungarian.py:106 (auction_lap: the span, _auction_phase's lax.while_loop "
            "at :40 and the fallback, XLA, not Pallas)")

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


def auction_lap(cost: torch.Tensor, n_persons=None, tight_iters: int = 500,
                loose_iters: int = 800, _impl=None):
    """Min-cost assignment of persons (dim 1) to objects (dim 2).

    cost (B, P, O), any strides, P <= O; n_persons (B,) live persons per
    row.  Returns person2obj (B, P) int64, obj_assigned (B, O) float32
    {0, 1}, obj2person (B, O) int64 (0 where obj_assigned is 0), as
    `ov3det.ops.auction_lap` does.

    CUDA tensors take one launch of `auction_lap_kernel` (no host wait; a
    cost that is not f32 is cast first), counted in `auction_lap.launches`;
    `_impl="first"` the first design (torch ops around `auction_phases`).
    CPU tensors take :func:`auction_lap_plain`.
    """
    if cost.dim() != 3:
        raise ValueError(f"auction_lap expects a (B, P, O) cost, got {tuple(cost.shape)}")
    B, P, O = cost.shape
    if n_persons is not None:
        if tuple(n_persons.shape) != (B,) or n_persons.dtype.is_floating_point \
                or n_persons.dtype == torch.bool:
            raise ValueError(f"auction_lap expects (B,) integer n_persons, got "
                             f"{tuple(n_persons.shape)} {n_persons.dtype}")
        if n_persons.device != cost.device:
            raise ValueError(f"auction_lap operands on several devices: {cost.device}, "
                             f"{n_persons.device}")
    if _impl not in (None, "first"):
        raise ValueError(f"auction_lap: _impl is None (the fused launch) or 'first', got {_impl!r}")
    if cost.device.type == "cpu":
        if _impl is not None:
            raise ValueError("auction_lap: _impl chooses between CUDA kernels; these tensors lie on "
                             "the CPU")
        return auction_lap_plain(cost, n_persons, tight_iters, loose_iters)
    if cost.device.type != "cuda":
        raise ValueError(f"auction_lap runs on cuda or cpu tensors, got {cost.device}")
    if _impl == "first":
        benefit, person_live, span = auction_inputs(cost, n_persons)
        person2obj, obj2person = auction_phases(benefit, person_live, span * 2e-4, span * 5e-3,
                                                tight_iters, loose_iters)
        return _fallback(person2obj, obj2person)
    dev = cost.device
    p2o = torch.empty((B, P), dtype=torch.int64, device=dev)
    assigned = torch.empty((B, O), dtype=torch.float32, device=dev)
    o2p = torch.empty((B, O), dtype=torch.int64, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        fits = ctypes.c_int()
        _build.check(lib, lib.ov3_auction_lap_fits(P, O, ctypes.byref(fits)), "auction_lap")
        if not fits.value:
            raise ValueError(f"auction_lap kernel: a row of {P} x {O} does not fit in shared memory")
        if cost.dtype != torch.float32:
            cost = cost.float()
        n = None if n_persons is None else n_persons.to(torch.int64).contiguous()
        status = lib.ov3_auction_lap(cost.data_ptr(), *cost.stride(), B, P, O,
                                     None if n is None else n.data_ptr(), tight_iters, loose_iters,
                                     p2o.data_ptr(), assigned.data_ptr(), o2p.data_ptr(),
                                     torch.cuda.current_stream().cuda_stream)
    _build.check(lib, status, "auction_lap")
    auction_lap.launches += 1
    return p2o, assigned, o2p


auction_lap.launches = 0


def _on_cuda(benefit, person_live, eps_tight, eps_loose) -> bool:
    if benefit.dim() != 3 or benefit.dtype != torch.float32:
        raise ValueError(f"auction expects a (B, P, O) f32 benefit, got {tuple(benefit.shape)} "
                         f"{benefit.dtype}")
    B, P, O = benefit.shape
    if tuple(person_live.shape) != (B, P) or person_live.dtype != torch.bool:
        raise ValueError(f"auction expects (B, P) bool live persons, got "
                         f"{tuple(person_live.shape)} {person_live.dtype}")
    for eps in (eps_tight, eps_loose):
        if tuple(eps.shape) != (B,) or eps.dtype != torch.float32:
            raise ValueError(f"auction expects (B,) f32 eps, got {tuple(eps.shape)} {eps.dtype}")
    devices = {t.device for t in (benefit, person_live, eps_tight, eps_loose)}
    if len(devices) != 1:
        raise ValueError(f"auction operands on several devices: {devices}")
    if benefit.device.type == "cpu":
        return False
    if benefit.device.type != "cuda":
        raise ValueError(f"auction runs on cuda or cpu tensors, got {benefit.device}")
    return True


def auction_phases(benefit: torch.Tensor, person_live: torch.Tensor, eps_tight: torch.Tensor,
                   eps_loose: torch.Tensor, tight_iters: int = 500, loose_iters: int = 800):
    """benefit (B, P, O) f32, person_live (B, P) bool, eps_tight and
    eps_loose (B,) f32 -> person2obj (B, P), obj2person (B, O), int64 (-1
    unassigned or free, -2 not live), of the phase each row took.

    Launches the CUDA kernel for CUDA tensors, with no host wait; CPU
    tensors take :func:`auction_phases_plain`."""
    if not _on_cuda(benefit, person_live, eps_tight, eps_loose):
        return auction_phases_plain(benefit, person_live, eps_tight, eps_loose, tight_iters,
                                    loose_iters)
    B, P, O = benefit.shape
    lib = _lib()
    if P > lib.ov3_auction_max_persons():
        raise ValueError(f"auction kernel takes at most {lib.ov3_auction_max_persons()} persons, "
                         f"got {P}")
    with torch.cuda.device(benefit.device):
        fits = ctypes.c_int()
        _build.check(lib, lib.ov3_auction_fits(P, O, ctypes.byref(fits)), "auction")
        if not fits.value:
            raise ValueError(f"auction kernel: a row of {P} x {O} does not fit in shared memory")
        benefit, live = benefit.contiguous(), person_live.to(torch.uint8).contiguous()
        eps_tight, eps_loose = eps_tight.contiguous(), eps_loose.contiguous()
        p2o = torch.empty((B, P), dtype=torch.int64, device=benefit.device)
        o2p = torch.empty((B, O), dtype=torch.int64, device=benefit.device)
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.ov3_auction(benefit.data_ptr(), live.data_ptr(), eps_tight.data_ptr(),
                                 eps_loose.data_ptr(), B, P, O, tight_iters, loose_iters,
                                 p2o.data_ptr(), o2p.data_ptr(), stream)
    _build.check(lib, status, "auction")
    auction_phases.launches += 1
    return p2o, o2p


auction_phases.launches = 0

_SIGNATURES = {
    "ov3_auction": ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 3,
                    ctypes.c_int),
    "ov3_auction_fits": ([ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)], ctypes.c_int),
    "ov3_auction_max_persons": ([], ctypes.c_int),
    "ov3_auction_lap": ([ctypes.c_void_p] + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 3
                        + [ctypes.c_void_p] + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4,
                        ctypes.c_int),
    "ov3_auction_lap_fits": ([ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)],
                             ctypes.c_int),
}


def _lib() -> ctypes.CDLL:
    return _build.load("auction", _SIGNATURES)
