"""The matcher's forward auction as a device loop: the CUDA kernel's wrapper
and its plain version.

The kernel (`ov3det_torch/csrc/auction.cu`) is the counterpart of the two
`lax.while_loop` phases of `ov3det/ops/hungarian.py` (`_auction_phase`,
`:40-105`), which XLA runs on the TPU (not a Pallas kernel): one CTA a row
of the (R, P, O) benefit, the row in shared memory, every round on the
device, so that the step waits for nothing on the host and can be captured
in a CUDA graph.  A round is `_round` to the bit; a row stops when no person
is unassigned (a round on such a row changes nothing, so this gives JAX's
batch-wide loop's result) or at the round cap; a row the tight phase leaves
unconverged runs the loose phase and takes its result.

The plain version (`auction_phases_plain`) runs the rounds as torch ops in
blocks of `_CHECK_EVERY`, with one host sync a block on convergence: the CPU
path, and the kernel's oracle on the card.
"""
from __future__ import annotations

import ctypes
import torch

from ov3det_torch.ops.kernels import _build

SOURCE = "ov3det_torch/csrc/auction.cu"
REPLACES = "ov3det/ops/hungarian.py:40 (_auction_phase: lax.while_loop, XLA, not Pallas)"

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
}


def _lib() -> ctypes.CDLL:
    return _build.load("auction", _SIGNATURES)
