"""Batched linear assignment on the device by the auction algorithm.

Counterpart of `ov3det/ops/hungarian.py`: Bertsekas' forward auction with
persons = ground-truth boxes and objects = proposals, batched over
(B, P, O).  Unassigned persons bid in parallel (Jacobi), the highest bid per
object wins and evicts the previous holder; a single phase from zero prices
per epsilon.  Two-tier epsilon: a tight phase (2e-4 of the benefit range,
at most `tight_iters` rounds), then, for rows that did not converge, a loose
phase (5e-3 of the range, at most `loose_iters` rounds), then a rank-
matching fallback for anything still unassigned.  Padded persons (index >=
n_persons) never bid.  Ties go to the first maximum (`torch.argmax`, as
`jnp.argmax`).

The phases are `ops.kernels.auction.auction_phases`: on the card one CUDA
kernel whose rounds loop on the device (JAX's `lax.while_loop`), so that
nothing here waits on the host and the training step can be captured in a
CUDA graph; on the CPU the plain version, whose rounds run in blocks with
one host check a block.  The range, the fallback and the outputs are torch
ops with no host wait.
"""
from __future__ import annotations

import torch

from ov3det_torch.ops.kernels.auction import auction_phases


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


def auction_lap(cost: torch.Tensor, n_persons=None, tight_iters: int = 500,
                loose_iters: int = 800):
    """Min-cost assignment of persons (dim 1) to objects (dim 2).

    cost (B, P, O) with P <= O; n_persons (B,) live persons per row.
    Returns person2obj (B, P) int64, obj_assigned (B, O) float32 {0, 1},
    obj2person (B, O) int64 (0 where obj_assigned is 0), as
    `ov3det.ops.auction_lap` does.
    """
    B, P, O = cost.shape
    dev = cost.device
    benefit, person_live, span = auction_inputs(cost, n_persons)
    person2obj, obj2person = auction_phases(benefit, person_live, span * 2e-4, span * 5e-3,
                                            tight_iters, loose_iters)

    # rank-match any person still unassigned onto the free objects
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
