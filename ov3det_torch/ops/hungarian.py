"""Batched linear assignment on the device by the auction algorithm.

Counterpart of `ov3det/ops/hungarian.py`: Bertsekas' forward auction with
persons = ground-truth boxes and objects = proposals, batched over
(B, P, O).  Unassigned persons bid in parallel (Jacobi), the highest bid per
object wins and evicts the previous holder; a single phase from zero prices
per epsilon.  Two-tier epsilon: a tight phase (2e-4 of the benefit range,
at most `tight_iters` rounds), then, for rows that did not converge, a loose
phase (5e-3 of the range, at most `loose_iters` rounds), then a rank-
matching fallback for anything still unassigned.  Padded persons (index >=
n_persons) never bid.

The JAX package runs each phase as one `lax.while_loop` that tests for an
unassigned person every round.  Here the rounds run in blocks of
`_CHECK_EVERY` with one host sync per block: once no person is unassigned a
round changes nothing, so the extra rounds of the last block leave the
result as the JAX loop would, and the round cap is kept exactly.  The loose
phase runs only when a row of the tight phase did not converge; rows are
independent, and its result is taken only for those rows, as in JAX.
Ties go to the first maximum (`torch.argmax`, as `jnp.argmax`).
"""
from __future__ import annotations

import torch

_NEG = -1e18
_CHECK_EVERY = 8  # auction rounds between host syncs on convergence


def _round(benefit, person2obj, obj2person, price, eps):
    """One Jacobi round of the forward auction (hungarian.py:55-96)."""
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
    (B, P), eps (B, 1) -> person2obj (B, P; -1 unassigned), obj2person
    (B, O; -1 free), int64."""
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
    benefit = -cost.float()
    if n_persons is None:
        n_persons = torch.full((B,), P, dtype=torch.int64, device=dev)
    person_live = torch.arange(P, device=dev)[None, :] < n_persons[:, None]

    live = person_live[:, :, None].expand_as(benefit)
    span = (torch.where(live, benefit, float("-inf")).amax((1, 2))
            - torch.where(live, benefit, float("inf")).amin((1, 2)))
    span = torch.where(person_live.any(1), span, torch.ones_like(span))
    span = torch.clamp(span, min=1e-3)[:, None]

    person2obj, obj2person = _auction_phase(benefit, person_live, span * 2e-4, tight_iters)
    tight_ok = ~(person2obj == -1).any(1, keepdim=True)
    if not bool(tight_ok.all()):
        p2o_l, o2p_l = _auction_phase(benefit, person_live, span * 5e-3, loose_iters)
        person2obj = torch.where(tight_ok, person2obj, p2o_l)
        obj2person = torch.where(tight_ok, obj2person, o2p_l)

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
