"""The matcher's auction on the CPU against the JAX package.

- `auction_lap` (its plain version, the CPU's path and the kernel's oracle)
  equals `ov3det.ops.auction_lap` exactly on tied costs, on ragged rows
  (`n_persons` 0, 1 and full), on near-duplicate rows that the tight phase
  does not converge, on the criterion's shapes, and on rows with NaN or
  infinite costs (a diverged step's: one value, one person, a whole row);
- the kernel's loop, emulated row by row in numpy (a row stops when it has
  no unassigned person, the loose phase runs only for a row the tight one
  left unconverged, a round `_round`'s arithmetic in f32), gives the plain
  version's assignments: stopping each row on its own changes nothing;
- the wrapper's checks.  The kernel itself runs on the card only
  (`chip_smoke.py`, phase 14).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ov3det.ops import auction_lap as jax_auction
from ov3det_torch.ops.hungarian import auction_inputs, auction_lap
from ov3det_torch.ops.kernels import auction

NEG = np.float32(-1e18)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(1)


def costs(kind: str, rng) -> tuple:
    """(cost (B, P, O) f32, n_persons (B,))."""
    B, P, O = 6, 8, 20
    if kind == "ties":
        return rng.integers(0, 3, (B, P, O)).astype(np.float32), np.full(B, P)
    if kind == "ragged":
        return rng.normal(size=(B, P, O)).astype(np.float32), np.array([0, 1, P, 3, 0, P])
    if kind == "non-converging":  # near-duplicate persons: an eps price war
        base = np.repeat(rng.normal(size=(B, 1, O)), P, 1)
        return (base + 1e-7 * rng.normal(size=(B, P, O))).astype(np.float32), np.full(B, P)
    if kind in ("nan", "inf"):  # a diverged step's costs: one value, one person, a whole row
        cost = rng.normal(size=(B, P, O)).astype(np.float32)
        bad = np.float32(np.nan if kind == "nan" else np.inf)  # inf: a benefit of -inf
        cost[0, 5, 7], cost[1, 2], cost[3] = bad, bad, bad
        return cost, np.array([P, 5, P, 3, P, 0])
    # the criterion's: 2 layers x 2 scenes, 64 GT slots, 32 queries -> (4, 32, 64)^T
    cost = rng.normal(size=(4, 32, 64)).astype(np.float32)
    return cost, rng.integers(0, 33, 4)


KINDS = ["ties", "ragged", "non-converging", "criterion", "nan", "inf"]


@pytest.mark.parametrize("kind", KINDS)
def test_plain_auction_matches_jax(kind):
    cost, n = costs(kind, np.random.default_rng(KINDS.index(kind)))
    want = jax_auction(jnp.asarray(cost), jnp.asarray(n, jnp.int32))
    got = auction_lap(torch.from_numpy(cost), torch.from_numpy(n))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def emulate_kernel(benefit, live, eps_t, eps_l, tight=500, loose=800):
    """`csrc/auction.cu` in numpy, one row at a time, f32 throughout."""
    B, P, O = benefit.shape
    p2o_out = np.zeros((B, P), np.int64)
    o2p_out = np.zeros((B, O), np.int64)
    for r in range(B):
        ben = benefit[r]
        for eps, cap in ((eps_t[r], tight), (eps_l[r], loose)):
            p2o = np.where(live[r], -1, -2)
            o2p = np.full(O, -1)
            price = np.zeros(O, np.float32)
            it = 0
            while (p2o == -1).any() and it < cap:
                best, bid = np.zeros(P, np.int64), np.zeros(P, np.float32)
                for p in np.flatnonzero(p2o == -1):
                    values = ben[p] - price
                    b = int(np.argmax(values))  # the first maximum
                    w2 = np.max(np.where(np.arange(O) == b, NEG, values))
                    best[p] = b
                    bid[p] = np.float32(np.float32(np.float32(price[b] + values[b]) - w2) + eps)
                winval, winper = np.full(O, NEG), np.zeros(O, np.int64)
                for o in range(O):
                    col = np.where((p2o == -1) & (best == o), bid, NEG)
                    winval[o], winper[o] = col.max(), int(np.argmax(col))  # lowest on a tie
                contested = winval > NEG / 2
                price = np.where(contested, winval, price)
                o2p = np.where(contested, winper, o2p)
                held = np.maximum(p2o, 0)
                evicted = (p2o >= 0) & contested[held] & (winper[held] != np.arange(P))
                won = (p2o == -1) & contested[best] & (winper[best] == np.arange(P))
                p2o = np.where(won, best, np.where(evicted, -1, p2o))
                it += 1
            if not (p2o == -1).any():
                break  # converged: the loose phase does not run
        p2o_out[r], o2p_out[r] = p2o, o2p
    return p2o_out, o2p_out


@pytest.mark.parametrize("kind", KINDS)
def test_row_by_row_loop_equals_the_plain_version(kind):
    cost, n = costs(kind, np.random.default_rng(10 + KINDS.index(kind)))
    if kind == "non-converging":  # a smaller price war keeps the numpy loop short
        cost, n = cost[:2, :4], np.full(2, 4)
    benefit, live, span = auction_inputs(torch.from_numpy(cost), torch.from_numpy(n))
    eps_t, eps_l = span * 2e-4, span * 5e-3
    want = auction.auction_phases_plain(benefit, live, eps_t, eps_l, 500, 800)
    got = emulate_kernel(benefit.numpy(), live.numpy(), eps_t.numpy(), eps_l.numpy())
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())
    if kind == "non-converging":  # the tight phase hit its cap
        tight, _ = auction._auction_phase(benefit, live, eps_t[:, None], 500)
        assert bool((tight == -1).any())


def test_wrapper_checks():
    benefit, live, span = auction_inputs(torch.randn(2, 3, 5))
    with pytest.raises(ValueError, match="bool"):
        auction.auction_phases(benefit, live.long(), span, span)
    with pytest.raises(ValueError, match=r"\(B,\) f32 eps"):
        auction.auction_phases(benefit, live, span[:1], span)
    assert auction.auction_phases.launches == 0  # the CPU launches nothing
