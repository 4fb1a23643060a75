"""What the fused auction (`csrc/auction.cu`, `auction_lap_kernel`: the whole
`auction_lap` in one launch) relies on, checked on the CPU:

- the kernel emulated in numpy, row by row: the cost read through its
  strides and negated, the span reduced from the live persons' benefits that
  are not NaN and the eps as f32 products; each round's bids in one pass
  (the first maximum, w1, and the NaN-propagating maximum of the rest with
  -1e18), each object's winner by the largest 64-bit key (the bid's bits
  made monotone, -0 folded onto +0, NaN above everything, the person index
  inverted) and the price taken from the winner's own bid; both phases with
  each row stopping on its own; the fallback by the ballots' order (the free
  objects first, then the rest) and an amax mark;
- the emulation equals JAX's `auction_lap` and the port's plain one exactly,
  on `test_torch_auction.py`'s kinds, with capped phases (the fallback
  runs), on a transposed cost as the criterion passes it, and its rounds
  equal `_round` on states whose bids tie at +0 and -0;
- the key orders bids as `torch.amax`/`argmax` do, NaN and signed zeros
  included;
- the wrapper's checks.  The kernel itself runs on the card only, where
  chip_smoke.py (phase 14) holds it against the plain `auction_lap`.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ov3det.ops import auction_lap as jax_auction
from ov3det_torch.ops import hungarian
from ov3det_torch.ops.kernels import auction as A
from test_torch_auction import KINDS, costs

NEG = np.float32(-1e18)
F32_MAX = np.finfo(np.float32).max


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(1)


# ------------------------------------------------------------ emulation
def bid_key(bid: np.ndarray, person: np.ndarray) -> np.ndarray:
    """The kernel's `bid_key`: uint64, larger for amax's bid, and among
    equal bids for argmax's (the lowest) person; 0 is no bid."""
    bid = np.where(bid == 0, np.float32(0), bid).astype(np.float32)  # -0 folded onto +0
    bits = bid.view(np.uint32).astype(np.uint64)
    mono = np.where(bits & 0x80000000, ~bits & 0xFFFFFFFF, bits | 0x80000000)
    mono = np.where(np.isnan(bid), np.uint64(0xFFFFFFFF), mono)
    inv = (~person.astype(np.uint64)) & 0xFFFFFFFF
    return (mono << np.uint64(32)) | inv


def top_two(values: np.ndarray) -> tuple:
    """(best, w1, rest): the first maximum (a NaN first), its value, and the
    NaN-propagating maximum of -1e18 and the other values."""
    nan = np.isnan(values)
    best = int(np.argmax(nan)) if nan.any() else int(np.argmax(values))
    others = np.delete(values, best)
    if np.isnan(others).any():
        rest = np.float32(np.nan)
    else:
        rest = np.float32(max(NEG, others.max(initial=NEG)))
    return best, values[best], rest


def emulate_round(ben, p2o, o2p, price, eps):
    """One round of `auction_lap_kernel` on one row, in place; returns the
    number of persons it assigned less those it evicted."""
    O = ben.shape[1]
    keys = np.zeros(O, np.uint64)
    bid = np.zeros(ben.shape[0], np.float32)
    for p in np.flatnonzero(p2o == -1):
        best, w1, rest = top_two((ben[p] - price).astype(np.float32))
        bid[p] = np.float32(np.float32(np.float32(price[best] + w1) - rest) + eps)
        keys[best] = max(keys[best], bid_key(bid[p:p + 1], np.array([p]))[0])
    gained = 0
    for o in range(O):
        key = int(keys[o])
        if key == 0 or key >> 32 == 0xFFFFFFFF:
            continue  # no bidder, or a NaN bid: uncontested
        w = (~key) & 0xFFFFFFFF
        if not bid[w] > NEG / 2:
            continue
        if o2p[o] >= 0:
            p2o[o2p[o]] = -1
        else:
            gained += 1
        p2o[w], o2p[o], price[o] = o, w, bid[w]
    return gained


def emulate_phase(ben, live: int, eps, cap: int):
    P, O = ben.shape
    p2o = np.where(np.arange(P) < live, -1, -2)
    o2p = np.full(O, -1)
    price = np.zeros(O, np.float32)
    left, it = live, 0
    while left > 0 and it < cap:
        left -= emulate_round(ben, p2o, o2p, price, eps)
        it += 1
    assert left == (p2o == -1).sum()
    return p2o, o2p, left


def emulate_span(ben, live: int):
    """`auction_inputs`'s span as the kernel reduces it, and the two eps."""
    seen = ben[:live][~np.isnan(ben[:live])]
    with np.errstate(invalid="ignore", over="ignore"):
        span = np.float32(seen.max() - seen.min()) if seen.size else np.float32(np.nan)
    if np.isnan(span):
        span = np.float32(1.0)
    if np.isinf(span):
        span = np.float32(F32_MAX if span > 0 else -F32_MAX)
    span = max(span, np.float32(1e-3))
    return np.float32(span * np.float32(2e-4)), np.float32(span * np.float32(5e-3))


def emulate_fallback(p2o, o2p):
    """The fallback as the kernel's first warp runs it."""
    O = o2p.shape[0]
    order = np.concatenate([np.flatnonzero(o2p < 0), np.flatnonzero(o2p >= 0)])
    mark = np.full(O, -1)
    rank = 0
    for p in range(p2o.shape[0]):
        if p2o[p] == -1:
            fb = order[min(rank, O - 1)]
            p2o[p] = fb
            mark[fb] = max(mark[fb], p)
            rank += 1
    return p2o, np.where(o2p >= 0, o2p, mark)


def emulate_kernel(cost: np.ndarray, n_persons, tight: int = 500, loose: int = 800):
    """`auction_lap_kernel` on cost (R, P, O) of any strides -> the three
    outputs of `auction_lap`."""
    R, P, O = cost.shape
    p2o_out = np.zeros((R, P), np.int64)
    o2p_out = np.zeros((R, O), np.int64)
    assigned = np.zeros((R, O), np.float32)
    for r in range(R):
        ben = -cost[r].astype(np.float32)  # read through the strides, negated
        live = P if n_persons is None else int(np.clip(n_persons[r], 0, P))
        eps_t, eps_l = emulate_span(ben, live)
        p2o, o2p, left = emulate_phase(ben, live, eps_t, tight)
        if left:
            p2o, o2p, left = emulate_phase(ben, live, eps_l, loose)
        if left:
            p2o, o2p = emulate_fallback(p2o, o2p)
        p2o_out[r], o2p_out[r] = np.maximum(p2o, 0), np.maximum(o2p, 0)
        assigned[r] = o2p >= 0
    return p2o_out, assigned, o2p_out


def _check(cost: np.ndarray, n, tight: int = 500, loose: int = 800, jax_too: bool = True):
    got = emulate_kernel(cost, n, tight, loose)
    t_cost = torch.from_numpy(np.ascontiguousarray(cost))
    t_n = None if n is None else torch.from_numpy(np.asarray(n))
    plain = A.auction_lap_plain(t_cost, t_n, tight, loose)
    for g, w in zip(got, plain):
        np.testing.assert_array_equal(g, w.numpy())
    if jax_too:
        want = jax_auction(jnp.asarray(cost), None if n is None else jnp.asarray(n, jnp.int32),
                           tight_iters=tight, loose_iters=loose)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w))
    return got


# ------------------------------------------------------------ tests
@pytest.mark.parametrize("kind", KINDS)
def test_emulated_kernel_equals_jax_and_the_plain_version(kind):
    cost, n = costs(kind, np.random.default_rng(20 + KINDS.index(kind)))
    if kind == "non-converging":  # a smaller price war keeps the numpy loop short
        cost, n = cost[:2, :4], np.full(2, 4)
    _check(cost, n)


def test_capped_phases_run_the_fallback():
    cost, _ = costs("non-converging", np.random.default_rng(5))
    cost, n = cost[:3, :6], np.array([6, 4, 0])
    ben = -cost[0]
    assert emulate_phase(ben, 6, *emulate_span(ben, 6)[1:], 3)[2] > 0  # the loose phase capped
    _check(cost, n, tight=2, loose=3)


def test_transposed_cost_as_the_criterion_passes_it():
    rng = np.random.default_rng(8)
    # (layers x scenes, queries, GT) -> (rows, GT, queries): a strided view
    base = rng.normal(size=(4, 32, 16)).astype(np.float32)
    view = np.swapaxes(base, 1, 2)
    assert not view.flags["C_CONTIGUOUS"]
    n = np.array([16, 3, 0, 9])
    got = _check(view, n)
    t_view = torch.from_numpy(base).transpose(1, 2)
    for g, w in zip(got, hungarian.auction_lap(t_view, torch.from_numpy(n))):
        np.testing.assert_array_equal(g, w.numpy())


def test_no_live_person_and_none_given():
    rng = np.random.default_rng(9)
    cost = rng.normal(size=(3, 5, 9)).astype(np.float32)
    _check(cost, None)
    _check(cost, np.array([0, 0, 0]))
    _check(cost, np.array([-2, 7, 5]), jax_too=False)  # outside [0, P]: clamped to the live count


@pytest.mark.parametrize("zero", [0.0, -0.0])
def test_rounds_with_bids_tied_at_signed_zero_equal_the_plain_round(zero):
    # eps 0 and prices of -0/+0 make bids of exactly +-0 that tie across
    # persons: the winner is the lowest person, and the new price is its own
    # bid, as `_round`'s amax gives it
    P, O = 5, 4
    ben = np.zeros((P, O), np.float32)
    ben[:, 1] = np.float32(-1.0)
    ben[3, 2] = np.float32(zero)
    for signs in ([0.0, -0.0, 0.0, -0.0], [-0.0, -0.0, 0.0, 0.0]):
        price = np.array(signs, np.float32)
        eps = np.float32(zero)
        p2o = np.array([-1, -1, 2, -1, -1])
        o2p = np.array([-1, -1, 2, -1])
        e_p2o, e_o2p, e_price = p2o.copy(), o2p.copy(), price.copy()
        emulate_round(ben, e_p2o, e_o2p, e_price, eps)
        t = A._round(torch.from_numpy(ben)[None], torch.from_numpy(p2o)[None],
                     torch.from_numpy(o2p)[None], torch.from_numpy(price)[None],
                     torch.tensor([[eps]]))
        np.testing.assert_array_equal(e_p2o, t[0][0].numpy())
        np.testing.assert_array_equal(e_o2p, t[1][0].numpy())
        np.testing.assert_array_equal(e_price.view(np.int32), t[2][0].numpy().view(np.int32))


def test_key_orders_bids_as_amax_and_argmax():
    rng = np.random.default_rng(4)
    specials = np.array([np.nan, -0.0, 0.0, np.inf, -np.inf, 1.0, -1.0, NEG, 3e38], np.float32)
    for trial in range(300):
        n = int(rng.integers(1, 9))
        bids = rng.choice(specials, n) if trial % 2 else rng.normal(size=n).astype(np.float32)
        if trial % 3 == 0:
            bids[rng.integers(0, n)] = bids[0]  # a tie
        keys = bid_key(bids, np.arange(n))
        winner = int((~int(keys.max())) & 0xFFFFFFFF)
        col = torch.from_numpy(bids)
        assert winner == int(torch.argmax(col)), (bids, winner)
        amax = col.amax().numpy()
        assert (np.isnan(amax) and np.isnan(bids[winner])) or amax == bids[winner]
        if np.isnan(bids).any():
            assert int(keys.max()) >> 32 == 0xFFFFFFFF  # a NaN bid: uncontested


def test_wrapper_checks():
    cost = torch.randn(2, 3, 5)
    with pytest.raises(ValueError, match=r"\(B, P, O\) cost"):
        A.auction_lap(cost[0])
    with pytest.raises(ValueError, match="integer n_persons"):
        A.auction_lap(cost, torch.ones(2))
    with pytest.raises(ValueError, match="integer n_persons"):
        A.auction_lap(cost, torch.ones(3, dtype=torch.int64))
    with pytest.raises(ValueError, match="_impl"):
        A.auction_lap(cost, _impl="first")  # a CUDA design, refused on the CPU
    with pytest.raises(ValueError, match="_impl"):
        A.auction_lap(cost.to("meta"), _impl="second")
    with pytest.raises(ValueError, match="cuda or cpu"):
        A.auction_lap(cost.to("meta"))
    with pytest.raises(ValueError, match="several devices"):
        A.auction_lap(cost, torch.ones(2, dtype=torch.int64, device="meta"))
    before = A.auction_lap.launches, A.auction_phases.launches
    assert hungarian.auction_lap(cost)[0].shape == (2, 3)
    assert (A.auction_lap.launches, A.auction_phases.launches) == before  # the CPU launches nothing
