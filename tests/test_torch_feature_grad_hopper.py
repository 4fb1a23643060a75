"""What the feature-gradient scatter of the ball-group
(`csrc/feature_grad.cu`: `feature_map`, then `feature_sum`) relies on,
checked on the CPU:

- the kernels' order emulated in numpy (the map's counts a (CTA, warp)
  segment, their column prefix, the sums over the cluster and the scan over
  the points, each slot placed at its segment's place plus its rank among
  the equal keys of its warp's step; the work records, heavy points first;
  each point's rows added from 0.0f one after another in list order) equals
  the port's `_scatter` (an accumulating `index_put_`) bit for bit, and its
  list is the stable order of the slots by point;
- through `BallGroup`, the port's gradient equals the `jax.vjp` of JAX's
  Pallas ball-group in interpret mode (1e-6, as `test_torch_masked.py`:
  XLA's `.at[].add` sums in another order; exactly at the interim shape,
  whose integer cotangents sum exactly in any order);
- the wrapper's checks.  The kernels themselves run only on the card, where
  chip_smoke.py (phase 7) holds them against `_scatter` bit for bit.

Cases: empty balls, points no slot names, one point named by every slot of
a ball, K 1, N not a multiple of K (the padded bucket) and the interim SA's
shapes at a narrow C.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ov3det.ops.pallas.ball_group_kernel import ball_group_pallas
from ov3det_torch.ops import pointcloud
from ov3det_torch.ops.kernels import ball_group as BG

SOURCE = (Path(BG.__file__).resolve().parents[2] / "csrc" / "feature_grad.cu").read_text()
CONSTS = dict(re.findall(r"constexpr int (k\w+) = (\d+);", SOURCE))
CLUSTER, MAX_WARPS = int(CONSTS["kMapCluster"]), int(CONSTS["kMapMaxWarps"])
HEAVY, MAX_SLOTS = int(CONSTS["kHeavy"]), int(CONSTS["kMaxSlots"])


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------ emulation
def emulate_map(keys: np.ndarray, N: int, warps: int = MAX_WARPS):
    """`feature_map` for one scene: keys (KM,) int32 -> (list (valid,) of
    slot indices point-major, work records (N, 3) {point, first, end} in
    the kernel's order).  The cluster's CTA c, warp w owns segment
    c * warps + w; counts go into a (segments, N) histogram."""
    KM = keys.shape[0]
    segs = CLUSTER * warps
    seg = -(-KM // segs)
    valid = (keys >= 0) & (keys < N)
    hist = np.zeros((segs, N), np.int64)
    for q in range(segs):
        lo, hi = min(q * seg, KM), min(q * seg + seg, KM)
        np.add.at(hist[q], keys[lo:hi][valid[lo:hi]], 1)
    # within a CTA: each warp's place among its CTA's counts (column prefix)
    per_cta = hist.reshape(CLUSTER, warps, N)
    warp_prefix = np.cumsum(per_cta, axis=1) - per_cta
    tot = per_cta.sum(1)  # (CTA, N)
    ahead = np.cumsum(tot, axis=0) - tot  # the CTAs before each one
    count = tot.sum(0)
    start = np.cumsum(count) - count  # the scan over the points
    place = (start[None, None, :] + ahead[:, None, :] + warp_prefix).reshape(segs, N)
    out = np.full(int(count.sum()), -1, np.int64)
    for q in range(segs):
        lo, hi = min(q * seg, KM), min(q * seg + seg, KM)
        for base in range(lo, hi, 32):  # a warp step: 32 slots, ranks by lane among equal keys
            step = keys[base:min(base + 32, hi)]
            for lane, k in enumerate(step):
                if 0 <= k < N:
                    rank = int(np.sum(step[:lane] == k))
                    out[place[q, k] + rank] = base + lane
            for k in np.unique(step[(step >= 0) & (step < N)]):
                place[q, k] += int(np.sum(step == k))
    total = int(count.sum())
    heavy = count * N > HEAVY * total
    order = np.concatenate([np.flatnonzero(heavy), np.flatnonzero(~heavy)])
    work = np.stack([order, start[order], start[order] + count[order]], 1)
    return out, work


def emulate_sum(grad_rows: np.ndarray, slots: np.ndarray, work: np.ndarray, N: int) -> np.ndarray:
    """`feature_sum` for one scene: grad_rows (KM, C) f32 (the cotangent's
    feature columns), each point's rows added from 0.0f one after another
    in list order (the items' slices of channels are independent)."""
    C = grad_rows.shape[1]
    out = np.full((N, C), np.nan, np.float32)
    acc = np.zeros((work.shape[0], C), np.float32)
    counts = work[:, 2] - work[:, 1]
    for t in range(int(counts.max(initial=0))):
        live = counts > t
        rows = grad_rows[slots[work[live, 1] + t]]
        acc[live] = acc[live] + rows  # f32 + f32, rounded once
    out[work[:, 0]] = acc
    return out


def emulate(src: np.ndarray, grad: np.ndarray, N: int):
    """Both launches: src (B, K, M) int32, grad (B, K, M, 3 + C) f32 ->
    (B, N, C) f32, and each scene's list."""
    B, K, M = src.shape
    out, lists = [], []
    for b in range(B):
        slots, work = emulate_map(src[b].reshape(-1), N)
        out.append(emulate_sum(grad[b, ..., 3:].reshape(K * M, -1), slots, work, N))
        lists.append(slots)
    return np.stack(out), lists


# ------------------------------------------------------------ cases
def case(name: str):
    """(xyz (B, N, 3), feats (B, N, C), centers (B, M, 3), radius, K)."""
    rng = np.random.default_rng(CASES.index(name))
    B, N, M, K, C, radius = 2, 256, 32, 8, 8, 0.35
    if name == "interim":  # the masked step's interim SA at a narrow C
        B, N, M, K, C, radius = 1, 2048, 1024, 32, 4, 0.4
    if name == "k1":
        K = 1
    if name == "ragged_n":
        N = 251  # not a multiple of K: a shorter last bucket
    xyz = rng.uniform(-1, 1, (B, N, 3)).astype(np.float32)
    centers = xyz[:, rng.choice(N, M, replace=False)].copy()
    if name == "empty_balls":
        centers[:, ::3] += 10.0  # a third of the balls hold no point
    if name == "one_point":  # the first center's ball holds one point, named by all K slots
        centers[:, 0] = [5.0, 5.0, 5.0]
        xyz[:, 3] = [5.0, 5.0, 5.05]
    if name == "unnamed":
        radius = 0.05  # most balls hold few points: many points are named by no slot
    feats = rng.normal(size=(B, N, C)).astype(np.float32)
    return xyz, feats, centers, radius, K


CASES = ["random", "empty_balls", "unnamed", "one_point", "k1", "ragged_n", "interim"]


@pytest.mark.parametrize("name", CASES)
def test_emulated_kernels_equal_scatter_bit_for_bit(name):
    xyz, feats, centers, radius, K = case(name)
    N, C = xyz.shape[1], feats.shape[-1]
    src = BG.slot_sources_plain(_t(xyz), _t(centers), radius, K).numpy()
    rng = np.random.default_rng(7)
    grad = rng.normal(size=src.shape + (3 + C,)).astype(np.float32)
    grad[..., 3:] *= np.float32(2.0) ** rng.integers(-20, 20, grad[..., 3:].shape)  # rounding bites
    got, lists = emulate(src, grad, N)
    want = BG._scatter(_t(src), _t(grad), N, C).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    for b, slots in enumerate(lists):  # the list is the stable order of the slots by point
        keys = src[b].reshape(-1)
        order = np.argsort(keys, kind="stable")
        np.testing.assert_array_equal(slots, order[keys[order] >= 0])
    named = np.zeros((src.shape[0], N), bool)
    for b in range(src.shape[0]):
        named[b, src[b][src[b] >= 0]] = True
    assert (got[~named] == 0).all() and not np.signbit(got[~named]).any()
    if name == "empty_balls":
        assert (src[:, :, ::3] == -1).all()
    if name == "unnamed":
        assert (~named).mean() > 0.3
    if name == "one_point":
        assert (src[:, :, 0] == 3).all()


def test_work_records_put_heavy_points_first():
    rng = np.random.default_rng(3)
    N, KM = 64, 2048
    keys = rng.integers(0, N, KM).astype(np.int32)
    keys[::5] = 7  # point 7 named by a fifth of the slots, 6.4 times the mean
    keys[1::9] = 40
    keys[2::50] = -1
    slots, work = emulate_map(keys, N)
    count = np.bincount(keys[keys >= 0], minlength=N)
    assert work[0, 0] == 7 and work[1, 0] == 40  # heavy, in point order
    assert sorted(work[:, 0].tolist()) == list(range(N))
    light = work[2:, 0]
    assert (np.diff(light) > 0).all()
    np.testing.assert_array_equal(work[:, 2] - work[:, 1], count[work[:, 0]])
    assert len(slots) == count.sum()


def test_map_fits_the_masked_step():
    # 8 scenes x 32 x 1024 slots onto 2048 points: 32 warps a CTA, a uint16 place
    assert 32 * 1024 <= MAX_SLOTS
    assert 32 * (2048 + 0) * 2 + 2048 * 12 <= 232448  # the card's shared memory a CTA


@pytest.mark.parametrize("name", ["random", "empty_balls", "one_point", "k1", "ragged_n",
                                  "interim"])
def test_ball_group_vjp_matches_pallas(name, monkeypatch):
    monkeypatch.setenv("OV3DET_BALLGROUP", "pallas")  # the TPU's ball-group, interpreted
    xyz, feats, centers, radius, K = case(name)
    C = feats.shape[-1]
    rng = np.random.default_rng(12)
    shape = (xyz.shape[0], K, centers.shape[1], 3 + C)
    # at the interim shape a point sums up to ~250 rows, and XLA adds them in
    # another order: small integers make every partial sum exact in f32, so
    # the two must agree exactly there; elsewhere normal values within 1e-6
    exact = name == "interim"
    g = (rng.integers(-8, 9, shape) if exact else rng.normal(size=shape)).astype(np.float32)

    def fn(f):
        return ball_group_pallas(jnp.asarray(xyz), f, jnp.asarray(centers), radius, K, True, True)

    want, vjp = jax.vjp(fn, jnp.asarray(feats))
    (want_grad,) = vjp(jnp.asarray(g))
    tf = _t(feats).requires_grad_()
    got = pointcloud.ball_group(_t(xyz), tf, _t(centers), radius, K)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    got.backward(_t(g))
    if exact:
        np.testing.assert_array_equal(tf.grad.numpy(), np.asarray(want_grad))
    else:
        np.testing.assert_allclose(tf.grad.numpy(), np.asarray(want_grad), rtol=1e-6, atol=1e-6)
    src = BG.slot_sources_plain(_t(xyz), _t(centers), radius, K)
    emulated, _ = emulate(src.numpy(), g, xyz.shape[1])
    np.testing.assert_array_equal(tf.grad.numpy(), emulated)


def test_wrapper_checks():
    src = torch.zeros((2, 4, 8), dtype=torch.int32)
    grad = torch.zeros((2, 4, 8, 3 + 5))
    before = BG.feature_scatter.launches
    assert BG.feature_scatter(src, grad, 10, 5).shape == (2, 10, 5)
    with pytest.raises(TypeError, match="int32 sources"):
        BG.feature_scatter(src.long(), grad, 10, 5)
    with pytest.raises(TypeError, match="f32 cotangent"):
        BG.feature_scatter(src, grad.double(), 10, 5)
    with pytest.raises(TypeError, match="f32 cotangent"):
        BG.feature_scatter(src, grad, 10, 6)  # C disagrees with the cotangent's width
    with pytest.raises(TypeError, match="f32 cotangent"):
        BG.feature_scatter(src, grad[:, :3], 10, 5)
    with pytest.raises(ValueError, match="several devices"):
        BG.feature_scatter(src, grad.to("meta"), 10, 5)
    with pytest.raises(ValueError, match="cuda or cpu"):
        BG.feature_scatter(src.to("meta"), grad.to("meta"), 10, 5)
    with pytest.raises(ValueError, match="N >= 1"):
        BG.feature_scatter(src, grad, 0, 5)
    assert BG.feature_scatter.launches == before  # the CPU launches nothing
