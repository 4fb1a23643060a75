"""The routed first-K design (`first_k_lanes` of `ov3det_torch/csrc/first_k.cu`)
emulated on the CPU with numpy: the scene's points cut into contiguous
slices, a warp each, staged a fixed count of points at a time; each lane's
tests a step of `UNROLL` points at a time, each hit appended to its ball's
own list at its own count until the ball holds nsample (up to UNROLL - 1
more within the step); at each stage a slice stops a ball whose hits there
and in the earlier slices reach nsample; the slices' lists merged in slice
order.  The emulation equals JAX's `ball_query(method="first_k")` and the
port's plain version exactly:

- at nsample 1, 32, 64 and 128, with the kernel's split (`slices_for`,
  `SLICE_POINTS`) and with slice counts and stage sizes that are no
  multiple of 32;
- whatever the order in which the slices see each other's counts (the
  warps run without a barrier): in lockstep, one slice after another, or
  never;
- on full, empty and partial balls, balls that fill at a slice or stage
  boundary, and at the r^2 boundary, where the expanded distance and a
  direct subtraction disagree (the case of `tests/test_torch_reference_ckpt.py`);
- with r^2 <= 0, which the kernel tests as d < -inf, and with NaN points
  and centers.

And the wrapper's glue: the split and `kMaxSample` mirror the source,
`_impl="first"` is refused on CPU tensors and an unknown `_impl` raises.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ov3det.ops.pointcloud import ball_query as jax_ball_query
from ov3det_torch.ops.kernels import ball_query as bq

SOURCE = Path(__file__).resolve().parents[1] / "ov3det_torch" / "csrc" / "first_k.cu"
NAN = np.float32(np.nan)


@pytest.fixture(autouse=True)
def _setup():
    torch.set_num_threads(1)


def _norm2(x, y, z):
    return (x * x + y * y) + z * z


def lanes_emulation(xyz: np.ndarray, centers: np.ndarray, radius: float, nsample: int,
                    slices=None, slice_points: int = bq.SLICE_POINTS, unroll: int = bq.UNROLL,
                    schedule: str = "lockstep") -> np.ndarray:
    """(B, N, 3), (B, M, 3) f32 -> (B, M, nsample) int64, step by step as the
    routed design takes it.  `schedule` orders the slices' stages: in
    lockstep (each stage sees the earlier slices' counts from the start of
    the same stage), one slice after another (each sees the earlier slices'
    final counts), or "never" (no slice stops for the others)."""
    B, N, _ = xyz.shape
    M = centers.shape[1]
    S = bq.slices_for(nsample) if slices is None else slices
    r2 = np.float32(bq._r2(radius))
    thr0 = r2 if r2 > 0 else np.float32(-np.inf)
    L = -(-N // S)
    stages = -(-L // slice_points)
    out = np.zeros((B, M, nsample), np.int64)
    order = ([(t, s) for t in range(stages) for s in range(S)] if schedule == "lockstep" else
             [(t, s) for s in range(S) for t in range(stages)])
    with np.errstate(invalid="ignore", over="ignore"):
        for b in range(B):
            c = centers[b]
            c2 = _norm2(c[:, 0], c[:, 1], c[:, 2])
            picks = [[[] for _ in range(M)] for _ in range(S)]
            thr = np.full((S, M), thr0, np.float32)
            published = np.zeros((S, M), np.int64)  # the counts at the last stage start
            for t, s in order:
                lo = s * L + t * slice_points
                n = max(0, min(slice_points, min(N, (s + 1) * L) - lo))
                if n == 0:
                    continue
                counts = np.array([len(p) for p in picks[s]])
                published[s] = np.minimum(counts, nsample)
                if schedule != "never":
                    thr[s, counts + published[:s].sum(0) >= nsample] = -np.inf
                rows = np.zeros((-(-n // unroll) * unroll, 4), np.float32)
                rows[:, 3] = NAN  # past the stage's rows: no distance passes
                p = xyz[b, lo:lo + n]
                rows[:n, :3] = p
                rows[:n, 3] = _norm2(p[:, 0], p[:, 1], p[:, 2])
                for j in range(0, n, unroll):
                    q = rows[j:j + unroll]  # (unroll, 4)
                    cross = ((c[:, None, 0] * q[None, :, 0] + c[:, None, 1] * q[None, :, 1])
                             + c[:, None, 2] * q[None, :, 2])
                    d = (c2[:, None] + q[None, :, 3]) - np.float32(2) * cross  # (M, unroll)
                    for m in np.nonzero((d < thr[s, :, None]).any(1))[0]:
                        picks[s][m] += [lo + j + u for u in range(unroll) if d[m, u] < thr[s, m]]
                        if len(picks[s][m]) >= nsample:
                            thr[s, m] = -np.inf
            for m in range(M):
                merged = [i for s in range(S) for i in picks[s][m][:nsample]][:nsample]
                head = merged[0] if merged else 0
                out[b, m] = merged + [head] * (nsample - len(merged))
    return out


def _jax(xyz, centers, radius, nsample):
    return np.asarray(jax_ball_query(jnp.asarray(xyz), jnp.asarray(centers), radius, nsample,
                                     method="first_k"))


def _plain(xyz, centers, radius, nsample):
    return bq.first_k_plain(torch.from_numpy(xyz), torch.from_numpy(centers), radius,
                            nsample).numpy()


def _cloud(seed: int, B: int, N: int, M: int):
    """Half the centers on points, the rest anywhere, some far from every point."""
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-1, 1, (B, N, 3)).astype(np.float32)
    centers = np.concatenate([xyz[:, :M // 2], rng.uniform(-2, 2, (B, M - M // 2, 3))], 1)
    return xyz, np.ascontiguousarray(centers, dtype=np.float32)


@pytest.mark.parametrize("nsample,radius", [(1, 0.2), (32, 0.4), (64, 0.2), (128, 0.9)])
def test_lanes_equal_jax_and_plain(nsample, radius):
    """The kernel's own split: 4 slices of 650 points (2 of 1300 at nsample
    128), stages of 256."""
    xyz, centers = _cloud(nsample, 2, 2600, 24)
    want = _jax(xyz, centers, radius, nsample)
    got = lanes_emulation(xyz, centers, radius, nsample)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(_plain(xyz, centers, radius, nsample), want)
    hits = (want[..., 1:] != want[..., :1]).sum(-1) + 1
    assert (want == 0).all(-1).any()  # an empty ball
    if radius == 0.9:
        assert (hits == nsample).any()  # a full ball: its slice-1 hits are not needed


@pytest.mark.parametrize("slices,slice_points", [(3, 36), (5, 100), (1, 44), (4, 8)])
@pytest.mark.parametrize("nsample", [1, 32, 64, 128])
def test_ragged_splits_equal_jax(slices, slice_points, nsample):
    """Slice counts and stage sizes that are no multiple of 32, balls that
    fill inside a slice, across a slice boundary and at a stage boundary,
    in each order in which the slices may see each other's counts."""
    xyz, centers = _cloud(slices * 10 + nsample, 1, 603, 10)
    radius = 0.6 if nsample >= 64 else 0.35
    want = _jax(xyz, centers, radius, nsample)
    for schedule in ("lockstep", "one after another", "never"):
        np.testing.assert_array_equal(
            lanes_emulation(xyz, centers, radius, nsample, slices, slice_points,
                            schedule=schedule), want)


def test_a_ball_that_fills_at_a_slice_boundary():
    """A ball whose nsample-th hit is the last point of slice 0, and one
    whose first hit is the first point of slice 1."""
    N, ns = 40, 8
    xyz = np.full((1, N, 3), 5.0, np.float32)
    L = -(-N // bq.slices_for(ns))
    xyz[0, L - ns:L] = 0.0  # hits L - ns .. L - 1: the ball fills at slice 0's end
    xyz[0, L:L + 3] = [10.0, 0.0, 0.0]  # the second center's only hits open slice 1
    centers = np.array([[[0, 0, 0], [10, 0, 0]]], np.float32)
    want = _jax(xyz, centers, 0.1, ns)
    got = lanes_emulation(xyz, centers, 0.1, ns)
    np.testing.assert_array_equal(got, want)
    assert got[0, 0].tolist() == list(range(L - ns, L))
    assert got[0, 1].tolist() == [L, L + 1, L + 2] + [L] * (ns - 3)


def test_full_empty_and_boundary_balls():
    """The r^2 boundary scene of test_torch_reference_ckpt.py (a point the
    expanded distance puts inside and a direct subtraction outside), all
    balls full and all empty."""
    radius = 0.2
    c0, r2 = np.float32(10.0), np.float32(radius * radius)
    direct = lambda p: (p - c0) * (p - c0)  # noqa: E731
    expanded = lambda p: np.maximum((c0 * c0 + p * p) - np.float32(2) * (c0 * p), 0)  # noqa: E731
    p = np.nextafter(np.float32(c0 + np.float32(radius)), np.float32(0))
    while not (direct(p) >= r2 and expanded(p) < r2):
        p = np.nextafter(p, np.float32(20))
    q = p
    while expanded(q) < r2:
        q = np.nextafter(q, np.float32(20))
    xyz = np.zeros((1, 6, 3), np.float32)
    xyz[0, :, 0] = [30.0, q, p, c0 - np.float32(0.1), 40.0, c0]
    centers = np.array([[[c0, 0, 0], [30.0, 0, 0], [-5.0, 0, 0]]], np.float32)
    got = lanes_emulation(xyz, centers, radius, 4)
    np.testing.assert_array_equal(got, _jax(xyz, centers, radius, 4))
    assert got[0, 0].tolist() == [2, 3, 5, 2] and got[0, 2].tolist() == [0] * 4

    cloud = np.random.default_rng(5).uniform(-1, 1, (1, 300, 3)).astype(np.float32)
    full = lanes_emulation(cloud, cloud[:, :9].copy(), 4.0, 64)
    np.testing.assert_array_equal(full, np.broadcast_to(np.arange(64), full.shape))
    far = np.full((1, 4, 3), 7.0, np.float32)
    assert not lanes_emulation(cloud, far, 0.3, 32).any()


@pytest.mark.parametrize("radius", [0.0, -0.0])
def test_no_ball_holds_a_point_at_r2_zero(radius):
    """r^2 = 0: the clamped distance is never below it, nor is any d below
    -inf, which the kernel tests instead."""
    xyz, centers = _cloud(3, 1, 50, 4)
    want = _jax(xyz, centers, radius, 8)
    assert not want.any()
    np.testing.assert_array_equal(lanes_emulation(xyz, centers, radius, 8), want)


def test_nan_points_and_centers_hit_nothing():
    xyz, centers = _cloud(9, 1, 80, 6)
    xyz[0, 3:9, 1] = np.nan
    centers[0, 2, 0] = np.nan
    want = _jax(xyz, centers, 0.5, 16)
    np.testing.assert_array_equal(lanes_emulation(xyz, centers, 0.5, 16), want)
    np.testing.assert_array_equal(_plain(xyz, centers, 0.5, 16), want)


def test_route_mirrors_the_source():
    src = SOURCE.read_text()
    assert f"constexpr int kMaxSample = {bq.MAX_NSAMPLE};" in src
    assert f"constexpr int kSlicePoints = {bq.SLICE_POINTS};" in src
    assert f"constexpr int kUnroll = {bq.UNROLL};" in src
    centers = int(re.search(r"constexpr int kCenters = (\d+);", src).group(1))
    assert "constexpr int kLaneTile = 32 * kCenters;" in src and 32 * centers == bq.LANE_TILE
    assert "constexpr int slices_for(int nsample) { return nsample <= 64 ? 4 : 2; }" in src
    assert [bq.slices_for(n) for n in (1, 64, 65, 128)] == [4, 4, 2, 2]
    # the slice and stage split the emulation takes
    assert "const int L = (N + S - 1) / S, lo = slice * L;" in src
    assert "ov3::stage_words(mine + (t & 1) * kRawWords, src + 3 * t * kSlicePoints" in src
    # the distance in `_d2_expanded`'s order and the test against -inf at r^2 <= 0
    assert "d[u][r] = __fsub_rn(__fadd_rn(c2[r], q.w), __fmul_rn(2.0f, cross));" in src
    assert "const float thr0 = r2 > 0.0f ? r2 : -INFINITY;" in src
    # the stop of a slice for the earlier slices' counts
    assert "if (before >= nsample) thr[r] = -INFINITY;" in src
    # one launch a call on each route
    assert src.count("first_k_lanes<4><<<") == 1 and src.count("first_k_lanes<2><<<") == 1
    assert src.count("first_k_kernel<<<") == 1


def test_impl_first_is_refused_on_cpu_tensors():
    xyz, centers = (torch.from_numpy(a) for a in _cloud(2, 1, 100, 4))
    with pytest.raises(ValueError, match="CPU"):
        bq.first_k(xyz, centers, 0.3, 8, _impl="first")
    with pytest.raises(ValueError, match="_impl"):
        bq.first_k(xyz, centers, 0.3, 8, _impl="lanes")
    before = bq.first_k.launches
    np.testing.assert_array_equal(bq.first_k(xyz, centers, 0.3, 8).numpy(),
                                  bq.first_k_plain(xyz, centers, 0.3, 8).numpy())
    assert bq.first_k.launches == before
