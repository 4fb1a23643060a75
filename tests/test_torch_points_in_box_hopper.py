"""The routed empty-box design (`points_in_box_cluster` of
`ov3det_torch/csrc/points_in_box.cu`) emulated on the CPU with numpy: a
cluster of `cluster_size_for(N)` CTAs a (scene, tile of `CLUSTER_TILE`
boxes), CTA r counting its contiguous slice of the points, each thread its
`BOXES_PER_THREAD` boxes against every point-lane'th point of the slice, the
lanes' counts summed into the leader's.  The emulation's counts equal the
JAX package's `points_in_box_counts` and the port's plain version exactly:

- on jittered boxes of `make_batch` scenes and on rotated boxes with points
  1e-5 either side of each face;
- with box tiles ragged at the end (K 1, 17, 37) and point slices ragged
  at the end (N 1, 511, 513, 2600), one slice smaller than `SLICE_MIN`,
  and N 0;
- on a box that holds every point, a flat box, NaN and infinite corners.

And the wrapper's glue: the tile, slice and cluster constants mirror the
source, `_impl="first"` is refused on CPU tensors and an unknown `_impl`
raises.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ov3det.eval.parse import points_in_box_counts as jax_counts
from ov3det.geometry.boxes_np import corners_from_upright_depth_param_np
from ov3det_torch.ops.kernels import points_in_box as pib
from tests import torch_parity as tp
from tests.test_torch_points_in_box import _face_points, _with_empty_boxes

SOURCE = Path(__file__).resolve().parents[1] / "ov3det_torch" / "csrc" / "points_in_box.cu"
EPS = np.float32(pib.EPS)


@pytest.fixture(autouse=True)
def _setup():
    torch.set_num_threads(1)


def _constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE.read_text()).group(1))


def cluster_emulation(points: np.ndarray, corners: np.ndarray) -> np.ndarray:
    """(B, N, 3), (B, K, 8, 3) f32 -> (B, K) int32 as the routed design
    counts: each box's parameters in depth coordinates, each CTA of the
    cluster its slice of the points, each thread's count over its points,
    the counts summed."""
    B, N, _ = points.shape
    K = corners.shape[1]
    cs = pib.cluster_size_for(N)
    L = -(-N // cs)
    tile = pib.CLUSTER_TILE
    point_lanes = _constant("kClusterThreads") // _constant("kBoxLanes")
    depth = np.stack([corners[..., 0], corners[..., 2], -corners[..., 1]], -1)
    origin = depth[:, :, 0]
    edges = [depth[:, :, j] - origin for j in (1, 3, 4)]
    his = [((e[..., 0] * e[..., 0] + e[..., 1] * e[..., 1]) + e[..., 2] * e[..., 2]) + EPS
           for e in edges]
    counts = np.zeros((B, K), np.int64)
    with np.errstate(invalid="ignore", over="ignore"):
        for b in range(B):
            for k0 in range(0, K, tile):
                box = slice(k0, min(k0 + tile, K))
                o = origin[b, box]
                for rank in range(cs):  # the CTAs of the cluster
                    lo, hi = rank * L, min(N, (rank + 1) * L)
                    for q in range(point_lanes):  # a thread's points, then its count
                        p = points[b, lo + q:hi:point_lanes]  # (n, 3)
                        rel = [p[None, :, a] - o[:, a, None] for a in range(3)]
                        inside = np.ones(rel[0].shape, bool)
                        for e, h in zip(edges, his):
                            e = e[b, box]
                            proj = (rel[0] * e[:, 0, None] + rel[1] * e[:, 1, None]) \
                                + rel[2] * e[:, 2, None]
                            inside &= (proj >= -EPS) & (proj <= h[b, box][:, None])
                        counts[b, box] += inside.sum(1)
    return counts.astype(np.int32)


def _jax(points, corners):
    return np.asarray(jax_counts(jnp.asarray(points), jnp.asarray(corners)))


def _plain(points, corners):
    return pib.points_in_box_plain(torch.from_numpy(points), torch.from_numpy(corners)).numpy()


def _check(points, corners):
    want = _jax(points, corners)
    got = cluster_emulation(points, corners)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(_plain(points, corners), want)
    return want


def _random_boxes(seed: int, B: int, K: int, N: int) -> tuple:
    rng = np.random.default_rng(seed)
    points = rng.uniform(-2.5, 2.5, (B, N, 3)).astype(np.float32)
    corners = corners_from_upright_depth_param_np(
        rng.uniform(-2, 2, (B, K, 3)), rng.uniform(0.2, 3, (B, K, 3)),
        rng.uniform(-np.pi, np.pi, (B, K))).astype(np.float32)
    return points, corners


@pytest.mark.parametrize("seed", [0, 1])
def test_cluster_counts_equal_jax_on_make_batch_scenes(seed):
    batch, out = _with_empty_boxes(seed)
    want = _check(batch["point_clouds"], out["box_corners"])
    assert (want >= 5).any() and (want < 5).any()


@pytest.mark.parametrize("K,N", [(1, 2600), (17, 513), (37, 511), (33, 1), (16, 1025),
                                 (5, 0)])
def test_ragged_tiles_and_slices(K, N):
    """Box tiles ragged at the end, point slices ragged at the end, one
    slice under `SLICE_MIN`, a single point and no point."""
    points, corners = _random_boxes(K * 7 + N, 2, K, N)
    want = _check(points, corners)
    if N == 0:
        assert not want.any()
    else:
        assert pib.cluster_size_for(N) == min(pib.MAX_CLUSTER, max(1, -(-N // pib.SLICE_MIN)))


@pytest.mark.parametrize("angle", [0.0, -2.1])
def test_points_a_margin_either_side_of_each_face(angle):
    rng = np.random.default_rng(int(angle * 10) + 70)
    B, K, per_face = 2, 3, 5
    centers = np.array([[-2.5, 0.0, 0.3], [0.0, 0.2, -0.4], [2.5, -0.1, 0.0]])
    centers = np.broadcast_to(centers, (B, K, 3)) + rng.uniform(-0.1, 0.1, (B, K, 3))
    sizes = rng.uniform(0.8, 1.6, (B, K, 3))
    angles = angle + rng.uniform(-0.2, 0.2, (B, K))
    corners = corners_from_upright_depth_param_np(centers, sizes, angles).astype(np.float32)
    points = []
    for b in range(B):
        parts = [_face_points(corners[b, k], per_face, rng) for k in range(K)]
        points.append(np.concatenate([p for pair in parts for p in pair]))
    want = _check(np.stack(points), corners)
    np.testing.assert_array_equal(want, 6 * per_face)


def test_every_point_flat_nan_and_infinite_boxes():
    batch = tp.make_batch(seed=5)
    points = batch["point_clouds"]
    B, N = points.shape[:2]
    big = corners_from_upright_depth_param_np(np.zeros((B, 1, 3)), np.full((B, 1, 3), 100.0),
                                              np.full((B, 1), 0.4))
    small = corners_from_upright_depth_param_np(np.zeros((B, 1, 3)), np.full((B, 1, 3), 1.5),
                                                np.zeros((B, 1)))
    flat = corners_from_upright_depth_param_np(
        np.zeros((B, 1, 3)), np.broadcast_to(np.array([1.5, 1.5, 0.0]), (B, 1, 3)),
        np.zeros((B, 1)))
    nan, inf = small.copy(), small.copy()
    nan[:, 0, 3, 1] = np.nan
    inf[:, 0, 4, 0] = np.inf
    corners = np.concatenate([big, small, flat, nan, inf], 1).astype(np.float32)
    got = _check(points, corners)
    np.testing.assert_array_equal(got[:, 0], N)
    np.testing.assert_array_equal(got[:, 3], 0)
    assert (got[:, 1] > 0).all()


def test_route_mirrors_the_source():
    src = SOURCE.read_text()
    assert _constant("kBoxesPerThread") == pib.BOXES_PER_THREAD
    assert "constexpr int kClusterTile = kBoxLanes * kBoxesPerThread;" in src
    assert _constant("kBoxLanes") * pib.BOXES_PER_THREAD == pib.CLUSTER_TILE
    assert _constant("kSliceMin") == pib.SLICE_MIN and _constant("kMaxCluster") == pib.MAX_CLUSTER
    assert re.search(r"return N <= kSliceMin \? 1\s*: \(N \+ kSliceMin - 1\) / kSliceMin < "
                     r"kMaxCluster \? \(N \+ kSliceMin - 1\) / kSliceMin\s*: kMaxCluster;", src)
    assert [pib.cluster_size_for(n) for n in (0, 512, 513, 4096, 4097, 40000)] == [1, 1, 2, 8, 8, 8]
    # the slice a CTA of the cluster takes, and each thread's points in it
    assert "const int L = (N + cs - 1) / cs, lo = rank * L;" in src
    assert "const int g = tid % kBoxLanes, q = tid / kBoxLanes;" in src
    # one launch a call on each route: the cluster by cudaLaunchKernelEx
    assert src.count("cudaLaunchKernelEx(&cfg, points_in_box_cluster") == 1
    assert src.count("points_in_box_kernel<<<") == 1


def test_impl_first_is_refused_on_cpu_tensors():
    points, corners = (torch.from_numpy(a) for a in _random_boxes(9, 1, 4, 50))
    with pytest.raises(ValueError, match="CPU"):
        pib.points_in_box(points, corners, _impl="first")
    with pytest.raises(ValueError, match="_impl"):
        pib.points_in_box(points, corners, _impl="cluster")
    before = pib.points_in_box.launches
    np.testing.assert_array_equal(pib.points_in_box(points, corners).numpy(),
                                  _plain(points.numpy(), corners.numpy()))
    assert pib.points_in_box.launches == before
