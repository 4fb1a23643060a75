"""The parse's empty-box test on the CPU: the plain version of the kernel
(`ov3det_torch.ops.kernels.points_in_box`), which the wrapper takes for CPU
tensors, against the JAX package's `points_in_box_counts`, counts equal
exactly:

- on the boxes of `make_batch` scenes (jittered GT boxes, as the parse
  tests build them);
- on rotated boxes with points 1e-5 inside and outside each face (far
  beyond the rounding of either side), a box that holds every point, NaN
  corners and a single box a scene;

and the wrapper's glue: CPU tensors take the plain version (no build, no
launch counted), the counts are int32 on both routes, the chunking over
boxes changes nothing, and `parse_predictions` keeps the mask that the
former matmul form of the test gave.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ov3det.eval.parse import points_in_box_counts as jax_counts
from ov3det.geometry.boxes_np import corners_from_upright_depth_param_np
from ov3det_torch.eval import parse
from ov3det_torch.ops.kernels import _build
from ov3det_torch.ops.kernels import points_in_box as pib
from tests import torch_parity as tp
from tests.test_torch_infer import _crafted_outputs

MARGIN = 1e-5  # distance of the crafted points from a face


@pytest.fixture(autouse=True)
def _setup():
    torch.set_num_threads(1)


def _jax(points: np.ndarray, corners: np.ndarray) -> np.ndarray:
    return np.asarray(jax_counts(jnp.asarray(points), jnp.asarray(corners)))


def _port(points: np.ndarray, corners: np.ndarray, **kw) -> np.ndarray:
    got = pib.points_in_box_plain(torch.from_numpy(points), torch.from_numpy(corners), **kw)
    assert got.dtype == torch.int32
    return got.numpy()


def _face_points(corners: np.ndarray, per_face: int, rng) -> tuple:
    """Points MARGIN inside and MARGIN outside each of a box's six faces, at
    random places on the face: (inside (6 * per_face, 3), outside (...)),
    f32, upright-depth."""
    d = corners.astype(np.float64)[:, [0, 2, 1]] * np.array([1.0, 1.0, -1.0])  # depth coords
    origin = d[0]
    edges = np.stack([d[j] - origin for j in (1, 3, 4)])  # (3, 3)
    inside, outside = [], []
    for j in range(3):
        normal = edges[j] / np.linalg.norm(edges[j])
        for high in (False, True):
            t = rng.uniform(0.1, 0.9, (per_face, 3))
            t[:, j] = 1.0 if high else 0.0
            on_face = origin + t @ edges
            inward = -normal if high else normal
            inside.append(on_face + MARGIN * inward)
            outside.append(on_face - MARGIN * inward)
    return (np.concatenate(inside).astype(np.float32),
            np.concatenate(outside).astype(np.float32))


def _with_empty_boxes(seed: int) -> tuple:
    """The parse tests' crafted outputs (jittered GT boxes of `make_batch`
    scenes) and, after them, the same boxes moved 20 m along x, away from
    every point."""
    batch, out = _crafted_outputs(seed)
    moved = out["box_corners"] + np.array([20.0, 0.0, 0.0], np.float32)
    out = {k: np.concatenate([v, moved if k == "box_corners" else v], 1) for k, v in out.items()}
    return batch, out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_counts_equal_jax_on_make_batch_scenes(seed):
    batch, out = _with_empty_boxes(seed)
    want = _jax(batch["point_clouds"], out["box_corners"])
    np.testing.assert_array_equal(_port(batch["point_clouds"], out["box_corners"]), want)
    assert (want >= 5).any() and (want < 5).any()  # both sides of the parse's cut


@pytest.mark.parametrize("seed", [3, 4])
def test_plain_counts_equal_jax_on_random_boxes(seed):
    rng = np.random.default_rng(seed)
    batch = tp.make_batch(seed=seed)
    B, K = batch["point_clouds"].shape[0], 37
    corners = corners_from_upright_depth_param_np(
        rng.uniform(-2, 2, (B, K, 3)), rng.uniform(0.1, 3, (B, K, 3)),
        rng.uniform(-np.pi, np.pi, (B, K))).astype(np.float32)
    want = _jax(batch["point_clouds"], corners)
    np.testing.assert_array_equal(_port(batch["point_clouds"], corners), want)
    assert want.max() > 0


@pytest.mark.parametrize("angle", [0.0, 0.3, -2.1])
def test_points_a_margin_either_side_of_each_face(angle):
    """Three rotated boxes a scene, apart; each face has points MARGIN inside
    (counted) and MARGIN outside (not counted)."""
    rng = np.random.default_rng(int(angle * 10) + 50)
    B, K, per_face = 2, 3, 7
    centers = np.array([[-2.5, 0.0, 0.3], [0.0, 0.2, -0.4], [2.5, -0.1, 0.0]])
    centers = np.broadcast_to(centers, (B, K, 3)) + rng.uniform(-0.1, 0.1, (B, K, 3))
    sizes = rng.uniform(0.8, 1.6, (B, K, 3))
    angles = angle + rng.uniform(-0.2, 0.2, (B, K))
    corners = corners_from_upright_depth_param_np(centers, sizes, angles).astype(np.float32)
    points = []
    for b in range(B):
        parts = [_face_points(corners[b, k], per_face, rng) for k in range(K)]
        points.append(np.concatenate([p for pair in parts for p in pair]))
    points = np.stack(points)
    want = _jax(points, corners)
    np.testing.assert_array_equal(want, 6 * per_face)
    np.testing.assert_array_equal(_port(points, corners), want)


def test_a_box_holding_every_point_nan_corners_and_one_box():
    batch = tp.make_batch(seed=5)
    points = batch["point_clouds"]
    B, N = points.shape[:2]
    big = corners_from_upright_depth_param_np(np.zeros((B, 1, 3)), np.full((B, 1, 3), 100.0),
                                              np.full((B, 1), 0.4))
    small = corners_from_upright_depth_param_np(np.zeros((B, 1, 3)), np.full((B, 1, 3), 1.5),
                                                np.zeros((B, 1)))
    nan = small.copy()
    nan[:, 0, 3, 1] = np.nan  # one coordinate of one corner
    corners = np.concatenate([big, small, nan], 1).astype(np.float32)
    want = _jax(points, corners)
    got = _port(points, corners)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:, 0], N)
    np.testing.assert_array_equal(got[:, 2], 0)
    assert (got[:, 1] > 0).all()
    # K 1
    np.testing.assert_array_equal(_port(points, corners[:, 1:2]), want[:, 1:2])


def test_chunks_of_boxes_give_the_same_counts():
    batch, out = _crafted_outputs(1)
    points, corners = batch["point_clouds"], out["box_corners"]
    K = corners.shape[1]
    whole = _port(points, corners, chunk=K)
    for chunk in (1, 7):
        np.testing.assert_array_equal(_port(points, corners, chunk=chunk), whole)
    np.testing.assert_array_equal(_port(points, corners), whole)


def test_the_wrapper_sends_cpu_tensors_to_the_plain_version(monkeypatch):
    batch, out = _crafted_outputs(0)
    points, corners = torch.from_numpy(batch["point_clouds"]), torch.from_numpy(out["box_corners"])
    calls = []
    plain = pib.points_in_box_plain

    def spy(*args, **kw):
        calls.append(args)
        return plain(*args, **kw)

    monkeypatch.setattr(pib, "points_in_box_plain", spy)
    before = pib.points_in_box.launches
    got = parse.points_in_box_counts(points, corners)
    assert len(calls) == 1 and pib.points_in_box.launches == before
    assert "points_in_box" not in _build._loaded  # nothing was built or loaded
    np.testing.assert_array_equal(got.numpy(), _jax(batch["point_clouds"], out["box_corners"]))


def test_counts_are_int32_as_in_jax():
    """The CPU route returns int32, the JAX function's dtype and the one the
    kernel writes (chip_smoke.py holds the card's route to the plain
    version's dtype)."""
    batch, out = _crafted_outputs(0)
    got = pib.points_in_box(torch.from_numpy(batch["point_clouds"]),
                            torch.from_numpy(out["box_corners"]))
    assert got.dtype == torch.int32
    assert _jax(batch["point_clouds"], out["box_corners"]).dtype == np.int32


@pytest.mark.parametrize("bad", ["points", "corners", "dtype", "empty"])
def test_the_wrapper_refuses_bad_operands(bad):
    points, corners = torch.zeros(2, 10, 3), torch.zeros(2, 4, 8, 3)
    if bad == "points":
        points = torch.zeros(2, 10, 4)
    elif bad == "corners":
        corners = torch.zeros(3, 4, 8, 3)
    elif bad == "dtype":
        corners = corners.double()
    else:
        corners = torch.zeros(2, 0, 8, 3)
    with pytest.raises(ValueError):
        pib.points_in_box(points, corners)


def _matmul_counts(points, corners):
    """The port's former empty-box test: a matmul over the three axes."""
    depth = torch.stack([corners[..., 0], corners[..., 2], -corners[..., 1]], dim=-1)
    origin = depth[:, :, 0, :]
    edges = torch.stack([depth[:, :, j, :] - origin for j in (1, 3, 4)], dim=2)
    sq = (edges * edges).sum(dim=-1)
    rel = points[:, None, :, :] - origin[:, :, None, :]
    proj = torch.matmul(rel, edges.transpose(-1, -2))
    eps = 1e-6
    return ((proj >= -eps) & (proj <= sq[:, :, None, :] + eps)).all(dim=-1).sum(dim=-1)


@pytest.mark.parametrize("no_nms", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_parse_keeps_the_mask_of_the_former_test(monkeypatch, seed, no_nms):
    batch, out = _with_empty_boxes(seed)
    t = {k: torch.from_numpy(v) for k, v in out.items()}
    args = (t["box_corners"], t["sem_cls_prob"], t["objectness_prob"],
            torch.from_numpy(batch["point_clouds"]))
    keep, cls = parse.parse_predictions(*args, remove_empty_box=True, no_nms=no_nms)
    monkeypatch.setattr(parse, "points_in_box", _matmul_counts)
    keep_before, cls_before = parse.parse_predictions(*args, remove_empty_box=True, no_nms=no_nms)
    assert torch.equal(keep, keep_before) and torch.equal(cls, cls_before)
    assert 0 < int(keep.sum()) < keep.numel()
