"""The traffic's scenes: a frozen copy of the port's synthetic generator.

`make_scene` and `make_batch` are `ov3det_torch/datasets/synthetic.py`'s
(with the box codec of `geometry/boxes_np.py`): the same draws in the same
order, so one seed gives the same scenes whatever the program later does
to its own copy.  `canvas` and `CALIB` are the open-vocabulary schema's
530 x 730 uint8 canvas and calibration (`SyntheticOVDataset`).
"""
from __future__ import annotations

import numpy as np

_SIGNS_X = np.array([1, 1, -1, -1, 1, 1, -1, -1], np.float32)
_SIGNS_Y = np.array([1, 1, 1, 1, -1, -1, -1, -1], np.float32)
_SIGNS_Z = np.array([1, -1, -1, 1, 1, -1, -1, 1], np.float32)


def flip_axis_to_camera_np(xyz: np.ndarray) -> np.ndarray:
    """Depth (X right, Y fwd, Z up) -> camera (X right, Y down, Z fwd)."""
    out = xyz[..., [0, 2, 1]].copy()
    out[..., 1] *= -1
    return out


def roty_batch_np(t: np.ndarray) -> np.ndarray:
    c, s = np.cos(t), np.sin(t)
    zeros = np.zeros_like(t)
    ones = np.ones_like(t)
    rows = np.stack([c, zeros, s, zeros, ones, zeros, -s, zeros, c], axis=-1)
    return rows.reshape(t.shape + (3, 3)).astype(np.float32)


def box_corners_from_param_np(box_size, angle, center) -> np.ndarray:
    """Camera-frame (l, w, h) + heading + center -> (..., 8, 3) corners."""
    half = box_size.astype(np.float32) * 0.5
    sx = half[..., 0:1] * _SIGNS_X
    sy = half[..., 2:3] * _SIGNS_Y
    sz = half[..., 1:2] * _SIGNS_Z
    local = np.stack([sx, sy, sz], axis=-1)  # (..., 8, 3)
    R = roty_batch_np(np.asarray(angle, np.float32))
    rotated = np.einsum("...kj,...ij->...ki", local, R)
    return (rotated + np.asarray(center, np.float32)[..., None, :]).astype(np.float32)


def corners_from_upright_depth_param_np(center_depth, size, angle) -> np.ndarray:
    """Upright-depth params -> camera-frame corners."""
    return box_corners_from_param_np(
        np.asarray(size), np.asarray(angle),
        flip_axis_to_camera_np(np.asarray(center_depth)),
    )


def _angle_to_bin_np(angle: np.ndarray, num_bins: int):
    two_pi = 2 * np.pi
    per = two_pi / num_bins
    a = np.mod(angle, two_pi)
    shifted = np.mod(a + per / 2, two_pi)
    cls = np.floor(shifted / per).astype(np.int64)
    residual = shifted - (cls * per + per / 2)
    return cls, residual.astype(np.float32)


def _bin_to_angle_np(cls, residual, num_bins):
    per = 2 * np.pi / num_bins
    angle = cls * per + residual
    return np.where(angle > np.pi, angle - 2 * np.pi, angle).astype(np.float32)


def _randf(rng: np.random.Generator, lo, hi, size):
    """Uniform float32 in [lo, hi), drawn natively in f32."""
    u = rng.random(size=size, dtype=np.float32)
    return lo + (hi - lo) * u


def make_scene(
    rng: np.random.Generator,
    num_points: int = 2048,
    max_num_obj: int = 64,
    num_semcls: int = 18,
    num_angle_bin: int = 1,
    num_boxes: int | None = None,
    use_color: bool = False,
    scan_idx: int = 0,
) -> dict:
    K = int(num_boxes) if num_boxes is not None else int(rng.integers(1, 9))
    centers = _randf(rng, -2.5, 2.5, (K, 3))
    centers[:, 2] = _randf(rng, 0.2, 1.5, K)
    # classes are LEARNABLE from geometry: class k has a characteristic size
    # (so the classifier head can be trained on synthetic data end-to-end)
    labels = rng.integers(0, num_semcls, size=K).astype(np.int64)
    base = 0.3 + 1.3 * (labels.astype(np.float32) + 0.5) / num_semcls
    sizes = base[:, None] * _randf(rng, 0.85, 1.15, (K, 3))
    if num_angle_bin > 1:
        raw = _randf(rng, 0, 2 * np.pi, K)
        acls, ares = _angle_to_bin_np(raw, num_angle_bin)
        angles = _bin_to_angle_np(acls, ares, num_angle_bin)
    else:
        angles = np.zeros(K, np.float32)
        acls = np.zeros(K, np.int64)
        ares = np.zeros(K, np.float32)

    # points: 70% inside boxes (uniform in the unrotated box then rotated),
    # 30% floor/background.  Point i belongs to box i % K, so reshaping the
    # draw to (m, K, 3) makes column k exactly box k: the per-box
    # scale/rotate/shift applies with no per-point gathers
    n_obj = int(num_points * 0.7)
    m = -(-n_obj // K)  # ceil: pad to whole K-point rows, trim after
    u = _randf(rng, -0.5, 0.5, (m * K, 3)).reshape(m, K, 3)
    c, s = np.cos(-angles), np.sin(-angles)  # (K,)
    zeros, ones = np.zeros_like(c), np.ones_like(c)
    rot = np.stack(
        [c, -s, zeros, s, c, zeros, zeros, zeros, ones], axis=-1
    ).reshape(K, 3, 3)
    local = (u * sizes[None]).transpose(1, 0, 2)  # (K, m, 3)
    objK = np.matmul(local, rot.transpose(0, 2, 1))  # x @ R^T == R @ x rows
    obj = (objK + centers[:, None, :]).transpose(1, 0, 2)
    obj = obj.reshape(m * K, 3)[:n_obj]
    n_bg = num_points - n_obj
    bg = _randf(rng, -3.5, 3.5, (n_bg, 3))
    bg[:, 2] = _randf(rng, 0.0, 0.05, n_bg)
    point_cloud = np.concatenate([obj, bg], axis=0)
    # extents before the shuffle (permutation-invariant), reduced along the
    # contiguous axis of a transposed copy
    pc_t = np.ascontiguousarray(point_cloud.T)
    pc_min = pc_t.min(axis=1)
    pc_max = pc_t.max(axis=1)
    # mix object and background points so point order carries no signal.
    # Every consumer is order-insensitive (FPS/ball-query select by
    # geometry), so mixing, not randomness, is what matters: sizes that
    # split 70/30 in whole blocks of 10 take a deterministic 7-obj/3-bg
    # block interleave, other sizes a random permutation.
    if num_points % 10 == 0 and n_obj == (num_points // 10) * 7:
        blocks = num_points // 10
        mixed = np.empty((num_points, 3), np.float32)
        m3 = mixed.reshape(blocks, 10, 3)
        m3[:, :7] = point_cloud[:n_obj].reshape(blocks, 7, 3)
        m3[:, 7:] = point_cloud[n_obj:].reshape(blocks, 3, 3)
        point_cloud = mixed
    else:
        point_cloud = point_cloud[rng.permutation(point_cloud.shape[0])]
    if use_color:
        color = _randf(rng, -0.5, 0.5, (num_points, 3))
        point_cloud = np.concatenate([point_cloud, color], axis=1)

    extent = pc_max - pc_min

    def pad(arr, shape, dtype):
        out = np.zeros(shape, dtype)
        out[: arr.shape[0]] = arr
        return out

    centers_norm = (centers - pc_min) / extent
    corners = corners_from_upright_depth_param_np(
        centers[None], sizes[None], angles[None]
    )[0].astype(np.float32)

    present = np.zeros(max_num_obj, np.float32)
    present[:K] = 1.0
    return {
        "point_clouds": np.ascontiguousarray(point_cloud, np.float32),
        "gt_box_corners": pad(corners, (max_num_obj, 8, 3), np.float32),
        "gt_box_centers": pad(centers, (max_num_obj, 3), np.float32),
        "gt_box_centers_normalized": pad(
            centers_norm * present[:K, None], (max_num_obj, 3), np.float32
        ),
        "gt_box_sem_cls_label": pad(labels, (max_num_obj,), np.int64),
        "gt_box_present": present,
        "scan_idx": np.int64(scan_idx),
        "gt_box_sizes": pad(sizes, (max_num_obj, 3), np.float32),
        "gt_box_sizes_normalized": pad(sizes / extent, (max_num_obj, 3), np.float32),
        "gt_box_angles": pad(angles, (max_num_obj,), np.float32),
        "gt_angle_class_label": pad(acls, (max_num_obj,), np.int64),
        "gt_angle_residual_label": pad(ares, (max_num_obj,), np.float32),
        "point_cloud_dims_min": pc_min.astype(np.float32),
        "point_cloud_dims_max": pc_max.astype(np.float32),
    }


def make_batch(
    rng: np.random.Generator,
    batch_size: int = 2,
    **scene_kwargs,
) -> dict:
    scenes = [make_scene(rng, scan_idx=i, **scene_kwargs) for i in range(batch_size)]
    return {k: np.stack([s[k] for s in scenes]) for k in scenes[0]}


IMG_H, IMG_W = 530, 730  # the SUN RGB-D canvas
RTILT = np.array([[0.999, 0.02, -0.04], [-0.02, 0.999, 0.01], [0.04, -0.01, 0.999]], np.float32)
K_CAM = np.array([[529.5, 0, 365.0], [0, 529.5, 265.0], [0, 0, 1]], np.float32)


def with_images(batch: dict, rng: np.random.Generator) -> dict:
    """`batch` with the OV schema's fields: a uint8 canvas a scene drawn
    from `rng`, its height and width, and the calibration matrices."""
    B = batch["point_clouds"].shape[0]
    return dict(batch,
                image=rng.integers(0, 256, size=(B, IMG_H, IMG_W, 3), dtype=np.uint8),
                image_height=np.full(B, IMG_H, np.int32), image_width=np.full(B, IMG_W, np.int32),
                calib_Rtilt=np.broadcast_to(RTILT, (B, 3, 3)).copy(),
                calib_K=np.broadcast_to(K_CAM, (B, 3, 3)).copy())
