"""Host-side numpy augmentations for point-cloud detection.

A copy of `ov3det/datasets/augment.py:13-121`: the augmentation block of the
reference datasets (reference datasets/sunrgbd.py:301-349,
scannet.py:339-357) and the RandomCuboid crop (reference
utils/random_cuboid.py).  Each is a pure function of its
`np.random.Generator`, so one generator state gives the same result in both
packages.  They run in the loader's worker processes.
"""
from __future__ import annotations

import numpy as np


def rotz(t: float) -> np.ndarray:
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], dtype=np.float64)


def random_sampling(pc: np.ndarray, num_sample: int, rng: np.random.Generator,
                    return_choices: bool = False):
    """Uniform random subsample to a fixed count (reference utils/pc_util.py:24-32)."""
    replace = pc.shape[0] < num_sample
    choices = rng.choice(pc.shape[0], num_sample, replace=replace)
    if return_choices:
        return pc[choices], choices
    return pc[choices]


def flip_yz_plane(point_cloud: np.ndarray, bboxes: np.ndarray):
    """Mirror along the YZ plane (reference sunrgbd.py:303-307)."""
    point_cloud[:, 0] = -point_cloud[:, 0]
    bboxes[:, 0] = -bboxes[:, 0]
    bboxes[:, 6] = np.pi - bboxes[:, 6]
    return point_cloud, bboxes


def rotate_z(point_cloud: np.ndarray, bboxes: np.ndarray, rot_angle: float):
    """Rotate scene + oriented boxes about +Z (reference sunrgbd.py:309-315)."""
    rot_mat = rotz(rot_angle)
    point_cloud[:, 0:3] = point_cloud[:, 0:3] @ rot_mat.T
    bboxes[:, 0:3] = bboxes[:, 0:3] @ rot_mat.T
    bboxes[:, 6] -= rot_angle
    return point_cloud, bboxes


def jitter_color(rgb: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Brightness/shift/jitter + 30% color dropout (reference sunrgbd.py:317-334).
    rgb in [0,1] (mean NOT subtracted)."""
    rgb = rgb * (1 + 0.4 * rng.random(3) - 0.2)
    rgb = rgb + (0.1 * rng.random(3) - 0.05)
    rgb = rgb + np.expand_dims(0.05 * rng.random(rgb.shape[0]) - 0.025, -1)
    rgb = np.clip(rgb, 0, 1)
    rgb = rgb * np.expand_dims(rng.random(rgb.shape[0]) > 0.3, -1)
    return rgb


def random_scale(point_cloud: np.ndarray, bboxes: np.ndarray, rng: np.random.Generator,
                 lo: float = 0.85, hi: float = 1.15, scale_height_feature: bool = False):
    """Global uniform scale (reference sunrgbd.py:336-344)."""
    s = rng.random() * (hi - lo) + lo
    point_cloud[:, 0:3] *= s
    bboxes[:, 0:3] *= s
    bboxes[:, 3:6] *= s
    if scale_height_feature:
        point_cloud[:, -1] *= s
    return point_cloud, bboxes, s


def check_aspect(crop_range: np.ndarray, aspect_min: float) -> bool:
    """reference utils/random_cuboid.py:5-13."""
    xy = np.min(crop_range[:2]) / np.max(crop_range[:2])
    xz = np.min(crop_range[[0, 2]]) / np.max(crop_range[[0, 2]])
    yz = np.min(crop_range[1:]) / np.max(crop_range[1:])
    return (xy >= aspect_min) or (xz >= aspect_min) or (yz >= aspect_min)


class RandomCuboid:
    """Crop a random cuboid containing >= min_points and >= 1 box center.

    reference utils/random_cuboid.py:16-98 (center box-filter policy).
    """

    def __init__(self, min_points: int, aspect: float = 0.8, min_crop: float = 0.5,
                 max_crop: float = 1.0):
        self.min_points = min_points
        self.aspect = aspect
        self.min_crop = min_crop
        self.max_crop = max_crop

    def __call__(self, point_cloud: np.ndarray, target_boxes: np.ndarray,
                 rng: np.random.Generator, per_point_labels=None):
        range_xyz = np.max(point_cloud[:, 0:3], axis=0) - np.min(
            point_cloud[:, 0:3], axis=0
        )
        for _ in range(100):
            crop_range = self.min_crop + rng.random(3) * (self.max_crop - self.min_crop)
            if not check_aspect(crop_range, self.aspect):
                continue
            center = point_cloud[rng.choice(len(point_cloud)), 0:3]
            new_range = range_xyz * crop_range / 2.0
            max_xyz, min_xyz = center + new_range, center - new_range
            keep = np.all(point_cloud[:, 0:3] <= max_xyz, axis=1) & np.all(
                point_cloud[:, 0:3] >= min_xyz, axis=1
            )
            if keep.sum() < self.min_points:
                continue
            new_pc = point_cloud[keep]
            new_boxes = target_boxes
            if target_boxes.sum() > 0:
                centers = target_boxes[:, 0:3]
                lo = np.min(new_pc[:, 0:3], axis=0)
                hi = np.max(new_pc[:, 0:3], axis=0)
                keep_boxes = np.all(centers >= lo, axis=1) & np.all(
                    centers <= hi, axis=1
                )
                if keep_boxes.sum() == 0:
                    continue
                new_boxes = target_boxes[keep_boxes]
            if per_point_labels is not None:
                per_point_labels = [x[keep] for x in per_point_labels]
            return new_pc, new_boxes, per_point_labels
        return point_cloud, target_boxes, per_point_labels
