"""Dataset configurations: class maps, angle codecs, box corner codecs.

A copy of `ov3det/datasets/dataset_configs.py:16-198` (SunrgbdDatasetConfig,
reference datasets/sunrgbd.py:54-165; ScannetDatasetConfig, reference
datasets/scannet.py:36-169).  Class vocabularies, angle-bin counts and the
open-vocabulary support split are kept verbatim: they define checkpoint and
metric compatibility.  The box codec takes tensors
(`ov3det_torch.geometry.boxes`) or numpy arrays (`geometry.boxes_np`).
"""
from __future__ import annotations

import numpy as np

from ov3det_torch.geometry.boxes import corners_from_upright_depth_param
from ov3det_torch.geometry.boxes_np import corners_from_upright_depth_param_np


class BaseDatasetConfig:
    num_semcls: int
    num_angle_bin: int
    max_num_obj: int = 64
    clip_embed_length: int = 640

    def angle2class(self, angle: float):
        """Continuous heading -> (bin, residual); reference sunrgbd.py:102-120."""
        num_class = self.num_angle_bin
        angle = angle % (2 * np.pi)
        angle_per_class = 2 * np.pi / float(num_class)
        shifted = (angle + angle_per_class / 2) % (2 * np.pi)
        cls = int(shifted / angle_per_class)
        residual = shifted - (cls * angle_per_class + angle_per_class / 2)
        return cls, residual

    def class2angle(self, cls, residual, to_label_format=True):
        angle_per_class = 2 * np.pi / float(self.num_angle_bin)
        angle = cls * angle_per_class + residual
        if to_label_format and angle > np.pi:
            angle -= 2 * np.pi
        return angle

    def class2angle_batch(self, cls, residual, to_label_format=True):
        angle_per_class = 2 * np.pi / float(self.num_angle_bin)
        angle = cls * angle_per_class + residual
        if to_label_format:
            angle = np.where(angle > np.pi, angle - 2 * np.pi, angle)
        return angle.astype(np.float32)

    def box_parametrization_to_corners(self, center, size, angle):
        """(tensors) upright-depth params -> camera-frame corners."""
        return corners_from_upright_depth_param(center, size, angle)

    def box_parametrization_to_corners_np(self, center, size, angle):
        """numpy twin: runs in the loader's worker processes."""
        return corners_from_upright_depth_param_np(center, size, angle)

    def my_compute_box_3d(self, center, size, heading_angle):
        """Raw GT corners in depth coords, half-size parametrization
        (reference sunrgbd.py:155-165)."""
        c, s = np.cos(-heading_angle), np.sin(-heading_angle)
        R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        l, w, h = size
        x = np.array([-l, l, l, -l, -l, l, l, -l])
        y = np.array([w, w, -w, -w, w, w, -w, -w])
        z = np.array([h, h, h, h, -h, -h, -h, -h])
        corners = np.dot(R, np.vstack([x, y, z]))
        return (corners + np.asarray(center)[:, None]).T


class SunrgbdDatasetConfig(BaseDatasetConfig):
    """reference datasets/sunrgbd.py:54-165 (verbatim vocabulary).

    num_semcls is 20 although only 17 names are enumerated: the open-vocab
    fork extends the 10 base classes with novel ids; training keeps only GT
    of `support_class` ids 10-19 (reference sunrgbd.py:100, 266-268).
    """

    def __init__(self):
        self.num_semcls = 20
        self.clip_embed_length = 640
        self.num_angle_bin = 12
        self.max_num_obj = 64
        self.type2class = {
            "bathtub": 0,
            "bed": 1,
            "bookshelf": 2,
            "box": 3,
            "chair": 4,
            "counter": 5,
            "desk": 6,
            "door": 7,
            "dresser": 8,
            "lamp": 9,
            "night_stand": 10,
            "pillow": 11,
            "sink": 12,
            "sofa": 13,
            "table": 14,
            "tv": 15,
            "toilet": 16,
        }
        self.class2type = {v: k for k, v in self.type2class.items()}
        self.type2onehotclass = dict(self.type2class)
        # open-vocabulary split: classes whose GT is kept during training
        self.support_class = np.array([10, 11, 12, 13, 14, 15, 16, 17, 18, 19])


class ScannetDatasetConfig(BaseDatasetConfig):
    """reference datasets/scannet.py:36-169 (verbatim vocabulary)."""

    def __init__(self):
        self.num_semcls = 18
        self.clip_embed_length = 640
        self.num_angle_bin = 1
        self.max_num_obj = 64
        self.type2class = {
            "cabinet": 0,
            "bed": 1,
            "chair": 2,
            "sofa": 3,
            "table": 4,
            "door": 5,
            "window": 6,
            "bookshelf": 7,
            "picture": 8,
            "counter": 9,
            "desk": 10,
            "curtain": 11,
            "refrigerator": 12,
            "shower curtain": 13,
            "toilet": 14,
            "sink": 15,
            "bathtub": 16,
            "garbagebin": 17,
        }
        self.class2type = {v: k for k, v in self.type2class.items()}
        self.nyu40ids = np.array(
            [3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33, 34, 36, 39]
        )
        self.nyu40id2class = {nid: i for i, nid in enumerate(list(self.nyu40ids))}
        # semantic segmentation vocabulary (used by the pseudo-label tools)
        self.num_class_semseg = 20
        self.type2class_semseg = {
            "wall": 0,
            "floor": 1,
            "cabinet": 2,
            "bed": 3,
            "chair": 4,
            "sofa": 5,
            "table": 6,
            "door": 7,
            "window": 8,
            "bookshelf": 9,
            "picture": 10,
            "counter": 11,
            "desk": 12,
            "curtain": 13,
            "refrigerator": 14,
            "shower curtain": 15,
            "toilet": 16,
            "sink": 17,
            "bathtub": 18,
            "garbagebin": 19,
        }
        self.class2type_semseg = {v: k for k, v in self.type2class_semseg.items()}
        self.nyu40ids_semseg = np.array(
            [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33, 34, 36, 39]
        )
        self.nyu40id2class_semseg = {
            nid: i for i, nid in enumerate(list(self.nyu40ids_semseg))
        }

    def angle2class(self, angle):
        raise ValueError("ScanNet does not have rotated bounding boxes.")

    def class2angle_batch(self, cls, residual, to_label_format=True):
        return np.zeros(np.shape(cls), np.float32)

    @staticmethod
    def rotate_aligned_boxes(input_boxes, rot_mat):
        """Rotate axis-aligned boxes, re-fitting AABBs
        (reference scannet.py:148-169)."""
        centers, lengths = input_boxes[:, 0:3], input_boxes[:, 3:6]
        new_centers = np.dot(centers, rot_mat.T)
        dx, dy = lengths[:, 0] / 2.0, lengths[:, 1] / 2.0
        new_x = np.zeros((dx.shape[0], 4))
        new_y = np.zeros((dx.shape[0], 4))
        for i, (cx, cy) in enumerate([(-1, -1), (1, -1), (1, 1), (-1, 1)]):
            crnrs = np.zeros((dx.shape[0], 3))
            crnrs[:, 0] = cx * dx
            crnrs[:, 1] = cy * dy
            crnrs = np.dot(crnrs, rot_mat.T)
            new_x[:, i] = crnrs[:, 0]
            new_y[:, i] = crnrs[:, 1]
        new_dx = 2.0 * np.max(new_x, 1)
        new_dy = 2.0 * np.max(new_y, 1)
        new_lengths = np.stack((new_dx, new_dy, lengths[:, 2]), axis=1)
        return np.concatenate([new_centers, new_lengths], axis=1)
