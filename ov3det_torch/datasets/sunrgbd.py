"""SUN RGB-D detection dataset (VoteNet-format preprocessed dumps).

A copy of `ov3det/datasets/sunrgbd.py:35-241` (reference
datasets/sunrgbd.py:168-462): loads `<scan>_pc.npz["pc"]` (N x 6) and
`<scan>_bbox.npy` (K x 8: cx,cy,cz,hx,hy,hz,angle,cls with HALF sizes),
applies the open-vocabulary support-class filter during training, augments,
and emits the padded fixed-shape training dict.  Pure numpy: it runs in the
loader's worker processes, which never touch CUDA.

With `use_image` each sample also carries what the RegionCLIP teacher reads
(`ov3det/datasets/sunrgbd.py:83-107, 175-180`): `<raw>/image/<scan>.jpg` on
a 530 x 730 uint8 canvas (decoded by `utils/jpeg.py` to PIL's values), the
image's height and width, and Rtilt and K from `<raw>/calib/<scan>.txt`.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ov3det_torch.datasets.augment import (
    RandomCuboid,
    flip_yz_plane,
    jitter_color,
    random_sampling,
    random_scale,
    rotate_z,
)
from ov3det_torch.datasets.dataset_configs import SunrgbdDatasetConfig
from ov3det_torch.utils import jpeg

MEAN_COLOR_RGB = np.array([0.5, 0.5, 0.5])
# fixed padded image canvas (reference packs images into a 1-D buffer of
# 530*730*3, sunrgbd.py:47,284-285; a 2-D zero-padded canvas batches cleanly)
MAX_IMG_H, MAX_IMG_W = 530, 730


class SunrgbdDetectionDataset:
    def __init__(
        self,
        dataset_config: SunrgbdDatasetConfig,
        split_set: str = "train",
        root_dir: Optional[str] = None,
        raw_data_dir: Optional[str] = None,
        pseudo_box_dir: Optional[str] = None,
        feature_2d_dir: Optional[str] = None,
        num_points: int = 20000,
        use_color: bool = False,
        use_image: bool = False,
        use_height: bool = False,
        augment: bool = False,
        use_random_cuboid: bool = True,
        random_cuboid_min_points: int = 30000,
        use_pbox: bool = False,
        use_2d_feature: bool = False,
        seed: int = 0,
    ):
        assert num_points <= 50000
        assert split_set in ("train", "val", "trainval")
        assert root_dir is not None, "pass data.root_dir (no hard-coded paths)"
        self.dataset_config = dataset_config
        self.data_path = root_dir + f"_{split_set}"
        self.raw_data_path = raw_data_dir
        self.pseudo_box_dir = pseudo_box_dir
        self.feature_2d_dir = feature_2d_dir
        self.scan_names = sorted(
            {os.path.basename(x)[0:6] for x in os.listdir(self.data_path)}
        )
        self.num_points = num_points
        self.augment = augment
        self.use_color = use_color
        self.use_image = use_image
        self.use_height = use_height
        self.use_random_cuboid = use_random_cuboid
        self.random_cuboid_augmentor = RandomCuboid(
            min_points=random_cuboid_min_points, aspect=0.75, min_crop=0.75, max_crop=1.0
        )
        self.max_num_obj = dataset_config.max_num_obj
        self.train = split_set == "train"
        self.use_pbox = use_pbox
        self.use_2d_feature = use_2d_feature
        self.seed = seed
        if use_image:  # build the decoder here, not in the loader's workers
            jpeg.ensure_built()

    def __len__(self):
        return len(self.scan_names)

    def _load_image_calib(self, scan_name):
        calib_file = os.path.join(self.raw_data_path, "calib", scan_name + ".txt")
        with open(calib_file) as fh:
            lines = fh.read().splitlines()
        Rtilt = np.reshape(np.array([float(x) for x in lines[0].split(" ")]), (3, 3), "F")
        K = np.reshape(np.array([float(x) for x in lines[1].split(" ")]), (3, 3), "F")
        # RGB (the teacher tower normalizes with RGB statistics)
        img = jpeg.read_jpeg(os.path.join(self.raw_data_path, "image", scan_name + ".jpg"))
        h, w = img.shape[0], img.shape[1]
        if img.ndim != 3 or h > MAX_IMG_H or w > MAX_IMG_W:
            raise ValueError(f"scan {scan_name}: image of shape {img.shape} does not fit the "
                             f"{MAX_IMG_H} x {MAX_IMG_W} x 3 canvas")
        # uint8 canvas: the teacher normalizes (and so promotes) on the device
        canvas = np.zeros((MAX_IMG_H, MAX_IMG_W, 3), np.uint8)
        canvas[:h, :w] = img
        return Rtilt, K, canvas, h, w

    def get_image(self, idx: int) -> np.ndarray:
        """Image-only path of the device image bank (datasets/image_bank.py):
        the canvas, which augmentation never touches."""
        return self._load_image_calib(self.scan_names[idx])[2]

    def __getitem__(self, idx: int) -> dict:
        rng = np.random.default_rng(
            None if self.augment else self.seed * 100003 + idx
        )
        scan_name = self.scan_names[idx]
        scan_path = os.path.join(self.data_path, scan_name)
        point_cloud = np.load(scan_path + "_pc.npz")["pc"]  # (N, 6)
        bboxes = np.load(scan_path + "_bbox.npy")  # (K, 8)

        # open-vocabulary: training keeps only support-class GT
        # (reference sunrgbd.py:266-268)
        if self.train:
            keep = np.isin(bboxes[:, -1], self.dataset_config.support_class)
            bboxes = bboxes[keep]
        if self.use_pbox:
            pseudo = np.load(
                os.path.join(self.pseudo_box_dir, scan_name) + "_bbox.npy"
            )
            bboxes = np.concatenate([bboxes, pseudo], axis=0)
        if self.use_2d_feature:
            feature_2d = np.load(
                os.path.join(self.feature_2d_dir, scan_name) + ".npy"
            )
        if self.use_image:
            calib_Rtilt, calib_K, img_canvas, img_h, img_w = self._load_image_calib(
                scan_name
            )

        if not self.use_color:
            point_cloud = point_cloud[:, 0:3]
        else:
            point_cloud = point_cloud[:, 0:6].copy()
            point_cloud[:, 3:] = point_cloud[:, 3:] - MEAN_COLOR_RGB

        if self.use_height:
            floor_height = np.percentile(point_cloud[:, 2], 0.99)
            height = point_cloud[:, 2] - floor_height
            point_cloud = np.concatenate([point_cloud, height[:, None]], 1)

        if self.augment:
            if rng.random() > 0.5:
                point_cloud, bboxes = flip_yz_plane(point_cloud, bboxes)
            rot_angle = (rng.random() * np.pi / 3) - np.pi / 6
            point_cloud, bboxes = rotate_z(point_cloud, bboxes, rot_angle)
            if self.use_color:
                rgb = point_cloud[:, 3:6] + MEAN_COLOR_RGB
                point_cloud[:, 3:6] = jitter_color(rgb, rng) - MEAN_COLOR_RGB
            point_cloud, bboxes, _ = random_scale(
                point_cloud, bboxes, rng, 0.85, 1.15, self.use_height
            )
            if self.use_random_cuboid:
                point_cloud, bboxes, _ = self.random_cuboid_augmentor(
                    point_cloud, bboxes, rng
                )

        ret = build_ret_dict(
            point_cloud,
            bboxes,
            self.dataset_config,
            self.max_num_obj,
            self.num_points,
            rng,
            idx,
        )
        if self.use_2d_feature:
            ret["feature_2d"] = feature_2d
        if self.use_image:
            ret["image"] = img_canvas
            ret["image_height"] = np.int64(img_h)
            ret["image_width"] = np.int64(img_w)
            ret["calib_Rtilt"] = calib_Rtilt.astype(np.float32)
            ret["calib_K"] = calib_K.astype(np.float32)
        return ret


def build_ret_dict(point_cloud, bboxes, dataset_config, max_num_obj, num_points, rng, idx):
    """Padded-label construction shared by SUN RGB-D (half-size oriented
    boxes) — reference datasets/sunrgbd.py:351-462."""
    K = bboxes.shape[0]
    angle_classes = np.zeros((max_num_obj,), np.int64)
    angle_residuals = np.zeros((max_num_obj,), np.float32)
    raw_sizes = np.zeros((max_num_obj, 3), np.float32)
    label_mask = np.zeros((max_num_obj,), np.float32)
    label_mask[:K] = 1
    target_bboxes = np.zeros((max_num_obj, 6), np.float32)

    for i in range(K):
        bbox = bboxes[i]
        raw_sizes[i] = bbox[3:6] * 2
        cls_id, res = dataset_config.angle2class(bbox[6])
        angle_classes[i] = cls_id
        angle_residuals[i] = res
        corners = dataset_config.my_compute_box_3d(bbox[0:3], bbox[3:6], bbox[6])
        mn, mx = corners.min(axis=0), corners.max(axis=0)
        target_bboxes[i] = np.concatenate([(mn + mx) / 2.0, mx - mn])

    point_cloud = random_sampling(point_cloud, num_points, rng)
    pc_min = point_cloud[:, :3].min(axis=0)
    pc_max = point_cloud[:, :3].max(axis=0)
    extent = pc_max - pc_min

    box_sizes_normalized = raw_sizes / extent[None, :]
    box_centers = target_bboxes[:, 0:3]
    box_centers_normalized = (box_centers - pc_min[None, :]) / extent[None, :]
    box_centers_normalized = box_centers_normalized * label_mask[:, None]

    # re-encode angles through the bin codec for VoteNet eval parity
    # (reference sunrgbd.py:421-426)
    raw_angles = dataset_config.class2angle_batch(
        angle_classes.astype(np.float32), angle_residuals
    )
    box_corners = dataset_config.box_parametrization_to_corners_np(
        box_centers[None], raw_sizes[None], raw_angles[None]
    )[0]

    semcls = np.zeros((max_num_obj,), np.int64)
    semcls[:K] = bboxes[:, -1].astype(np.int64)
    return {
        "point_clouds": point_cloud.astype(np.float32),
        "gt_box_corners": box_corners.astype(np.float32),
        "gt_box_centers": box_centers.astype(np.float32),
        "gt_box_centers_normalized": box_centers_normalized.astype(np.float32),
        "gt_box_sem_cls_label": semcls,
        "gt_box_present": label_mask,
        "scan_idx": np.int64(idx),
        "gt_box_sizes": raw_sizes,
        "gt_box_sizes_normalized": box_sizes_normalized.astype(np.float32),
        "gt_box_angles": raw_angles.astype(np.float32),
        "gt_angle_class_label": angle_classes,
        "gt_angle_residual_label": angle_residuals,
        "point_cloud_dims_min": pc_min.astype(np.float32),
        "point_cloud_dims_max": pc_max.astype(np.float32),
    }
