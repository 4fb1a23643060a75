"""ScanNet detection dataset (VoteNet-format preprocessed dumps).

A copy of `ov3det/datasets/scannet.py:23-181` (reference
datasets/scannet.py:172-417): loads
`<scene>_vert.npy` (N x 6 xyz+rgb) and `<scene>_bbox.npy` (K x 7
axis-aligned cx,cy,cz,dx,dy,dz,nyu40id with FULL sizes), maps nyu40 ids to
the 18-class vocabulary, augments (two flips + small z rotation with AABB
re-fitting), and emits the padded fixed-shape training dict.  Pure numpy:
it runs in the loader's worker processes, which never touch CUDA.

With `use_image` each sample also carries the scene's frames from
`frames_dir` (`datasets/image_utils.load_scene_frames`, padded to
`max_frames`): `images`, `depths`, `poses` and `frame_mask`, as
`ov3det/datasets/scannet.py:149-180` gives them.  No training step reads
them: the teacher takes a SUN RGB-D canvas (`image`), which ScanNet's batch
lacks, in JAX as here.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ov3det_torch.datasets.augment import random_sampling, rotz
from ov3det_torch.datasets.dataset_configs import ScannetDatasetConfig
from ov3det_torch.datasets.image_utils import load_scene_frames
from ov3det_torch.utils import jpeg

MEAN_COLOR_RGB = np.array([109.8, 97.2, 83.8])


class ScannetDetectionDataset:
    def __init__(
        self,
        dataset_config: ScannetDatasetConfig,
        split_set: str = "train",
        root_dir: Optional[str] = None,
        meta_data_dir: Optional[str] = None,
        pseudo_box_dir: Optional[str] = None,
        feature_2d_dir: Optional[str] = None,
        num_points: int = 40000,
        use_color: bool = False,
        use_height: bool = False,
        use_image: bool = False,
        frames_dir: Optional[str] = None,
        max_frames: int = 64,
        augment: bool = False,
        use_pbox: bool = False,
        use_2d_feature: bool = False,
        seed: int = 0,
    ):
        assert root_dir is not None, "pass data.root_dir (no hard-coded paths)"
        assert split_set in ("train", "val", "all")
        self.dataset_config = dataset_config
        self.data_path = root_dir
        self.pseudo_box_dir = pseudo_box_dir
        self.feature_2d_dir = feature_2d_dir
        all_scan_names = {
            os.path.basename(x)[0:12]
            for x in os.listdir(root_dir)
            if x.startswith("scene")
        }
        if split_set == "all":
            self.scan_names = sorted(all_scan_names)
        else:
            split_file = os.path.join(meta_data_dir, f"scannetv2_{split_set}.txt")
            with open(split_file) as f:
                names = f.read().splitlines()
            self.scan_names = [s for s in names if s in all_scan_names]
        self.num_points = num_points
        self.use_color = use_color
        self.use_height = use_height
        self.use_image = use_image
        self.frames_dir = frames_dir
        self.max_frames = max_frames
        self.augment = augment
        self.use_pbox = use_pbox
        self.use_2d_feature = use_2d_feature
        self.max_num_obj = dataset_config.max_num_obj
        self.seed = seed
        if use_image:  # build the decoder here, not in the loader's workers
            jpeg.ensure_built()

    def __len__(self):
        return len(self.scan_names)

    def __getitem__(self, idx: int) -> dict:
        rng = np.random.default_rng(
            None if self.augment else self.seed * 100003 + idx
        )
        scan_name = self.scan_names[idx]
        mesh_vertices = np.load(os.path.join(self.data_path, scan_name) + "_vert.npy")
        box_dir = self.pseudo_box_dir if self.use_pbox else self.data_path
        instance_bboxes = np.load(os.path.join(box_dir, scan_name) + "_bbox.npy")
        if self.use_2d_feature:
            pre_inds = np.load(
                os.path.join(self.data_path, scan_name) + "_inds.npy"
            )
            feature_2d = np.load(
                os.path.join(self.feature_2d_dir, scan_name) + ".npy"
            )

        if not self.use_color:
            point_cloud = mesh_vertices[:, 0:3]
        else:
            point_cloud = mesh_vertices[:, 0:6].copy()
            point_cloud[:, 3:] = (point_cloud[:, 3:] - MEAN_COLOR_RGB) / 256.0

        if self.use_height:
            floor_height = np.percentile(point_cloud[:, 2], 0.99)
            height = point_cloud[:, 2] - floor_height
            point_cloud = np.concatenate([point_cloud, height[:, None]], 1)

        point_cloud, choices = random_sampling(
            point_cloud, self.num_points, rng, return_choices=True
        )
        if self.use_2d_feature:
            feature_2d = feature_2d[pre_inds][choices]

        M = self.max_num_obj
        K = instance_bboxes.shape[0]
        target_bboxes = np.zeros((M, 6), np.float32)
        target_bboxes_mask = np.zeros((M,), np.float32)
        target_bboxes_mask[:K] = 1
        target_bboxes[:K] = instance_bboxes[:, 0:6]

        if self.augment:
            if rng.random() > 0.5:
                point_cloud[:, 0] = -point_cloud[:, 0]
                target_bboxes[:, 0] = -target_bboxes[:, 0]
            if rng.random() > 0.5:
                point_cloud[:, 1] = -point_cloud[:, 1]
                target_bboxes[:, 1] = -target_bboxes[:, 1]
            rot_angle = (rng.random() * np.pi / 18) - np.pi / 36  # -5..+5 deg
            rot_mat = rotz(rot_angle)
            point_cloud[:, 0:3] = point_cloud[:, 0:3] @ rot_mat.T
            target_bboxes = self.dataset_config.rotate_aligned_boxes(
                target_bboxes, rot_mat
            )

        raw_sizes = target_bboxes[:, 3:6].astype(np.float32)
        raw_angles = np.zeros((M,), np.float32)
        pc_min = point_cloud[:, :3].min(axis=0)
        pc_max = point_cloud[:, :3].max(axis=0)
        extent = pc_max - pc_min

        box_centers = target_bboxes[:, 0:3].astype(np.float32)
        centers_norm = (box_centers - pc_min[None]) / extent[None]
        centers_norm = centers_norm * target_bboxes_mask[:, None]
        sizes_norm = raw_sizes / extent[None]

        box_corners = self.dataset_config.box_parametrization_to_corners_np(
            box_centers[None], raw_sizes[None], raw_angles[None]
        )[0]

        semcls = np.zeros((M,), np.int64)
        semcls[:K] = [
            self.dataset_config.nyu40id2class[int(x)] for x in instance_bboxes[:K, -1]
        ]

        if self.use_image:
            images, depths, poses, frame_mask = load_scene_frames(
                self.frames_dir, scan_name, max_frames=self.max_frames
            )

        ret = {
            "point_clouds": point_cloud.astype(np.float32),
            "gt_box_corners": box_corners.astype(np.float32),
            "gt_box_centers": box_centers,
            "gt_box_centers_normalized": centers_norm.astype(np.float32),
            "gt_angle_class_label": np.zeros((M,), np.int64),
            "gt_angle_residual_label": np.zeros((M,), np.float32),
            "gt_box_sem_cls_label": semcls,
            "gt_box_present": target_bboxes_mask,
            "scan_idx": np.int64(idx),
            "gt_box_sizes": raw_sizes,
            "gt_box_sizes_normalized": sizes_norm.astype(np.float32),
            "gt_box_angles": raw_angles,
            "point_cloud_dims_min": pc_min.astype(np.float32),
            "point_cloud_dims_max": pc_max.astype(np.float32),
        }
        if self.use_2d_feature:
            ret["feature_2d"] = feature_2d
        if self.use_image:
            # multi-frame views (reference scannet.py:276-285, :390-393),
            # padded to a fixed frame count so batches stay fixed-shape
            ret["images"] = images.astype(np.float32)
            ret["depths"] = depths.astype(np.float32)
            ret["poses"] = poses.astype(np.float32)
            ret["frame_mask"] = frame_mask
        return ret
