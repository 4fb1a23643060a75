"""Synthetic scene generator in the training-batch schema.

A numpy copy of `make_scene`, `make_batch` and `SyntheticDataset` from
`ov3det/datasets/synthetic.py:16-176`: the same draws in the same order, so
one `np.random.Generator` state gives bit-identical scenes in both packages.
`SyntheticOVDataset` (`synthetic.py:179-214`) adds the open-vocabulary
schema's 530 x 730 uint8 canvas and calibration, bit for bit.
Scenes hold a floor slab plus points concentrated inside the GT boxes; the
schema is that of the real SUN RGB-D / ScanNet loaders.

`write_scannet_tree` writes such scenes as a ScanNet detection tree (the
files `datasets/scannet.py` reads, and per-scan point labels for the
pseudo-label filter), and `write_sunrgbd_tree` as a SUN RGB-D tree with
images and calibration, for runs of the CLIs without the real datasets.
"""
from __future__ import annotations

import os
import shutil

import numpy as np

from ov3det_torch.geometry.boxes_np import corners_from_upright_depth_param_np


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


class SyntheticDataset:
    """Synthetic scenes with the real datasets' interface; scene `idx` is
    drawn from `default_rng(seed * 100003 + idx)`."""

    def __init__(self, size: int = 64, seed: int = 0, **scene_kwargs):
        self.size = size
        self.seed = seed
        self.scene_kwargs = scene_kwargs
        self.scan_names = [f"synthetic{i:04d}" for i in range(size)]

    def __len__(self):
        return self.size

    def __getitem__(self, idx: int) -> dict:
        rng = np.random.default_rng(self.seed * 100003 + idx)
        return make_scene(rng, scan_idx=idx, **self.scene_kwargs)


class SyntheticOVDataset(SyntheticDataset):
    """Synthetic scenes plus the open-vocabulary batch schema's image fields
    (reference datasets/sunrgbd.py:275-285): a fixed 530 x 730 uint8 canvas
    drawn from its own `default_rng(seed * 7919 + idx)` (so the scene's
    draws are those of `SyntheticDataset`), its height and width, and the
    calibration matrices Rtilt and K."""

    IMG_H, IMG_W = 530, 730  # the SUN RGB-D canvas (reference sunrgbd.py:47)

    _RTILT = np.array([[0.999, 0.02, -0.04], [-0.02, 0.999, 0.01], [0.04, -0.01, 0.999]],
                      np.float32)
    _K = np.array([[529.5, 0, 365.0], [0, 529.5, 265.0], [0, 0, 1]], np.float32)

    def get_image(self, idx: int) -> np.ndarray:
        """The canvas of scene `idx`, uint8 (the teacher normalises it on
        the device)."""
        rng = np.random.default_rng(self.seed * 7919 + idx)
        return rng.integers(0, 256, size=(self.IMG_H, self.IMG_W, 3), dtype=np.uint8)

    def __getitem__(self, idx: int) -> dict:
        d = super().__getitem__(idx)
        d["image"] = self.get_image(idx)
        d["image_height"] = np.int32(self.IMG_H)
        d["image_width"] = np.int32(self.IMG_W)
        d["calib_Rtilt"] = self._RTILT
        d["calib_K"] = self._K
        return d


# ScanNet's 18 detection classes as nyu40 ids (`ScannetDatasetConfig.nyu40ids`)
_NYU40IDS = np.array([3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33, 34, 36, 39])


def write_scannet_tree(root: str, num_train: int, num_val: int, num_points: int = 40000,
                       seed: int = 0) -> dict:
    """Write `num_train + num_val` `make_scene` scenes (18 classes, 1 angle
    bin; scene i from `default_rng(seed * 100003 + i)`) as a ScanNet
    detection tree under `root`:

      scannet_train_detection_data/scene{i:04d}_00_vert.npy  (N, 6) xyz, rgb 0..255
      scannet_train_detection_data/scene{i:04d}_00_bbox.npy  (K, 7) center, size, nyu40 id
      meta_data/scannetv2_train.txt, scannetv2_val.txt       the first num_train, the rest
      labels/scene{i:04d}_00.npy                             (N, 4) xyz, class 0..17 (18: none)

    The label files are what `generate_pseudo_label --label_dir` reads: each
    point carries the class of the first GT box holding it.  Returns the
    three directories and the two splits' scan names."""
    data, meta, labels = (os.path.join(root, d) for d in
                          ("scannet_train_detection_data", "meta_data", "labels"))
    for d in (data, meta, labels):
        os.makedirs(d, exist_ok=True)
    names = [f"scene{i:04d}_00" for i in range(num_train + num_val)]
    for i, name in enumerate(names):
        rng = np.random.default_rng(seed * 100003 + i)
        s = make_scene(rng, num_points=num_points, num_semcls=18, num_angle_bin=1, scan_idx=i)
        xyz = s["point_clouds"]
        k = int(s["gt_box_present"].sum())
        centers, sizes = s["gt_box_centers"][:k], s["gt_box_sizes"][:k]
        cls = s["gt_box_sem_cls_label"][:k]
        rgb = rng.integers(0, 256, size=(len(xyz), 3)).astype(np.float32)
        np.save(os.path.join(data, f"{name}_vert.npy"), np.concatenate([xyz, rgb], 1))
        np.save(os.path.join(data, f"{name}_bbox.npy"),
                np.concatenate([centers, sizes, _NYU40IDS[cls][:, None]], 1).astype(np.float32))
        point_cls = np.full(len(xyz), 18, np.int64)
        for j in range(k - 1, -1, -1):  # the first box holding a point wins
            inside = np.all(np.abs(xyz - centers[j]) <= sizes[j] / 2, axis=-1)
            point_cls[inside] = cls[j]
        np.save(os.path.join(labels, f"{name}.npy"),
                np.concatenate([xyz, point_cls[:, None].astype(np.float32)], 1))
    with open(os.path.join(meta, "scannetv2_train.txt"), "w") as fh:
        fh.write("\n".join(names[:num_train]))
    with open(os.path.join(meta, "scannetv2_val.txt"), "w") as fh:
        fh.write("\n".join(names[num_train:]))
    return {"root_dir": data, "meta_data_dir": meta, "label_dir": labels,
            "train": names[:num_train], "val": names[num_train:]}


# a SUN RGB-D-like camera: the depth frame upright, K of a 730 x 530 Kinect v2
_SUNRGBD_RTILT = np.eye(3)
_SUNRGBD_K = np.array([[529.5, 0.0, 365.0], [0.0, 529.5, 265.0], [0.0, 0.0, 1.0]])


def write_sunrgbd_tree(root: str, num_train: int, num_val: int, images: list,
                       num_points: int = 20000, seed: int = 0) -> dict:
    """Write `num_train + num_val` `make_scene` scenes (20 classes, 12
    angle bins; scene i from `default_rng(seed * 100003 + i)`) as a SUN
    RGB-D tree under `root`, in the layout `datasets/sunrgbd.py` reads:

      sunrgbd_pc_bbox_50k_v1_{train,val}/{i:06d}_pc.npz  pc (N, 6): xyz, rgb in [0, 1]
      sunrgbd_pc_bbox_50k_v1_{train,val}/{i:06d}_bbox.npy (K, 8): center, half size,
                                                           heading, class
      sunrgbd_trainval/calib/{i:06d}.txt  Rtilt, then K, each 9 numbers column-major
      sunrgbd_trainval/image/{i:06d}.jpg  a copy of images[i % len(images)]

    Returns the `--dataset_root_dir` and `--meta_data_dir` of the tree and
    the two splits' scan names."""
    data = os.path.join(root, "sunrgbd_pc_bbox_50k_v1")
    raw = os.path.join(root, "sunrgbd_trainval")
    for d in (data + "_train", data + "_val", os.path.join(raw, "calib"),
              os.path.join(raw, "image")):
        os.makedirs(d, exist_ok=True)
    names = [f"{i:06d}" for i in range(num_train + num_val)]
    calib = " ".join(f"{v:.6f}" for v in _SUNRGBD_RTILT.flatten("F")) + "\n" + \
        " ".join(f"{v:.6f}" for v in _SUNRGBD_K.flatten("F")) + "\n"
    for i, name in enumerate(names):
        rng = np.random.default_rng(seed * 100003 + i)
        s = make_scene(rng, num_points=num_points, num_semcls=20, num_angle_bin=12, scan_idx=i)
        k = int(s["gt_box_present"].sum())
        rgb = rng.uniform(0, 1, size=(num_points, 3)).astype(np.float32)
        split = data + ("_train" if i < num_train else "_val")
        np.savez(os.path.join(split, f"{name}_pc.npz"),
                 pc=np.concatenate([s["point_clouds"], rgb], 1))
        boxes = np.concatenate([s["gt_box_centers"][:k], s["gt_box_sizes"][:k] / 2,
                                s["gt_box_angles"][:k, None],
                                s["gt_box_sem_cls_label"][:k, None]], 1)
        np.save(os.path.join(split, f"{name}_bbox.npy"), boxes.astype(np.float32))
        with open(os.path.join(raw, "calib", f"{name}.txt"), "w") as fh:
            fh.write(calib)
        shutil.copyfile(images[i % len(images)], os.path.join(raw, "image", f"{name}.jpg"))
    return {"root_dir": data, "meta_data_dir": raw, "train": names[:num_train],
            "val": names[num_train:]}
