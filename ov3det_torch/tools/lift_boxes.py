"""Offline 2D->3D box lifting: RegionCLIP 2D detections -> 3D pseudo boxes.

Counterpart of reference 3DOVDet_tools/{scannet,sunrgbd}/lift_boxes.py with
configurable paths instead of hard-coded cluster constants:

  ScanNet (multi-view): per frame, build a view frustum for each 2D box
  from the depth intrinsics + camera pose; keep scene points inside the
  frustum whose (LSeg/GT) semantic label matches the box class; the AABB of
  the survivors is the lifted 3D box.  Per scene: class-wise NMS @0.7,
  optional snap to GSS geometric proposals (IoU >= 0.3 with score transfer)
  followed by volume-scored NMS.

  SUN RGB-D (single view): pixels inside the 2D box with matching label are
  back-projected through depth + calibration to upright-depth coords; AABB
  of the survivors; same NMS / GSS flow.

Output rows: [cx, cy, cz, dx, dy, dz, label, score] per box
(the reference swaps score/label columns at the end, lift_boxes.py:172-173).

A copy of `ov3det/tools/lift_boxes.py` (numpy only; the port never imports
the JAX package).  It reads the depth and label PNGs with
`ov3det_torch.utils.png.read_png` where the JAX package uses PIL, with the
same values.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from ov3det_torch.tools.box3d_np import box_3d_iou, cs2vv, gss_nms, vv2cs
from ov3det_torch.tools.projection_np import (
    ProjectionHelper,
    SunrgbdCalibrationNp,
    get_edge_mask_2d,
)
from ov3det_torch.utils.png import read_png


@dataclass
class LiftConfig:
    nms_thresh: float = 0.7
    size_nms_thresh: float = 0.0
    use_gss: bool = True
    match_thresh: float = 0.3
    depth_min: float = 0.1
    depth_max: float = 10.0
    image_dims: tuple = (240, 320)
    view: str = "multi"


def _finalize(boxes: np.ndarray, cfg: LiftConfig, gss_path: Optional[str]) -> np.ndarray:
    """Shared per-scene tail: NMS -> GSS snap -> size-NMS -> cs layout."""
    if boxes.shape[0] == 0:
        return np.zeros((0, 8))
    boxes = gss_nms(boxes, cfg.nms_thresh, class_wise=True)
    if cfg.use_gss and gss_path is not None and os.path.isfile(gss_path):
        box_pool = cs2vv(np.load(gss_path))
        labels = -100 * np.ones(box_pool.shape[0])
        tmp_score = np.zeros(box_pool.shape[0])
        for box in boxes:
            iou = box_3d_iou(box, box_pool)
            if iou.size == 0 or iou.max() < cfg.match_thresh:
                continue
            index = int(np.argmax(iou))
            if box[-2] > tmp_score[index]:
                labels[index] = box[-1]
                tmp_score[index] = box[-2]
        scale = box_pool[:, 3:6] - box_pool[:, 0:3]
        box_pool = np.concatenate(
            [
                box_pool[:, :6],
                np.stack(
                    [
                        tmp_score,
                        labels,
                        np.prod(scale, -1),
                        2 * np.sum(scale * np.roll(scale, 1, -1), -1),
                    ],
                    1,
                ),
            ],
            -1,
        )
        boxes = box_pool[labels != -100]
        if boxes.shape[0] == 0:
            return np.zeros((0, 8))
        boxes = gss_nms(
            boxes, cfg.size_nms_thresh, use_size_score=True, class_wise=True,
            size_typ="Volume",
        )
    boxes = vv2cs(boxes)
    boxes[:, [6, 7]] = boxes[:, [7, 6]]  # -> [.., label, score]
    return boxes[:, :8]


def lift_scene_scannet(
    scan_name: str,
    *,
    detection_data_dir: str,
    frames_dir: str,
    label_path_fmt: str,
    boxes2d_dir: str,
    out_dir: str,
    scans_meta_fmt: Optional[str] = None,
    gss_path_fmt: Optional[str] = None,
    cfg: LiftConfig = LiftConfig(),
    pseudo_labels: bool = True,
    overwrite: bool = True,
) -> int:
    """Lift one ScanNet scene. Returns the number of output boxes."""
    out_fn = os.path.join(out_dir, scan_name + "_bbox.npy")
    if not overwrite and os.path.isfile(out_fn):
        return int(np.load(out_fn).shape[0])
    projector = ProjectionHelper(cfg.depth_min, cfg.depth_max, cfg.image_dims)

    frame_dir = os.path.join(frames_dir, scan_name, "color")
    frame_list = sorted(x.split(".")[0] for x in os.listdir(frame_dir))
    point_cloud = np.load(os.path.join(detection_data_dir, scan_name) + "_vert.npy")[:, :3]
    semantic = np.load(label_path_fmt.format(scan_name), allow_pickle=True)
    if pseudo_labels:
        point_cloud = semantic[:, :3]
        semantic = semantic[:, 3]

    intrinsic = np.loadtxt(os.path.join(frames_dir, scan_name, "intrinsic_depth.txt"))
    if scans_meta_fmt is not None:
        axis_align = _read_alignment(scans_meta_fmt.format(scan_name, scan_name))
    else:
        axis_align = np.eye(4)
    orig_pc = projector.project_alignment(point_cloud, np.linalg.inv(axis_align))

    def load_depth(fid):
        d = read_png(os.path.join(frames_dir, scan_name, "depth", f"{fid}.png"))
        return d.astype(np.float32) / 1000.0

    sem = projector.project_label(semantic, pseudo_labels)
    intrinsic = projector.resize_intrinsic(intrinsic)
    all_boxes = []
    for fid in frame_list:
        boxes2d = np.load(os.path.join(boxes2d_dir, scan_name, "color", f"{fid}.npy"))
        boxes2d = projector.get_edge_mask(boxes2d)
        if boxes2d.shape[0] == 0:
            continue
        pose = np.loadtxt(os.path.join(frames_dir, scan_name, "pose", f"{fid}.txt"))
        lifted = projector.compute_frustum_box(
            orig_pc, load_depth(fid), pose, boxes2d, sem, axis_align, intrinsic,
            view=cfg.view,
        )
        if lifted.shape[0]:
            all_boxes.append(lifted)
    boxes = np.concatenate(all_boxes, 0) if all_boxes else np.zeros((0, 8))
    gss_path = gss_path_fmt.format(scan_name) if gss_path_fmt else None
    boxes = _finalize(boxes, cfg, gss_path)
    os.makedirs(out_dir, exist_ok=True)
    np.save(out_fn, boxes)
    return boxes.shape[0]


def lift_scene_sunrgbd(
    scan_name: str,
    *,
    calib_path_fmt: str,
    depth_path_fmt: str,
    label_path_fmt: str,
    boxes2d_dir: str,
    out_dir: str,
    gss_path_fmt: Optional[str] = None,
    cfg: LiftConfig = LiftConfig(use_gss=True),
    use_gt_labels: bool = False,
    overwrite: bool = True,
) -> int:
    """Lift one SUN RGB-D frame (single-view back-projection)."""
    out_fn = os.path.join(out_dir, scan_name + "_bbox.npy")
    if not overwrite and os.path.isfile(out_fn):
        return int(np.load(out_fn).shape[0])

    if use_gt_labels:
        semantic = read_png(label_path_fmt.format(scan_name))
    else:
        semantic = np.load(label_path_fmt.format(scan_name)) + 1
    calib = SunrgbdCalibrationNp(calib_path_fmt.format(scan_name))
    depth = read_png(depth_path_fmt.format(scan_name)).astype(np.float64)
    depth = depth / 1000.0

    boxes2d = np.load(os.path.join(boxes2d_dir, scan_name + ".npy"))
    boxes2d = get_edge_mask_2d(boxes2d, semantic.shape)

    sem = SunrgbdCalibrationNp.project_label(semantic)
    v, u = np.indices(sem.shape)
    lifted = []
    for box in boxes2d:
        x, y, w, h = box[:4]
        label = int(box[-1])
        mask = (u >= x) & (u <= x + w) & (v >= y) & (v <= y + h) & (sem == label)
        if mask.sum() > 0:
            uvd = np.stack([u[mask], v[mask], depth[mask]], -1)
            sub = calib.project_image_to_upright_depth(uvd)
            lifted.append(np.concatenate([sub.min(0), sub.max(0), box[-2:]], -1))
    boxes = np.stack(lifted, 0) if lifted else np.zeros((0, 8))
    gss_path = gss_path_fmt.format(scan_name) if gss_path_fmt else None
    boxes = _finalize(boxes, cfg, gss_path)
    os.makedirs(out_dir, exist_ok=True)
    np.save(out_fn, boxes)
    return boxes.shape[0]


def _read_alignment(meta_path: str) -> np.ndarray:
    """Parse axisAlignment from a ScanNet scene meta txt."""
    for line in open(meta_path).read().splitlines():
        if line.startswith("axisAlignment"):
            vals = [float(x) for x in line.split("=")[1].strip().split(" ")]
            return np.array(vals).reshape(4, 4)
    return np.eye(4)


def run_pool(fn, scene_list: Sequence[str], **kw):
    """`fn(scene, **kw)` for each scene in turn, the boxes lifted of each
    (reference lift_boxes.py:178-187 with JAX's `processes=0`)."""
    return [fn(scene, **kw) for scene in scene_list]
