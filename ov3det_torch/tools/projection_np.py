"""Host-side projection helpers for the offline pseudo-label pipeline.

A copy of `ov3det/tools/projection_np.py` (numpy only; the port never
imports the JAX package).

Counterpart of reference 3DOVDet_tools/utils/projection.py (the numpy
ProjectionHelper used by the lifting scripts) and the SUN RGB-D calibration
file loader (reference 3DOVDet_tools/sunrgbd path + utils/image_util.py):
view-frustum construction from a 2D box + depth intrinsics, point-in-
frustum tests, axis-alignment transforms, 2D->3D back-projection, and the
3D-point <-> pixel correspondence used for 2D-feature transfer.
"""
from __future__ import annotations

import numpy as np

IGNORE_LABEL = -100
NYU40IDS = np.array([3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33, 34, 36, 39])
NYU40ID2CLASS = {nid: i for i, nid in enumerate(list(NYU40IDS))}


class ProjectionHelper:
    """ScanNet frustum lifting (reference 3DOVDet_tools/utils/projection.py)."""

    def __init__(self, depth_min: float, depth_max: float, image_dims):
        self.depth_min = depth_min
        self.depth_max = depth_max
        self.image_dims = tuple(image_dims)  # (H, W)
        depth_size = (640, 480)  # intrinsics refer to 640x480 depth maps
        self.resize_scale = (depth_size[0] / image_dims[1], depth_size[1] / image_dims[0])

    @staticmethod
    def project_label(semantic_labels: np.ndarray, pseudo: bool) -> np.ndarray:
        if not pseudo:
            out = np.full_like(semantic_labels, IGNORE_LABEL)
            for c in NYU40IDS:
                out[semantic_labels == c] = NYU40ID2CLASS[c]
            return out
        out = semantic_labels.copy()
        out[semantic_labels >= 18] = IGNORE_LABEL
        return out

    @staticmethod
    def project_alignment(point_cloud: np.ndarray, axis_align_matrix: np.ndarray):
        pts = np.ones((point_cloud.shape[0], 4))
        pts[:, :3] = point_cloud[:, :3]
        pts = pts @ axis_align_matrix.T
        out = point_cloud.copy()
        out[:, :3] = pts[:, :3]
        return out

    def get_edge_mask(self, box: np.ndarray) -> np.ndarray:
        """Drop 2D boxes that touch the image border (likely truncated)."""
        if box.shape[0] == 0:
            return box
        keep = (
            (box[:, 0] != 0)
            & (box[:, 1] != 0)
            & (box[:, 0] + box[:, 2] != self.image_dims[1])
            & (box[:, 1] + box[:, 3] != self.image_dims[0])
        )
        return box[keep]

    @staticmethod
    def depth2xyz(u, v, depth, intrinsic):
        uv1 = np.stack([u, v, np.ones_like(u)], axis=1).astype(np.float64)
        return (np.linalg.inv(intrinsic[:3, :3]) @ uv1.T * depth).T

    def resize_intrinsic(self, intrinsic: np.ndarray) -> np.ndarray:
        out = intrinsic.copy()
        out[0] /= self.resize_scale[0]
        out[1] /= self.resize_scale[1]
        return out

    def compute_frustum_corners(self, camera_to_world, box, intrinsic):
        """2D box (XYWH) + depth range -> 8 world-space frustum corners."""
        x, y, w, h = box[:4]
        u = np.array([x, x + w, x + w, x, x, x + w, x + w, x], np.float64)
        v = np.array([y, y, y + h, y + h, y, y, y + h, y + h], np.float64)
        d = np.repeat(np.array([self.depth_min, self.depth_max]), 4)
        corners = np.ones((8, 4))
        corners[:, :3] = self.depth2xyz(u, v, d, intrinsic)
        return (camera_to_world @ corners[:, :, None])  # (8, 4, 1)

    @staticmethod
    def compute_frustum_normals(corner_coords: np.ndarray) -> np.ndarray:
        """Inward normals of the 6 frustum planes; normalized like the
        reference (divided by squared length)."""
        cc = corner_coords[:, :3, 0]
        pairs = [
            (3, 0, 1, 0),  # front
            (2, 1, 5, 1),  # right
            (3, 2, 6, 2),  # roof
            (0, 3, 7, 3),  # left
            (1, 0, 4, 0),  # bottom
            (6, 5, 4, 5),  # back
        ]
        normals = np.zeros((6, 3))
        for i, (a, o1, b, o2) in enumerate(pairs):
            normals[i] = np.cross(cc[a] - cc[o1], cc[b] - cc[o2])
        normals /= np.sum(normals**2, axis=-1, keepdims=True)
        return normals

    @staticmethod
    def points_in_frustum(corner_coords, normals, pts, return_mask=True):
        p1 = pts - corner_coords[2, :3, 0]
        p2 = pts - corner_coords[4, :3, 0]
        p1 = p1 / np.sum(p1**2, -1, keepdims=True)
        p2 = p2 / np.sum(p2**2, -1, keepdims=True)
        mask = np.ones(pts.shape[0], bool)
        for k in range(6):
            ref = p1 if k < 3 else p2
            mask &= (ref @ normals[k]) < 0
        return mask if return_mask else mask.sum()

    def compute_frustum_box(
        self, points, depth, camera_to_world, boxes, labels, axis_align_matrix,
        intrinsic, view: str = "multi",
    ) -> np.ndarray:
        """Lift each 2D box to the AABB of the scene points inside its view
        frustum whose semantic label matches the box class.

        Returns (numBox, 8): [min(3), max(3), score, label].
        """
        boxes_3d = []
        for box in boxes:
            box_label = int(box[-1])
            if view == "multi":
                cc = self.compute_frustum_corners(camera_to_world, box, intrinsic)
                normals = self.compute_frustum_normals(cc)
                in_frustum = self.points_in_frustum(cc, normals, points)
                mask = in_frustum & (labels == box_label)
                if mask.sum() == 0:
                    continue
                sub = points[mask]
            else:  # single view: back-project the box's labeled depth pixels
                mask = labels == box_label
                if mask.sum() == 0:
                    continue
                v, u = np.indices(self.image_dims)
                sub = self.depth2xyz(u[mask], v[mask], depth[mask], intrinsic)
                sub = sub @ camera_to_world[:3, :3].T + camera_to_world[:3, 3]
            sub = self.project_alignment(sub, axis_align_matrix)
            boxes_3d.append(
                np.concatenate([sub.min(0), sub.max(0), box[-2:]], -1)
            )
        if not boxes_3d:
            return np.zeros((0, 8))
        return np.stack(boxes_3d, 0)

    def compute_projection(self, points, depth, camera_to_world, intrinsic,
                           accuracy: float = 0.05):
        """3D-point -> pixel correspondences for 2D-feature transfer
        (reference utils/projection.py:191-256 semantics, numpy).

        Returns (indices_3d, indices_2d) each (N+1,) with the live count in
        slot 0, or None if no correspondence survives.
        """
        N = points.shape[0]
        world_to_camera = np.linalg.inv(camera_to_world)
        hom = np.concatenate([points, np.ones((N, 1))], 1)
        cam = (world_to_camera @ hom.T)[:3]
        u = cam[0] * intrinsic[0, 0] / np.clip(cam[2], 1e-6, None) + intrinsic[0, 2]
        v = cam[1] * intrinsic[1, 1] / np.clip(cam[2], 1e-6, None) + intrinsic[1, 2]
        ui = np.round(u).astype(np.int64)
        vi = np.round(v).astype(np.int64)
        H, W = self.image_dims
        valid = (ui >= 0) & (vi >= 0) & (ui < W) & (vi < H) & (cam[2] > 0)
        lin = np.clip(vi, 0, H - 1) * W + np.clip(ui, 0, W - 1)
        dvals = depth.reshape(-1)[lin]
        good = (
            valid
            & (dvals >= self.depth_min)
            & (dvals <= self.depth_max)
            & (np.abs(dvals - cam[2]) <= accuracy)
        )
        idx3 = np.where(good)[0]
        if idx3.size == 0:
            return None
        out3 = np.zeros(N + 1, np.int64)
        out2 = np.zeros(N + 1, np.int64)
        out3[0] = out2[0] = idx3.size
        out3[1 : 1 + idx3.size] = idx3
        out2[1 : 1 + idx3.size] = lin[idx3]
        return out3, out2

    @staticmethod
    def backproject_features(features, indices_3d, indices_2d, num_points):
        """Scatter per-pixel features onto points (reference Projection fn)."""
        C = 1 if features.ndim == 2 else features.shape[0]
        out = np.zeros((C, num_points), features.dtype)
        n = indices_3d[0]
        if n > 0:
            flat = features.reshape(C, -1)
            out[:, indices_3d[1 : 1 + n]] = flat[:, indices_2d[1 : 1 + n]]
        return out


class SunrgbdCalibrationNp:
    """Calibration loaded from a SUN RGB-D calib txt (numpy, tools path)."""

    def __init__(self, calib_path: str):
        lines = open(calib_path).read().splitlines()
        self.Rtilt = np.reshape(
            np.array([float(x) for x in lines[0].split(" ")]), (3, 3), "F"
        )
        self.K = np.reshape(np.array([float(x) for x in lines[1].split(" ")]), (3, 3), "F")

    def project_image_to_upright_depth(self, uv_depth: np.ndarray) -> np.ndarray:
        """[u, v, depth] pixels -> upright-depth 3D points."""
        f_u, f_v = self.K[0, 0], self.K[1, 1]
        c_u, c_v = self.K[0, 2], self.K[1, 2]
        x = (uv_depth[:, 0] - c_u) * uv_depth[:, 2] / f_u
        y = (uv_depth[:, 1] - c_v) * uv_depth[:, 2] / f_v
        cam = np.stack([x, y, uv_depth[:, 2]], -1)
        depth = np.stack([cam[:, 0], cam[:, 2], -cam[:, 1]], -1)  # cam -> depth
        return depth @ self.Rtilt.T

    @staticmethod
    def project_label(labels: np.ndarray) -> np.ndarray:
        """SUN RGB-D seg labels: ids >= 1; 0 = unlabeled -> IGNORE."""
        out = labels.astype(np.int64) - 1
        out[labels == 0] = IGNORE_LABEL
        return out


def get_edge_mask_2d(boxes: np.ndarray, image_shape) -> np.ndarray:
    """SUN RGB-D variant of the border filter (XYWH boxes)."""
    if boxes.shape[0] == 0:
        return boxes
    H, W = image_shape[:2]
    keep = (
        (boxes[:, 0] != 0)
        & (boxes[:, 1] != 0)
        & (boxes[:, 0] + boxes[:, 2] != W)
        & (boxes[:, 1] + boxes[:, 3] != H)
    )
    return boxes[keep]
