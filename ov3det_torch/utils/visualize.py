"""Point-cloud / bounding-box visualization writers (PLY, OBJ-free).

A copy of `ov3det/utils/visualize.py` (numpy only; the port never
imports the JAX package).

Counterpart of the reference's trimesh/plyfile writers
(reference utils/pc_util.py:145-295, 3DOVDet_tools/utils/io_utils.py:140-319,
3DOVDet_tools/{scannet,sunrgbd}/visualize_box.py): dependency-free ASCII
PLY output for point clouds, colored point clouds, and boxes rendered as
edge line-sets (PLY edge elements — viewable in MeshLab/CloudCompare).
"""
from __future__ import annotations

import os

import numpy as np

_BOX_EDGES = [
    (0, 1), (1, 2), (2, 3), (3, 0),
    (4, 5), (5, 6), (6, 7), (7, 4),
    (0, 4), (1, 5), (2, 6), (3, 7),
]


def write_ply(points: np.ndarray, filename: str, colors: np.ndarray | None = None):
    """points: (N, 3); colors: optional (N, 3) in [0, 1] or [0, 255]."""
    os.makedirs(os.path.dirname(os.path.abspath(filename)), exist_ok=True)
    N = points.shape[0]
    with open(filename, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {N}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            if colors.max() <= 1.0:
                colors = (colors * 255).astype(np.uint8)
            f.write(
                "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            )
        f.write("end_header\n")
        for i in range(N):
            row = f"{points[i,0]:.4f} {points[i,1]:.4f} {points[i,2]:.4f}"
            if colors is not None:
                row += f" {int(colors[i,0])} {int(colors[i,1])} {int(colors[i,2])}"
            f.write(row + "\n")


def write_bbox_ply(corners: np.ndarray, filename: str,
                   color: tuple = (0, 255, 0)):
    """corners: (K, 8, 3) box corner sets -> PLY with edge elements."""
    os.makedirs(os.path.dirname(os.path.abspath(filename)), exist_ok=True)
    K = corners.shape[0]
    with open(filename, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {K * 8}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write(f"element edge {K * len(_BOX_EDGES)}\n")
        f.write("property int vertex1\nproperty int vertex2\n")
        f.write("end_header\n")
        for k in range(K):
            for c in corners[k]:
                f.write(
                    f"{c[0]:.4f} {c[1]:.4f} {c[2]:.4f} "
                    f"{color[0]} {color[1]} {color[2]}\n"
                )
        for k in range(K):
            for a, b in _BOX_EDGES:
                f.write(f"{k * 8 + a} {k * 8 + b}\n")


def write_scene_with_boxes(
    points: np.ndarray,
    box_corners: np.ndarray,
    out_prefix: str,
    point_colors: np.ndarray | None = None,
):
    """Dump `<prefix>_pc.ply` + `<prefix>_boxes.ply` for a scene."""
    write_ply(points, out_prefix + "_pc.ply", point_colors)
    if box_corners.shape[0]:
        write_bbox_ply(box_corners, out_prefix + "_boxes.ply")


def boxes_cs_to_corners(boxes_cs: np.ndarray) -> np.ndarray:
    """[cx,cy,cz,dx,dy,dz] axis-aligned -> (K, 8, 3) corners (depth coords)."""
    c, d = boxes_cs[:, :3], boxes_cs[:, 3:6] / 2
    signs = np.array(
        [
            [-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
            [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1],
        ],
        np.float64,
    )
    return c[:, None, :] + signs[None] * d[:, None, :]
