"""Small pseudo-label format tools.

A copy of `ov3det/tools/format_tools.py` (numpy only; the port never
imports the JAX package).

Counterparts of reference 3DOVDet_tools/{scannet,sunrgbd}/distribute_boxes.py
(split RegionCLIP predictions into per-frame .npy), scannet/adjust_format.py
(class ids 0-17 -> nyu40), scannet/assign_box_label_from_gt.py (oracle label
assignment for GSS proposals), and generate_categories.py (LVIS-format
category file for RegionCLIP).
"""
from __future__ import annotations

import os
from typing import Sequence

import numpy as np

NYU40IDS = np.array([3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33, 34, 36, 39])


def distribute_boxes(
    predictions,  # list of {"image_id"/"file_name", "instances": [...]}
    out_dir: str,
    score_thresh: float = 0.7,
    drop_background: bool = True,
    num_classes: int = 18,
):
    """Split RegionCLIP `instances_predictions.pth`-style records into
    per-frame (K, 6) arrays [x, y, w, h, score, cls]
    (reference distribute_boxes.py:27-41 / :18-50)."""
    os.makedirs(out_dir, exist_ok=True)
    written = 0
    for rec in predictions:
        rows = []
        for inst in rec["instances"]:
            score = float(inst["score"])
            cls = int(inst["category_id"])
            if score <= score_thresh:
                continue
            if drop_background and cls >= num_classes:
                continue
            x, y, w, h = inst["bbox"]
            rows.append([x, y, w, h, score, cls])
        arr = np.array(rows, np.float32) if rows else np.zeros((0, 6), np.float32)
        name = str(rec.get("image_id", rec.get("file_name")))
        np.save(os.path.join(out_dir, f"{name}.npy"), arr)
        written += 1
    return written


def adjust_format_to_nyu40(in_dir: str, out_dir: str, scan_names: Sequence[str]):
    """Pseudo boxes with class ids 0..17 -> nyu40 ids, drop the score column
    (reference scannet/adjust_format.py:10-16) so the dataloader's
    nyu40id2class mapping applies uniformly."""
    os.makedirs(out_dir, exist_ok=True)
    for scan in scan_names:
        boxes = np.load(os.path.join(in_dir, scan + "_bbox.npy"))
        if boxes.shape[0]:
            out = boxes[:, :7].copy()
            out[:, 6] = NYU40IDS[boxes[:, 6].astype(int)]
        else:
            out = np.zeros((0, 7))
        np.save(os.path.join(out_dir, scan + "_bbox.npy"), out)


def assign_box_label_from_gt(
    proposals: np.ndarray,  # (K, >=6) [cx,cy,cz,dx,dy,dz,...]
    points: np.ndarray,  # (N, 3)
    semantic_labels: np.ndarray,  # (N,) class ids, IGNORE < 0
    min_points: int = 5,
) -> np.ndarray:
    """Oracle label assignment: each proposal gets the modal semantic label
    of its contained points (reference scannet/assign_box_label_from_gt.py:28-70).
    Returns (K, 8) rows [geometry(6), label, score=1]; unlabeled dropped."""
    out = []
    for box in proposals:
        lo = box[0:3] - box[3:6] / 2
        hi = box[0:3] + box[3:6] / 2
        inside = np.all(points >= lo, -1) & np.all(points <= hi, -1)
        labels = semantic_labels[inside]
        labels = labels[labels >= 0]
        if labels.size < min_points:
            continue
        vals, counts = np.unique(labels, return_counts=True)
        out.append(np.concatenate([box[:6], [vals[np.argmax(counts)], 1.0]]))
    return np.stack(out, 0) if out else np.zeros((0, 8))


def label_agreement(
    pseudo_labels: np.ndarray, gt_semantic_labels: np.ndarray
) -> tuple[int, int]:
    """Pixelwise 2D pseudo-vs-GT semantic label agreement for ONE scene.

    Counterpart of reference 3DOVDet_tools/scannet/assess_pseudo_label.py:28-48:
    GT frames carry raw nyu40 ids (mapped to 0..17 / IGNORE), pseudo frames
    carry 0..17 class ids with >=18 treated as IGNORE; the agreement is the
    plain pixel count of equal mapped labels over ALL pixels (IGNOREs only
    match IGNOREs, exactly as the reference's `==` does).

    Returns (matching_pixels, total_pixels).
    """
    from ov3det_torch.tools.projection_np import ProjectionHelper

    gt = ProjectionHelper.project_label(
        np.asarray(gt_semantic_labels, np.int64), pseudo=False
    )
    ps = ProjectionHelper.project_label(
        np.asarray(pseudo_labels, np.int64), pseudo=True
    )
    return int(np.sum(ps == gt)), int(gt.size)


def assess_pseudo_labels(
    scenes,  # iterable of (pseudo_frames, gt_frames) array pairs per scene
) -> dict:
    """Aggregate 2D pseudo-label quality over scenes, one after another (the
    reference script's mp.Pool loop, assess_pseudo_label.py:52-61).
    Returns per-scene rates plus the corpus-level correctness count/total."""
    results = [label_agreement(p, g) for p, g in scenes]
    count = sum(r[0] for r in results)
    total = sum(r[1] for r in results)
    return {
        "per_scene": [c / t if t else 0.0 for c, t in results],
        "count": count,
        "total": total,
        "correctness": count / total if total else 0.0,
    }


def generate_categories(concepts: Sequence[str]) -> list[dict]:
    """Concept list -> LVIS-format categories for RegionCLIP
    (reference generate_categories.py:8-19)."""
    return [
        {
            "id": i + 1,
            "name": c,
            "frequency": "f",
            "synset": f"{c}.n.01",
            "synonyms": [c],
            "def": c,
            "instance_count": 1,
            "image_count": 1,
        }
        for i, c in enumerate(concepts)
    ]
