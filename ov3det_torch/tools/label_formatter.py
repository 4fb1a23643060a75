"""Online pseudo-label writer: detector predictions -> per-scan bbox files.

Counterpart of reference utils/label_formatter.py:66-206 (LabelFormatter):
during the `inference` pass over the train split, accumulate
(center, size, label, score, objectness, scan_idx) rows per prediction;
then threshold per class, keep boxes whose contained points' modal semantic
label agrees with the box label, and write `{scan}_bbox.npy` files the
dataloader consumes via use_pbox (after `format_tools.adjust_format_to_nyu40`
for ScanNet, whose loader reads nyu40 ids).

A copy of `ov3det/tools/label_formatter.py` (numpy only; the port never
imports the JAX package).  `step` takes the port's eval outputs, tensors on
any device, and casts them to f32 numpy on the host first.
"""
from __future__ import annotations

import os
from typing import Sequence

import numpy as np

IGNORE_LABEL = -100
_NYU40IDS = np.array([3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33, 34, 36, 39])
_NYU40ID2CLASS = {nid: i for i, nid in enumerate(list(_NYU40IDS))}


def _host(x) -> np.ndarray:
    """A tensor (any device, any float dtype) or array -> f32 numpy."""
    if hasattr(x, "detach"):
        x = x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def axis_aligned_iou_np(box_q: np.ndarray, box_k: np.ndarray, typ: str = "vv",
                        eps: float = 1e-5) -> np.ndarray:
    """AABB IoU of one box vs many; 'vv' = [min,max], 'cs' = [center,size]
    (reference utils/label_formatter.py:10-64)."""
    q = box_q[None, :]
    if typ == "cs":
        q = np.concatenate([q[:, :3] - q[:, 3:6] / 2, q[:, :3] + q[:, 3:6] / 2], 1)
        box_k = np.concatenate(
            [box_k[:, :3] - box_k[:, 3:6] / 2, box_k[:, :3] + box_k[:, 3:6] / 2], 1
        )
    inter = np.prod(
        np.clip(np.minimum(q[:, 3:6], box_k[:, 3:6]) - np.maximum(q[:, :3], box_k[:, :3]), 0, None),
        axis=-1,
    )
    vq = np.prod(q[:, 3:6] - q[:, :3], -1)
    vk = np.prod(box_k[:, 3:6] - box_k[:, :3], -1)
    return inter / (vq + vk - inter + eps)


class LabelFormatter:
    def __init__(
        self,
        output_path: str,
        label_path: str,
        scene_list: Sequence[str],
        num_classes: int = 18,
    ):
        self.boxes = []
        self.output_path = output_path
        # label_path=None skips the modal-semantic-label agreement filter
        # (gen_pseudo keeps every thresholded box) — for datasets without
        # per-scan point-label files
        self.raw_label_path = (
            os.path.join(label_path, "{}.npy") if label_path else None
        )
        self.scene_list = list(scene_list)
        self.num_classes = num_classes

    def step(self, outputs: dict, batch: dict):
        """Accumulate predictions of one batch (final-layer outputs).

        Row layout: center(3), size(3), label, score, objectness, scan_idx
        (reference label_formatter.py:81-106)."""
        sem_cls_prob = _host(outputs["sem_cls_prob"])  # (B, Q, C)
        obj_prob = _host(outputs["objectness_prob"])
        center = _host(outputs["center_unnormalized"])
        size = _host(outputs["size_unnormalized"])
        B, Q, _ = sem_cls_prob.shape
        label = np.argmax(sem_cls_prob, -1).astype(np.float32)
        score = np.max(sem_cls_prob, -1)
        scan_idx = np.repeat(
            _host(batch["scan_idx"])[:, None], Q, axis=1
        )
        rows = np.concatenate(
            [center, size, label[..., None], score[..., None], obj_prob[..., None],
             scan_idx[..., None]],
            axis=-1,
        ).reshape(B * Q, 10)
        self.boxes.append(rows)

    def compute(self, topk: int, th_s: float, th_o: float):
        """Per-class score/objectness thresholding (reference :117-132)."""
        self.boxes = np.concatenate(self.boxes, 0)
        kept = []
        for label in range(self.num_classes):
            rows = self.boxes[self.boxes[:, 6] == label]
            keep = (rows[:, 7] >= th_s) & (rows[:, 8] >= th_o)
            kept.append(rows[keep])
        self.pseudo_boxes = np.concatenate(kept, 0)

    @staticmethod
    def crop_pc_mask(pc: np.ndarray, box: np.ndarray) -> np.ndarray:
        lo = box[0:3] - box[3:6] / 2
        hi = box[0:3] + box[3:6] / 2
        return np.all(pc >= lo, -1) & np.all(pc <= hi, -1)

    @staticmethod
    def project_label(semantic_labels: np.ndarray, pseudo: bool = True) -> np.ndarray:
        """nyu40 (or already-projected) labels -> 0..17 / IGNORE."""
        if not pseudo:
            out = np.full_like(semantic_labels, IGNORE_LABEL)
            for c in _NYU40IDS:
                out[semantic_labels == c] = _NYU40ID2CLASS[c]
            return out
        out = semantic_labels.copy()
        out[semantic_labels >= 18] = IGNORE_LABEL
        return out

    def gen_pseudo(self, idx: int) -> int:
        """Write one scan's pseudo boxes; a box survives iff the modal
        semantic label of its contained points equals the box label
        (reference :134-167)."""
        scan_name = self.scene_list[idx]
        mask = self.pseudo_boxes[:, -1] == idx
        if self.raw_label_path is None:
            out_boxes = self.pseudo_boxes[mask][:, :7]
        else:
            raw = np.load(self.raw_label_path.format(scan_name))
            points = raw[:, :3]
            sem = self.project_label(raw[:, 3], pseudo=True)
            filtered = []
            for box in self.pseudo_boxes[mask]:
                inside = self.crop_pc_mask(points, box) & (sem != IGNORE_LABEL)
                if inside.sum() > 0:
                    vals, counts = np.unique(sem[inside], return_counts=True)
                    if vals[np.argmax(counts)] == box[6]:
                        filtered.append(box)
            out_boxes = (
                np.stack(filtered, 0)[:, :7] if filtered else np.zeros((0, 7))
            )
        os.makedirs(self.output_path, exist_ok=True)
        np.save(os.path.join(self.output_path, scan_name) + "_bbox.npy", out_boxes)
        return out_boxes.shape[0]

    def save(self) -> int:
        """Write every scan's file, one after another (JAX's `processes=0`)."""
        return sum(self.gen_pseudo(i) for i in range(len(self.scene_list)))

    def process(self, topk: int, th_s: float, th_o: float) -> int:
        self.compute(topk, th_s, th_o)
        n = self.save()
        print(f"Done! Acquired {n} boxes.")
        return n
