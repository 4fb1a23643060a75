"""Pseudo-box quality evaluation: precision/recall vs GT boxes.

Counterpart of reference 3DOVDet_tools/{scannet,sunrgbd}/evaluate_box.py +
utils/evaluation/pr_helper.py:169-229 (PRCalculator): final-point precision
and recall per class at an IoU threshold, axis-aligned IoU by default.

A copy of `ov3det/tools/evaluate_box.py` on the port's VOC matching
(`ov3det_torch/eval/voc.py` `eval_det_cls`, which takes each scan's
detections as a list of (box, score) tuples and the IoU as an argument) and its
rotated IoU (`geometry/iou_np.py` `box3d_iou_batch_np`).
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ov3det_torch.eval.voc import eval_det_cls
from ov3det_torch.tools.box3d_np import box_3d_iou


def _aabb_pairwise(dets: np.ndarray, gts: np.ndarray) -> np.ndarray:
    """Pairwise AABB IoU on [cx,cy,cz,dx,dy,dz] rows."""
    out = np.zeros((len(dets), len(gts)))
    for i, d in enumerate(dets):
        out[i] = box_3d_iou(d, gts, typ="cs")
    return out


class PRCalculator:
    """Precision/recall accumulator (reference pr_helper.py:169-229)."""

    def __init__(self, ap_iou_thresh: float = 0.25, class2type_map=None, obb=False):
        self.ap_iou_thresh = ap_iou_thresh
        self.class2type_map = class2type_map
        self.aabb = not obb
        self.reset()

    def step(self, batch_pred_map_cls, batch_gt_map_cls):
        assert len(batch_pred_map_cls) == len(batch_gt_map_cls)
        for i in range(len(batch_pred_map_cls)):
            self.gt_map_cls[self.scan_cnt] = batch_gt_map_cls[i]
            self.pred_map_cls[self.scan_cnt] = batch_pred_map_cls[i]
            self.scan_cnt += 1

    def compute_metrics(self) -> dict:
        pred, gt = {}, {}
        for img_id, dets in self.pred_map_cls.items():
            for cls, bbox, score in dets:
                pred.setdefault(cls, {}).setdefault(img_id, []).append((bbox, score))
                gt.setdefault(cls, {}).setdefault(img_id, [])
        for img_id, gts in self.gt_map_cls.items():
            for cls, bbox in gts:
                gt.setdefault(cls, {}).setdefault(img_id, []).append(bbox)

        ret, prec_list, rec_list = {}, [], []
        iou = _aabb_pairwise if self.aabb else None  # None: the rotated IoU
        results = {
            cls: eval_det_cls(pred[cls],
                              {i: np.asarray(g) for i, g in gt[cls].items()},
                              self.ap_iou_thresh, iou=iou)
            for cls in gt
            if cls in pred
        }
        for key in sorted(gt.keys()):
            name = self.class2type_map[key] if self.class2type_map else str(key)
            if key in results and len(results[key][1]):
                rec, prec, _ = results[key]
                ret[f"{name} Precision"] = prec[-1]
                prec_list.append(prec[-1])
                ret[f"{name} Recall"] = rec[-1]
                rec_list.append(rec[-1])
            else:
                ret[f"{name} Precision"] = 0
                ret[f"{name} Recall"] = 0
                rec_list.append(0)
        ret["mPrecision"] = float(np.mean(prec_list)) if prec_list else 0.0
        ret["AR"] = float(np.mean(rec_list)) if rec_list else 0.0
        return ret

    def reset(self):
        self.gt_map_cls = {}
        self.pred_map_cls = {}
        self.scan_cnt = 0


def evaluate_pseudo_boxes(
    pseudo_box_dir: str,
    gt_box_dir: str,
    scan_names,
    iou_thresh: float = 0.25,
    class2type_map=None,
    nyu40_gt: bool = True,
) -> dict:
    """PR of saved pseudo-box files vs GT bbox files
    (reference scannet/evaluate_box.py:20-40)."""
    nyu40ids = np.array(
        [3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33, 34, 36, 39]
    )
    nyu2cls = {n: i for i, n in enumerate(nyu40ids)}
    calc = PRCalculator(iou_thresh, class2type_map)
    for scan in scan_names:
        pseudo = np.load(os.path.join(pseudo_box_dir, scan + "_bbox.npy"))
        gt = np.load(os.path.join(gt_box_dir, scan + "_bbox.npy"))
        preds = [
            (int(b[6]), b[:6], float(b[7]) if b.shape[0] > 7 else 1.0) for b in pseudo
        ]
        gts = []
        for b in gt:
            cls = int(b[-1])
            if nyu40_gt:
                if cls not in nyu2cls:
                    continue
                cls = nyu2cls[cls]
            gts.append((cls, b[:6]))
        calc.step([preds], [gts])
    return calc.compute_metrics()
