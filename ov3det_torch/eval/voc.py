"""VOC-style detection AP (host side, VoteNet-exact).

A copy of `ov3det/eval/voc.py:20-196` (reference utils/eval_det.py):
per-class greedy TP/FP matching over confidence-sorted detections +
precision-envelope AP integration.  The semantics are identical; the
per-pair python IoU calls are replaced by one vectorized det-x-gt IoU matrix
per scan (`geometry/iou_np.py`).  Only what `APCalculator` uses is kept: the
array input format, the VOC2010+ AP and one process.
"""
from __future__ import annotations

import numpy as np

from ov3det_torch.geometry.iou_np import box3d_iou_batch_np


def voc_ap(rec: np.ndarray, prec: np.ndarray) -> float:
    """Precision-envelope AP (reference utils/eval_det.py:23-54)."""
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = np.maximum(mpre[i - 1], mpre[i])
    i = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[i + 1] - mrec[i]) * mpre[i + 1]))


def eval_det_cls(pred, gt, ovthresh=0.25, iou=None):
    """Greedy matching for one class (reference utils/eval_det.py:66-155).

    pred: {scan_id: (corners (m, 8, 3), scores (m,))};
    gt: {scan_id: corners (g, 8, 3)} (possibly empty arrays).
    iou: (boxes (m, ...), gts (g, ...)) -> (m, g); None is the rotated
    `box3d_iou_batch_np` of corner sets (`tools/evaluate_box.py` passes an
    axis-aligned IoU of 6-vectors).
    """
    iou = box3d_iou_batch_np if iou is None else iou
    class_recs = {}
    npos = 0
    for img_id in gt.keys():
        bbox = np.asarray(gt[img_id])
        class_recs[img_id] = {"bbox": bbox, "det": [False] * len(bbox)}
        npos += len(bbox)
    for img_id in pred.keys():
        if img_id not in gt:
            class_recs[img_id] = {"bbox": np.array([]), "det": []}

    # flatten (scan insertion order, in-scan order — identical sequence to
    # the reference's nested append loops, so the confidence sort below
    # ranks the same entries in the same way)
    image_ids, confidence, det_index_in_img = [], [], []
    for img_id, (boxes, scores) in pred.items():
        m = len(scores)
        image_ids += [img_id] * m
        confidence.append(np.asarray(scores))
        det_index_in_img.append(np.arange(m))
    confidence = (np.concatenate(confidence) if confidence
                  else np.zeros(0))
    det_index_in_img = (np.concatenate(det_index_in_img)
                        if det_index_in_img else np.zeros(0, np.int64))

    # vectorized IoU: one matrix per scan instead of one clip per pair
    iou_cache = {}
    for img_id, (boxes, scores) in pred.items():
        gts = class_recs[img_id]["bbox"]
        if len(boxes) and len(gts):
            iou_cache[img_id] = iou(np.asarray(boxes, np.float64), np.asarray(gts, np.float64))

    sorted_ind = np.argsort(-confidence) if len(confidence) else []
    nd = len(image_ids)
    tp = np.zeros(nd)
    fp = np.zeros(nd)

    for rank, d in enumerate(sorted_ind):
        img_id = image_ids[d]
        R = class_recs[img_id]
        ovmax, jmax = -np.inf, -1
        if R["bbox"].size > 0:
            ious = iou_cache[img_id][det_index_in_img[d]]
            jmax = int(np.argmax(ious))
            ovmax = float(ious[jmax])
        if ovmax > ovthresh:
            if not R["det"][jmax]:
                tp[rank] = 1.0
                R["det"][jmax] = True
            else:
                fp[rank] = 1.0
        else:
            fp[rank] = 1.0

    fp = np.cumsum(fp)
    tp = np.cumsum(tp)
    rec = tp / float(npos) if npos > 0 else np.zeros_like(tp)
    prec = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
    return rec, prec, voc_ap(rec, prec)


def eval_det(pred_all: dict, gt_all: dict, ovthresh: float = 0.25):
    """Multi-class AP (reference utils/eval_det.py:164-272).

    Scan entries are what APCalculator accumulates: preds
    `(classes (M,), corners (M, 8, 3), scores (M,))`, gts
    `(classes (G,), corners (G, 8, 3))`.
    """
    pred, gt = {}, {}
    for img_id, (cls_arr, boxes, scores) in pred_all.items():
        for classname in np.unique(cls_arr):
            m = cls_arr == classname
            # mask keeps in-scan order => same per-class sequence as the
            # reference's per-det append loop
            pred.setdefault(int(classname), {})[img_id] = (boxes[m], scores[m])
            gt.setdefault(int(classname), {}).setdefault(
                img_id, np.zeros((0, 8, 3)))
    for img_id, (cls_arr, boxes) in gt_all.items():
        for classname in np.unique(cls_arr):
            gt.setdefault(int(classname), {})[img_id] = boxes[cls_arr == classname]

    # the classes with detections first, then the rest: the JAX package's
    # order, which the float32 mean over ap.values() sums in
    rec, prec, ap = {}, {}, {}
    for cls in gt.keys():
        if cls in pred:
            rec[cls], prec[cls], ap[cls] = eval_det_cls(pred[cls], gt[cls], ovthresh)
    for cls in gt.keys():
        if cls not in pred:
            rec[cls], prec[cls], ap[cls] = 0, 0, 0
    return rec, prec, ap
