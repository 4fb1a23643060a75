"""VOC-style detection AP (host side, VoteNet-exact).

A copy of `ov3det/eval/voc.py:20-196` (reference utils/eval_det.py):
per-class greedy TP/FP matching over confidence-sorted detections +
precision-envelope AP integration.  The semantics are identical; the
per-pair python IoU calls are replaced by one vectorized det-x-gt IoU matrix
per scan (`geometry/iou_np.py`), and the class loop can fan out over a
process pool like the reference's Pool(10) (utils/eval_det.py:253).  Scans
come as the arrays `APCalculator` accumulates or as the reference's tuple
lists, normalised on entry.
"""
from __future__ import annotations

from multiprocessing import Pool

import numpy as np

from ov3det_torch.geometry.iou_np import box3d_iou_batch_np


def voc_ap(rec: np.ndarray, prec: np.ndarray, use_07_metric: bool = False) -> float:
    """Precision-envelope AP (reference utils/eval_det.py:23-54); with
    `use_07_metric` the VOC 2007 11-point interpolation."""
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = 0.0 if np.sum(rec >= t) == 0 else float(np.max(prec[rec >= t]))
            ap += p / 11.0
        return ap
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = np.maximum(mpre[i - 1], mpre[i])
    i = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[i + 1] - mrec[i]) * mpre[i + 1]))


def eval_det_cls(pred, gt, ovthresh=0.25, use_07_metric=False, iou=None):
    """Greedy matching for one class (reference utils/eval_det.py:66-155).

    pred: {scan_id: (corners (m, 8, 3), scores (m,))}, or a scan's
    reference-style list of (box, score) tuples;
    gt: {scan_id: corners (g, 8, 3)} (possibly empty arrays).
    iou: (boxes (m, ...), gts (g, ...)) -> (m, g); None is the rotated
    `box3d_iou_batch_np` of corner sets (`tools/evaluate_box.py` passes an
    axis-aligned IoU of 6-vectors).
    """
    iou = box3d_iou_batch_np if iou is None else iou
    pred = {img: _as_box_score_pairs(v) for img, v in pred.items()}
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
    return rec, prec, voc_ap(rec, prec, use_07_metric)


def _eval_cls_wrapper(args):
    return eval_det_cls(*args)


def _as_box_score_pairs(v):
    """One scan's detections of a class as (boxes, scores) arrays: the pair
    itself, or a list of (box, score) tuples (corner (8, 3) or AABB rows)."""
    if isinstance(v, tuple) and len(v) == 2:
        return np.asarray(v[0]), np.asarray(v[1])
    if not len(v):
        return np.zeros((0, 8, 3)), np.zeros(0)
    return np.stack([np.asarray(b) for b, _ in v]), np.array([s for _, s in v])


def _as_pred_arrays(dets):
    """One scan's detections as (classes, corners, scores) arrays: the triple
    itself, or the reference's list of (cls, corners, score) tuples."""
    if isinstance(dets, tuple):
        return dets
    if not len(dets):
        return np.zeros(0, np.int64), np.zeros((0, 8, 3)), np.zeros(0)
    return (np.array([d[0] for d in dets], np.int64), np.stack([np.asarray(d[1]) for d in dets]),
            np.array([d[2] for d in dets]))


def _as_gt_arrays(gts):
    """One scan's GT boxes as (classes, corners) arrays: the pair itself, or
    a list of (cls, corners) tuples."""
    if isinstance(gts, tuple):
        return gts
    if not len(gts):
        return np.zeros(0, np.int64), np.zeros((0, 8, 3))
    return np.array([g[0] for g in gts], np.int64), np.stack([np.asarray(g[1]) for g in gts])


def eval_det(pred_all: dict, gt_all: dict, ovthresh: float = 0.25, use_07_metric: bool = False,
             processes: int = 0):
    """Multi-class AP (reference utils/eval_det.py:164-272).

    Scan entries are what APCalculator accumulates, preds `(classes (M,),
    corners (M, 8, 3), scores (M,))` and gts `(classes (G,), corners (G, 8,
    3))`, or the reference's tuple lists `[(cls, corners, score)]` and
    `[(cls, corners)]`.  `processes` > 0 scores the classes in a process
    pool of at most that many workers.
    """
    pred, gt = {}, {}
    for img_id, dets in pred_all.items():
        cls_arr, boxes, scores = _as_pred_arrays(dets)
        for classname in np.unique(cls_arr):
            m = cls_arr == classname
            # mask keeps in-scan order => same per-class sequence as the
            # reference's per-det append loop
            pred.setdefault(int(classname), {})[img_id] = (boxes[m], scores[m])
            gt.setdefault(int(classname), {}).setdefault(
                img_id, np.zeros((0, 8, 3)))
    for img_id, gts in gt_all.items():
        cls_arr, boxes = _as_gt_arrays(gts)
        for classname in np.unique(cls_arr):
            gt.setdefault(int(classname), {})[img_id] = boxes[cls_arr == classname]

    # the classes with detections first, then the rest: the JAX package's
    # order, which the float32 mean over ap.values() sums in
    work = [(cls, pred[cls], gt[cls]) for cls in gt if cls in pred]
    args = [(p, g, ovthresh, use_07_metric) for _, p, g in work]
    if processes > 0 and len(work) > 1:
        with Pool(processes=min(processes, len(work))) as pool:
            results = pool.map(_eval_cls_wrapper, args)
    else:
        results = [eval_det_cls(*a) for a in args]
    rec, prec, ap = {}, {}, {}
    for (cls, _, _), (r, p, a) in zip(work, results):
        rec[cls], prec[cls], ap[cls] = r, p, a
    for cls in gt:
        if cls not in pred:
            rec[cls], prec[cls], ap[cls] = 0, 0, 0
    return rec, prec, ap
