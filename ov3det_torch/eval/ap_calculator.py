"""AP calculator: accumulate per-scan predictions and GT, compute mAP / AR.

Counterpart of `ov3det/eval/ap_calculator.py:20-200` (reference
utils/ap_calculator.py:241-450), with the same metric schema (per-class AP
and Recall, mAP and AR at each IoU threshold) and the same strings.
`step_meter` runs `parse_predictions` (empty-box removal and NMS) on the
outputs' device, copies its results and the outputs it needs to the host in
one transfer, and assembles the proposals there; the VOC matching
(`eval/voc.py`) runs on the host, in `eval_processes` processes when that
is above 0.

`get_ap_config_dict` holds the settings (VoteNet's by default: class-aware
3D NMS at IoU 0.25, per-class proposals above confidence 0.05); AP is
taken at IoU 0.25 and 0.5 (`AP_IOU_THRESH`) unless `ap_iou_thresh` says
otherwise.  `exact_eval=False` (the train-time AP) turns off the empty-box
removal of the default settings.  `use_old_type_nms` is kept and has no
effect, as in the JAX package, whose parse never receives it.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from ov3det_torch.eval.parse import assemble_predictions, parse_predictions
from ov3det_torch.eval.voc import eval_det

AP_IOU_THRESH = (0.25, 0.5)


def get_ap_config_dict(remove_empty_box=True, use_3d_nms=True, nms_iou=0.25,
                       use_old_type_nms=False, cls_nms=True, per_class_proposal=True,
                       use_cls_confidence_only=False, conf_thresh=0.05, no_nms=False,
                       dataset_config=None) -> dict:
    """VoteNet's mAP settings (reference utils/ap_calculator.py:241-269)."""
    return {
        "remove_empty_box": remove_empty_box,
        "use_3d_nms": use_3d_nms,
        "nms_iou": nms_iou,
        "use_old_type_nms": use_old_type_nms,
        "cls_nms": cls_nms,
        "per_class_proposal": per_class_proposal,
        "use_cls_confidence_only": use_cls_confidence_only,
        "conf_thresh": conf_thresh,
        "no_nms": no_nms,
        "dataset_config": dataset_config,
    }


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _fetch(*tensors: torch.Tensor) -> list:
    """Device tensors -> numpy arrays of their shapes, in one copy: each is
    flattened into one float32 buffer (classes and masks are exact there)."""
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors]).cpu().numpy()
    out, off = [], 0
    for t in tensors:
        out.append(flat[off:off + t.numel()].reshape(t.shape))
        off += t.numel()
    return out


class APCalculator:
    def __init__(self, dataset_config=None, ap_iou_thresh=AP_IOU_THRESH,
                 class2type_map: Optional[dict] = None, exact_eval: bool = True,
                 ap_config_dict: Optional[dict] = None, eval_processes: int = 0):
        self.ap_iou_thresh = list(ap_iou_thresh)
        if ap_config_dict is None:
            ap_config_dict = get_ap_config_dict(dataset_config=dataset_config,
                                                remove_empty_box=exact_eval)
        self.ap_config_dict = ap_config_dict
        self.class2type_map = class2type_map
        self.exact_eval = exact_eval
        self.eval_processes = eval_processes
        self.reset()

    def make_gt_list(self, gt_box_corners, gt_box_sem_cls_labels, gt_box_present):
        """Per-sample `(classes (G,), corners (G, 8, 3))` array pairs (same
        array-native scan format as assemble_predictions)."""
        batch_gt = []
        for i in range(gt_box_corners.shape[0]):
            keep = gt_box_present[i] == 1
            batch_gt.append((
                np.asarray(gt_box_sem_cls_labels[i][keep], np.int64),
                np.asarray(gt_box_corners[i][keep]),
            ))
        return batch_gt

    def step_meter(self, outputs: dict, targets: dict):
        """outputs: final-layer model outputs (B, Q, ...) as tensors on one
        device; targets: the batch (tensors on any device, or numpy).  What
        it needs of both is on the host when it returns, so the outputs may
        be a CUDA graph's static tensors, overwritten by the next replay."""
        self.step(
            predicted_box_corners=outputs["box_corners"],
            sem_cls_probs=outputs["sem_cls_prob"],
            objectness_probs=outputs["objectness_prob"],
            point_cloud=targets["point_clouds"],
            gt_box_corners=_host(targets["gt_box_corners"]),
            gt_box_sem_cls_labels=_host(targets["gt_box_sem_cls_label"]),
            gt_box_present=_host(targets["gt_box_present"]),
        )

    def step(
        self,
        predicted_box_corners,
        sem_cls_probs,
        objectness_probs,
        point_cloud,
        gt_box_corners,
        gt_box_sem_cls_labels,
        gt_box_present,
    ):
        cfgd = self.ap_config_dict
        dev = predicted_box_corners.device
        with torch.inference_mode():
            pred_mask, pred_sem_cls = parse_predictions(
                predicted_box_corners,
                sem_cls_probs,
                objectness_probs,
                torch.as_tensor(point_cloud).to(dev),
                nms_iou=cfgd["nms_iou"],
                remove_empty_box=cfgd["remove_empty_box"],
                use_3d_nms=cfgd["use_3d_nms"],
                cls_nms=cfgd["cls_nms"],
                no_nms=cfgd["no_nms"],
            )
            corners_np, probs_np, obj_np, mask_np, cls_np = _fetch(
                predicted_box_corners, sem_cls_probs, objectness_probs, pred_mask, pred_sem_cls)
        batch_pred = assemble_predictions(
            corners_np, probs_np, obj_np, mask_np, cls_np,
            conf_thresh=cfgd["conf_thresh"],
            per_class_proposal=cfgd["per_class_proposal"],
            use_cls_confidence_only=cfgd["use_cls_confidence_only"],
        )
        batch_gt = self.make_gt_list(
            gt_box_corners, gt_box_sem_cls_labels, gt_box_present
        )
        self.accumulate(batch_pred, batch_gt)

    def accumulate(self, batch_pred_map_cls, batch_gt_map_cls):
        assert len(batch_pred_map_cls) == len(batch_gt_map_cls)
        for i in range(len(batch_pred_map_cls)):
            self.gt_map_cls[self.scan_cnt] = batch_gt_map_cls[i]
            self.pred_map_cls[self.scan_cnt] = batch_pred_map_cls[i]
            self.scan_cnt += 1

    def compute_metrics(self):
        overall = OrderedDict()
        for thresh in self.ap_iou_thresh:
            ret = OrderedDict()
            rec, _, ap = eval_det(self.pred_map_cls, self.gt_map_cls, ovthresh=thresh,
                                  processes=self.eval_processes)
            for key in sorted(ap.keys()):
                # SUN RGB-D names only 17 of its 20 class ids (reference
                # sunrgbd.py:60-78): fall back to the numeric id
                name = (self.class2type_map or {}).get(key, str(key))
                ret[f"{name} Average Precision"] = ap[key]
            ap_vals = np.array(list(ap.values()), dtype=np.float32)
            ap_vals[np.isnan(ap_vals)] = 0
            ret["mAP"] = float(ap_vals.mean()) if len(ap_vals) else 0.0
            rec_list = []
            for key in sorted(ap.keys()):
                name = (self.class2type_map or {}).get(key, str(key))
                try:
                    ret[f"{name} Recall"] = rec[key][-1]
                    rec_list.append(rec[key][-1])
                except (TypeError, IndexError):
                    ret[f"{name} Recall"] = 0
                    rec_list.append(0)
            ret["AR"] = float(np.mean(rec_list)) if rec_list else 0.0
            overall[thresh] = ret
        return overall

    def metrics_to_str(self, overall, per_class=True):
        mAPs, ARs, per_cls = [], [], []
        for t in self.ap_iou_thresh:
            mAPs.append(f"{overall[t]['mAP'] * 100:.2f}")
            ARs.append(f"{overall[t]['AR'] * 100:.2f}")
            if per_class:
                per_cls.append("-" * 5)
                per_cls.append(f"IOU Thresh={t}")
                for k, v in overall[t].items():
                    if k not in ("mAP", "AR"):
                        per_cls.append(f"{k}: {v * 100:.2f}")
        s = ", ".join(f"mAP{t:.2f}" for t in self.ap_iou_thresh)
        s += ": " + ", ".join(mAPs) + "\n"
        s += ", ".join(f"AR{t:.2f}" for t in self.ap_iou_thresh)
        s += ": " + ", ".join(ARs)
        if per_class:
            s += "\n" + "\n".join(per_cls)
        return s

    def metrics_to_dict(self, overall):
        return {
            **{f"mAP_{t}": overall[t]["mAP"] * 100 for t in self.ap_iou_thresh},
            **{f"AR_{t}": overall[t]["AR"] * 100 for t in self.ap_iou_thresh},
        }

    def reset(self):
        self.gt_map_cls = {}
        self.pred_map_cls = {}
        self.scan_cnt = 0
