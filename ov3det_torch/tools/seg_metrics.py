"""Semantic-segmentation QA metrics (pixel accuracy / Dice / P / R).

A copy of `ov3det/tools/seg_metrics.py` (numpy only; the port never
imports the JAX package).

Counterpart of reference 3DOVDet_tools/utils/image_segmentation_metrics.py
(SegmentationMetrics / BinaryMetrics): the reference's 2D-segmentation QA
side of the pseudo-label pipeline scores predicted masks against GT with
per-class tp/fp/fn-derived metrics. SURVEY.md marks it unused by the main
pipeline; it is kept for sidecar completeness.

Host-side numpy tool (QA runs on label maps, not on the device hot path).
Differences from the reference, by design:
- one vectorized confusion accumulation via ``np.bincount`` over joint
  (gt, pred) class ids instead of a per-class Python loop over full-image
  binary masks (the reference re-reads the (N,H,W) planes C times);
- inputs are class-id maps or logits as numpy arrays — no torch, no
  device transfer (this is a preprocessing-QA tool, so keeping it off the
  accelerator avoids a pointless H2D of label rasters).

Semantics match the reference exactly where it defines them: eps placement,
``ignore_background`` dropping class 0 AFTER the confusion counts,
``average=True`` macro-averaging Dice/P/R but never pixel accuracy, the
``0-1``/softmax/sigmoid/none activation modes, and BinaryMetrics' extra
specificity output with its sigmoid>0.5 threshold.
"""

from __future__ import annotations

import numpy as np

__all__ = ["SegmentationMetrics", "BinaryMetrics", "confusion_counts"]


def _softmax(x: np.ndarray, axis: int) -> np.ndarray:
    z = x - x.max(axis=axis, keepdims=True)
    e = np.exp(z)
    return e / e.sum(axis=axis, keepdims=True)


def _sigmoid(x: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-x))


def confusion_counts(gt: np.ndarray, pred: np.ndarray, num_classes: int):
    """tp/fp/fn per class from integer class-id maps, one bincount pass.

    gt, pred: integer arrays of identical shape with values in
    [0, num_classes). Returns (3, num_classes) float64 [tp; fp; fn] —
    the reference's ``_get_class_data`` matrix layout.
    """
    g = np.asarray(gt).reshape(-1).astype(np.int64)
    p = np.asarray(pred).reshape(-1).astype(np.int64)
    joint = np.bincount(g * num_classes + p, minlength=num_classes * num_classes)
    cm = joint.reshape(num_classes, num_classes).astype(np.float64)  # [gt, pred]
    tp = np.diag(cm).copy()
    fp = cm.sum(axis=0) - tp  # predicted i, gt != i
    fn = cm.sum(axis=1) - tp  # gt i, predicted != i
    return np.stack([tp, fp, fn])


class SegmentationMetrics:
    """Multi-class: returns (pixel_acc, dice, precision, recall).

    Reference image_segmentation_metrics.py:55-137 semantics:
    - ``activation``: '0-1' (argmax over the class axis, default) |
      'softmax' | 'sigmoid' | None/'none'. Soft activations are scored by
      their argmax here — the reference multiplies soft scores into
      tp/fp, which makes "pixel accuracy" non-counting; every published
      use in the reference repo passes '0-1'. For soft inputs the class
      decision is identical (argmax is monotone under softmax/sigmoid).
    - ``ignore_background``: drop class 0 AFTER counting.
    - ``average``: macro-average dice/precision/recall; pixel_acc is
      always the scalar micro rate.
    """

    def __init__(self, eps: float = 1e-5, average: bool = True,
                 ignore_background: bool = True, activation: str = "0-1"):
        if activation not in (None, "none", "softmax", "sigmoid", "0-1"):
            raise ValueError(f"unsupported activation {activation!r}")
        self.eps = float(eps)
        self.average = bool(average)
        self.ignore = bool(ignore_background)
        self.activation = activation

    def __call__(self, y_true: np.ndarray, y_pred: np.ndarray):
        """y_true: (N, H, W) int class ids; y_pred: (N, C, H, W) scores
        (any activation mode) or (N, H, W) int class ids (then the
        activation mode is irrelevant)."""
        y_true = np.asarray(y_true)
        y_pred = np.asarray(y_pred)
        if y_pred.ndim == y_true.ndim + 1:
            num_classes = y_pred.shape[1]
            pred_ids = np.argmax(y_pred, axis=1)
        else:
            pred_ids = y_pred.astype(np.int64)
            num_classes = int(max(y_true.max(initial=0),
                                  pred_ids.max(initial=0))) + 1
        matrix = confusion_counts(y_true, pred_ids, num_classes)
        if self.ignore:
            matrix = matrix[:, 1:]
        tp, fp, fn = matrix
        # reference :104-108 — eps only in pixel_acc's numerator; class
        # metrics carry eps on both sides
        pixel_acc = (tp.sum() + self.eps) / (tp.sum() + fp.sum())
        dice = (2 * tp + self.eps) / (2 * tp + fp + fn + self.eps)
        precision = (tp + self.eps) / (tp + fp + self.eps)
        recall = (tp + self.eps) / (tp + fn + self.eps)
        if self.average:
            dice, precision, recall = (
                float(np.mean(dice)), float(np.mean(precision)),
                float(np.mean(recall)),
            )
        return float(pixel_acc), dice, precision, recall


class BinaryMetrics:
    """Binary: returns (pixel_acc, dice, precision, specificity, recall).

    Reference image_segmentation_metrics.py:140-186: y_pred is (N, 1, H, W)
    logits ('0-1' thresholds sigmoid at 0.5; 'sigmoid' scores the
    probabilities; None scores raw values) and y_true is (N, H, W) in
    {0, 1}. The soft modes keep the reference's soft-count semantics
    (they are well-defined here: tp = sum(p * t) etc.).
    """

    def __init__(self, eps: float = 1e-5, activation: str = "0-1"):
        if activation not in (None, "none", "sigmoid", "0-1"):
            raise ValueError(f"unsupported activation {activation!r}")
        self.eps = float(eps)
        self.activation = activation

    def __call__(self, y_true: np.ndarray, y_pred: np.ndarray):
        y_pred = np.asarray(y_pred, np.float64)
        if y_pred.ndim == 4:
            if y_pred.shape[1] != 1:
                raise ValueError(
                    "predictions must contain only one channel for binary "
                    f"segmentation, got {y_pred.shape}"
                )
            y_pred = y_pred[:, 0]
        if self.activation == "sigmoid":
            p = _sigmoid(y_pred)
        elif self.activation == "0-1":
            p = (_sigmoid(y_pred) > 0.5).astype(np.float64)
        else:
            p = y_pred
        t = np.asarray(y_true, np.float64)
        tp = float((p * t).sum())
        fp = float((p * (1 - t)).sum())
        fn = float(((1 - p) * t).sum())
        tn = float(((1 - p) * (1 - t)).sum())
        eps = self.eps
        pixel_acc = (tp + tn + eps) / (tp + tn + fp + fn + eps)
        dice = (2 * tp + eps) / (2 * tp + fp + fn + eps)
        precision = (tp + eps) / (tp + fp + eps)
        recall = (tp + eps) / (tp + fn + eps)
        specificity = (tn + eps) / (tn + fp + eps)
        return pixel_acc, dice, precision, specificity, recall
