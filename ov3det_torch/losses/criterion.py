"""Set-prediction criterion: matcher costs, auction assignment, losses.

Counterpart of `ov3det/losses/criterion.py`: all decoder layers are matched
in one batched pass (the layer axis folded into the batch), the assignment
runs on the device (`ops.hungarian.auction_lap`), and every loss is a
masked fixed-shape reduction with the reference's normalisations
(weighted-mean cross entropy as torch's `F.cross_entropy` defines it).

Gradients, as in JAX: the cost matrix carries none (`criterion.py:123`),
so the GIoU over all layer x batch x query x GT pairs runs without autograd
when the GIoU loss weight is 0 (its value is then only logged);
`center_dist` does carry gradient into `loss_center`.  The class
probabilities arrive detached from the model.

Under a data group (`ov3det_torch.parallel`) each rank holds its rows of
the global batch, and the criterion makes its share of the JAX mesh step's
global loss: the box count is the group's (`num_boxes_global`,
`ov3det/losses/criterion.py:142-161`), the cross entropy divides by the
group's sum of its weights and the cardinality by the global batch, so the
ranks' losses add up to the global loss and their gradients add up to its
gradient.  The loss dict it returns holds the global values, the same on
every rank.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ov3det_torch.config import LossConfig
from ov3det_torch.geometry.iou import generalized_box3d_iou
from ov3det_torch.ops.hungarian import auction_lap
from ov3det_torch.parallel.mesh import data_group

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def huber_loss(error: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    """reference utils/misc.py:25-36."""
    abs_error = error.abs()
    quadratic = torch.clamp(abs_error, max=delta)
    linear = abs_error - quadratic
    return 0.5 * quadratic ** 2 + delta * linear


def _weighted_ce(logits, labels, class_weights, weight_sum=None):
    """Per-layer weighted-mean cross entropy: logits (L, B, Q, C), labels
    (L, B, Q) -> (L,), divided by the sum of the per-sample weights as
    torch's weighted 'mean' does (reference criterion.py:171-176), or by
    `weight_sum` (L,), the group's."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
    w = class_weights[labels]
    if weight_sum is None:
        weight_sum = w.sum((1, 2))
    return (nll * w).sum((1, 2)) / torch.clamp(weight_sum, min=1e-8)


def _take(per_gt, inds):
    """per_gt (B, G, ...) -> (L, B, Q, ...) at the matched GT index."""
    L = inds.shape[0]
    src = per_gt[None].expand(L, *per_gt.shape)
    idx = inds.reshape(*inds.shape, *([1] * (per_gt.dim() - 2)))
    return torch.gather(src, 2, idx.expand(*inds.shape, *per_gt.shape[2:]))


def compute_assignments(outputs: dict, targets: dict, cfg: LossConfig,
                        rotated_boxes: bool, with_giou_grad: bool = False) -> dict:
    """Matcher costs and the assignment of every decoder layer at once.

    Returns per_prop_gt_inds and proposal_matched_mask (L, B, Q), and the
    gious and center_dist matrices (L, B, Q, G) the losses reuse.  The GIoU
    is computed under autograd only when `with_giou_grad`.
    """
    pred_corners = outputs["box_corners"]
    L, B, Q = pred_corners.shape[:3]
    gt_corners = targets["gt_box_corners"]
    G = gt_corners.shape[1]
    nactual = targets["nactual_gt"]

    matcher_rotated = rotated_boxes and cfg.matcher_giou == "rotated"
    with torch.set_grad_enabled(with_giou_grad and torch.is_grad_enabled()):
        gious = generalized_box3d_iou(
            pred_corners.reshape(L * B, Q, 8, 3), gt_corners.repeat(L, 1, 1, 1),
            nactual.repeat(L), rotated_boxes=matcher_rotated,
            compute_dtype=_DTYPES[cfg.giou_compute_dtype],
        ).reshape(L, B, Q, G)

    center_dist = (outputs["center_normalized"][:, :, :, None, :]
                   - targets["gt_box_centers_normalized"][None, :, None, :, :]).abs().sum(-1)

    probs = outputs["sem_cls_prob"]
    gt_onehot = torch.nn.functional.one_hot(targets["gt_box_sem_cls_label"].long(),
                                            probs.shape[-1]).to(probs.dtype)
    cls_prob_at_gt = torch.einsum("lbqc,bgc->lbqg", probs, gt_onehot)
    m = cfg.matcher
    with torch.no_grad():
        cost = (m.cost_class * (-cls_prob_at_gt)
                + m.cost_objectness * (-outputs["objectness_prob"][..., None])
                + m.cost_center * center_dist
                + m.cost_giou * (-gious))
        # the auction takes (batch, persons = GT, objects = proposals)
        _, obj_assigned, obj2person = auction_lap(
            cost.reshape(L * B, Q, G).transpose(1, 2), nactual.repeat(L))
    return {
        "per_prop_gt_inds": obj2person.reshape(L, B, Q),
        "proposal_matched_mask": obj_assigned.reshape(L, B, Q),
        "gious": gious,
        "center_dist": center_dist,
    }


def set_criterion(outputs: dict, targets: dict, cfg: LossConfig, num_angle_bin: int,
                  num_semcls: int, teacher_feats: Optional[torch.Tensor] = None):
    """The criterion over stacked layer outputs (L, B, Q, ...).

    targets: the padded GT dict of the batch schema, as tensors on the
    outputs' device.  teacher_feats: the frozen 2D teacher's region
    features, (B, Q, C) shared by every layer or (L, B, Q, C), for the
    2D-alignment loss (per layer, the sum over (B, Q) of 1 - cosine with
    `visual_embeds`, in f32).  The losses divide by the box count of the
    whole batch: this batch's, or the group's under a data group (JAX's
    `num_boxes_global`).  Returns (total, loss_dict): `<name>_<l>` for the aux layers and bare
    names for the last, each weighted (or as it is where the weight is 0),
    `loss_cardinality` (log only) and `loss`, the total.  Under a data group
    `total` is this rank's share of the global loss (what it back-propagates)
    and `loss_dict` the global values, detached.
    """
    nactual = targets["gt_box_present"].sum(1).long()
    targets = dict(targets, nactual_gt=nactual)
    group = data_group()
    sharded = group is not None and group.sharded

    rotated = num_angle_bin > 1
    matcher_exact = (not rotated) or cfg.matcher_giou == "rotated"
    assign = compute_assignments(outputs, targets, cfg, rotated_boxes=rotated,
                                 with_giou_grad=matcher_exact and cfg.giou_weight > 0)
    inds = assign["per_prop_gt_inds"]
    matched = assign["proposal_matched_mask"]
    L = inds.shape[0]
    losses = {}

    box_label = _take(targets["gt_box_sem_cls_label"].long(), inds)
    box_label = torch.where(matched > 0, box_label, torch.full_like(box_label, num_semcls))
    class_weights = torch.ones(num_semcls + 1, device=inds.device)
    class_weights[-1:].fill_(cfg.no_object_weight)  # a fill, not a copy from the host
    num_boxes_global, weight_sum = nactual.sum().float(), None
    if sharded:  # the global box count and weight sums, in one all-reduce
        sums = torch.cat([num_boxes_global[None], class_weights[box_label].sum((1, 2))])
        torch.distributed.all_reduce(sums)
        num_boxes_global, weight_sum = sums[0], sums[1:]
    num_boxes = torch.clamp(num_boxes_global, min=1.0)
    losses["loss_sem_cls"] = _weighted_ce(outputs["sem_cls_logits"], box_label, class_weights,
                                          weight_sum)

    angle_cls_at = _take(targets["gt_angle_class_label"].long(), inds)
    logp = torch.log_softmax(outputs["angle_logits"], dim=-1)
    angle_ce = -torch.gather(logp, -1, angle_cls_at[..., None])[..., 0]
    losses["loss_angle_cls"] = (angle_ce * matched).sum((1, 2)) / num_boxes

    gt_res_norm = targets["gt_angle_residual_label"] / (math.pi / num_angle_bin)
    res_at_gt_bin = torch.gather(outputs["angle_residual_normalized"], -1,
                                 angle_cls_at[..., None])[..., 0]
    reg = huber_loss(res_at_gt_bin - _take(gt_res_norm, inds), delta=1.0)
    losses["loss_angle_reg"] = (reg * matched).sum((1, 2)) / num_boxes

    center_sel = torch.gather(assign["center_dist"], -1, inds[..., None])[..., 0]
    losses["loss_center"] = (center_sel * matched).sum((1, 2)) / num_boxes

    if matcher_exact or cfg.giou_weight <= 0:
        giou_sel = torch.gather(1.0 - assign["gious"], -1, inds[..., None])[..., 0]
    else:
        # axis-aligned matcher with an active GIoU loss: the exact rotated
        # GIoU on the matched pairs only (criterion.py:235-254)
        pred = outputs["box_corners"]
        P = pred.shape[0] * pred.shape[1] * pred.shape[2]
        g = generalized_box3d_iou(
            pred.reshape(P, 1, 8, 3), _take(targets["gt_box_corners"], inds).reshape(P, 1, 8, 3),
            torch.ones(P, dtype=torch.int64, device=pred.device), rotated_boxes=True,
            compute_dtype=_DTYPES[cfg.giou_compute_dtype])
        giou_sel = 1.0 - g.reshape(inds.shape)
    losses["loss_giou"] = (giou_sel * matched).sum((1, 2)) / num_boxes

    gt_sizes_at = _take(targets["gt_box_sizes_normalized"], inds)
    size_l1 = (outputs["size_normalized"] - gt_sizes_at).abs().sum(-1)
    losses["loss_size"] = (size_l1 * matched).sum((1, 2)) / num_boxes

    with torch.no_grad():
        pred_obj = (torch.argmax(outputs["sem_cls_logits"], -1) != num_semcls).float().sum(-1)
        card = (pred_obj - nactual[None].float()).abs()
        losses["loss_cardinality"] = (card.sum(-1) / (card.shape[-1] * group.world) if sharded
                                      else card.mean(-1))

    if teacher_feats is not None:  # 2D-alignment distillation (criterion.py:132-141)
        # in f32, but the norm of bf16 embeds in bf16 as JAX's: the squares'
        # f32 sum rounded to bf16, its root rounded to bf16
        t = teacher_feats.float() if teacher_feats.dim() == 4 else teacher_feats.float()[None]
        embeds = outputs["visual_embeds"]
        v = embeds.float()
        norm_v = ((v * v).sum(-1).to(torch.bfloat16).float().sqrt().to(torch.bfloat16).float()
                  if embeds.dtype == torch.bfloat16 else torch.linalg.vector_norm(v, dim=-1))
        cos = (v * t).sum(-1) / torch.clamp(norm_v * torch.linalg.vector_norm(t, dim=-1), min=1e-8)
        losses["loss_2dalignment"] = (1.0 - cos).sum((1, 2))

    weights = {
        "loss_sem_cls": cfg.sem_cls_weight,
        "loss_angle_cls": cfg.angle_cls_weight,
        "loss_angle_reg": cfg.angle_reg_weight,
        "loss_center": cfg.center_weight,
        "loss_size": cfg.size_weight,
        "loss_giou": cfg.giou_weight,
        "loss_2dalignment": cfg.alignment_2d_weight,
    }
    total = torch.zeros((), device=inds.device)
    loss_dict = {}
    for name, per_layer in losses.items():
        w = weights.get(name, 0.0)
        for l in range(L):
            key = name if l == L - 1 else f"{name}_{l}"
            loss_dict[key] = per_layer[l] * (w if w > 0 else 1.0)
        if w > 0:
            total = total + w * per_layer.sum()
    loss_dict["loss"] = total
    if sharded:  # the global values: the sum of the ranks' shares, in one all-reduce
        shares = torch.stack([v.detach() for v in loss_dict.values()])
        torch.distributed.all_reduce(shares)
        loss_dict = dict(zip(loss_dict, shares.unbind()))
    return total, loss_dict
