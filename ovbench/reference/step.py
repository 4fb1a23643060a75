"""The training step as plain PyTorch: the forward in training mode, the
frozen teacher's region features, the set criterion, the backward, the
clipped AdamW update (the port's `engine/train.py` `make_train_step`)."""
from __future__ import annotations

import torch

from .criterion import as_attrs, set_criterion
from .optim import AdamW, lr_schedule
from .teacher import teacher_features

INPUT_KEYS = ("point_clouds", "point_cloud_dims_min", "point_cloud_dims_max")


class TrainStep:
    def __init__(self, model, cfg: dict, teacher=None):
        self.model, self.teacher = model, teacher
        self.loss = as_attrs(cfg["loss"])
        self.num_angle_bin = cfg["model"]["num_angle_bin"]
        self.num_semcls = cfg["model"]["num_semcls"]
        schedule = lr_schedule(cfg["optim"], cfg["max_epoch"], cfg["iters_per_epoch"])
        self.optimizer = AdamW(model.parameters(), cfg["optim"], schedule)
        self.assignments = []  # each step's matched GT a proposal (-1: none), on the host
        self.teacher_io = []  # each step's teacher (boxes, features), f32 on the host
        self.forward = None  # the first step's last layer: corners, class and objectness probabilities

    def __call__(self, batch: dict, generator: torch.Generator) -> dict:
        """One step on a batch of tensors; the loss dict as floats."""
        self.model.train()
        outputs = self.model({k: batch[k] for k in INPUT_KEYS}, generator)
        if self.forward is None:
            self.forward = tuple(outputs[k][-1].detach().float().cpu()
                                 for k in ("box_corners", "sem_cls_prob", "objectness_prob"))
        feats = None
        if self.teacher is not None:
            boxes, feats = teacher_features(self.teacher, batch, outputs)
            self.teacher_io.append((boxes.float().cpu(), feats.float().cpu()))
        record = {}
        total, losses = set_criterion(outputs, batch, self.loss, num_angle_bin=self.num_angle_bin,
                                      num_semcls=self.num_semcls, teacher_feats=feats,
                                      record=record)
        self.assignments.append(torch.where(record["proposal_matched_mask"] > 0,
                                            record["per_prop_gt_inds"], -1).cpu())
        for p in self.model.parameters():
            p.grad = None
        total.backward()
        self.optimizer.step()
        return {k: float(v.detach()) for k, v in losses.items()}
