"""Serving entry points: the eval step and a detector that answers requests.

Counterpart of `make_eval_step` (`ov3det/engine/train.py:273-314`) followed
by `parse_predictions_device` and `assemble_predictions`
(`ov3det/eval/parse.py:53-151`), the eval loop shape of
`ov3det/main.py:344-376`: a batch of scenes in, detections out.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ov3det_torch.config import LossConfig, ModelConfig, TrainConfig
from ov3det_torch.eval.parse import assemble_predictions, parse_predictions
from ov3det_torch.losses.criterion import set_criterion
from ov3det_torch.models.detr3d import Model3DETR, last_layer_outputs

INPUT_KEYS = ("point_clouds", "point_cloud_dims_min", "point_cloud_dims_max")


def make_eval_step(model: Model3DETR, loss_cfg: Optional[LossConfig] = None,
                   num_angle_bin: int = 1, num_semcls: int = 18):
    """Eval forward (`ov3det/engine/train.py:273-315`): batch dict of
    tensors -> the final decoder layer's outputs (what evaluation consumes).
    With `loss_cfg` it returns `(outputs, loss_dict)`, the criterion over
    every decoder layer's outputs, as the reference's evaluate logs it
    (engine.py:198-206); the batch then carries the GT of the training
    schema.  Puts the model in eval mode."""

    def eval_step(batch: dict):
        model.eval()
        with torch.inference_mode():
            outputs = model({k: batch[k] for k in INPUT_KEYS})
            if loss_cfg is None:
                return last_layer_outputs(outputs)
            _, loss_dict = set_criterion(outputs, batch, loss_cfg, num_angle_bin=num_angle_bin,
                                         num_semcls=num_semcls)
            return last_layer_outputs(outputs), loss_dict

    return eval_step


class Detector:
    """A detector on one device: `detect(batch)` returns one
    `(classes (M,), corners (M, 8, 3), scores (M,))` triple per scene.

    `cfg` is a `TrainConfig` (its model part is used) or a `ModelConfig`.
    `state_dict` is a port state_dict (see `models.convert`); without one the
    weights are the seeded random initialisation.  `device` defaults to
    CUDA and raises when no card is present.
    """

    def __init__(self, cfg: TrainConfig | ModelConfig, state_dict: Optional[dict] = None,
                 device=None, seed: int = 0):
        if isinstance(cfg, TrainConfig):
            cfg = cfg.model
        self.model = Model3DETR(cfg, device=device, seed=seed)
        if state_dict is not None:
            self.model.load_state_dict(state_dict)
        self.device = next(self.model.parameters()).device
        self.eval_step = make_eval_step(self.model)

    def detect(self, batch: dict) -> list:
        """batch: numpy arrays of `INPUT_KEYS` (point_clouds (B, N, 3), dims (B, 3))."""
        inputs = {k: torch.as_tensor(np.asarray(batch[k], np.float32)).to(self.device)
                  for k in INPUT_KEYS}
        with torch.inference_mode():
            out = self.eval_step(inputs)
            keep, _ = parse_predictions(out["box_corners"], out["sem_cls_prob"],
                                        out["objectness_prob"], inputs["point_clouds"])
            host = [t.cpu().numpy() for t in (out["box_corners"], out["sem_cls_prob"],
                                              out["objectness_prob"], keep)]
        return assemble_predictions(*host)
