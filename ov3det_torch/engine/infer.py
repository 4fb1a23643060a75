"""Serving entry points: the eval step and a detector that answers requests.

Counterpart of `make_eval_step` (`ov3det/engine/train.py:273-314`) followed
by `parse_predictions_device` and `assemble_predictions`
(`ov3det/eval/parse.py:53-151`), the eval loop shape of
`ov3det/main.py:344-376`: a batch of scenes in, detections out.

JAX runs the eval step and the parse as jitted programs; on a card the port
runs each as one CUDA-graph replay (`GraphedEval`): the eval step's forward
(and criterion, with the loss), and the detector's forward and parse.  A
graph is captured once for each signature of inputs, (B, N) for a batch of
scenes, and replayed for every later batch of that signature; the loader
pads a last partial batch to full size, so an eval pass sees one.  A
replay's outputs are the graph's static tensors, valid until the next call
of the same step: every consumer copies what it needs to the host before
that (`APCalculator.step_meter`, `LabelFormatter.step`, `Detector.detect`).
The CPU, `--debug_nans` and a data group (whose criterion all-reduces) run
the same functions eagerly.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ov3det_torch.config import LossConfig, ModelConfig, TrainConfig
from ov3det_torch.eval.parse import assemble_predictions, parse_predictions
from ov3det_torch.losses.criterion import set_criterion
from ov3det_torch.models.detr3d import Model3DETR, last_layer_outputs
from ov3det_torch.parallel.mesh import data_group

INPUT_KEYS = ("point_clouds", "point_cloud_dims_min", "point_cloud_dims_max")


class GraphedEval:
    """`fn(inputs)` (a dict of tensors -> tensors in dicts and tuples, no
    side effect on the state) as one CUDA-graph replay a call.

    graph (default: on a CUDA device outside a data group): the first call
    with a signature (the inputs' keys, shapes and dtypes) runs `fn`
    eagerly on a side stream, which warms up what it touches, and returns
    that result; then `fn` on static copies of the inputs is captured once.
    `keys` names the inputs `fn` reads (None: every tensor of the dict).
    Every later call copies its inputs into the static ones and replays,
    and returns the static outputs, valid until the next call.  A capture
    that fails raises.  `graph` False (or a CPU device) calls `fn`."""

    def __init__(self, fn: Callable[[dict], object], device, graph: Optional[bool] = None,
                 keys: Optional[tuple] = None):
        self.fn, self.keys = fn, keys
        self.device = torch.device(device)
        if graph is None:
            graph = self.device.type == "cuda" and data_group() is None
        if graph and self.device.type != "cuda":
            raise ValueError("a CUDA graph needs a CUDA device")
        self.graph = graph
        self._graphs: dict = {}  # signature -> (graph, static inputs, static outputs)

    def __call__(self, inputs: dict):
        inputs = {k: v for k, v in inputs.items()
                  if isinstance(v, torch.Tensor) and (self.keys is None or k in self.keys)}
        if not self.graph:
            return self.fn(inputs)
        key = tuple((k, tuple(v.shape), v.dtype) for k, v in inputs.items())
        if key not in self._graphs:
            return self._capture(key, inputs)
        _, static_in, static_out = self._graphs[key]
        for k, v in inputs.items():
            static_in[k].copy_(v)
        self._replay(key)
        return static_out

    def _capture(self, key, inputs: dict):
        """The eager warm-up on a side stream, then the capture."""
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            static_in = {k: v.clone() for k, v in inputs.items()}
            out = self.fn(static_in)
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        static_out = self._record(graph, side, static_in)
        self._graphs[key] = (graph, static_in, static_out)
        return out

    def _record(self, graph, stream, static_in: dict):
        """Capture `fn` on the static inputs into `graph`: its static outputs."""
        with torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
            return self.fn(static_in)

    def _replay(self, key) -> None:
        self._graphs[key][0].replay()


def make_eval_step(model: Model3DETR, loss_cfg: Optional[LossConfig] = None,
                   num_angle_bin: int = 1, num_semcls: int = 18,
                   graph: Optional[bool] = None) -> GraphedEval:
    """Eval forward (`ov3det/engine/train.py:273-315`): batch dict of
    tensors -> the final decoder layer's outputs (what evaluation consumes).
    With `loss_cfg` it returns `(outputs, loss_dict)`, the criterion over
    every decoder layer's outputs, as the reference's evaluate logs it
    (engine.py:198-206); the batch then carries the GT of the training
    schema.  Puts the model in eval mode.  On a card the step is a
    `GraphedEval` replay (`graph` as there): its outputs are valid until
    the next call."""

    def eval_step(batch: dict):
        model.eval()
        with torch.inference_mode():
            outputs = model({k: batch[k] for k in INPUT_KEYS})
            if loss_cfg is None:
                return last_layer_outputs(outputs)
            _, loss_dict = set_criterion(outputs, batch, loss_cfg, num_angle_bin=num_angle_bin,
                                         num_semcls=num_semcls)
            return last_layer_outputs(outputs), loss_dict

    # the forward reads the scenes; the criterion the whole batch
    return GraphedEval(eval_step, next(model.parameters()).device, graph,
                       keys=INPUT_KEYS if loss_cfg is None else None)


class Detector:
    """A detector on one device: `detect(batch)` returns one
    `(classes (M,), corners (M, 8, 3), scores (M,))` triple per scene.

    `cfg` is a `TrainConfig` (its model part is used) or a `ModelConfig`.
    `state_dict` is a port state_dict (see `models.convert`); without one the
    weights are the seeded random initialisation.  `device` defaults to
    CUDA and raises when no card is present.  On a card a request's forward
    and parse are one CUDA-graph replay (`request`, a `GraphedEval`; its
    `graph` False runs them eagerly); `eval_step` is the eager forward."""

    def __init__(self, cfg: TrainConfig | ModelConfig, state_dict: Optional[dict] = None,
                 device=None, seed: int = 0):
        if isinstance(cfg, TrainConfig):
            cfg = cfg.model
        self.model = Model3DETR(cfg, device=device, seed=seed)
        if state_dict is not None:
            self.model.load_state_dict(state_dict)
        self.device = next(self.model.parameters()).device
        self.eval_step = eval_step = make_eval_step(self.model, graph=False)

        def forward_and_parse(inputs: dict) -> tuple:
            out = eval_step(inputs)
            keep, _ = parse_predictions(out["box_corners"], out["sem_cls_prob"],
                                        out["objectness_prob"], inputs["point_clouds"])
            return out["box_corners"], out["sem_cls_prob"], out["objectness_prob"], keep

        # a closure, not a bound method: no cycle through the detector, so
        # the graph's memory goes with the last reference to the detector
        self.request = GraphedEval(forward_and_parse, self.device)

    def detect(self, batch: dict) -> list:
        """batch: numpy arrays of `INPUT_KEYS` (point_clouds (B, N, 3), dims (B, 3))."""
        with torch.inference_mode():
            inputs = {k: torch.as_tensor(np.asarray(batch[k], np.float32)).to(self.device)
                      for k in INPUT_KEYS}
            host = [t.cpu().numpy() for t in self.request(inputs)]
        return assemble_predictions(*host)
