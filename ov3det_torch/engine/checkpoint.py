"""Checkpoints with the reference's latest / best / periodic semantics.

Counterpart of `ov3det/engine/checkpoint.py:40-119` (reference
utils/io.py:8-58, main.py:254-327): `checkpoint` every epoch,
`checkpoint_best` when AP25 improves, `checkpoint_{epoch:04d}` every N
epochs, and resume from the latest on restart (model and optimiser restored,
training continues at epoch + 1).

A checkpoint is one file, `torch.save` of `{"model": state_dict,
"optimizer": AdamW.state_dict(), "epoch": int}`, written under a temporary
name and renamed into place, so that a crash mid-write leaves the previous
checkpoint whole.  The optimiser's state is the port's own `AdamW`'s (`count`,
`mu`, `nu`): `count` carries the learning-rate schedule across a resume.  No
RNG state is saved: the training loop seeds the dropout generator from
(seed, iteration) each step.  Small scalars (`best_ap25`) ride in a
`<name>.extra.json` sidecar, as in the JAX package.

The frozen 2D teacher is never saved, which is what the JAX package's
`_split_teacher` (`ov3det/engine/checkpoint.py:19-36`) achieves by
stripping it from its state: in the port the teacher is no part of the
detector (`Training.teacher` sits beside it, its weights are buffers of its
own module, not in the optimiser), so a checkpoint holds the detector and
its optimiser alone, the same file as a point-only run's.  On resume the
teacher is rebuilt from the RegionCLIP checkpoint it came from, or from its
seed and a recalibration on the same canvas, which are deterministic
(`ov3det_torch.main.build_teacher`).  The device image bank is not ported
(ROADMAP Queue 1 item 8).
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Optional

import torch

from ov3det_torch.engine.train import AdamW


class CheckpointManager:
    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, name: str) -> str:
        return os.path.join(self.directory, name)

    def save(self, model: torch.nn.Module, optimizer: AdamW, epoch: int,
             name: str = "checkpoint", extra: Optional[dict] = None) -> str:
        payload = {"model": model.state_dict(), "optimizer": optimizer.state_dict(),
                   "epoch": int(epoch)}
        path = self._path(name)
        fd, tmp = tempfile.mkstemp(dir=self.directory, prefix=f".{name}.")
        try:
            with os.fdopen(fd, "wb") as fh:
                torch.save(payload, fh)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        if extra:
            self.write_extra(extra, name)
        return path

    def write_extra(self, extra: dict, name: str = "checkpoint"):
        """Small scalar payload (the reference's best_val_metrics, utils/io.py:8-30,
        stored inside checkpoint.pth): a JSON sidecar, so that the training
        loop can refresh the best-AP bookkeeping without rewriting the
        checkpoint itself."""
        path = self._path(name) + ".extra.json"
        with open(path + ".tmp", "w") as fh:
            json.dump({k: float(v) for k, v in extra.items()}, fh)
        os.replace(path + ".tmp", path)

    def save_latest(self, model, optimizer, epoch, extra=None):
        return self.save(model, optimizer, epoch, "checkpoint", extra)

    def save_best(self, model, optimizer, epoch, extra=None):
        return self.save(model, optimizer, epoch, "checkpoint_best", extra)

    def save_periodic(self, model, optimizer, epoch, extra=None):
        return self.save(model, optimizer, epoch, f"checkpoint_{epoch:04d}", extra)

    def restore(self, model: torch.nn.Module, optimizer: Optional[AdamW] = None,
                name: str = "checkpoint"):
        """Load a checkpoint into `model` (and `optimizer`, when given), on
        the model's device; returns `(payload, epoch, extra)`, or
        `(None, -1, None)` when the checkpoint is absent.  Resume semantics
        match reference utils/io.py:33-58: the caller continues at epoch + 1.
        """
        path = self._path(name)
        if not os.path.isfile(path):
            return None, -1, None
        device = next(model.parameters()).device
        payload = torch.load(path, map_location=device, weights_only=True)
        model.load_state_dict(payload["model"])
        if optimizer is not None:
            optimizer.load_state_dict(payload["optimizer"])
        extra = None
        if os.path.isfile(path + ".extra.json"):
            with open(path + ".extra.json") as fh:
                extra = json.load(fh)
        return payload, int(payload["epoch"]), extra


def restore_eval_checkpoint(model: torch.nn.Module, test_ckpt: Optional[str] = None,
                            checkpoint_dir: Optional[str] = None) -> int:
    """Load `--test_ckpt` (one checkpoint file, reference main.py:374-375), or
    else `checkpoint_dir`'s latest checkpoint, into `model`; returns its
    epoch."""
    if test_ckpt:
        ckpt_dir, name = os.path.split(os.path.abspath(test_ckpt))
    else:
        if not checkpoint_dir:
            raise ValueError("set --test_ckpt or --checkpoint_dir")
        ckpt_dir, name = checkpoint_dir, "checkpoint"
    payload, epoch, _ = CheckpointManager(ckpt_dir).restore(model, name=name)
    if payload is None:
        raise FileNotFoundError(f"no checkpoint at {os.path.join(ckpt_dir, name)}")
    return epoch
