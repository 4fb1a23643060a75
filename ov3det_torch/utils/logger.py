"""Scalar logging: JSONL always, TensorBoard when available.

A copy of `ov3det/utils/logger.py:16-48` (reference utils/logger.py:14-31,
the tensorboardX Logger) with
the same `log_scalars(dict, step, prefix)` surface; additionally appends
every scalar group to `<dir>/scalars.jsonl` so runs are inspectable without
TensorBoard.
"""
from __future__ import annotations

import json
import os
import time
from typing import Optional


class Logger:
    def __init__(self, log_dir: Optional[str] = None):
        self.log_dir = log_dir
        self._jsonl = None
        self._writer = None
        if log_dir is not None:
            os.makedirs(log_dir, exist_ok=True)
            self._jsonl = open(os.path.join(log_dir, "scalars.jsonl"), "a")
            try:
                from tensorboardX import SummaryWriter

                self._writer = SummaryWriter(log_dir)
            except ImportError:
                self._writer = None

    def log_scalars(self, scalar_dict: dict, step: int, prefix: Optional[str] = None):
        if self.log_dir is None:
            return
        row = {"step": int(step), "time": time.time()}
        for k, v in scalar_dict.items():
            v = float(v)
            name = f"{prefix}{k}" if prefix else k
            row[name] = v
            if self._writer is not None:
                self._writer.add_scalar(name, v, step)
        self._jsonl.write(json.dumps(row) + "\n")
        self._jsonl.flush()

    def close(self):
        if self._jsonl:
            self._jsonl.close()
        if self._writer:
            self._writer.close()
