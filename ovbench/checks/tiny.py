"""Tiny copies of the benchmark's configurations and cells for the CPU
tests: every width cut so that a run takes seconds on the CPU, the
structure (the vanilla and the masked encoder, the teacher, the heads)
kept.  1024 pre-encoder tokens keep the fused attention's path (its hashed
dropout, the masked layer's radius) in the tiny models."""
from __future__ import annotations

import copy
import os
import sys
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from ovbench import harness  # noqa: E402


def config(name: str, compute_dtype: str = "float32") -> dict:
    cfg = copy.deepcopy(harness.config(name))
    m = cfg["model"]
    m["encoder"].update(dim=64, ffn_dim=64, num_heads=4)
    m["decoder"].update(dim=64, ffn_dim=64, num_layers=2)
    m.update(preenc_npoints=1024, num_queries=16, clip_embed_dim=64, preenc_nsample=16,
             preenc_mlp=[16, 32, 64], compute_dtype=compute_dtype)
    if m["encoder"]["kind"] == "masked":
        m.update(interim_nsample=8, interim_mlp=[64, 64, 64])
    cfg["data"].update(num_points=2048, batch_size_per_device=2, max_num_obj=8)
    if cfg["teacher"].get("enabled"):
        cfg["teacher"].update(width=16, layers=[1, 1, 1, 1], embed_dim=64)
    return cfg


def cell(name: str) -> dict:
    spec = harness.workload(name)
    spec["traffic_params"] = dict(spec["traffic_params"], pool=4)
    if spec["traffic"] == "detect":
        spec["traffic_params"].update(checked=2, sample=2)
    return spec


def args(workload: str, seed: int = 12345, seconds: float = 0.5, trace: int = 0):
    return SimpleNamespace(workload=workload, seed=seed, seconds=seconds, trace=trace)
