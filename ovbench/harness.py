"""What every cell's run shares: finding a cell's files by name, building the
port's config from a configuration file, the device checks, the caches and
the per-layer readers.

A cell is `workloads/<cell>.json` (its configuration, its traffic kind and
that kind's parameters, its chips and its limits); its configuration is
`configs/<config>.json`; its traffic kind is `traffic/<kind>.py`, a module
with `run(ctx) -> dict`; a per-layer metric is `metrics/<metric>.py`, a
module with `read(ctx) -> float | None`.  Which metrics a cell reports is
`BENCHMARK.json`'s: an end-to-end or per-layer metric with a "workloads"
list is reported in those cells, one without in every cell that reports
the end-to-end metric it moves.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import os
import resource
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "ov3det")
CACHE = os.path.join(ROOT, ".ovbench_cache")


def load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def workload(name: str, here: str = HERE) -> dict:
    spec = load_json(os.path.join(here, "workloads", f"{name}.json"))
    spec["name"] = name
    return spec


def config(name: str, here: str = HERE) -> dict:
    return load_json(os.path.join(here, "configs", f"{name}.json"))


def _module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def traffic(kind: str, here: str = HERE):
    """The driver of a traffic kind: `traffic/<kind>.py`."""
    return _module(os.path.join(here, "traffic", f"{kind}.py"), f"ovbench_traffic_{kind}")


def reader(metric: str, here: str = HERE):
    """The reader of a per-layer metric: `metrics/<metric>.py`."""
    return _module(os.path.join(here, "metrics", f"{metric}.py"),
                   "ovbench_metric_" + metric.replace(".", "_"))


def cell_metrics(bench: dict, cell: str) -> tuple:
    """(end-to-end entries, per-layer entries) that `cell` reports."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return e2e, per_layer


def _replace(obj, values: dict):
    """A dataclass with the fields in `values` replaced, nested dataclasses
    replaced in turn; lists become tuples."""
    changes = {}
    for f in dataclasses.fields(obj):
        if f.name not in values:
            continue
        v = values[f.name]
        cur = getattr(obj, f.name)
        if dataclasses.is_dataclass(cur) and isinstance(v, dict):
            changes[f.name] = _replace(cur, v)
        else:
            changes[f.name] = tuple(v) if isinstance(v, list) else v
    return dataclasses.replace(obj, **changes)


def train_config(cfg: dict):
    """The port's `TrainConfig` of a configuration file: its `model`,
    `loss`, `optim` and `data` blocks over the port's defaults, the
    teacher's `enabled` and `compute_dtype`, and `max_epoch`."""
    from ov3det_torch.config import TrainConfig

    t = cfg.get("teacher", {})
    return _replace(TrainConfig(), {
        "model": cfg["model"], "loss": cfg["loss"], "optim": cfg["optim"], "data": cfg["data"],
        "teacher": {k: t[k] for k in ("enabled", "compute_dtype") if k in t},
        "max_epoch": cfg["max_epoch"]})


def set_cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the kernels themselves build into `ov3det_torch/_build/`)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(CACHE, sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def require_devices(chips: int) -> str | None:
    """None when CUDA holds `chips` cards, else why not."""
    import torch

    if not torch.cuda.is_available():
        return "torch.cuda.is_available() is false"
    if torch.cuda.device_count() < chips:
        return f"{torch.cuda.device_count()} CUDA devices, the cell asks for {chips}"
    return None


def forbidden_modules() -> list:
    """The loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def read_per_layer(entries: list, ctx) -> dict:
    """{name: {"value", "unit"}} of the per-layer metrics whose readers find
    something to read."""
    out = {}
    for m in entries:
        value = reader(m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def host_mark() -> tuple:
    """What the host did so far in this process: CPU seconds, context
    switches (voluntary, forced) and garbage collections by generation."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return (time.process_time(), ru.ru_nvcsw, ru.ru_nivcsw,
            tuple(g["collections"] for g in gc.get_stats()))


def host_detail(mark: tuple) -> dict:
    """The host's work since `mark` (`host_mark()`): where a window's time
    on the host went, beside its end-to-end numbers."""
    now = host_mark()
    return {"cpu_s": now[0] - mark[0], "switches": now[1] - mark[1],
            "forced_switches": now[2] - mark[2],
            "collections": [b - a for a, b in zip(mark[3], now[3])]}
