"""Build the CUDA kernels of `ov3det_torch/csrc/` and bind them with ctypes.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled on its own
with `nvcc -gencode arch=compute_90a,code=sm_90a` into
`ov3det_torch/_build/lib<name>-<hash>.so` at first use.  The hash covers the
source, the shared headers (`csrc/*.cuh`) and the flags, so an edited source
is rebuilt and an unchanged one is loaded as it is.  Nothing here runs at import time: the CPU tests import
every module on machines without nvcc or a card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
KERNEL_SOURCES = ("fps", "ball_group", "feature_grad", "attention_fwd", "attention_bwd", "auction",
                  "nms", "quant_conv", "points_in_box", "first_k", "roi_align", "attn_pool",
                  "normalise", "bn_relu", "add_norm")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return path


def library_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str):
    """Start nvcc for one source; returns (target, tmp, process) or None
    when the library is already built."""
    target = library_path(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return target, tmp, proc


def build(names=KERNEL_SOURCES) -> dict:
    """Compile the named sources, one nvcc process each, all at once.

    Returns {name: compiler output} for the sources built now (the ptxas
    register and shared-memory report included); raises if one fails.
    """
    started = {name: _start(name) for name in names}
    logs, failed = {}, []
    for name, job in started.items():
        if job is None:
            continue
        target, tmp, proc = job
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(name)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, target)
    if failed:
        detail = "\n".join(f"--- {n}\n{logs[n]}" for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{detail}")
    return logs


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The ctypes handle of `csrc/<name>.cu`, built first if needed.

    `signatures` maps each C function to (argtypes, restype); every source
    also exports `ov3_error_string`.
    """
    lib = _loaded.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, (argtypes, restype) in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        lib.ov3_error_string.argtypes = [ctypes.c_int]
        lib.ov3_error_string.restype = ctypes.c_char_p
        _loaded[name] = lib
    return lib


def check(lib: ctypes.CDLL, status: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if status != 0:
        reason = lib.ov3_error_string(status).decode()
        raise RuntimeError(f"{what} kernel failed: CUDA error {status} ({reason})")
