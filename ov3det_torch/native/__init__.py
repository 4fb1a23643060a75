"""Native (C++) host code, built with g++ at first use and loaded with ctypes.

Two sources live here: `rotated_iou.cpp`, the host-side rotated 3D IoU of
the VOC evaluation (a copy of `ov3det/native/__init__.py` for the port), and
`jpeg_decode.cpp`, the datasets' JPEG decoder (`ov3det_torch/utils/jpeg.py`).
Each is built into `ov3det_torch/_build/` under a name that carries a hash
of the source and the flags, never when a module is imported.  Without a
compiler the evaluation uses the vectorized numpy IoU (`geometry/iou_np.py`),
as the JAX package does; the first IoU call prints which of the two serves
this process.  Neither is a device kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "rotated_iou.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_lock = threading.Lock()
_state: dict = {}  # "lib": the loaded library or None once resolved


def library_path(source: Path = SOURCE) -> Path:
    digest = hashlib.sha256(source.read_bytes() + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{source.stem}-{digest}.so"


def build_library(source: Path) -> tuple[Path, Optional[str]]:
    """The built library of `source`: its path, and the reason of a failure
    or None.  Compiles into a temporary name, then renames, so that
    concurrent builds (test workers) never load a half-written library."""
    path = library_path(source)
    if path.is_file():
        return path, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so")
    os.close(fd)
    try:
        subprocess.run(["g++", *FLAGS, "-o", tmp, str(source)], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, path)
        return path, None
    except subprocess.CalledProcessError as exc:
        return path, f"g++ failed: {exc.stderr.decode(errors='replace')[-2000:]}"
    except (OSError, subprocess.SubprocessError) as exc:
        return path, f"{type(exc).__name__}: {exc}"
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load():
    with _lock:
        if "lib" in _state:
            return _state["lib"]
        path, why = build_library(SOURCE)
        lib = None
        if why is None:
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as exc:
                why = str(exc)
        if lib is not None:
            lib.box3d_iou_batch.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_double),
            ]
            lib.box3d_iou_batch.restype = None
            print(f"rotated IoU of the evaluation: the C++ core ({path.name})")
        else:
            print(f"rotated IoU of the evaluation: numpy (the C++ core did not build: {why})")
        _state["lib"] = lib
        return lib


def native_available() -> bool:
    return _load() is not None


def box3d_iou_batch_native(corners1: np.ndarray, corners2: np.ndarray) -> Optional[np.ndarray]:
    """Pairwise rotated 3D IoU via the C++ core; None if unavailable.

    corners1 (M, 8, 3), corners2 (N, 8, 3) -> (M, N) float64.
    """
    lib = _load()
    if lib is None:
        return None
    c1 = np.ascontiguousarray(corners1, np.float32)
    c2 = np.ascontiguousarray(corners2, np.float32)
    if c1.shape[1:] != (8, 3) or c2.shape[1:] != (8, 3):
        raise ValueError(f"corners must be (M, 8, 3) and (N, 8, 3), got {c1.shape}, {c2.shape}")
    m, n = c1.shape[0], c2.shape[0]
    out = np.empty((m, n), np.float64)
    lib.box3d_iou_batch(
        c1.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), m,
        c2.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    return out
