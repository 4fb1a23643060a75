"""JPEG files -> numpy, without an imaging library.

The JAX package decodes the datasets' images with PIL
(`ov3det/datasets/sunrgbd.py:90-95`, `ov3det/datasets/image_utils.py:45`),
which the card's machine lacks.  `read_jpeg` decodes with
`ov3det_torch/native/jpeg_decode.cpp`, a baseline decoder that gives the
values libjpeg-turbo gives under PIL's defaults, `np.asarray(
PIL.Image.open(path))` (see the source for what it decodes and what it
refuses).  The library is built with g++ at first use, by `ensure_built`,
which the datasets call when they are constructed with `use_image=True`, so
that the loader's worker processes only load the built file.  There is no
fallback: without g++ the first use raises.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np

from ov3det_torch.native import build_library

SOURCE = Path(__file__).resolve().parents[1] / "native" / "jpeg_decode.cpp"

_lock = threading.Lock()
_state: dict = {}  # "lib": the loaded library


def ensure_built() -> ctypes.CDLL:
    """Build (once) and load the decoder; raises RuntimeError if it cannot."""
    with _lock:
        if "lib" in _state:
            return _state["lib"]
        path, why = build_library(SOURCE)
        if why is not None:
            raise RuntimeError(f"the JPEG decoder ({SOURCE.name}) did not build: {why}")
        lib = ctypes.CDLL(str(path))
        buf, size, err = ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p
        lib.ov3_jpeg_header.argtypes = [buf, size, ctypes.POINTER(ctypes.c_int32), err,
                                        ctypes.c_int]
        lib.ov3_jpeg_header.restype = ctypes.c_int
        lib.ov3_jpeg_decode.argtypes = [buf, size, ctypes.c_void_p, size, err, ctypes.c_int]
        lib.ov3_jpeg_decode.restype = ctypes.c_int
        _state["lib"] = lib
        return lib


def read_jpeg(path) -> np.ndarray:
    """A JPEG file -> the array `np.asarray(PIL.Image.open(path))` gives:
    uint8 (H, W, 3) RGB for a 3-component file, (H, W) for a greyscale one.
    Raises ValueError naming the file for a file the decoder refuses or
    that is truncated or corrupt."""
    lib = ensure_built()
    with open(path, "rb") as fh:
        data = fh.read()
    dims = (ctypes.c_int32 * 3)()
    err = ctypes.create_string_buffer(256)
    if lib.ov3_jpeg_header(data, len(data), dims, err, len(err)):
        raise ValueError(f"{path}: {err.value.decode(errors='replace')}")
    h, w, c = dims
    out = np.empty((h, w, 3) if c == 3 else (h, w), np.uint8)
    if lib.ov3_jpeg_decode(data, len(data), out.ctypes.data, out.nbytes, err, len(err)):
        raise ValueError(f"{path}: {err.value.decode(errors='replace')}")
    return out
