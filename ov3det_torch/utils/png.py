"""A small PNG reader for the lifting tools' depth and label images.

The JAX package reads them with PIL (`ov3det/tools/lift_boxes.py:129-134,
174-185`); the port reads them with `zlib` and numpy, so that it needs no
imaging library.  It handles what ScanNet and SUN RGB-D ship: greyscale
(colour type 0), 8 or 16 bits a sample, not interlaced, with any of the five
scanline filters (None, Sub, Up, Average, Paeth).  Every other PNG raises
`ValueError`.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunks(data: bytes):
    """(type, payload) of each chunk, the CRC checked."""
    pos = len(_SIGNATURE)
    while pos < len(data):
        if pos + 8 > len(data):
            raise ValueError("truncated PNG chunk header")
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        payload = data[pos + 8:pos + 8 + length]
        if len(payload) != length or pos + 12 + length > len(data):
            raise ValueError("truncated PNG chunk")
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + payload) != crc:
            raise ValueError(f"bad CRC in PNG chunk {kind!r}")
        yield kind, payload
        pos += 12 + length
        if kind == b"IEND":
            return
    raise ValueError("PNG without IEND")


def _paeth_row(raw: bytes, prior: bytearray, bpp: int) -> bytearray:
    out = bytearray(raw)
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        b = prior[i]
        c = prior[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (out[i] + pred) & 0xFF
    return out


def _average_row(raw: bytes, prior: bytearray, bpp: int) -> bytearray:
    out = bytearray(raw)
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        out[i] = (out[i] + ((a + prior[i]) >> 1)) & 0xFF
    return out


def _unfilter(data: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Scanlines (a filter byte each) -> (height, stride) uint8."""
    if len(data) != height * (stride + 1):
        raise ValueError(f"PNG image data holds {len(data)} bytes, expected "
                         f"{height * (stride + 1)}")
    rows = np.frombuffer(data, np.uint8).reshape(height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        kind, raw = rows[y, 0], rows[y, 1:]
        if kind == 0:
            row = raw
        elif kind == 1:  # Sub: a running sum, modulo 256, over each byte of a pixel
            row = np.cumsum(raw.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:  # Up
            row = raw + prior
        elif kind == 3:
            row = np.frombuffer(_average_row(raw.tobytes(), bytearray(prior.tobytes()), bpp),
                                np.uint8)
        elif kind == 4:
            row = np.frombuffer(_paeth_row(raw.tobytes(), bytearray(prior.tobytes()), bpp),
                                np.uint8)
        else:
            raise ValueError(f"unknown PNG filter type {kind}")
        out[y] = row
        prior = out[y]
    return out


def read_png(path: str) -> np.ndarray:
    """A greyscale PNG -> (H, W) uint8 (8 bits) or uint16 (16 bits), as
    `np.array(PIL.Image.open(path))` gives its values."""
    with open(path, "rb") as fh:
        data = fh.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, payload in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"IDAT":
            idat.append(payload)
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    width, height, depth, colour, compression, filtering, interlace = header
    if colour != 0 or depth not in (8, 16):
        raise ValueError(f"{path}: colour type {colour} at {depth} bits; only greyscale at 8 or 16 "
                         "bits is read")
    if compression != 0 or filtering != 0 or interlace != 0:
        raise ValueError(f"{path}: interlaced or non-standard PNG (compression {compression}, "
                         f"filter method {filtering}, interlace {interlace})")
    bpp = depth // 8
    pixels = _unfilter(zlib.decompress(b"".join(idat)), height, width * bpp, bpp)
    if depth == 8:
        return pixels.reshape(height, width)
    return pixels.view(">u2").reshape(height, width).astype(np.uint16)
