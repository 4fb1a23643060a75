"""The device image bank: every scene's canvas on the card, once.

Counterpart of `ov3det/datasets/image_bank.py:33-89` and the yuv420 codec
of `ov3det/datasets/loader.py:131-168, 346-367`, copied so that the port
imports nothing of the JAX package.  The only reader of the canvases is the
frozen 2D teacher, and a canvas never changes: `build_image_bank` encodes
each scene's canvas once into a yuv420 row (1.5 bytes a pixel: Y, then U and
V averaged over 2 x 2 pixels) and puts the (N_scenes, row_bytes) uint8 bank
on the model's device; `BankRefDataset` gives the training batches an int32
`image_ref` (the scene's row) in place of the canvas; the training step
gathers its rows and decodes them on the device before the teacher
(`ov3det_torch.engine.train.decode_banked_images`).  The decoded canvases
are the 4:2:0 round trip of the originals, not the originals.

The encoder is JAX's to the bit (integer full-range BT.601 scaled by 256,
every intermediate an integer below 2^24, exact in f32); the decoder is the
same arithmetic as JAX's `yuv420_decode_rows`, as plain torch on the device.
"""
from __future__ import annotations

import numpy as np
import torch


def yuv_sample_bytes(sample_shape) -> int:
    """Bytes of one sample's yuv420 row: (..., H, W, 3) with even H and W."""
    h, w = sample_shape[-3], sample_shape[-2]
    frames = int(np.prod(sample_shape[:-3], dtype=np.int64)) if len(sample_shape) > 3 else 1
    return frames * (h * w + 2 * (h // 2) * (w // 2))


# full-range BT.601 (JPEG) scaled by 256, as f32 rows of one product
_YUV_M = np.array([[77, 150, 29], [-43, -85, 128], [128, -107, -21]], np.float32).T


def yuv420_encode(img: np.ndarray) -> np.ndarray:
    """(..., H, W, 3) uint8 RGB -> one uint8 row [Y | U / 2x2 | V / 2x2]."""
    a = np.asarray(img)
    h, w = a.shape[-3], a.shape[-2]
    yuv = np.floor(
        (a.reshape(-1, 3).astype(np.float32) @ _YUV_M + 128.0) * (1.0 / 256.0)
    ).reshape(-1, h, w, 3)
    y, u, v = yuv[..., 0], yuv[..., 1] + 128.0, yuv[..., 2] + 128.0

    def sub(c):  # 2 x 2 box average, rounded half up; sums below 2^24
        c4 = c.reshape(-1, h // 2, 2, w // 2, 2)
        return np.floor((c4.sum(axis=(2, 4)) + 2.0) * 0.25)

    parts = [np.clip(y, 0, 255).astype(np.uint8).reshape(-1),
             np.clip(sub(u), 0, 255).astype(np.uint8).reshape(-1),
             np.clip(sub(v), 0, 255).astype(np.uint8).reshape(-1)]
    return np.concatenate(parts)


def yuv420_decode_rows(rows: torch.Tensor, shape) -> torch.Tensor:
    """yuv420 rows (B, row_bytes) uint8, laid out per sample as [Y | U | V]
    over its frames, -> uint8 RGB of `shape` (B, ..., H, W, 3), on the rows'
    device: nearest 2 x 2 chroma upsampling and the inverse JPEG matrix in
    f32, rounded half to even and clamped."""
    B = shape[0]
    h, w = shape[-3], shape[-2]
    F = int(np.prod(shape[:-3], dtype=np.int64)) // B  # frames a sample
    ny, nc = h * w, (h // 2) * (w // 2)
    y = rows[:, :F * ny].reshape(-1, h, w).float()

    def chroma(part):
        c = part.reshape(-1, h // 2, w // 2).repeat_interleave(2, 1).repeat_interleave(2, 2)
        return c.float() - 128.0

    u = chroma(rows[:, F * ny:F * (ny + nc)])
    v = chroma(rows[:, F * (ny + nc):])
    rgb = torch.stack([y + 1.402 * v, y - 0.344136 * u - 0.714136 * v, y + 1.772 * u], -1)
    return torch.clamp(torch.round(rgb), 0, 255).to(torch.uint8).reshape(shape)


def build_image_bank(dataset, device, key: str = "image") -> tuple:
    """Encode every scene's canvas once and put the bank on `device`.

    dataset: has `get_image(idx)` (the canvas alone) or `dataset[idx][key]`;
    every canvas uint8 (H, W, 3) of one even H and W.  Returns (bank, (H, W)):
    bank an (N, row_bytes) uint8 tensor on `device`."""
    get = getattr(dataset, "get_image", None) or (lambda i: dataset[i][key])
    rows, hw = [], None
    for i in range(len(dataset)):
        img = np.asarray(get(i))
        if img.dtype != np.uint8 or img.ndim != 3 or img.shape[-1] != 3:
            raise ValueError(f"{key} {i}: {img.dtype} {img.shape}, expected uint8 (H, W, 3)")
        if hw is None:
            hw = img.shape[:2]
            if hw[0] % 2 or hw[1] % 2:
                raise ValueError(f"{key}: {hw} is not on the 2 x 2 chroma grid")
        elif img.shape[:2] != hw:
            raise ValueError(f"{key} {i}: {img.shape[:2]}, the bank holds {hw}")
        rows.append(yuv420_encode(img))
    bank = torch.from_numpy(np.stack(rows)).to(device)
    return bank, (int(hw[0]), int(hw[1]))


class BankRefDataset:
    """A dataset's view for the bank: each sample's `key` canvas replaced by
    `<key>_ref`, its int32 row in the bank (the scene's index)."""

    def __init__(self, dataset, key: str = "image"):
        self.dataset = dataset
        self.key = key

    def __len__(self):
        return len(self.dataset)

    def __getattr__(self, name):  # scan_names and the rest
        if name.startswith("__") or name == "dataset":  # unpickling: not set yet
            raise AttributeError(name)
        return getattr(self.dataset, name)

    def __getitem__(self, idx: int) -> dict:
        d = dict(self.dataset[idx])
        d.pop(self.key)
        d[self.key + "_ref"] = np.int32(idx)
        return d
