"""The device image bank: every scene's canvas on the card, once.

Counterpart of `ov3det/datasets/image_bank.py:33-89`; the yuv420 codec is
the packed transfer's (`ov3det_torch.datasets.loader`, copied from
`ov3det/datasets/loader.py:131-168, 346-367`).  The only reader of the canvases is the
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

from ov3det_torch.datasets.loader import yuv420_decode_rows, yuv420_encode, yuv_sample_bytes

__all__ = ["BankRefDataset", "build_image_bank", "yuv420_decode_rows", "yuv420_encode",
           "yuv_sample_bytes"]


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
