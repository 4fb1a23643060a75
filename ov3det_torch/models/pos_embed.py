"""Coordinate positional embeddings (Fourier features / sine).

Counterpart of `ov3det/models/pos_embed.py` at its defaults (3-d input,
Gaussian scale 1, coordinates normalised to the scene's box, temperature
1e4, scale 2 pi); output (B, N, d_pos) channels-last.  `gauss_B` is a
parameter, as in the JAX package (`ov3det/models/pos_embed.py:38-46`, which
keeps it in params and stops its gradient at use), so its `.grad` stays
None; the training step's AdamW still decays it, as optax does.  The
original torch code held it as a buffer.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ov3det_torch.geometry.boxes import shift_scale_points

_TEMPERATURE = 10000.0
_SCALE = 2 * math.pi


class PositionEmbeddingCoords(nn.Module):
    def __init__(self, d_pos: int, pos_type: str = "fourier"):
        super().__init__()
        if pos_type not in ("fourier", "sine"):
            raise ValueError(f"unknown pos_type {pos_type!r}")
        self.d_pos = d_pos
        self.pos_type = pos_type
        if pos_type == "fourier":
            if d_pos % 2:
                raise ValueError("fourier embedding needs an even d_pos")
            self.gauss_B = nn.Parameter(torch.zeros(3, d_pos // 2))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        if self.pos_type == "fourier":
            with torch.no_grad():
                self.gauss_B.normal_(generator=generator)

    def _fourier(self, xyz):
        feat = torch.matmul(xyz * (2.0 * math.pi), self.gauss_B.detach())
        return torch.cat([torch.sin(feat), torch.cos(feat)], dim=-1)

    def _sine(self, xyz):
        # per-coordinate interleaved sin/cos at geometric frequencies
        # (reference models/position_embedding.py:42-87)
        ndim = self.d_pos // xyz.shape[-1]
        if ndim % 2 != 0:
            ndim -= 1
        rems = self.d_pos - ndim * xyz.shape[-1]
        outs = []
        for d in range(xyz.shape[-1]):
            cdim = ndim + (2 if rems > 0 else 0)
            rems -= 2 if rems > 0 else 0
            dim_t = torch.arange(cdim, dtype=torch.float32, device=xyz.device)
            dim_t = _TEMPERATURE ** (2 * torch.div(dim_t, 2, rounding_mode="floor") / cdim)
            pos = (xyz[..., d] * _SCALE)[..., None] / dim_t
            inter = torch.stack([torch.sin(pos[..., 0::2]), torch.cos(pos[..., 1::2])], dim=-1)
            outs.append(inter.reshape(pos.shape[:-1] + (cdim,)))
        return torch.cat(outs, dim=-1)

    def forward(self, xyz, input_range):
        """xyz (B, N, 3), input_range ((B, 3) min, (B, 3) max) -> (B, N, d_pos)."""
        xyz = shift_scale_points(xyz.detach(), src_range=input_range)
        return self._fourier(xyz) if self.pos_type == "fourier" else self._sine(xyz)
