"""PointNet++-style set abstraction of the port.

Counterpart of `ov3det/models/pointnet.py:31-87` on its bucketed path:
FPS -> fused ball-group (the kernels) -> shared MLP (Dense + BatchNorm + ReLU
per width) -> max-pool over the neighbour axis.  The ball-group emits the
neighbour-major (B, K, M, 3 + C) layout, so the pool reduces axis 1.
In training mode the BatchNorms use the batch statistics.  No gradient
reaches the grouped coordinates: the selection carries none in JAX either.
The features do get one (the ball-group's backward, `BallGroup`): the
masked encoder's interim set abstraction groups the encoder's 256-channel
token features and trains through them.  The pre-encoder groups the raw
input colour, or nothing.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ov3det_torch.models.mlp import BatchNorm, Dense
from ov3det_torch.ops.pointcloud import ball_group, furthest_point_sample, gather_points


class PointnetSAModule(nn.Module):
    def __init__(self, npoint: int, radius: float, nsample: int, in_channels: int,
                 mlp_dims: Sequence[int], compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.npoint = npoint
        self.radius = radius
        self.nsample = nsample
        dims = [3 + in_channels, *mlp_dims]
        self.layers = nn.ModuleList(
            Dense(a, b, bias=False, compute_dtype=compute_dtype)
            for a, b in zip(dims[:-1], dims[1:])
        )
        self.norms = nn.ModuleList(BatchNorm(d) for d in mlp_dims)

    def forward(self, xyz: torch.Tensor, features: Optional[torch.Tensor] = None):
        """xyz (B, N, 3), features (B, N, C) or None -> (new_xyz (B, npoint, 3),
        new_features (B, npoint, mlp_dims[-1]), fps_inds (B, npoint))."""
        inds = furthest_point_sample(xyz, self.npoint)
        new_xyz = gather_points(xyz, inds)
        h = ball_group(xyz, features, new_xyz, self.radius, self.nsample)  # (B, K, M, 3 + C)
        for layer, norm in zip(self.layers, self.norms):
            h = torch.relu(norm(layer(h)))
        return new_xyz, h.amax(dim=1), inds
