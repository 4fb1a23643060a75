"""PointNet++-style set abstraction of the port.

Counterpart of `ov3det/models/pointnet.py:31-87` on its bucketed path:
FPS -> fused ball-group (the kernels) -> shared MLP (Dense + BatchNorm + ReLU
per width) -> max-pool over the neighbour axis.  The ball-group emits the
neighbour-major (B, K, M, 3 + C) layout, so the pool reduces axis 1.
In training mode the BatchNorms use the batch statistics.  After each
Dense, `bn_relu` runs the BatchNorm, the ReLU and, at the last width, the
max-pool: on CUDA tensors as the kernels of `ops/kernels/bn_relu.py`
(`BnRelu`, forward and backward), on CPU tensors as the module expression
`relu(BatchNorm(y))` and `amax` (`bn_relu_plain`).  No gradient
reaches the grouped coordinates: the selection carries none in JAX either.
The features do get one (the ball-group's backward, `BallGroup`): the
masked encoder's interim set abstraction groups the encoder's 256-channel
token features and trains through them.  The pre-encoder groups the raw
input colour, or nothing.

`ball_query_method="first_k"` (reference 3DETR checkpoints) takes
`ball_query` + `group_points` instead (`pointnet.py:68-73` of the JAX
package): the (B, M, K, 3 + C) layout, pooled over axis 2.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from ov3det_torch.models.mlp import BatchNorm, Dense
from ov3det_torch.ops.kernels.bn_relu import (
    bn_relu_apply,
    bn_relu_grad_apply,
    bn_relu_grad_sums,
    bn_stats,
)
from ov3det_torch.ops.pointcloud import (
    ball_group,
    ball_query,
    furthest_point_sample,
    gather_points,
    group_points,
)
from ov3det_torch.parallel.mesh import data_group


def bn_relu_plain(y: torch.Tensor, norm: BatchNorm,
                  pool_axis: Optional[int] = None) -> torch.Tensor:
    """The module expression: `norm` (which updates its running statistics
    in training mode), then `torch.relu`, then the max over `pool_axis` when
    given."""
    h = torch.relu(norm(y))
    return h if pool_axis is None else h.amax(dim=pool_axis)


class BnRelu(torch.autograd.Function):
    """relu(BatchNorm(y)) [max over `pool_axis`] through the four kernels.

    Forward: in training mode `bn_stats`, then the norm's own `statistics`
    (the global batch's under a sharded data group, the running statistics
    updated); in eval mode the running statistics; then `bn_relu_apply`.  It
    saves y, the channels' mean, scale, bias and rsqrt(var + eps) (and the
    pooled output): no f32 copy of y.  Backward (training mode only; no
    caller takes a gradient through an eval-mode module): `bn_relu_grad_sums`;
    under a sharded group the two sums all-reduced for the input gradient
    (dweight and dbias stay this rank's, which the step sums with the other
    gradients); then `bn_relu_grad_apply`.  Returns dy, dweight, dbias."""

    @staticmethod
    def forward(ctx, y, weight, bias, norm, pool_axis):
        if norm.training:
            mean, var, var_raw, count = norm.statistics(bn_stats(y), y.numel() // y.shape[-1])
        else:
            mean, var, var_raw, count = norm.running_mean, norm.running_var, None, None
        s = torch.rsqrt(var + norm.eps)
        scale = s * weight
        out = bn_relu_apply(y, mean, scale, bias, pool_axis)
        ctx.pool_axis, ctx.count = pool_axis, count
        group = data_group()
        ctx.sharded = norm.training and group is not None and group.sharded
        ctx.save_for_backward(y, mean, scale, bias, s, var_raw,
                              out if pool_axis is not None else None)
        return out

    @staticmethod
    def backward(ctx, grad):
        y, mean, scale, bias, s, var_raw, pooled = ctx.saved_tensors
        if var_raw is None:
            raise RuntimeError("BnRelu: no gradient through an eval-mode BatchNorm; train the "
                               "module, or run it under torch.no_grad()")
        sums, q = bn_relu_grad_sums(y, grad, mean, scale, bias, s, ctx.pool_axis, pooled)
        total = sums
        if ctx.sharded:
            total = sums.clone()
            dist.all_reduce(total)
        dy = None
        if ctx.needs_input_grad[0]:
            dy = bn_relu_grad_apply(y, grad, mean, scale, bias, s, total, ctx.count, var_raw,
                                    ctx.pool_axis, pooled, q)
        return dy, sums[1], sums[0], None, None


def bn_relu(y: torch.Tensor, norm: BatchNorm, pool_axis: Optional[int] = None) -> torch.Tensor:
    """relu(norm(y)), then the max over `pool_axis` when given: the kernels
    (`BnRelu`) for a CUDA tensor, the module expression (`bn_relu_plain`)
    for a CPU one."""
    if y.device.type == "cuda":
        return BnRelu.apply(y, norm.weight, norm.bias, norm, pool_axis)
    return bn_relu_plain(y, norm, pool_axis)


class PointnetSAModule(nn.Module):
    def __init__(self, npoint: int, radius: float, nsample: int, in_channels: int,
                 mlp_dims: Sequence[int], compute_dtype: Optional[torch.dtype] = None,
                 ball_query_method: str = "bucketed"):
        super().__init__()
        self.ball_query_method = ball_query_method
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
        if self.ball_query_method == "bucketed":
            h = ball_group(xyz, features, new_xyz, self.radius, self.nsample)  # (B, K, M, 3 + C)
            k_axis = 1
        else:
            inds_k = ball_query(xyz, new_xyz, self.radius, self.nsample)
            h = group_points(xyz, features, new_xyz, inds_k, self.radius)  # (B, M, K, 3 + C)
            k_axis = 2
        last = len(self.layers) - 1
        for i, (layer, norm) in enumerate(zip(self.layers, self.norms)):
            h = bn_relu(layer(h), norm, k_axis if i == last else None)
        return new_xyz, h, inds
