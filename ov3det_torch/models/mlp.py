"""Dense, normalisation and MLP building blocks with flax's numerics.

Counterpart of `ov3det/models/mlp.py`.  The cast sites follow flax, not
PyTorch habit:
  * `Dense` with a compute dtype casts its input and its f32 weights to that
    dtype and returns it; without one it computes in the promoted type of
    input and weights (f32).
  * `LayerNorm` and `BatchNorm` compute in f32 whatever their input and
    return f32, so the residual stream stays f32.
  * Parameters are stored in f32 and cast at use.
BatchNorm normalises each channel over all leading axes, with flax's
training-mode statistics (below).  Dropout follows flax `nn.Dropout`: per
element, a kept value is the IEEE quotient by the keep probability rounded
to the input's dtype, rounded to that dtype (0.9 is 0.8984375 in bf16), on
the CPU and on the card alike (`ops/kernels/add_norm.dropped`), with the
mask drawn from an explicit `torch.Generator`.  On CUDA tensors
LayerNorm, and the pre-norm residual x + dropout(branch) in front of it
(`LayerNorm.add`), run as the kernels of `ops/kernels/add_norm.py`
(`AddNorm`); CPU tensors keep the module expressions.

Under a data group (`ov3det_torch.parallel`) the two see the global batch,
as under the JAX package's mesh: BatchNorm's training statistics are
reduced over the ranks (`bn_axis_name`, `ov3det/models/mlp.py:38-51`), and
a dropout mask is the rank's rows of one draw over the global batch from
the generator every rank seeds alike, as JAX's partitionable threefry makes
each device's mask a slice of one global draw.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ov3det_torch.ops.kernels.add_norm import (
    add_norm,
    add_norm_grad,
    add_norm_plain,
    dropped,
    layer_norm_plain,
)
from ov3det_torch.parallel.mesh import all_reduce_sum, data_group

_TRUNC_STD = 0.87962566103423978  # std of the unit normal truncated to [-2, 2]


def dropout_mask(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
                 batch_dim: int = 0) -> Optional[torch.Tensor]:
    """The keep mask of flax `nn.Dropout` in training for a tensor like x:
    each element kept with probability 1 - rate (a uniform draw below it);
    None at rate 0.  Under a data group of world W the draw covers W times
    the rows of `batch_dim` and this rank keeps its own: the masks of the
    ranks differ, and together they are the mask of one rank holding the
    global batch."""
    if rate <= 0.0:
        return None
    if generator is None:
        raise ValueError("training-mode dropout needs a torch.Generator")
    keep_prob = 1.0 - rate
    world, rank = (g.world, g.rank) if (g := data_group()) else (1, 0)
    b = x.shape[batch_dim]
    shape = list(x.shape)
    shape[batch_dim] = b * world
    return (torch.rand(shape, generator=generator, device=x.device) < keep_prob).narrow(
        batch_dim, rank * b, b)


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
            batch_dim: int = 0) -> torch.Tensor:
    """flax `nn.Dropout` in training: the kept elements (`dropout_mask`)
    divided by the keep probability 1 - rate rounded to x's dtype, the
    quotient rounded to x's dtype (`dropped`), the rest zeroed; its VJP the
    same quotient of the incoming gradient."""
    return dropped(x, dropout_mask(x, rate, generator, batch_dim), 1.0 - rate)


class Dense(nn.Linear):
    """`nn.Linear` with flax `nn.Dense` numerics.

    `init` is "lecun" (flax's default, truncated normal of variance
    1/fan_in) or "xavier" (uniform, as the transformer layers use).
    """

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 compute_dtype: Optional[torch.dtype] = None, init: str = "lecun"):
        self.compute_dtype = compute_dtype
        self.init = init
        super().__init__(in_features, out_features, bias=bias)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        # nn.Linear.__init__ calls this without a generator: fill
        # deterministically and leave the global RNG alone; models draw
        # their weights from an explicit generator afterwards.
        with torch.no_grad():
            if self.bias is not None:
                self.bias.zero_()
            if generator is None:
                self.weight.zero_()
            elif self.init == "xavier":
                nn.init.xavier_uniform_(self.weight, generator=generator)
            else:
                std = 1.0 / math.sqrt(self.in_features) / _TRUNC_STD
                nn.init.trunc_normal_(self.weight, std=std, a=-2 * std, b=2 * std,
                                      generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or torch.promote_types(x.dtype, self.weight.dtype)
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class AddNorm(torch.autograd.Function):
    """LayerNorm(x + dropout(branch)) through the kernels of
    `ops/kernels/add_norm.py`, or LayerNorm(x) without a branch.

    Forward: `add_norm` gives x_new (f32), y (f32) and each row's mean, r
    and var_raw, which it saves with x_new (x without a branch), the weight
    and the keep mask; returns (x_new, y), or y alone without a branch.
    Backward: `add_norm_grad`, one kernel: dx (x's dtype) from y's gradient
    and, with a branch, x_new's own gradient added in f32; dbranch; dweight
    and dbias.  LayerNorm is per row, so a data group changes nothing: the
    mask is the rank's rows of one global draw (`dropout_mask`), and
    dweight and dbias stay the rank's, which the step sums with the other
    gradients."""

    @staticmethod
    def forward(ctx, x, branch, weight, bias, keep, keep_prob, eps):
        x_new, y, stats = add_norm(x, weight, bias, eps, branch, keep, keep_prob)
        ctx.dx_dtype, ctx.keep_prob = x.dtype, keep_prob
        ctx.branch_dtype = None if branch is None else branch.dtype
        ctx.save_for_backward(x if x_new is None else x_new, stats, weight, keep)
        return y if x_new is None else (x_new, y)

    @staticmethod
    def backward(ctx, *grads):
        x, stats, weight, keep = ctx.saved_tensors
        grad_res, grad_y = (None, grads[0]) if ctx.branch_dtype is None else grads
        dx, dbranch, sums = add_norm_grad(x, grad_y, stats, weight, ctx.dx_dtype, grad_res,
                                          ctx.branch_dtype, keep, ctx.keep_prob)
        return dx, dbranch, sums[0], sums[1], None, None, None


class LayerNorm(nn.Module):
    """flax `nn.LayerNorm` (fast variance, f32 compute) with eps 1e-5.

    On a CUDA tensor the kernels (`AddNorm`) run it, forward and backward;
    on a CPU tensor the module expression (`layer_norm_plain`: the mean and
    the mean of squares in f32, var = clamp(mean(x^2) - mean^2, 0), then
    (x - mean) * (rsqrt(var + eps) * weight) + bias).  `add` is the pre-norm
    residual in front of it, x + dropout(branch) with a mask of
    `dropout_mask`, fused into the same kernels."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.device.type == "cuda":
            return AddNorm.apply(x, None, self.weight, self.bias, None, 1.0, self.eps)
        return layer_norm_plain(x, self.weight, self.bias, self.eps)[0]

    def add(self, x: torch.Tensor, branch: torch.Tensor, keep: Optional[torch.Tensor] = None,
            keep_prob: float = 1.0) -> tuple:
        """(x_new, self(x_new)) with x_new = x + dropped(branch, keep,
        keep_prob): one launch of the kernels on a CUDA tensor, the module
        expressions on a CPU one."""
        if x.device.type == "cuda":
            return AddNorm.apply(x, branch, self.weight, self.bias, keep, keep_prob, self.eps)
        return add_norm_plain(x, self.weight, self.bias, self.eps, branch, keep, keep_prob)[:2]


class BatchNorm(nn.Module):
    """flax `nn.BatchNorm` (momentum 0.9, eps 1e-5) over all leading axes.

    Eval mode normalises with the running statistics.  Training mode, as
    flax computes it: the batch mean and the fast biased variance
    mean(x^2) - mean^2 (clamped at 0) in f32 over every axis but the last,
    the input normalised with them (the gradient flows through both), and
    the running statistics updated in place to 0.9 old + 0.1 batch with the
    biased variance.  `torch.nn.functional.batch_norm` would keep the
    unbiased variance instead, and so would `SyncBatchNorm`.  Under a data
    group the count, sum x and sum x^2 of each channel are summed over the
    ranks in one differentiable all-reduce, in f32, and every rank updates
    its running statistics with the same global values.
    """

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def statistics(self, sums: torch.Tensor, rows: int) -> tuple:
        """Training mode's (mean, var, var_raw, count) of each channel from its
        sum x and sum x^2 over `rows` rows ((2, C) f32): the mean and the fast
        biased variance var = clamp(mean x^2 - mean^2, 0) (var_raw before the
        clamp), over the data group's global batch when it is sharded (the
        count and the sums in one differentiable all-reduce; count then that
        (1,) tensor, else the float `rows`).  Updates the running statistics
        in place.  The module's forward and the set abstraction's kernels
        (`models/pointnet.py`) both take their statistics here."""
        group = data_group()
        if group is None or not group.sharded:
            count = float(rows)
            mean, mean2 = (sums / count).unbind(0)
        else:
            red = all_reduce_sum(torch.cat([sums.new_full((1,), rows), sums.reshape(-1)]))
            count = red[:1]
            mean, mean2 = (red[1:] / red[0]).chunk(2)
        var_raw = mean2 - mean * mean
        var = torch.clamp(var_raw, min=0.0)
        with torch.no_grad():
            self.running_mean.copy_(0.9 * self.running_mean + (1 - 0.9) * mean)
            self.running_var.copy_(0.9 * self.running_var + (1 - 0.9) * var)
        return mean, var, var_raw, count

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            axes = tuple(range(x.dim() - 1))
            sums = torch.stack([x.sum(axes), (x * x).sum(axes)])
            mean, var, _, _ = self.statistics(sums, x.numel() // x.shape[-1])
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


class GenericMLP(nn.Module):
    """Counterpart of flax `GenericMLP`: Dense [+ norm] + ReLU [+ dropout in
    training] per hidden width, then the output Dense [+ norm] [+ ReLU]."""

    def __init__(self, in_dim: int, hidden_dims: Sequence[int], output_dim: int,
                 norm: Optional[str] = None, dropout: float = 0.0,
                 hidden_use_bias: bool = False, output_use_bias: bool = True,
                 output_use_activation: bool = False, output_use_norm: bool = False,
                 compute_dtype: Optional[torch.dtype] = None, batch_dim: int = 0):
        super().__init__()
        if norm not in (None, "bn"):  # the detector's MLPs use no other
            raise ValueError(f"unknown norm {norm!r}")
        self.dropout = dropout
        self.batch_dim = batch_dim  # the batch axis of the input, for dropout under a group
        self.output_use_activation = output_use_activation
        dims = [in_dim, *hidden_dims]
        self.layers = nn.ModuleList(
            Dense(a, b, bias=hidden_use_bias, compute_dtype=compute_dtype)
            for a, b in zip(dims[:-1], dims[1:])
        )
        self.layers.append(Dense(dims[-1], output_dim, bias=output_use_bias,
                                 compute_dtype=compute_dtype))
        norm_dims = list(hidden_dims) if norm else []
        if norm and output_use_norm:
            norm_dims.append(output_dim)
        self.norms = nn.ModuleList(BatchNorm(d) for d in norm_dims)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        n_hidden = len(self.layers) - 1
        for i in range(n_hidden):
            x = self.layers[i](x)
            if self.norms:
                x = self.norms[i](x)
            x = F.relu(x)
            if self.training:
                x = dropout(x, self.dropout, generator, self.batch_dim)
        x = self.layers[-1](x)
        if len(self.norms) > n_hidden:
            x = self.norms[-1](x)
        if self.output_use_activation:
            x = F.relu(x)
        return x
