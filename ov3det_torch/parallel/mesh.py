"""The data group: data parallelism over `torch.distributed`.

Counterpart of `ov3det/parallel/mesh.py:1-61`.  The JAX package shards the
global batch over a `data` mesh and lets GSPMD compute the global batch's
loss; here each rank is one process holding its rows `[r b, (r + 1) b)` of
the global batch, and the modules make the same computation explicit:

  * training-mode BatchNorm reduces (count, sum x, sum x^2) over the group
    (`models/mlp.py`), as `bn_axis_name` does;
  * the criterion divides by the global box count and the global sums of
    its weights, so that the local losses of the ranks add up to the global
    loss (`losses/criterion.py`);
  * the training step sums the gradients over the group in one all-reduce
    of one flat buffer, before the clip (`engine/train.py`);
  * the attention kernel's dropout seed is the shared draw plus the rank,
    and element-wise dropout masks are the rank's rows of one global draw
    (`models/transformer.py`, `models/mlp.py`).

There is no `DistributedDataParallel` wrapper.  Every module looks the group
up here, as the JAX kernels look the mesh up in `data_mesh()`: the group is
`torch.distributed`'s default process group, whoever started it
(`init_data_group`, `ov3det_torch.engine.runtime.init_multihost`, torchrun
or a test), and None when none is initialised.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class DataGroup:
    rank: int
    world: int
    backend: str

    @property
    def sharded(self) -> bool:
        """True when the batch is split: a world of 1 computes as no group."""
        return self.world > 1


def data_group() -> Optional[DataGroup]:
    """The initialised default process group, or None."""
    if not (dist.is_available() and dist.is_initialized()):
        return None
    return DataGroup(dist.get_rank(), dist.get_world_size(), dist.get_backend())


def init_data_group(rank: int, world: int, init_method: str, device: torch.device,
                    backend: Optional[str] = None) -> DataGroup:
    """Join the group of `world` ranks at `init_method` (`tcp://host:port` or
    `env://`) as `rank`; backend `nccl` for a CUDA device and `gloo` for the
    CPU unless given.  A group that is already initialised is used as it is."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        backend = backend or ("nccl" if device.type == "cuda" else "gloo")
        dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)
    return data_group()


def _flat(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def _unflat(flat: torch.Tensor, like: Sequence[torch.Tensor]) -> list:
    out, off = [], 0
    for t in like:
        out.append(flat[off:off + t.numel()].view_as(t))
        off += t.numel()
    return out


@torch.no_grad()
def replicate(tensors: Sequence[torch.Tensor]) -> None:
    """Overwrite `tensors` (parameters, buffers, optimiser moments) with rank
    0's values: one broadcast a dtype and device."""
    group = data_group()
    if group is None or not group.sharded:
        return
    buckets: dict = {}
    for t in tensors:
        buckets.setdefault((t.dtype, t.device), []).append(t)
    for ts in buckets.values():
        flat = _flat(ts)
        dist.broadcast(flat, src=0)
        for t, v in zip(ts, _unflat(flat, ts)):
            t.copy_(v)


def shard_batch(batch: dict) -> dict:
    """This rank's rows `[r b, (r + 1) b)` of a global batch (every array's
    leading axis), b = global rows / world."""
    group = data_group()
    if group is None or not group.sharded:
        return batch
    out = {}
    for k, v in batch.items():
        n = v.shape[0]
        if n % group.world:
            raise ValueError(f"{k}: {n} rows do not split over {group.world} ranks")
        b = n // group.world
        out[k] = v[group.rank * b:(group.rank + 1) * b]
    return out


@torch.no_grad()
def all_reduce_grads(params: Sequence[torch.nn.Parameter]) -> None:
    """Sum the gradients of `params` over the group in one all-reduce of one
    flat buffer.  A parameter without a gradient keeps none (its gradient is
    None on every rank: the same model runs everywhere)."""
    group = data_group()
    if group is None:
        return
    with_grad = [p for p in params if p.grad is not None]
    if not with_grad:
        return
    grads = [p.grad for p in with_grad]
    flat = _flat(grads)
    dist.all_reduce(flat)
    for p, g in zip(with_grad, _unflat(flat, grads)):
        p.grad = g


class _AllReduceSum(torch.autograd.Function):
    """y = sum over ranks of x, on every rank.  Every rank's loss uses y, and
    the loss of the step is the sum of the ranks' losses, so the gradient of
    x is the sum over ranks of the gradients of y."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad)
        return grad


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The differentiable sum of `x` over the group (x itself without one)."""
    group = data_group()
    if group is None:
        return x
    return _AllReduceSum.apply(x)


class _GatherRows(torch.autograd.Function):
    """The ranks' (b, ...) tensors stacked into (world b, ...) on every rank,
    through an all-reduce of a zeroed buffer (gloo has no all-gather of CUDA
    tensors).  A loss of the gathered rows is the same on every rank, so the
    backward hands each rank its own rows' gradient and no sum: a step that
    sums the gradients over the ranks then gets the gradient of that loss."""

    @staticmethod
    def forward(ctx, x, rank: int, world: int):
        b = x.shape[0]
        ctx.rows = (rank * b, (rank + 1) * b)
        out = x.new_zeros((world * b, *x.shape[1:]))
        out[rank * b:(rank + 1) * b] = x
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        lo, hi = ctx.rows
        return grad[lo:hi], None, None


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """`jax.lax.all_gather(x, axis_name, tiled=True)` over the group,
    differentiable as described in `_GatherRows`."""
    group = data_group()
    if group is None or not group.sharded:
        return x
    return _GatherRows.apply(x, group.rank, group.world)


def gather_objects(obj) -> list:
    """Every rank's picklable `obj`, in rank order (through the host)."""
    group = data_group()
    if group is None or not group.sharded:
        return [obj]
    out = [None] * group.world
    dist.all_gather_object(out, obj)
    return out


_HOST_GROUP: list = []  # [the default group, a gloo group of its ranks]


def _host_group():
    """A gloo group of the default group's ranks, made on first use (every
    rank makes it at the same call) and again after a new default group."""
    world = dist.group.WORLD
    if not _HOST_GROUP or _HOST_GROUP[0] is not world:
        _HOST_GROUP[:] = [world, dist.new_group(backend="gloo")]
    return _HOST_GROUP[1]


def leave_data_group() -> None:
    """Destroy the process groups, the host group's last reference first, so
    that no gloo group of this module outlives `destroy_process_group` into
    the interpreter's exit."""
    _HOST_GROUP.clear()
    dist.destroy_process_group()


def any_rank(flag: bool) -> bool:
    """True on every rank when `flag` is true on any (an all-reduce of the
    maximum): ranks that must leave a loop together agree on it.  The flag
    crosses on the host, over gloo, so that asking it every step does not
    make the host wait for the card as an NCCL all-reduce and its `.item()`
    would."""
    group = data_group()
    if group is None or not group.sharded:
        return flag
    t = torch.tensor([int(flag)])
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_host_group())
    return bool(t.item())
