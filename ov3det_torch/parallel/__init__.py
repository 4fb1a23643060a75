"""Data parallelism of the port: the data group and its collectives."""
from ov3det_torch.parallel.mesh import (
    DataGroup,
    all_gather_rows,
    all_reduce_grads,
    all_reduce_sum,
    any_rank,
    data_group,
    gather_objects,
    init_data_group,
    replicate,
    shard_batch,
)

__all__ = ["DataGroup", "all_gather_rows", "all_reduce_grads", "all_reduce_sum", "any_rank",
           "data_group", "gather_objects", "init_data_group", "replicate", "shard_batch"]
