"""Sharded sparse subsystem of the port: id-range routed Theta shards
(§4, Fig. 5), the counterpart of ``repro.shard``.

``partition``     id-range partitioner + host-side batch routing
``plan_slicing``  TransposePlan slicing at id-range / sample boundaries
``step``          the sparse loss and gradient over a (data, model) mesh
"""
from repro_torch.shard.partition import (  # noqa: F401
    Partition,
    ShardCell,
    ShardedSparseBatch,
    balanced_partition,
    make_partition,
    route_batch,
    route_ids,
    shard_slot_width,
)
from repro_torch.shard.plan_slicing import (  # noqa: F401
    restrict_plan,
    shard_plan_grid,
    slice_plan,
)
from repro_torch.shard.step import (  # noqa: F401
    make_sharded_sparse_loss,
    sharded_sparse_loss_and_grad,
    sharded_sparse_nll,
)
