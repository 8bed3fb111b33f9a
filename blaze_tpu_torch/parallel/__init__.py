"""The exchange tier inside one process (parallel/exchange.py): the
shuffle exchange (hash, single, round_robin, range), the coalesced AQE
reader and the broadcast exchange. The mesh tier of the JAX package
(parallel/{mesh,sharded,repartition,mesh_ops,mesh_exec}.py) waits for
ROADMAP 'Modules to port' item 7."""

from blaze_tpu_torch.parallel.exchange import (
    BroadcastExchangeExec,
    CoalescedShuffleReader,
    ShuffleExchangeExec,
    plan_coalesced_partitions,
)

__all__ = [
    "BroadcastExchangeExec",
    "CoalescedShuffleReader",
    "ShuffleExchangeExec",
    "plan_coalesced_partitions",
]
