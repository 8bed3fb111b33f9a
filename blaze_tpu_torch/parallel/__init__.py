"""The exchange tier (parallel/exchange.py): the shuffle exchange (hash,
single, round_robin, range) with its map stage on threads or on a
MiniCluster's worker processes (local or remote block reads), the
coalesced AQE reader and the broadcast exchange; and the embedder-facing
shuffle manager (parallel/shuffle_manager.py). The mesh tier of the JAX
package (parallel/{mesh,sharded,repartition,mesh_ops,mesh_exec}.py)
waits for ROADMAP 'Modules to port' item 7."""

from blaze_tpu_torch.parallel.exchange import (
    BroadcastExchangeExec,
    ClusterShuffleExchangeExec,
    CoalescedShuffleReader,
    RemoteClusterShuffleExchangeExec,
    ShuffleExchangeExec,
    plan_coalesced_partitions,
)

__all__ = [
    "BroadcastExchangeExec",
    "ClusterShuffleExchangeExec",
    "CoalescedShuffleReader",
    "RemoteClusterShuffleExchangeExec",
    "ShuffleExchangeExec",
    "plan_coalesced_partitions",
]
