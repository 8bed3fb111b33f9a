"""Exchange insertion: lower a single-process plan onto the shuffle tier.

The reference never executes a join or final aggregate without an
exchange underneath - Spark's planner guarantees co-partitioning via
ArrowShuffleExchangeExec and broadcast via ArrowBroadcastExchangeExec
(ArrowShuffleExchangeExec301.scala:78, ArrowBroadcastExchangeExec.scala:
139-256), and the TPC-DS CI exercises every query through those real
shuffles (tpcds.yml:139-147). This rule is that planner step engine-side:

- sort-merge joins get HASH ShuffleExchangeExec on BOTH children, keyed
  by the join keys with the same partition count -> co-partitioned,
  partition-wise join (SURVEY 2.3 "partition-wise join alignment");
- broadcast hash joins get BroadcastExchangeExec on the build side;
- COMPLETE hash aggregates split into PARTIAL -> hash exchange on the
  group keys -> FINAL (keyless: single-partition exchange), the
  reference's NativeHashAggregateExec mode mapping
  (NativeHashAggregateExec.scala:98-161); so does one that the fusion
  pass made a carry under HostFinalAggExec, keyless or keyed, when it
  reads more than one partition (the JAX package's pass leaves that one
  whole, and each partition then gives its own rows);
- a global Limit(Sort(...)) root coalesces partitions below the sort so
  top-N stays global.

Exchanges preserve schema exactly, so children are swapped in place and
bound column indices stay valid.

This is the JAX package's exchange pass, on the port's operators; its
mesh and fleet lowering (`lower_plan_to_mesh`, `lower_plan_to_fleet`)
waits for ROADMAP 'Modules to port' item 7.
"""

from __future__ import annotations

from typing import Dict, Optional

from blaze_tpu_torch.exprs import ir
from blaze_tpu_torch.exprs.ir import AggExpr
from blaze_tpu_torch.ops import (
    AggMode,
    HashAggregateExec,
    HashJoinExec,
    LimitExec,
    SortExec,
    SortMergeJoinExec,
)
from blaze_tpu_torch.ops.base import PhysicalOp
from blaze_tpu_torch.ops.fused import HostFinalAggExec
from blaze_tpu_torch.ops.streaming_smj import StreamingSortMergeJoinExec
from blaze_tpu_torch.ops.union import CoalescePartitionsExec
from blaze_tpu_torch.ops.window import WindowExec
from blaze_tpu_torch.parallel.exchange import (
    BroadcastExchangeExec,
    ShuffleExchangeExec,
)


def _hash_exchange(child: PhysicalOp, key_indices, num_partitions,
                   shuffle_dir) -> ShuffleExchangeExec:
    keys = [
        ir.BoundCol(i, child.schema.fields[i].dtype)
        for i in key_indices
    ]
    return ShuffleExchangeExec(
        child, keys, num_partitions, mode="hash",
        shuffle_dir=shuffle_dir,
    )


def insert_exchanges(op: PhysicalOp, num_partitions: int = 4,
                     shuffle_dir: Optional[str] = None) -> PhysicalOp:
    """Rewrite `op` so every join/final-aggregate runs over the shuffle
    tier. Returns the (possibly new) root."""
    seen: Dict[int, PhysicalOp] = {}
    root = _rewrite(op, num_partitions, shuffle_dir, seen)
    return _fix_global_limit(root)


def _rewrite(op: PhysicalOp, n: int, shuffle_dir,
             seen: Dict[int, PhysicalOp]) -> PhysicalOp:
    if id(op) in seen:  # shared subtree (CTE reuse): rewrite once
        return seen[id(op)]
    seen[id(op)] = op  # break cycles while recursing
    for i, c in enumerate(op.children):
        op.children[i] = _rewrite(c, n, shuffle_dir, seen)

    new: PhysicalOp = op
    if isinstance(op, (SortMergeJoinExec, StreamingSortMergeJoinExec)):
        from blaze_tpu_torch.ops.joins import JoinType

        if op.join_type is JoinType.LEFT_ANTI_NULL_AWARE:
            # NAAJ semantics are GLOBAL (any build-side NULL empties the
            # whole result, joins.py:574); hash bucketing would evaluate
            # them per partition. Run it single-partition instead.
            for i in (0, 1):
                if op.children[i].partition_count > 1:
                    op.children[i] = CoalescePartitionsExec(
                        op.children[i]
                    )
        else:
            for i, keys in ((0, op.left_keys), (1, op.right_keys)):
                ex: PhysicalOp = _hash_exchange(
                    op.children[i], keys, n, shuffle_dir
                )
                if isinstance(op, StreamingSortMergeJoinExec):
                    # the streaming join's window eviction assumes both
                    # inputs arrive key-sorted; a hash exchange orders
                    # by partition id only, so restore sortedness per
                    # partition (Spark plants the same per-partition
                    # sort under SMJ after its exchanges)
                    from blaze_tpu_torch.ops.sort import SortKey

                    ex = SortExec(
                        ex,
                        [SortKey(ir.BoundCol(
                            k, ex.schema.fields[k].dtype
                        )) for k in keys],
                    )
                op.children[i] = ex
    elif isinstance(op, HashJoinExec):
        if not getattr(op.children[0], "is_broadcast", False):
            op.children[0] = BroadcastExchangeExec(op.children[0])
    elif isinstance(op, WindowExec):
        child = op.children[0]
        if child.partition_count > 1:
            if op.partition_by and all(
                isinstance(e, ir.BoundCol) for e in op.partition_by
            ):
                # Spark plants a hash exchange on the window's
                # PARTITION BY so each frame is computed whole
                op.children[0] = _hash_exchange(
                    child, [e.index for e in op.partition_by], n,
                    shuffle_dir,
                )
            else:
                # no partition keys (global frames): single partition
                op.children[0] = CoalescePartitionsExec(child)
    elif isinstance(op, SortExec):
        # a pre-existing sort in the plan is a GLOBAL ordering
        # requirement (top-n inputs, order-sensitive windows); sorts
        # this pass itself plants under streaming SMJ are created after
        # recursion and are never revisited, so they stay per-partition
        if op.children[0].partition_count > 1:
            op.children[0] = CoalescePartitionsExec(op.children[0])
    elif (
        isinstance(op, HashAggregateExec)
        and op.mode is AggMode.COMPLETE
    ):
        partial = HashAggregateExec(
            op.children[0], keys=op.keys, aggs=op.aggs,
            mode=AggMode.PARTIAL,
        )
        if op.keys:
            exchange: PhysicalOp = _hash_exchange(
                partial, list(range(len(op.keys))), n, shuffle_dir
            )
        else:
            exchange = ShuffleExchangeExec(
                partial, [], 1, mode="single", shuffle_dir=shuffle_dir
            )
        key_names = [name for _, name in op.keys]
        new = HashAggregateExec(
            exchange,
            keys=[(ir.Col(kn), kn) for kn in key_names],
            aggs=[(AggExpr(a.fn, None), name) for a, name in op.aggs],
            mode=AggMode.FINAL,
        )
    elif isinstance(op, HostFinalAggExec) and \
            op.children[0].partition_count > 1:
        new = _split_fused_complete(op, n, shuffle_dir)
    seen[id(op)] = new
    return new


def _split_fused_complete(op, n: int, shuffle_dir) -> PhysicalOp:
    """A COMPLETE aggregate that the fusion pass already turned into
    HostFinalAggExec over a carry reads one partition; over several it
    splits as the unfused one does: the fused aggregate as the PARTIAL
    of each partition (its states stay on the device), an exchange -
    hash on the group keys, or single-partition when keyless - and the
    FINAL."""
    from blaze_tpu_torch.ops.fused import FusedAggregateExec

    state = op.children[0]
    if not isinstance(state, FusedAggregateExec):
        raise NotImplementedError(
            f"an aggregate over {type(state).__name__} reads one "
            "partition; coalesce its input first")
    partial = FusedAggregateExec(state.pipeline, state.agg)
    partial.children = state.children
    keys = op.template.keys
    if keys:
        exchange: PhysicalOp = _hash_exchange(
            partial, list(range(len(keys))), n, shuffle_dir)
    else:
        exchange = ShuffleExchangeExec(partial, [], 1, mode="single",
                                       shuffle_dir=shuffle_dir)
    return HashAggregateExec(
        exchange, keys=[(ir.Col(name), name) for _, name in keys],
        aggs=[(AggExpr(a.fn, None), name) for a, name in op.template.aggs],
        mode=AggMode.FINAL,
    )


def estimate_rows(op: PhysicalOp) -> int:
    """Leaf-driven row estimate (the JAX package's mesh cost guard):
    memory scans count resident rows, parquet scans approximate rows
    from file-range bytes (~16 B/row, the battery tables' order of
    magnitude), interior nodes sum their leaves. Deliberately coarse:
    an order of magnitude, not a cost model."""
    from blaze_tpu_torch.ops.memory_scan import MemoryScanExec
    from blaze_tpu_torch.ops.parquet_scan import ParquetScanExec

    if isinstance(op, MemoryScanExec):
        return sum(
            cb.num_rows for part in op.partitions for cb in part
        )
    if isinstance(op, ParquetScanExec):
        import os

        total = 0
        for group in op.file_groups:
            for fr in group:
                if fr.length:
                    total += fr.length
                else:
                    try:
                        total += os.path.getsize(fr.path)
                    except OSError:
                        pass
        return total // 16
    if not op.children:
        return 0
    return sum(estimate_rows(c) for c in op.children)


def _fix_global_limit(root: PhysicalOp) -> PhysicalOp:
    """Top-N and global limits must see ONE partition (Spark plants the
    single-partition exchange the same way for CollectLimit /
    TakeOrdered)."""
    if isinstance(root, LimitExec):
        inner = root.children[0]
        if isinstance(inner, SortExec):
            if inner.children[0].partition_count > 1:
                inner.children[0] = CoalescePartitionsExec(
                    inner.children[0]
                )
        elif inner.partition_count > 1:
            root.children[0] = CoalescePartitionsExec(inner)
    elif isinstance(root, SortExec):
        if root.children[0].partition_count > 1:
            root.children[0] = CoalescePartitionsExec(root.children[0])
    return root


def _bound_index(e, schema) -> Optional[int]:
    if isinstance(e, ir.BoundCol):
        return int(e.index)
    if isinstance(e, ir.Col):
        try:
            return int(schema.index_of(e.name))
        except (KeyError, ValueError):
            return None
    return None
