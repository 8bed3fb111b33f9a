"""Convert strategy + converters: PlanSpec -> native operator tree with
per-node fallback.

Reference behavior being reproduced (SURVEY 2.2, 3.1):
- every node is tagged convertible/not by DRY-RUNNING its conversion
  (BlazeConvertStrategy.scala:93-101)
- per-op enable gates (spark.blaze.enable.*, BlazeConverters.scala:76-91)
- exchanges and scans always convert when possible
  (BlazeConvertStrategy.scala:118-123)
- a node whose dry run fails falls back per node (tryConvert,
  BlazeConverters.scala:137-157); a node the dry run passed converts
  or raises
- join conditions become a native Filter above the join
  (BlazeConverters.scala:244-301)
- host<->native boundaries get explicit bridges: HostFallbackExec wraps
  host subtrees under native parents (ConvertToNative analog), and native
  subtrees under host parents are collected through run_plan (the
  ConvertToUnsafeRow direction)

The JAX package's planner/convert.py on the port's operators: the tree
is fused by the port's planner/fuse.fuse_pipelines, and a MemorySpec's
rows enter the device of the task that reads them. The tags are the
JAX package's for the same spec (tests/test_torch_planner.py holds
them): a conversion that raises in the port where the JAX package's
does not would otherwise send the node to pandas unseen.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional

from blaze_tpu_torch.exprs import ir
from blaze_tpu_torch.ops import (
    AggMode,
    FilterExec,
    HashAggregateExec,
    HashJoinExec,
    JoinType,
    LimitExec,
    ProjectExec,
    SortExec,
    SortKey,
    SortMergeJoinExec,
    UnionExec,
)
from blaze_tpu_torch.ops.base import PhysicalOp
from blaze_tpu_torch.ops.memory_scan import MemoryScanExec
from blaze_tpu_torch.ops.parquet_scan import ParquetScanExec
from blaze_tpu_torch.parallel.exchange import (
    BroadcastExchangeExec,
    ShuffleExchangeExec,
)
from blaze_tpu_torch.planner import spec as S
from blaze_tpu_torch.planner.host_engine import HostFallbackExec

log = logging.getLogger("blaze_tpu_torch.planner")

_JT = {
    "inner": JoinType.INNER,
    "left": JoinType.LEFT,
    "right": JoinType.RIGHT,
    "full": JoinType.FULL,
    "left_semi": JoinType.LEFT_SEMI,
    "left_anti": JoinType.LEFT_ANTI,
    "left_anti_null_aware": JoinType.LEFT_ANTI_NULL_AWARE,
}

_MODE = {
    "partial": AggMode.PARTIAL,
    "final": AggMode.FINAL,
    "complete": AggMode.COMPLETE,
}


@dataclasses.dataclass
class ConvertStrategy:
    """Per-op enable gates + heuristics (reference
    spark.blaze.enable.{scan,project,filter,sort,union,smj,bhj,aggr} and
    strategy switches, BlazeConverters.scala:76-91 /
    BlazeConvertStrategy.scala:43-82)."""

    enable_scan: bool = True
    enable_project: bool = True
    enable_filter: bool = True
    enable_sort: bool = True
    enable_union: bool = True
    enable_limit: bool = True
    enable_smj: bool = True
    enable_bhj: bool = True
    enable_aggr: bool = True
    enable_exchange: bool = True
    # the reference keeps Window host-side; this engine runs the common
    # window functions natively on device (ops/window.py) and falls back
    # to the host engine for the rest
    enable_window: bool = True

    # ---- strategy heuristics (BlazeConvertStrategy.scala:159-265) ----
    # Long continuously-fusable chains: the reference DECLINES to convert
    # them (length >= threshold) because JVM whole-stage codegen amortizes
    # long chains well (scala:191-221). This engine's fused pipelines
    # amortize even better (one XLA program), so the switch defaults OFF;
    # the mechanism is here for parity and for embedders whose host tier
    # is codegen-strong.
    continuous_codegen_threshold: int = 5
    enable_codegen_chain_heuristic: bool = False
    # A convertible scan whose PARENT stays host-side only buys a native
    # island plus two extra boundary crossings - keep it host-side
    # (scala:223-233).
    enable_scan_parent_heuristic: bool = True
    # Children of a non-convertible aggregate: the boundary would land
    # mid-aggregation; keep the subtree together (scala:234-265).
    enable_agg_child_heuristic: bool = True

    def gate(self, node: S.PlanSpec) -> bool:
        table = {
            S.ScanSpec: self.enable_scan,
            S.MemorySpec: True,
            S.ProjectSpec: self.enable_project,
            S.FilterSpec: self.enable_filter,
            S.SortSpec: self.enable_sort,
            S.UnionSpec: self.enable_union,
            S.LimitSpec: self.enable_limit,
            S.AggSpec: self.enable_aggr,
            S.ExchangeSpec: self.enable_exchange,
            S.WindowSpec: self.enable_window,
        }
        if isinstance(node, S.JoinSpec):
            return self.enable_smj if node.kind == "smj" else self.enable_bhj
        return table.get(type(node), False)


def convert_plan(root: S.PlanSpec,
                 strategy: Optional[ConvertStrategy] = None,
                 fuse: bool = True) -> PhysicalOp:
    """Convert a PlanSpec tree to an executable operator tree with
    per-node host fallback, then fuse stateless chains into single
    device programs (ops/fused.py)."""
    strategy = strategy or ConvertStrategy()
    _tag(root, strategy)
    _apply_heuristics(root, strategy)
    op = _build(root, strategy)
    if fuse:
        from blaze_tpu_torch.planner.fuse import fuse_pipelines

        op = fuse_pipelines(op)
    return op


# ---------------------------------------------------------------------------

def _tag(node: S.PlanSpec, strategy: ConvertStrategy) -> None:
    """Bottom-up dry-run tagging (convertibleTag analog)."""
    for c in node.children:
        _tag(c, strategy)
    if node.strategy == "never" or not strategy.gate(node):
        node.convertible = False
        return
    try:
        _check_convertible(node)
        node.convertible = True
    except Exception as e:
        log.debug("node %s not convertible: %s", type(node).__name__, e)
        node.convertible = False


def _apply_heuristics(root: S.PlanSpec,
                      strategy: ConvertStrategy) -> None:
    """Post-tagging strategy heuristics (BlazeConvertStrategy.scala:
    159-265): refine the convertible tags using PARENT context, which
    the bottom-up dry run cannot see."""

    def walk(node: S.PlanSpec, parent: Optional[S.PlanSpec]) -> None:
        if (
            strategy.enable_scan_parent_heuristic
            and isinstance(node, (S.ScanSpec, S.MemorySpec))
            and node.convertible
            and parent is not None
            and not parent.convertible
        ):
            # a native scan island under a host parent costs two extra
            # boundary crossings for zero fused work
            node.convertible = False
        if (
            strategy.enable_agg_child_heuristic
            and isinstance(node, S.AggSpec)
            and not node.convertible
        ):
            # keep the WHOLE aggregation subtree together (down to the
            # next exchange, which is a legitimate boundary anyway) -
            # a native island mid-aggregation costs two crossings
            def demote(n: S.PlanSpec) -> None:
                if isinstance(n, S.ExchangeSpec):
                    return
                n.convertible = False
                for cc in n.children:
                    demote(cc)

            for c in node.children:
                demote(c)
        for c in node.children:
            walk(c, node)

    def chain_pass(node: S.PlanSpec) -> None:
        # maximal chains of fusable narrow ops: the reference declines
        # chains >= threshold (JVM codegen amortizes them); gated OFF by
        # default here - see ConvertStrategy
        chain: list = []
        t = node
        while isinstance(t, (S.ProjectSpec, S.FilterSpec)) and \
                t.convertible and len(t.children) == 1:
            chain.append(t)
            t = t.children[0]
        if len(chain) >= strategy.continuous_codegen_threshold:
            for n in chain:
                n.convertible = False
        for c in t.children if chain else node.children:
            chain_pass(c)

    walk(root, None)
    if strategy.enable_codegen_chain_heuristic:
        chain_pass(root)


def _check_convertible(node: S.PlanSpec) -> None:
    """Cheap structural dry-run (full conversion happens in _build under
    tryConvert anyway)."""
    if isinstance(node, S.JoinSpec):
        if node.join_type not in _JT:
            raise NotImplementedError(node.join_type)
        if not node.left_keys or not node.right_keys:
            raise NotImplementedError("non-equi joins run on host")
        if node.skewed:
            raise NotImplementedError(
                "skew joins stay host-side (reference strategy)"
            )
    if isinstance(node, S.AggSpec) and node.mode not in _MODE:
        raise NotImplementedError(node.mode)
    if isinstance(node, S.ExchangeSpec) and node.mode not in (
        "hash", "single", "round_robin", "range", "broadcast"
    ):
        raise NotImplementedError(node.mode)
    if isinstance(node, S.WindowSpec):
        if node.function not in (
            "row_number", "rank", "dense_rank", "lag", "lead",
            "sum", "min", "max", "count", "avg",
        ):
            raise NotImplementedError(
                f"window fn {node.function} runs on host"
            )


def _smj_inputs_sorted(node: "S.JoinSpec") -> bool:
    """True when both join inputs carry a sort guarantee whose leading
    keys are exactly the join keys ascending - Spark plants SortExec
    under SMJ the same way, so a SortSpec child is the guarantee."""
    from blaze_tpu_torch.exprs import ir

    def guaranteed(child: S.PlanSpec, keys) -> bool:
        if not isinstance(child, S.SortSpec) or child.convertible is False:
            return False
        lead = list(child.keys)[: len(keys)]
        if len(lead) < len(keys):
            return False
        for (e, asc, _nf), name in zip(lead, keys):
            if not asc:
                return False
            if not (isinstance(e, ir.Col) and e.name == name):
                return False
        return True

    return guaranteed(node.children[0], list(node.left_keys)) and \
        guaranteed(node.children[1], list(node.right_keys))


def _build(node: S.PlanSpec, strategy: ConvertStrategy) -> PhysicalOp:
    """A node the tags mark as host becomes a HostFallbackExec; a node
    they mark as native converts or raises. (The JAX package also falls
    back when the conversion of a native-tagged node raises; here that
    would send the node to pandas on the host unseen.)"""
    if not node.convertible:
        return HostFallbackExec(node)
    return _convert_native(node, strategy)


def _child(node: S.PlanSpec, strategy: ConvertStrategy, i: int = 0
           ) -> PhysicalOp:
    return _build(node.children[i], strategy)


def _convert_native(node: S.PlanSpec, strategy: ConvertStrategy
                    ) -> PhysicalOp:
    if isinstance(node, S.MemorySpec):
        import pyarrow as pa

        from blaze_tpu_torch.types import from_arrow_schema

        rb = pa.RecordBatch.from_pandas(
            node.dataframe, preserve_index=False
        )
        n = rb.num_rows
        per = (n + node.partitions - 1) // node.partitions
        parts = []
        for p in range(node.partitions):
            sl = rb.slice(p * per, max(0, min(per, n - p * per)))
            # Arrow rows: each enters the reading task's device
            parts.append([sl] if sl.num_rows else [])
        return MemoryScanExec(parts, from_arrow_schema(rb.schema))
    if isinstance(node, S.ScanSpec):
        scan = ParquetScanExec(
            node.file_groups,
            projection=list(node.projection) if node.projection else None,
            pruning_predicate=node.predicate,
        )
        if node.predicate is not None:
            # pruning skips row groups; exact filtering still applies
            return FilterExec(scan, node.predicate)
        return scan
    if isinstance(node, S.ProjectSpec):
        return ProjectExec(_child(node, strategy), list(node.exprs))
    if isinstance(node, S.FilterSpec):
        return FilterExec(_child(node, strategy), node.predicate)
    if isinstance(node, S.SortSpec):
        return SortExec(
            _child(node, strategy),
            [SortKey(e, asc, nf) for e, asc, nf in node.keys],
            fetch=node.fetch,
        )
    if isinstance(node, S.UnionSpec):
        return UnionExec(
            [_build(c, strategy) for c in node.children]
        )
    if isinstance(node, S.LimitSpec):
        return LimitExec(_child(node, strategy), node.limit)
    if isinstance(node, S.AggSpec):
        return HashAggregateExec(
            _child(node, strategy),
            keys=list(node.keys),
            aggs=list(node.aggs),
            mode=_MODE[node.mode],
        )
    if isinstance(node, S.JoinSpec):
        left = _child(node, strategy, 0)
        right = _child(node, strategy, 1)
        jt = _JT[node.join_type]
        if node.kind == "bhj":
            out: PhysicalOp = HashJoinExec(
                left, right, list(node.left_keys),
                list(node.right_keys), jt,
            )
        else:
            out = None
            if _smj_inputs_sorted(node):
                # sort-guaranteed inputs take the streaming merge (the
                # reference's flagship operator, sort_merge_join_exec.rs:
                # 293-601); string keys fall through to materializing
                from blaze_tpu_torch.ops.streaming_smj import (
                    StreamingSortMergeJoinExec,
                )

                try:
                    out = StreamingSortMergeJoinExec(
                        left, right, list(node.left_keys),
                        list(node.right_keys), jt,
                    )
                except NotImplementedError:
                    out = None
            if out is None:
                out = SortMergeJoinExec(
                    left, right, list(node.left_keys),
                    list(node.right_keys), jt,
                )
        if node.condition is not None:
            # join conditions become a native filter above the join
            out = FilterExec(out, node.condition)
        return out
    if isinstance(node, S.ExchangeSpec):
        child = _child(node, strategy)
        if node.mode == "broadcast":
            return BroadcastExchangeExec(child)
        return ShuffleExchangeExec(
            child, list(node.keys), node.num_partitions, node.mode
        )
    if isinstance(node, S.WindowSpec):
        from blaze_tpu_torch.exprs.ir import Col
        from blaze_tpu_torch.ops.window import WindowExec, WindowFn

        child = _child(node, strategy)
        src = (
            Col(node.source) if node.source
            else (Col(node.order_by[0]) if node.order_by else None)
        )
        return WindowExec(
            child,
            partition_by=[Col(c) for c in node.partition_by],
            order_by=[SortKey(Col(c)) for c in node.order_by],
            functions=[WindowFn(node.function, src, node.output)],
        )
    raise NotImplementedError(type(node))
