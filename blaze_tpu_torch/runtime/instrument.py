"""Per-operator metric instrumentation.

The reference walks the finished plan in lockstep with a mirrored
MetricNode tree and reports per-operator counters into the Spark UI
(metrics.rs:32-56, NativeSupports.scala:215-228). `instrument(op, metrics)`
builds the same mirrored tree over our operator DAG: every node's batch
stream is wrapped to count rows/batches and inclusive elapsed wall time
(an operator's time contains its children's, like a profiler call tree;
subtract child nodes for exclusive time). The clock reads are the
host's: CUDA launches are asynchronous, so an operator's time is its
host work and launches, never a device sync."""

from __future__ import annotations

import time
from typing import Iterator

from blaze_tpu_torch.batch import ColumnBatch
from blaze_tpu_torch.ops.base import ExecContext, MetricNode, PhysicalOp


def _timed(execute, node: MetricNode):
    def run(partition: int, ctx: ExecContext) -> Iterator[ColumnBatch]:
        it = execute(partition, ctx)
        while True:
            t0 = time.perf_counter_ns()
            try:
                b = next(it)
            except StopIteration:
                node.add("elapsed_compute", time.perf_counter_ns() - t0)
                return
            node.add("elapsed_compute", time.perf_counter_ns() - t0)
            node.add("output_rows", b.num_rows)
            node.add("output_batches", 1)
            yield b

    return run


def instrument(op: PhysicalOp, metrics: MetricNode) -> PhysicalOp:
    """Mirror the plan under `metrics`, one MetricNode an operator, and
    time every node's batch stream. The JAX package wraps each node in
    a delegating operator; the port wraps each node's `execute` in
    place instead, so every node keeps its type and its children: the
    fused operators choose their path by their children's types (a
    folded INNER join under a keyed aggregate, ops/fused.py). Returns
    `op`; a tree instrumented once is not instrumented again."""
    if getattr(op, "_metric_node", None) is not None:
        return op
    node = MetricNode(op.describe())
    metrics.children.append(node)
    for c in op.children:
        instrument(c, node)
    op._metric_node = node
    op.execute = _timed(op.execute, node)
    return op


def exclusive_elapsed(node: MetricNode) -> int:
    """Exclusive compute nanoseconds for one metric node: inclusive time
    minus the children's inclusive times (clamped at zero - children
    driven from a sibling partition can exceed the parent's window)."""
    own = node.counters.get("elapsed_compute", 0)
    kids = sum(
        c.counters.get("elapsed_compute", 0) for c in node.children
    )
    return max(0, own - kids)


def operator_summary(root: MetricNode, limit: int = 6) -> list:
    """The metric tree flattened to its hottest operators (by
    EXCLUSIVE time): the machine-readable rollup the structured
    slow-query log (obs/slowlog.py) embeds, where the full
    render_metrics tree would bloat a one-line log record."""
    rows = []

    def walk(node: MetricNode) -> None:
        self_ms = exclusive_elapsed(node) / 1e6
        if node.counters:
            rows.append({
                "op": node.name,
                "self_ms": round(self_ms, 3),
                "rows": node.counters.get("output_rows", 0),
            })
        for ch in node.children:
            walk(ch)

    for ch in root.children:
        walk(ch)
    rows.sort(key=lambda r: -r["self_ms"])
    return rows[:max(0, limit)]


def render_metrics(root: MetricNode, indent: str = "") -> str:
    """Spark-UI-style rendering of the mirrored metric tree: one line
    per operator with rows/batches and inclusive + EXCLUSIVE time
    (reference counterpart: the SQLMetric panel fed by metrics.rs).
    Root-level counters - per-task dispatch/transfer/kernel-cache
    accounting recorded by the executor (`dispatch.*`: dispatches,
    h2d_batches, d2h_fetches, kernel_builds vs kernel_hits) - render
    first: dispatch count IS the perf model (runtime/dispatch.py), so
    it belongs in the same report as operator times."""
    lines = []
    if root.counters:
        stats = ", ".join(
            f"{k}={v}" for k, v in sorted(root.counters.items())
        )
        lines.append(f"[task: {stats}]")

    def walk(node: MetricNode, depth: int) -> None:
        c = node.counters
        incl_ms = c.get("elapsed_compute", 0) / 1e6
        excl_ms = exclusive_elapsed(node) / 1e6
        stats = []
        if "output_rows" in c:
            stats.append(f"rows={c['output_rows']:,}")
        if "output_batches" in c:
            stats.append(f"batches={c['output_batches']}")
        stats.append(f"time={incl_ms:.1f}ms")
        stats.append(f"self={excl_ms:.1f}ms")
        for k, v in sorted(c.items()):
            if k not in (
                "output_rows", "output_batches", "elapsed_compute"
            ):
                stats.append(f"{k}={v}")
        lines.append(
            f"{'  ' * depth}{node.name}  [{', '.join(stats)}]"
        )
        for ch in node.children:
            walk(ch, depth + 1)

    for ch in root.children:
        walk(ch, 0)
    return indent + ("\n" + indent).join(lines) if lines else ""
