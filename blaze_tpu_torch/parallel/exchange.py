"""Host-level exchange operators: the shuffle tier inside one process
(the JAX package's parallel/exchange.py, its local half).

These play Spark's orchestration role locally, the way the reference's
local-mode TPC-DS CI exercises its full shuffle path in one process
(SURVEY 4): a ShuffleExchange lazily runs the map stage (one
ShuffleWriterExec per input partition, run as tasks on a thread pool,
-> reference-format .data/.index files), then serves reduce partitions
as FileSegment reads; a BroadcastExchange collects the child once as
compressed IPC parts and replays them to every consumer partition
(reference ArrowBroadcastExchangeExec.scala:139-256).
CoalescedShuffleReader maps AQE-style partition specs (coalesced ranges)
onto the same files (reference NativeSupports.scala:131-212).

ClusterShuffleExchangeExec runs the map stage as TaskDefinitions on a
MiniCluster's worker processes (runtime/cluster.py) over a shared
shuffle directory; RemoteClusterShuffleExchangeExec lets each worker
write into its own private directory and reads every block back over
the workers' BlockServers (runtime/transport.py). Batches read back
enter the device on the consumer's context device, coalesced to the
batch size.
"""

from __future__ import annotations

import logging
import os
import tempfile
import threading
from typing import Iterator, List, Optional, Sequence, Tuple

from blaze_tpu_torch.batch import ColumnBatch
from blaze_tpu_torch.errors import classify, retry_action
from blaze_tpu_torch.exprs import ir
from blaze_tpu_torch.io.ipc import coalesce, partition_ranges
from blaze_tpu_torch.ops.base import ExecContext, PhysicalOp
from blaze_tpu_torch.ops.ipc_reader import FileSegment
from blaze_tpu_torch.ops.ipc_writer import collect_ipc
from blaze_tpu_torch.ops.shuffle_writer import ShuffleWriterExec
from blaze_tpu_torch.types import Schema

log = logging.getLogger("blaze_tpu_torch.exchange")


def _device_batches(arrow: Iterator, ctx: ExecContext
                    ) -> Iterator[ColumnBatch]:
    """Arrow batches read back from IPC, coalesced to the batch size, as
    batches on the context's device."""
    for rb in coalesce(arrow, ctx.config.batch_size):
        yield ColumnBatch.from_arrow(rb, device=ctx.device)


def _segment_batches(segs: Sequence, ctx: ExecContext
                     ) -> Iterator[ColumnBatch]:
    """Batches of local FileSegments or RemoteSegments, in order."""
    from blaze_tpu_torch.ops.ipc_reader import _source_batches

    def arrow():
        for seg in segs:
            yield from _source_batches(seg)

    return _device_batches(arrow(), ctx)


class _SampledReplay(PhysicalOp):
    """One-shot child stand-in for a range map task: yields the batches
    the sampling pass already pulled, then resumes the same iterator -
    so the child subtree runs once overall instead of once for the
    sample and once for the map."""

    def __init__(self, child: PhysicalOp, partition: int,
                 consumed: list, it):
        self.children = [child]
        self._partition = partition
        self._consumed = consumed
        self._it = it

    @property
    def schema(self) -> Schema:
        return self.children[0].schema

    @property
    def partition_count(self) -> int:
        return self.children[0].partition_count

    def execute(self, partition: int, ctx: ExecContext):
        assert partition == self._partition
        yield from self._consumed
        yield from self._it


class ShuffleExchangeExec(PhysicalOp):
    """Full repartitioning exchange (reference
    ArrowShuffleExchangeExec301.scala): hash / single / round_robin /
    range."""

    SAMPLE_ROWS_PER_PARTITION = 10_000
    MAX_TASK_ATTEMPTS = 3  # Spark-style task retry (SURVEY 5.3)

    def __init__(self, child: PhysicalOp, keys: Sequence[ir.Expr],
                 num_partitions: int, mode: str = "hash",
                 shuffle_dir: Optional[str] = None,
                 sort_ascending: Optional[Sequence[bool]] = None):
        self.children = [child]
        self.keys = list(keys)
        self.num_partitions = num_partitions
        self.mode = mode
        self.shuffle_dir = shuffle_dir
        self.sort_ascending = list(
            sort_ascending
            if sort_ascending is not None
            else [True] * len(keys)
        )
        self._map_outputs: Optional[List[Tuple[str, str]]] = None
        self._range_bounds: Optional[List[Tuple]] = None
        self._sample_replay: dict = {}
        self._lock = threading.Lock()

    @property
    def schema(self) -> Schema:
        return self.children[0].schema

    @property
    def partition_count(self) -> int:
        return self.num_partitions

    def describe(self) -> str:
        return (f"ShuffleExchangeExec({self.mode}, "
                f"{self.num_partitions} partitions)")

    def _compute_range_bounds(self, ctx: ExecContext) -> List[Tuple]:
        """The sampling pass, once for the plan (Spark runs a sample job
        the same way for RangePartitioning): pull up to
        SAMPLE_ROWS_PER_PARTITION key rows from each child partition,
        derive quantile bounds."""
        if self._range_bounds is not None:
            return self._range_bounds
        import pandas as pd

        from blaze_tpu_torch.ops.shuffle_writer import (
            compute_range_bounds,
            range_key_arrays,
        )
        from blaze_tpu_torch.ops.util import ensure_compacted

        child = self.children[0]
        frames = []
        self._sample_replay = {}
        for p in range(child.partition_count):
            taken = 0
            consumed = []
            it = child.execute(p, ctx)
            for cb in it:
                cb = ensure_compacted(cb)
                consumed.append(cb)
                if cb.num_rows == 0:
                    continue
                frames.append(pd.DataFrame({
                    f"k{i}": arr for i, arr in
                    enumerate(range_key_arrays(cb, self.keys))}))
                taken += cb.num_rows
                if taken >= self.SAMPLE_ROWS_PER_PARTITION:
                    break
            # the map stage replays what the sample pass already pulled
            # and continues the same iterator: the child runs once
            self._sample_replay[p] = (consumed, it)
        sample = (
            pd.concat(frames, ignore_index=True)
            if frames
            else pd.DataFrame({f"k{i}": [] for i in range(len(self.keys))})
        )
        self._range_bounds = compute_range_bounds(
            sample, self.num_partitions, self.sort_ascending
        )
        return self._range_bounds

    def range_bounds(self, ctx: ExecContext) -> List[Tuple]:
        """The bounds of a range exchange (sampled on first use)."""
        with self._lock:
            return self._compute_range_bounds(ctx)

    def _run_map_stage(self, ctx: ExecContext) -> List[Tuple[str, str]]:
        with self._lock:
            if self._map_outputs is not None:
                return self._map_outputs
            import concurrent.futures as cf

            from blaze_tpu_torch.runtime.dispatch import task_threads

            child = self.children[0]
            d = self.shuffle_dir or tempfile.mkdtemp(
                prefix="blz-shuffle-", dir=ctx.config.spill_dir())
            os.makedirs(d, exist_ok=True)
            bounds = (self._compute_range_bounds(ctx)
                      if self.mode == "range" else None)

            def run_map(map_id: int) -> Tuple[str, str]:
                data = os.path.join(
                    d, f"shuffle_{id(self):x}_{map_id}_0.data")
                index = os.path.join(
                    d, f"shuffle_{id(self):x}_{map_id}_0.index")
                for attempt in range(self.MAX_TASK_ATTEMPTS):
                    try:
                        # a range map task's first attempt resumes the
                        # sample pass's iterator; a retry pops nothing
                        # and runs the child again
                        src = child
                        replay = self._sample_replay.pop(map_id, None)
                        if replay is not None:
                            src = _SampledReplay(child, map_id, *replay)
                        writer = ShuffleWriterExec(
                            src, self.keys, self.num_partitions,
                            data, index, self.mode,
                            range_bounds=bounds,
                            sort_ascending=self.sort_ascending,
                        )
                        for _ in writer.execute(map_id, ctx):
                            pass
                        return (data, index)
                    except Exception as e:
                        # a Spark task's retry, classified as the
                        # scheduler's: only a transient failure runs
                        # again, and each retry is logged and counted
                        if retry_action(classify(e), attempt,
                                        self.MAX_TASK_ATTEMPTS,
                                        False) != "retry":
                            raise
                        ctx.metrics.add("task_retries", 1)
                        log.warning("map task %d failed transiently "
                                    "(attempt %d): %s; retrying",
                                    map_id, attempt + 1, e)
                raise AssertionError("unreachable: attempt loop fell "
                                     "through")

            # map tasks run concurrently like Spark executor threads:
            # host decode and encode overlap the card's work
            n = child.partition_count
            with cf.ThreadPoolExecutor(max_workers=task_threads(n)) as pool:
                outputs = list(pool.map(run_map, range(n)))
            ctx.metrics.add("exchange_map_tasks", n)
            self._map_outputs = outputs
            return outputs

    def map_output_statistics(self, ctx: ExecContext) -> List[int]:
        """Bytes per reduce partition, summed over map outputs - what the
        reference feeds AQE through mapOutputStatisticsFuture
        (ArrowShuffleExchangeExec301.scala:104-130)."""
        sizes = [0] * self.num_partitions
        for _, index in self._run_map_stage(ctx):
            for p, (_, length) in enumerate(partition_ranges(index)):
                sizes[p] += length
        return sizes

    def segments_for(self, partition_range: Tuple[int, int],
                     ctx: ExecContext,
                     map_range: Optional[Tuple[int, int]] = None
                     ) -> List[FileSegment]:
        """FileSegments covering [start, end) reduce partitions across the
        given range of map outputs (all by default). Reduce-range > 1 wide
        = AQE CoalescedPartitionSpec; map-range narrower than all maps =
        PartialReducerPartitionSpec (skew split)."""
        start, end = partition_range
        outputs = self._run_map_stage(ctx)
        if map_range is not None:
            outputs = outputs[map_range[0]: map_range[1]]
        segs = []
        for data, index in outputs:
            ranges = partition_ranges(index)
            for p in range(start, end):
                off, length = ranges[p]
                if length > 0:
                    segs.append(FileSegment(data, off, length))
        return segs

    def execute(self, partition: int, ctx: ExecContext
                ) -> Iterator[ColumnBatch]:
        yield from _segment_batches(
            self.segments_for((partition, partition + 1), ctx), ctx)


class ClusterShuffleExchangeExec(ShuffleExchangeExec):
    """ShuffleExchange whose map stage runs on a MiniCluster: map tasks
    ship as serialized TaskDefinitions to worker processes (the Spark
    driver's role for multi-host runs); the reduce side reads the same
    .data/.index files. The child subtree must be serializable
    (plan/serde). `map_metas` keeps each map task's completion record
    (its worker, wall and kernel launches)."""

    def __init__(self, child: PhysicalOp, keys, num_partitions: int,
                 cluster, mode: str = "hash",
                 shuffle_dir: Optional[str] = None):
        super().__init__(child, keys, num_partitions, mode, shuffle_dir)
        self.cluster = cluster
        self.map_metas: Optional[List[dict]] = None

    def describe(self) -> str:
        return (f"ClusterShuffleExchangeExec({self.mode}, "
                f"{self.num_partitions} partitions)")

    def _map_task(self, map_id: int, data: str, index: str,
                  bounds) -> bytes:
        from blaze_tpu_torch.plan.serde import task_to_proto

        plan = ShuffleWriterExec(
            self.children[0], self.keys, self.num_partitions, data, index,
            self.mode, range_bounds=bounds,
            sort_ascending=self.sort_ascending)
        return task_to_proto(plan, map_id, f"map-{map_id}")

    def _run_cluster_maps(self, ctx: ExecContext, paths) -> List[dict]:
        """Ship one writer task a child partition, each writing to its
        (data, index) pair; wait for every completion record."""
        bounds = (self._compute_range_bounds(ctx)
                  if self.mode == "range" else None)
        tasks = [self._map_task(m, data, index, bounds)
                 for m, (data, index) in enumerate(paths)]
        _, metas = self.cluster.run_tasks(tasks, return_metas=True)
        ctx.metrics.add("exchange_map_tasks", len(tasks))
        self.map_metas = metas
        return metas

    def _run_map_stage(self, ctx: ExecContext):
        with self._lock:
            if self._map_outputs is not None:
                return self._map_outputs
            d = self.shuffle_dir or tempfile.mkdtemp(
                prefix="blz-cshuffle-", dir=ctx.config.spill_dir())
            os.makedirs(d, exist_ok=True)
            outputs = [
                (os.path.join(d, f"cm{m}.data"),
                 os.path.join(d, f"cm{m}.index"))
                for m in range(self.children[0].partition_count)]
            self._run_cluster_maps(ctx, outputs)
            self._map_outputs = outputs
            return outputs


class RemoteClusterShuffleExchangeExec(ClusterShuffleExchangeExec):
    """Cluster exchange over DISJOINT per-worker data directories: the
    driver does not know (or share) where map outputs land. Map tasks
    carry __WORKER_LOCAL__ shuffle paths that the claiming worker
    rewrites into its private directory; its completion record reports
    (host, port, path, per-partition ranges), and reduce reads stream
    every block over the workers' BlockServers - the reference's netty
    remote-fetch path (ArrowBlockStoreShuffleReader301.scala:83-123)
    rather than its local-FileSegment shortcut."""

    def describe(self) -> str:
        return (f"RemoteClusterShuffleExchangeExec({self.mode}, "
                f"{self.num_partitions} partitions)")

    def _run_map_stage(self, ctx: ExecContext):
        from blaze_tpu_torch.runtime.cluster import WORKER_LOCAL_PREFIX

        with self._lock:
            if self._map_outputs is not None:
                return self._map_outputs
            tag = f"{id(self):x}"
            paths = [
                (f"{WORKER_LOCAL_PREFIX}/ex{tag}_m{m}.data",
                 f"{WORKER_LOCAL_PREFIX}/ex{tag}_m{m}.index")
                for m in range(self.children[0].partition_count)]
            self._map_outputs = self._run_cluster_maps(ctx, paths)
            return self._map_outputs

    def segments_for(self, partition_range: Tuple[int, int],
                     ctx: ExecContext,
                     map_range: Optional[Tuple[int, int]] = None):
        from blaze_tpu_torch.runtime.transport import RemoteSegment

        start, end = partition_range
        metas = self._run_map_stage(ctx)
        if map_range is not None:
            metas = metas[map_range[0]: map_range[1]]
        segs = []
        for meta in metas:
            for out in meta["outputs"]:
                for p in range(start, end):
                    off, length = out["ranges"][p]
                    if length > 0:
                        segs.append(RemoteSegment(
                            meta["host"], meta["port"], out["data"], off,
                            length))
        return segs

    def map_output_statistics(self, ctx: ExecContext) -> List[int]:
        sizes = [0] * self.num_partitions
        for meta in self._run_map_stage(ctx):
            for out in meta["outputs"]:
                for p, (_, length) in enumerate(out["ranges"]):
                    sizes[p] += length
        return sizes


class CoalescedShuffleReader(PhysicalOp):
    """AQE-style reader over a ShuffleExchange: each output partition maps
    to a (reduce-range, map-range) spec (reference CustomShuffleReaderExec
    handling, NativeSupports.scala:131-212):
    - (start, end) with full map range  = CoalescedPartitionSpec
    - single reduce + partial map range = PartialReducerPartitionSpec
      (skew-join split)
    """

    def __init__(self, exchange: ShuffleExchangeExec,
                 partition_ranges_: Sequence[Tuple[int, int]],
                 map_ranges: Optional[Sequence[Optional[Tuple[int, int]]]]
                 = None):
        self.children = [exchange]
        self.ranges = list(partition_ranges_)
        self.map_ranges = (
            list(map_ranges) if map_ranges is not None
            else [None] * len(self.ranges)
        )

    @property
    def schema(self) -> Schema:
        return self.children[0].schema

    @property
    def partition_count(self) -> int:
        return len(self.ranges)

    def execute(self, partition: int, ctx: ExecContext
                ) -> Iterator[ColumnBatch]:
        ex: ShuffleExchangeExec = self.children[0]
        yield from _segment_batches(ex.segments_for(
            self.ranges[partition], ctx, self.map_ranges[partition]), ctx)


def plan_coalesced_partitions(sizes: Sequence[int], target_bytes: int
                              ) -> List[Tuple[int, int]]:
    """AQE partition coalescing: greedily pack adjacent reduce partitions
    up to ~target_bytes (what Spark's CoalesceShufflePartitions does with
    the stats the exchange reports)."""
    ranges: List[Tuple[int, int]] = []
    start = 0
    acc = 0
    for i, s in enumerate(sizes):
        if acc > 0 and acc + s > target_bytes:
            ranges.append((start, i))
            start = i
            acc = 0
        acc += s
    if start < len(sizes):
        ranges.append((start, len(sizes)))
    return ranges


class BroadcastExchangeExec(PhysicalOp):
    """Collect-once, replay-everywhere broadcast (reference
    ArrowBroadcastExchangeExec: native IPC collect -> spark broadcast ->
    per-task CHANNEL reads)."""

    is_broadcast = True  # every partition replays the full relation

    def __init__(self, child: PhysicalOp,
                 num_partitions: Optional[int] = None):
        self.children = [child]
        self._parts: Optional[List[bytes]] = None
        self._n = num_partitions
        self._lock = threading.Lock()

    @property
    def schema(self) -> Schema:
        return self.children[0].schema

    @property
    def partition_count(self) -> int:
        return self._n or self.children[0].partition_count

    def broadcast_bytes(self, ctx: ExecContext) -> List[bytes]:
        with self._lock:
            if self._parts is None:
                self._parts = collect_ipc(self.children[0], ctx)
                ctx.metrics.add("broadcast_bytes",
                                sum(len(p) for p in self._parts))
            return self._parts

    def execute(self, partition: int, ctx: ExecContext
                ) -> Iterator[ColumnBatch]:
        from blaze_tpu_torch.io.ipc import decode_ipc_parts

        def arrow():
            for part in self.broadcast_bytes(ctx):
                yield from decode_ipc_parts(part)

        yield from _device_batches(arrow(), ctx)
