"""Shuffle write: repartition batches into a .data/.index file pair.

Reference counterpart: the native ShuffleWriterExec
(shuffle_writer_exec.rs): Spark murmur3 pmod bucketing, per-partition
buffers that spill to disk under memory pressure, and a final merge into
one data file and an index of LE i64 offsets, which Spark commits
(ArrowShuffleExchangeExec301.scala:531-602). The modes `single` and
`round_robin` cover the JVM's other partitionings.

Per batch, on the device: the partition id of every row (kernel K4 for
`hash`, an arange for `round_robin`; the padding rows get the sentinel
`num_partitions`; keys that include a string column hash on the host
from their real bytes - one fetch of the key columns, the C++ chain of
runtime/native.py, one copy of the ids back -, counted as
`dispatch.host_hash_batches`), one stable sort by id, the partitions' start offsets
by a binary search of the sorted ids, one gather of the columns. Then
one copy of the offsets and one of the sorted batch to the host, where
each partition's rows are a slice of one Arrow batch, encoded as one
zstd IPC part.

`range` (Spark's RangePartitioning, the JAX package's range mode) takes
bounds sampled when the plan is made (parallel/exchange.py) and ranks
rows on the host: one fetch of the key columns a batch, the ids
(`range_partition_ids`: the bounds each key tuple exceeds) copied back,
then the same sort and gather. Keys rank by value in the physical
representation (a date's days, a decimal's unscaled integer), a
string by its bytes, not its dictionary code, NaN above every number,
NULL first in either direction; a decimal(>18) key is refused (the JAX
package fails on one too).
"""

from __future__ import annotations

import os
import struct
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import pyarrow as pa
import torch

from blaze_tpu_torch.batch import ColumnBatch
from blaze_tpu_torch.exprs import ir
from blaze_tpu_torch.exprs.eval import DeviceEvaluator
from blaze_tpu_torch.exprs.optimize import bind_opt
from blaze_tpu_torch.exprs.typing import infer_dtype
from blaze_tpu_torch.io.ipc import encode_ipc_segment
from blaze_tpu_torch.ops.base import ExecContext, PhysicalOp
from blaze_tpu_torch.ops.host_lower import lower_strings_host, needs_host
from blaze_tpu_torch.ops.kernels import murmur3
from blaze_tpu_torch.ops.project import batch_cvs, passthrough_dictionary
from blaze_tpu_torch.ops.util import ensure_compacted, take_batch
from blaze_tpu_torch.runtime import dispatch
from blaze_tpu_torch.runtime.memory import get_pool
from blaze_tpu_torch.types import Schema

MODES = ("hash", "single", "round_robin", "range")


class PartitionBuffers:
    """Per-partition buffers of encoded parts, with the reference's
    buffer -> spill -> merge ladder (PartitionBuffer/spill_into,
    shuffle_writer_exec.rs:66-194, :522-556), registered with the host
    memory pool, which calls `spill` when over budget."""

    def __init__(self, num_partitions: int, spill_dir: str):
        self.num_partitions = num_partitions
        self.buffers: List[bytearray] = [
            bytearray() for _ in range(num_partitions)]
        self.spills: List[Tuple[str, List[int]]] = []
        self.spill_dir = spill_dir
        self.mem_used = 0
        self._pool = get_pool()
        self._pool.register(id(self), self.spill)

    def append(self, partition: int, part: bytes) -> None:
        self.buffers[partition] += part
        self.mem_used += len(part)
        self._pool.grow(id(self), len(part))

    def spill(self) -> int:
        """Write the buffers to a spill file; returns the bytes
        released."""
        if self.mem_used == 0:
            return 0
        path = os.path.join(
            self.spill_dir, f"blz-spill-{os.getpid()}-{id(self):x}-"
                            f"{len(self.spills)}.tmp")
        offsets = [0] * (self.num_partitions + 1)
        pos = 0
        with open(path, "wb") as f:
            for p in range(self.num_partitions):
                offsets[p] = pos
                f.write(self.buffers[p])
                pos += len(self.buffers[p])
                self.buffers[p] = bytearray()
        offsets[self.num_partitions] = pos
        self.spills.append((path, offsets))
        released, self.mem_used = self.mem_used, 0
        return released

    def finalize(self, data_path: str, index_path: str) -> List[int]:
        """Write the .data/.index pair; returns the partitions' byte
        lengths. Each partition is its buffered parts, then its parts of
        each spill file in spill order: the layout of the JAX package's
        assembly (runtime/native.py:356-376, cpp/blaze_host.cpp)."""
        offsets = [0] * (self.num_partitions + 1)
        pos = 0
        try:
            with open(data_path, "wb") as out:
                for p in range(self.num_partitions):
                    offsets[p] = pos
                    out.write(self.buffers[p])
                    pos += len(self.buffers[p])
                    for path, so in self.spills:
                        length = so[p + 1] - so[p]
                        if length > 0:
                            with open(path, "rb") as f:
                                f.seek(so[p])
                                out.write(f.read(length))
                            pos += length
                offsets[self.num_partitions] = pos
            with open(index_path, "wb") as idx:
                idx.write(struct.pack(f"<{len(offsets)}q", *offsets))
        finally:
            self.close()
        return [offsets[p + 1] - offsets[p]
                for p in range(self.num_partitions)]

    def close(self) -> None:
        """Leave the pool and delete the spill files."""
        self._pool.shrink(id(self), self.mem_used)
        self._pool.unregister(id(self))
        self.mem_used = 0
        self.buffers = [bytearray() for _ in range(self.num_partitions)]
        for path, _ in self.spills:
            try:
                os.remove(path)
            except OSError:
                pass
        self.spills = []


def spark_partition_ids(cb: ColumnBatch, key_exprs: Sequence[ir.Expr],
                        num_partitions: int) -> torch.Tensor:
    """Spark murmur3 pmod partition id of every row (kernel K4), int32
    of the batch's capacity, on its device; rows past `num_rows` get
    `num_partitions`. The batch must carry no pending selection."""
    if cb.selection is not None:
        raise ValueError("spark_partition_ids: compact the batch first")
    exprs, aug = list(key_exprs), cb
    if any(needs_host(e, cb.schema) for e in exprs):
        exprs, _, aug = lower_strings_host(exprs, cb)
    ev = DeviceEvaluator(aug.schema, batch_cvs(aug), cb.capacity, cb.device)
    cols = []
    for e in exprs:
        v, m = ev.evaluate(e)
        cols.append((v, m, infer_dtype(e, aug.schema),
                     passthrough_dictionary(e, aug)))
    if any(dt.is_string_like for _, _, dt, _ in cols):
        return _host_partition_ids(cols, cb.num_rows, cb.capacity,
                                   num_partitions, cb.device)
    return murmur3.partition_ids([c[:3] for c in cols], cb.num_rows,
                                 num_partitions)


def _host_partition_ids(cols, num_rows: int, capacity: int,
                        num_partitions: int, device) -> torch.Tensor:
    """Partition ids of keys that include strings: the live prefix of
    every key column in one fetch, Spark's hash on the host
    (exprs/hashing.hash_rows_host), pmod, and the ids back to the
    device with the padding's sentinel."""
    from blaze_tpu_torch.batch import _h2d
    from blaze_tpu_torch.exprs.hashing import hash_rows_host
    from blaze_tpu_torch.runtime.pack import get_packed

    dispatch.record("host_hash_batches")
    wanted = [t[:num_rows] for v, m, _, _ in cols
              for t in (v, m) if t is not None]
    host = iter(get_packed(wanted))
    rows = [(next(host), next(host) if m is not None else None, dt, d)
            for _, m, dt, d in cols]
    h = hash_rows_host(rows, num_rows)
    pid = np.full(capacity, num_partitions, dtype=np.int32)
    pid[:num_rows] = np.mod(h.astype(np.int64), num_partitions)
    return _h2d(pid, torch.device(device))


def round_robin_ids(cb: ColumnBatch, start: int, num_partitions: int
                    ) -> torch.Tensor:
    """Partition ids start, start + 1, ... mod n over the live rows;
    the padding rows get `num_partitions`."""
    idx = torch.arange(cb.capacity, dtype=torch.int64, device=cb.device)
    pid = (idx + start) % num_partitions
    pid = torch.where(idx < cb.num_rows, pid,
                      torch.full_like(pid, num_partitions))
    return pid.to(torch.int32)


def scatter_by_partition(cb: ColumnBatch, pids: torch.Tensor,
                         num_partitions: int
                         ) -> Tuple[pa.RecordBatch, np.ndarray]:
    """The live rows ordered by partition id, stably (input order inside
    a partition), as one Arrow batch, and the row offset where each
    partition starts (num_partitions + 1 entries, the last = num_rows).
    The padding rows' sentinel id sorts them past every partition."""
    sorted_ids, order = torch.sort(pids, stable=True)
    bounds = torch.searchsorted(
        sorted_ids, torch.arange(num_partitions + 1, dtype=torch.int32,
                                 device=pids.device))
    if bounds.device.type != "cpu":
        dispatch.record("d2h_fetches")
    offsets = bounds.cpu().numpy()
    rb = take_batch(cb, order, cb.num_rows).to_arrow()
    return rb, offsets


def _key_index(e: ir.Expr, schema: Schema) -> int:
    if isinstance(e, ir.BoundCol):
        return e.index
    if isinstance(e, ir.Col):
        return schema.index_of(e.name)
    raise NotImplementedError("range partitioning keys must be plain columns")


def range_key_columns(cb: ColumnBatch, key_exprs: Sequence[ir.Expr]
                      ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """(values, is NULL) of each range key over a compacted batch's live
    rows, from one fetch of the key columns: the physical values
    (date32 days, timestamp micros, a decimal's unscaled int64) typed,
    with NaN as +inf, which ranks it above every number (ties at inf
    meet in one or two adjacent partitions; the sort finishes), NULL
    slots zero; a string's values as an object array, None where
    NULL."""
    from blaze_tpu_torch.batch import host_columns

    idx = [_key_index(e, cb.schema) for e in key_exprs]
    for i in idx:
        dt = cb.schema.fields[i].dtype
        if dt.is_wide_decimal:
            raise NotImplementedError(
                f"range partitioning on a {dt} key: decimal(>18) keys are "
                "not ranked (the JAX package fails on them too)")
    keys = ColumnBatch(Schema([cb.schema.fields[i] for i in idx]),
                       [cb.columns[i] for i in idx], cb.num_rows)
    rb = keys.to_arrow()
    _, host = host_columns(rb)
    out = []
    for j, (vals, valid, _) in enumerate(host):
        isnull = np.zeros(rb.num_rows, dtype=bool) if valid is None \
            else ~valid
        if keys.schema.fields[j].dtype.is_string_like:
            vals = np.asarray(rb.column(j).to_pandas(), dtype=object)
        elif np.issubdtype(vals.dtype, np.floating):
            vals = np.where(np.isnan(vals), np.inf, vals)
        out.append((vals, isnull))
    return out


def range_key_arrays(cb: ColumnBatch, key_exprs: Sequence[ir.Expr]
                     ) -> List[np.ndarray]:
    """The range keys of a batch as object arrays with None for NULL:
    the sample the bounds are drawn from (the JAX package's
    `_key_array_for_range`, so both packages draw the same bounds)."""
    out = []
    for vals, isnull in range_key_columns(cb, key_exprs):
        arr = vals.astype(object)
        arr[isnull] = None
        out.append(arr)
    return out


def range_partition_ids(key_arrays: Sequence[np.ndarray],
                        bounds: Sequence[Tuple],
                        ascending: Sequence[bool],
                        nulls: Optional[Sequence[np.ndarray]] = None
                        ) -> np.ndarray:
    """Partition id per row for RANGE partitioning: the count of
    boundary tuples the row's key tuple exceeds lexicographically (rows
    equal to a bound land in the lower partition, like Spark's
    RangePartitioner binary search). NULL ranks first in the sort
    order regardless of direction. `key_arrays` are object arrays with
    None for NULL, or typed arrays with their NULL masks in `nulls`."""
    import pandas as pd

    n = len(key_arrays[0]) if key_arrays else 0
    if nulls is None:
        nulls = [np.asarray(pd.isna(a), dtype=bool) for a in key_arrays]
    pid = np.zeros(n, dtype=np.int32)
    for bound in bounds:
        gt = np.zeros(n, dtype=bool)
        eq = np.ones(n, dtype=bool)
        for arr, isn, bv, asc in zip(key_arrays, nulls, bound, ascending):
            if bv is None or (isinstance(bv, float) and np.isnan(bv)):
                col_gt = ~isn  # any value outranks a NULL bound
                col_eq = isn
            else:
                # NULL slots of an object array can't be compared:
                # substitute the bound itself, then mask them out
                safe = np.where(isn, bv, arr) if arr.dtype == object \
                    else arr
                with np.errstate(invalid="ignore"):
                    raw_gt = np.asarray(safe > bv, dtype=bool)
                    raw_lt = np.asarray(safe < bv, dtype=bool)
                if not asc:
                    raw_gt, raw_lt = raw_lt, raw_gt
                col_gt = raw_gt & ~isn
                col_eq = np.asarray(safe == bv, dtype=bool) & ~isn
            gt = gt | (eq & col_gt)
            eq = eq & col_eq
        pid += gt.astype(np.int32)
    return pid


def compute_range_bounds(sample_df, num_partitions: int,
                         ascending: Sequence[bool]) -> List[Tuple]:
    """num_partitions-1 boundary tuples from a sample of key rows
    (sampled once for the plan, the reference RangePartitioner role in
    ArrowShuffleExchangeExec301.scala:317-357)."""
    if len(sample_df) == 0 or num_partitions <= 1:
        return []
    s = sample_df.sort_values(
        list(sample_df.columns),
        ascending=list(ascending),
        na_position="first",
        kind="stable",
    ).reset_index(drop=True)
    n = len(s)
    bounds = []
    for k in range(1, num_partitions):
        idx = min(n - 1, (k * n) // num_partitions)
        row = tuple(
            None if (v is None or (isinstance(v, float) and np.isnan(v)))
            else v
            for v in s.iloc[idx]
        )
        bounds.append(row)
    return bounds


def range_ids(cb: ColumnBatch, key_exprs: Sequence[ir.Expr],
              bounds: Sequence[Tuple], ascending: Sequence[bool],
              num_partitions: int) -> torch.Tensor:
    """Range partition ids of a compacted batch on its device, int32 of
    its capacity, `num_partitions` past `num_rows`."""
    from blaze_tpu_torch.batch import _h2d

    cols = range_key_columns(cb, key_exprs)
    pid = np.full(cb.capacity, num_partitions, dtype=np.int32)
    pid[:cb.num_rows] = range_partition_ids(
        [v for v, _ in cols], bounds, ascending, [m for _, m in cols])
    return _h2d(pid, cb.device)


def append_parts(bufs: PartitionBuffers, rb: pa.RecordBatch,
                 offsets: np.ndarray, level: int) -> None:
    """One encoded part per non-empty partition of a scattered batch."""
    for p in np.flatnonzero(np.diff(offsets)):
        start = int(offsets[p])
        bufs.append(int(p), encode_ipc_segment(
            rb.slice(start, int(offsets[p + 1]) - start), level))


class ShuffleWriterExec(PhysicalOp):
    """Writes one map task's shuffle output. The output stream is empty
    (the lengths land in the index file), as in the reference
    (shuffle_writer_exec.rs:753-780)."""

    def __init__(self, child: PhysicalOp, key_exprs: Sequence[ir.Expr],
                 num_partitions: int, data_file: str, index_file: str,
                 mode: str = "hash",
                 range_bounds: Optional[Sequence[Tuple]] = None,
                 sort_ascending: Optional[Sequence[bool]] = None):
        if mode not in MODES:
            raise ValueError(f"shuffle writer mode {mode!r}")
        if mode in ("hash", "range") and not key_exprs:
            raise ValueError(f"{mode} partitioning requires keys")
        if num_partitions < 1:
            raise ValueError(f"num_partitions={num_partitions}")
        self.children = [child]
        self.key_exprs = [bind_opt(e, child.schema) for e in key_exprs]
        self.num_partitions = num_partitions
        self.data_file = data_file
        self.index_file = index_file
        self.mode = mode
        # range: the bounds are plan constants (sampled once for the
        # plan), so every map task splits alike
        self.range_bounds = list(range_bounds or []) if mode == "range" \
            else []
        self.sort_ascending = (
            list(sort_ascending) if sort_ascending is not None
            else [True] * len(key_exprs)) if mode == "range" else []

    @property
    def schema(self) -> Schema:
        return self.children[0].schema

    def describe(self) -> str:
        return (f"ShuffleWriterExec({self.mode}, "
                f"{self.num_partitions} partitions)")

    def execute(self, partition: int, ctx: ExecContext
                ) -> Iterator[ColumnBatch]:
        cfg = ctx.config
        n = self.num_partitions
        level = cfg.ipc_compression_level
        bufs = PartitionBuffers(n, cfg.spill_dir())
        rr_next = partition  # round robin starts at the map partition
        rows = 0
        try:
            for cb in self.children[0].execute(partition, ctx):
                cb = ensure_compacted(cb)
                if cb.num_rows == 0:
                    continue
                rows += cb.num_rows
                if self.mode == "single" or n == 1:
                    bufs.append(0, encode_ipc_segment(cb.to_arrow(), level))
                    continue
                if self.mode == "round_robin":
                    pids = round_robin_ids(cb, rr_next, n)
                    rr_next = (rr_next + cb.num_rows) % n
                elif self.mode == "range":
                    pids = range_ids(cb, self.key_exprs, self.range_bounds,
                                     self.sort_ascending, n)
                else:
                    pids = spark_partition_ids(cb, self.key_exprs, n)
                rb, offsets = scatter_by_partition(cb, pids, n)
                append_parts(bufs, rb, offsets, level)
        except BaseException:
            bufs.close()
            raise
        lengths = bufs.finalize(self.data_file, self.index_file)
        ctx.metrics.add("shuffle_rows_written", rows)
        ctx.metrics.add("shuffle_bytes_written", sum(lengths))
        return iter(())
