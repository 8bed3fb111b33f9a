"""External (grace) execution: hash-bucket an oversized input through
the engine's own shuffle format, then process it bucket by bucket.

A port of the JAX package's ops/external.py. An aggregate materializes
its input, which caps the rows it takes at once
(`max_materialize_rows`); past that, the input is bucketed by the
murmur3 hash of its keys (kernel K4, the shuffle writer's scatter and
segmented-IPC parts, on disk) and every group lands wholly in one
bucket, so buckets aggregate independently.
"""

from __future__ import annotations

import os
import tempfile
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import torch

from blaze_tpu_torch.batch import ColumnBatch
from blaze_tpu_torch.exprs import ir
from blaze_tpu_torch.io.ipc import coalesce, partition_ranges, \
    read_file_segment
from blaze_tpu_torch.ops.base import ExecContext
from blaze_tpu_torch.ops.shuffle_writer import (
    PartitionBuffers,
    append_parts,
    scatter_by_partition,
    spark_partition_ids,
)
from blaze_tpu_torch.ops.util import ensure_compacted
from blaze_tpu_torch.types import Schema

PidFn = Callable[[ColumnBatch], torch.Tensor]


class BucketedInput:
    """A stream hash-bucketed into an on-disk .data/.index pair."""

    def __init__(self, data_path: str, index_path: str, schema: Schema,
                 n_buckets: int, device: torch.device, batch_rows: int):
        self.data_path = data_path
        self.index_path = index_path
        self.schema = schema
        self.n_buckets = n_buckets
        self.device = device
        self.batch_rows = batch_rows

    def bucket(self, i: int) -> Iterator[ColumnBatch]:
        off, length = partition_ranges(self.index_path)[i]
        if length == 0:
            return
        for rb in coalesce(read_file_segment(self.data_path, off, length),
                           self.batch_rows):
            yield ColumnBatch.from_arrow(rb, device=self.device)

    def cleanup(self) -> None:
        for p in (self.data_path, self.index_path):
            try:
                os.remove(p)
            except OSError:
                pass


def subdivide_pid_fn(key_exprs: Sequence[ir.Expr], parent_modulus: int,
                     fanout: int = 4) -> PidFn:
    """Partition ids that split one parent bucket into `fanout` children
    by the next hash bits: the rows of a parent bucket share
    h % parent_modulus, so pmod(h, parent_modulus * fanout) //
    parent_modulus spreads them over 0..fanout-1 (K4 with that product
    as its run-time n). The padding's sentinel becomes `fanout`."""

    def pid(cb: ColumnBatch) -> torch.Tensor:
        wide = spark_partition_ids(cb, list(key_exprs),
                                   parent_modulus * fanout)
        return torch.div(wide, parent_modulus, rounding_mode="floor")

    return pid


def bucket_stream(
    batches: Iterator[ColumnBatch],
    key_exprs: Sequence[ir.Expr],
    n_buckets: int,
    ctx: ExecContext,
    schema: Schema,
    head: Sequence[ColumnBatch] = (),
    pid_fn: Optional[PidFn] = None,
) -> BucketedInput:
    """Write head + the rest of the stream into n_buckets hash buckets
    with the shuffle writer's scatter and parts. `pid_fn` replaces the
    partition ids (grace recursion)."""
    d = ctx.config.spill_dir()
    fd, data_path = tempfile.mkstemp(prefix="blz-ext-", suffix=".data",
                                     dir=d)
    os.close(fd)
    index_path = data_path[:-5] + ".index"
    bufs = PartitionBuffers(n_buckets, d)
    level = ctx.config.ipc_compression_level

    def feed(cb: ColumnBatch) -> None:
        cb = ensure_compacted(cb)
        if cb.num_rows == 0:
            return
        pids = (pid_fn(cb) if pid_fn is not None
                else spark_partition_ids(cb, list(key_exprs), n_buckets))
        rb, offsets = scatter_by_partition(cb, pids, n_buckets)
        append_parts(bufs, rb, offsets, level)

    try:
        for cb in head:
            feed(cb)
        for cb in batches:
            feed(cb)
    except BaseException:
        bufs.close()
        os.remove(data_path)
        raise
    bufs.finalize(data_path, index_path)
    return BucketedInput(data_path, index_path, schema, n_buckets,
                         ctx.device, ctx.config.batch_size)


def collect_until(
    it: Iterator[ColumnBatch], row_limit: int
) -> Tuple[List[ColumnBatch], bool]:
    """Pull batches until the stream ends or row_limit is crossed.
    Returns (collected, exceeded)."""
    out: List[ColumnBatch] = []
    total = 0
    for cb in it:
        out.append(cb)
        total += cb.num_rows
        if total > row_limit:
            return out, True
    return out, False
