"""IPC reader: the leaf that consumes an exchange.

Reference counterpart: IpcReaderExec (ipc_reader_exec.rs) with its three
modes (rs:83-93): CHANNEL_UNCOMPRESSED (decoded batches), CHANNEL
(compressed part bytes) and CHANNEL_AND_FILE_SEGMENT (a shuffle read:
local segments read from the .data file by path, offset and length,
remote ones streamed off another host's BlockServer,
runtime/transport.py). Sources come through the context's resource
registry, the analog of the reference's JniBridge resource map
(JniBridge.java:31).

Decoded Arrow batches of one schema are concatenated on the host up to
`batch_size` rows before they go to the device: a reduce task reads one
small part per map batch and partition, and each batch that crosses
costs a copy per buffer.
"""

from __future__ import annotations

import enum
from typing import Iterator

import pyarrow as pa

from blaze_tpu_torch.batch import ColumnBatch
from blaze_tpu_torch.io.ipc import (
    coalesce,
    decode_ipc_parts,
    decode_ipc_stream,
    read_file_segment,
)
from blaze_tpu_torch.ops.base import ExecContext, PhysicalOp
from blaze_tpu_torch.runtime.prefetch import prefetch
from blaze_tpu_torch.runtime.transport import (
    RemoteSegment,
    iter_remote_batches,
)
from blaze_tpu_torch.types import Schema


class IpcReadMode(enum.Enum):
    CHANNEL_UNCOMPRESSED = "channel_uncompressed"
    CHANNEL = "channel"
    CHANNEL_AND_FILE_SEGMENT = "channel_and_file_segment"


class FileSegment:
    """A byte range of a local .data file: one map task's output for
    one partition."""

    def __init__(self, path: str, offset: int, length: int):
        self.path = path
        self.offset = offset
        self.length = length

    def __repr__(self) -> str:
        return f"FileSegment({self.path!r}, {self.offset}, {self.length})"


def _source_batches(src) -> Iterator[pa.RecordBatch]:
    if isinstance(src, RemoteSegment):
        # a block on another host's BlockServer (the reference's
        # remote-fetch path, ipc_reader_exec.rs:283-326)
        return iter_remote_batches(src)
    if isinstance(src, FileSegment):
        return read_file_segment(src.path, src.offset, src.length)
    if isinstance(src, (bytes, bytearray, memoryview)):
        return decode_ipc_parts(bytes(src))
    if isinstance(src, pa.RecordBatch):
        return iter((src,))
    if hasattr(src, "read"):
        # a stream of parts (the reference's ReadableByteChannel path)
        return decode_ipc_stream(src)
    raise TypeError(f"IPC source of type {type(src).__name__}")


class IpcReaderExec(PhysicalOp):
    """Leaf reading IPC sources for each partition.

    `ctx.resources[resource_id]` holds a list of source lists (one per
    partition) or a callable partition -> list of sources. A source is
    compressed part bytes, a FileSegment, a RemoteSegment, a decoded
    RecordBatch, or a file-like stream of parts."""

    def __init__(self, resource_id: str, schema: Schema,
                 num_partitions: int,
                 mode: IpcReadMode = IpcReadMode.CHANNEL):
        self.children = []
        self.resource_id = resource_id
        self._schema = schema
        self._n = num_partitions
        self.mode = mode

    @property
    def schema(self) -> Schema:
        return self._schema

    @property
    def partition_count(self) -> int:
        return self._n

    def describe(self) -> str:
        return f"IpcReaderExec({self.resource_id!r}, {self.mode.value})"

    def execute(self, partition: int, ctx: ExecContext
                ) -> Iterator[ColumnBatch]:
        provider = ctx.resources[self.resource_id]
        sources = (provider(partition) if callable(provider)
                   else provider[partition])
        device = ctx.device
        limit = ctx.config.batch_size

        def arrow() -> Iterator[pa.RecordBatch]:
            for src in sources:
                yield from _source_batches(src)

        def batches() -> Iterator[ColumnBatch]:
            rows = 0
            for rb in coalesce(arrow(), limit):
                rows += rb.num_rows
                yield ColumnBatch.from_arrow(rb, device=device)
            ctx.metrics.add("ipc_rows_read", rows)

        # decode and copy the next batch while the consumer computes on
        # this one (the reduce-side twin of the scan's pipeline)
        yield from prefetch(batches(), depth=2)
