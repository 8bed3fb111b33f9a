"""IPC writer: collect a partition's batches as compressed IPC parts.

Reference counterpart: IpcWriterExec (ipc_writer_exec.rs), which hands
length-prefixed zstd IPC parts to a consumer (there a JVM lambda; here
the context's resource registry). It feeds a broadcast exchange's
collection."""

from __future__ import annotations

from typing import Iterator, List

from blaze_tpu_torch.batch import ColumnBatch
from blaze_tpu_torch.io.ipc import encode_ipc_segment
from blaze_tpu_torch.ops.base import ExecContext, PhysicalOp
from blaze_tpu_torch.ops.util import ensure_compacted
from blaze_tpu_torch.types import Schema


class IpcWriterExec(PhysicalOp):
    def __init__(self, child: PhysicalOp, resource_id: str):
        self.children = [child]
        self.resource_id = resource_id

    @property
    def schema(self) -> Schema:
        return self.children[0].schema

    def describe(self) -> str:
        return f"IpcWriterExec({self.resource_id!r})"

    def execute(self, partition: int, ctx: ExecContext
                ) -> Iterator[ColumnBatch]:
        sink = ctx.resources.setdefault(self.resource_id, [])
        nbytes = 0
        for cb in self.children[0].execute(partition, ctx):
            cb = ensure_compacted(cb)
            if cb.num_rows == 0:
                continue
            part = encode_ipc_segment(cb.to_arrow(),
                                      ctx.config.ipc_compression_level)
            nbytes += len(part)
            sink.append(part)
        ctx.metrics.add("ipc_bytes_written", nbytes)
        return iter(())


def collect_ipc(child: PhysicalOp, ctx: ExecContext) -> List[bytes]:
    """Run every partition through an IpcWriter and return the parts
    (the reference's broadcast collect,
    ArrowBroadcastExchangeExec.scala:178-222)."""
    rid = f"collect-{id(child):x}"
    op = IpcWriterExec(child, rid)
    ctx.resources[rid] = []
    for p in range(child.partition_count):
        for _ in op.execute(p, ctx):
            pass
    return ctx.resources.pop(rid)
