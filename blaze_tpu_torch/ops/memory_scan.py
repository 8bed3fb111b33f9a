"""In-memory scan: the test/bench fixture leaf (DataFusion MemoryExec
analog; the reference's join unit tests are built on the same pattern,
sort_merge_join_exec.rs build_table fixtures). A partition holds
ColumnBatches, or pyarrow RecordBatches that enter the device of the
executing task (how planner/convert.py builds a MemorySpec's scan, before
any task has a device)."""

from __future__ import annotations

from typing import Iterator, List, Sequence

from blaze_tpu_torch.types import Schema
from blaze_tpu_torch.batch import ColumnBatch
from blaze_tpu_torch.ops.base import ExecContext, PhysicalOp


class MemoryScanExec(PhysicalOp):
    def __init__(self, partitions: Sequence[List[ColumnBatch]],
                 schema: Schema):
        self.partitions = list(partitions)
        self._schema = schema
        self.children = []

    @property
    def schema(self) -> Schema:
        return self._schema

    @property
    def partition_count(self) -> int:
        return len(self.partitions)

    def execute(self, partition: int, ctx: ExecContext
                ) -> Iterator[ColumnBatch]:
        for b in self.partitions[partition]:
            if isinstance(b, ColumnBatch):
                yield b
            else:
                yield ColumnBatch.from_arrow(b, device=ctx.device)
