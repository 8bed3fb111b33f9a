"""N empty partitions of a schema (reference EmptyPartitionsExec,
empty_partitions_exec.rs:37-50)."""

from __future__ import annotations

from typing import Iterator

from blaze_tpu_torch.types import Schema
from blaze_tpu_torch.batch import ColumnBatch
from blaze_tpu_torch.ops.base import ExecContext, PhysicalOp


class EmptyPartitionsExec(PhysicalOp):
    def __init__(self, schema: Schema, num_partitions: int):
        self.children = []
        self._schema = schema
        self._n = num_partitions

    @property
    def schema(self) -> Schema:
        return self._schema

    @property
    def partition_count(self) -> int:
        return self._n

    def execute(self, partition: int, ctx: ExecContext
                ) -> Iterator[ColumnBatch]:
        return iter(())
