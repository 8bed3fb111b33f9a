"""Per-partition limit (Spark CollectLimit/LocalLimit analog)."""

from __future__ import annotations

from typing import Iterator

from blaze_tpu_torch.types import Schema
from blaze_tpu_torch.batch import ColumnBatch
from blaze_tpu_torch.ops.base import ExecContext, PhysicalOp
from blaze_tpu_torch.ops.util import ensure_compacted


class LimitExec(PhysicalOp):
    def __init__(self, child: PhysicalOp, limit: int):
        self.children = [child]
        self.limit = limit

    @property
    def schema(self) -> Schema:
        return self.children[0].schema

    def describe(self) -> str:
        return f"LimitExec[{self.limit}]"

    def execute(self, partition: int, ctx: ExecContext
                ) -> Iterator[ColumnBatch]:
        remaining = self.limit
        for cb in self.children[0].execute(partition, ctx):
            if remaining <= 0:
                return
            # a pending selection compacts first (kernel K2)
            cb = ensure_compacted(cb)
            if cb.num_rows > remaining:
                cb = ColumnBatch(cb.schema, cb.columns, remaining)
            remaining -= cb.num_rows
            yield cb
