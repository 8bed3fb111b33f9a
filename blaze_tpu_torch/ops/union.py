"""Union: append children's partitions (reference: DataFusion UnionExec,
from_proto.rs:429-436; wrapper NativeUnionExec.scala remaps child
partitions the same way), and CoalescePartitionsExec."""

from __future__ import annotations

from typing import Iterator, List

from blaze_tpu_torch.types import Schema
from blaze_tpu_torch.batch import ColumnBatch
from blaze_tpu_torch.ops.base import ExecContext, PhysicalOp


class UnionExec(PhysicalOp):
    def __init__(self, children: List[PhysicalOp]):
        if not children:
            raise ValueError("UnionExec needs at least one child")
        self.children = list(children)

    @property
    def schema(self) -> Schema:
        return self.children[0].schema

    @property
    def partition_count(self) -> int:
        return sum(c.partition_count for c in self.children)

    def execute(self, partition: int, ctx: ExecContext
                ) -> Iterator[ColumnBatch]:
        for child in self.children:
            n = child.partition_count
            if partition < n:
                for b in child.execute(partition, ctx):
                    # positional union: rename to the union schema
                    yield ColumnBatch(self.schema, b.columns, b.num_rows,
                                      b.selection)
                return
            partition -= n
        raise IndexError("partition out of range")


class CoalescePartitionsExec(PhysicalOp):
    """Merge every child partition into one (Spark
    CoalescePartitionsExec)."""

    def __init__(self, child: PhysicalOp):
        self.children = [child]

    @property
    def schema(self) -> Schema:
        return self.children[0].schema

    @property
    def partition_count(self) -> int:
        return 1

    def execute(self, partition: int, ctx: ExecContext
                ) -> Iterator[ColumnBatch]:
        if partition != 0:
            raise IndexError("partition out of range")
        child = self.children[0]
        for p in range(child.partition_count):
            yield from child.execute(p, ctx)
