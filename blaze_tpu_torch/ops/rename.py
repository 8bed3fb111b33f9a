"""Zero-copy positional column rename (reference RenameColumnsExec,
rename_columns_exec.rs:38-75 - used to reconcile Spark attribute names
like `col#123` across plan fragments)."""

from __future__ import annotations

from typing import Iterator, List

from blaze_tpu_torch.types import Schema
from blaze_tpu_torch.batch import ColumnBatch
from blaze_tpu_torch.ops.base import ExecContext, PhysicalOp


class RenameColumnsExec(PhysicalOp):
    _FINGERPRINT_STABLE = True

    def _fingerprint_params(self) -> str:
        return ";".join(self.names)

    def __init__(self, child: PhysicalOp, names: List[str]):
        self.children = [child]
        self.names = list(names)
        self._schema = child.schema.rename(self.names)

    @property
    def schema(self) -> Schema:
        return self._schema

    def execute(self, partition: int, ctx: ExecContext
                ) -> Iterator[ColumnBatch]:
        for b in self.children[0].execute(partition, ctx):
            yield ColumnBatch(self._schema, b.columns, b.num_rows,
                              b.selection)
