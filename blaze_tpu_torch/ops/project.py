"""Projection: evaluate expressions into a new column set.

Reference counterpart: DataFusion ProjectionExec built from proto
(from_proto.rs:173-192; wrapper NativeProjectExec.scala:61-77). The
expressions run eagerly, op by op, on the batch's device; the pending
selection rides through unchanged.
"""

from __future__ import annotations

from typing import Iterator, List, Sequence, Tuple

from blaze_tpu_torch.types import Field, Schema
from blaze_tpu_torch.batch import Column, ColumnBatch
from blaze_tpu_torch.exprs import ir
from blaze_tpu_torch.exprs.optimize import bind_opt
from blaze_tpu_torch.exprs.eval import CV, DeviceEvaluator
from blaze_tpu_torch.exprs.typing import (
    expr_computes_wide_decimal,
    infer_dtype,
)
from blaze_tpu_torch.ops.base import ExecContext, PhysicalOp


def batch_cvs(cb: ColumnBatch) -> List[CV]:
    """(values, validity) pairs of a batch's columns, evaluator input."""
    return [(c.values, c.validity) for c in cb.columns]


class ProjectExec(PhysicalOp):
    def __init__(self, child: PhysicalOp,
                 exprs: Sequence[Tuple[ir.Expr, str]]):
        self.children = [child]
        self.exprs = [(bind_opt(e, child.schema), name) for e, name in exprs]
        for e, _ in self.exprs:
            if expr_computes_wide_decimal(e, child.schema):
                raise NotImplementedError(
                    "compute on decimal(>18) waits for ROADMAP "
                    "'Modules to port': expressions and types"
                )
        self._schema = Schema(
            [
                Field(name, infer_dtype(e, child.schema), True)
                for e, name in self.exprs
            ]
        )

    @property
    def schema(self) -> Schema:
        return self._schema

    def execute(self, partition: int, ctx: ExecContext
                ) -> Iterator[ColumnBatch]:
        for cb in self.children[0].execute(partition, ctx):
            yield self._project(cb)

    def _project(self, cb: ColumnBatch) -> ColumnBatch:
        ev = DeviceEvaluator(cb.schema, batch_cvs(cb), cb.capacity,
                             cb.device)
        out_cols: List[Column] = []
        for (e, _), field in zip(self.exprs, self._schema):
            v, m = ev.evaluate(e)
            out_cols.append(Column(field.dtype, v, m))
        return ColumnBatch(self._schema, out_cols, cb.num_rows,
                           cb.selection)
