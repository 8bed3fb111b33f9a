"""Projection: evaluate expressions into a new column set.

Reference counterpart: DataFusion ProjectionExec built from proto
(from_proto.rs:173-192; wrapper NativeProjectExec.scala:61-77). The
expressions run eagerly, op by op, on the batch's device; the pending
selection rides through unchanged. Nodes with a string input are
evaluated on the host first (ops/host_lower.py); a string output column
keeps the dictionary of the column it passes through.
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
from blaze_tpu_torch.ops.host_lower import lower_strings_host, needs_host


def batch_cvs(cb: ColumnBatch) -> List[CV]:
    """(values, validity) pairs of a batch's columns, evaluator input."""
    return [(c.values, c.validity) for c in cb.columns]


class ProjectExec(PhysicalOp):
    _FINGERPRINT_STABLE = True

    def _fingerprint_params(self) -> str:
        return ";".join(f"{n}={e!r}" for e, n in self.exprs)

    def __init__(self, child: PhysicalOp,
                 exprs: Sequence[Tuple[ir.Expr, str]]):
        self.children = [child]
        self.exprs = [(bind_opt(e, child.schema), name) for e, name in exprs]
        for e, _ in self.exprs:
            if expr_computes_wide_decimal(e, child.schema):
                # the JAX package's routing gate and words
                raise NotImplementedError(
                    "compute on decimal(>18) is host-tier work"
                )
        self.host = any(needs_host(e, child.schema) for e, _ in self.exprs)
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
        exprs, aug = [e for e, _ in self.exprs], cb
        if self.host:
            exprs, _, aug = lower_strings_host(exprs, cb)
        ev = DeviceEvaluator(aug.schema, batch_cvs(aug), cb.capacity,
                             cb.device)
        out_cols: List[Column] = []
        for e, field in zip(exprs, self._schema):
            v, m = ev.evaluate(e)
            out_cols.append(Column(field.dtype, v, m,
                                   passthrough_dictionary(e, aug)))
        return ColumnBatch(self._schema, out_cols, cb.num_rows,
                           cb.selection)


def passthrough_dictionary(e: ir.Expr, cb: ColumnBatch):
    """The dictionary of a string column an expression passes through
    (a column reference), else None."""
    if isinstance(e, ir.BoundCol):
        return cb.columns[e.index].dictionary
    return None
