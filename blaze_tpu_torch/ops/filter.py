"""Filter: predicate -> deferred selection vector.

Reference counterpart: DataFusion FilterExec (from_proto.rs:193-201;
wrapper NativeFilterExec.scala). As in the JAX package (ops/filter.py),
the predicate result is ANDed into the batch's selection mask and
compaction is deferred to the next pipeline breaker, so shapes stay at
their bucket and no host sync happens per batch. A predicate node with a
string input is evaluated on the host first (ops/host_lower.py).
"""

from __future__ import annotations

from typing import Iterator

from blaze_tpu_torch.types import Schema
from blaze_tpu_torch.batch import ColumnBatch
from blaze_tpu_torch.exprs import ir
from blaze_tpu_torch.exprs.optimize import bind_opt
from blaze_tpu_torch.exprs.eval import DeviceEvaluator
from blaze_tpu_torch.exprs.typing import expr_computes_wide_decimal
from blaze_tpu_torch.ops.base import ExecContext, PhysicalOp
from blaze_tpu_torch.ops.host_lower import lower_strings_host, needs_host
from blaze_tpu_torch.ops.project import batch_cvs


class FilterExec(PhysicalOp):
    _FINGERPRINT_STABLE = True

    def _fingerprint_params(self) -> str:
        return repr(self.predicate)

    def __init__(self, child: PhysicalOp, predicate: ir.Expr):
        self.children = [child]
        self.predicate = bind_opt(predicate, child.schema)
        if expr_computes_wide_decimal(self.predicate, child.schema):
            # the JAX package's routing gate and words
            raise NotImplementedError(
                "predicates on decimal(>18) are host-tier work"
            )
        self.host = needs_host(self.predicate, child.schema)

    @property
    def schema(self) -> Schema:
        return self.children[0].schema

    def execute(self, partition: int, ctx: ExecContext
                ) -> Iterator[ColumnBatch]:
        for cb in self.children[0].execute(partition, ctx):
            yield self._filter(cb)

    def _filter(self, cb: ColumnBatch) -> ColumnBatch:
        pred, aug = self.predicate, cb
        if self.host:
            (pred,), _, aug = lower_strings_host([pred], cb)
        ev = DeviceEvaluator(aug.schema, batch_cvs(aug), cb.capacity,
                             cb.device)
        keep = ev.evaluate_predicate(pred)
        if cb.selection is not None:
            keep = keep & cb.selection
        return ColumnBatch(cb.schema, cb.columns, cb.num_rows, keep)
