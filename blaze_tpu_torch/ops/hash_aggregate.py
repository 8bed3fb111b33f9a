"""Hash aggregate, keyless: PARTIAL / FINAL / COMPLETE modes.

Reference counterpart: DataFusion AggregateExec built from proto
(from_proto.rs:452-545) with Spark's two-phase mode mapping
(NativeHashAggregateExec.scala:98-161). This slice ports the keyless
(global) aggregate of the JAX package's ops/hash_aggregate.py for
COUNT, COUNT(*), SUM, AVG, MIN and MAX over fixed-width non-decimal
input (MIN/MAX/COUNT also take decimal(<=18)). Grouping keys, decimal
SUM/AVG, FIRST/LAST and the variance family wait for ROADMAP
'Modules to port' item 3 (grouped_agg with kernel K3) and raise
NotImplementedError at construction.

The keyless case is one group, so every state is a masked reduction.
Kernel K1 (ops/kernels/stats.py) gives the sum, min, max and non-null
count of a column in one launch, where the JAX package runs two or
three reductions (`_SegOps.scalar`). States are (1,)-shaped device
tensors; they stay on the device across batches and leave it once, at
the end of the stream.

A COMPLETE aggregate whose input exceeds `max_materialize_rows` folds
per-batch PARTIAL states and merges them with one FINAL pass (the
keyless branch of the JAX package's `_execute_external`,
hash_aggregate.py:503-538); smaller inputs are concatenated and
aggregated once.
"""

from __future__ import annotations

import enum
from typing import Iterator, List, Sequence, Tuple

import torch

from blaze_tpu_torch.config import get_config
from blaze_tpu_torch.types import DataType, Field, Schema, TypeId
from blaze_tpu_torch.batch import Column, ColumnBatch, torch_dtype
from blaze_tpu_torch.exprs import ir
from blaze_tpu_torch.exprs.optimize import bind_opt
from blaze_tpu_torch.exprs.ir import AggExpr, AggFn
from blaze_tpu_torch.exprs.eval import DeviceEvaluator
from blaze_tpu_torch.exprs.typing import infer_dtype
from blaze_tpu_torch.ops.base import ExecContext, PhysicalOp
from blaze_tpu_torch.ops.external import collect_until
from blaze_tpu_torch.ops.kernels.stats import masked_stats
from blaze_tpu_torch.ops.project import batch_cvs
from blaze_tpu_torch.ops.util import concat_batches

_ROADMAP_GROUPED = "ROADMAP 'Modules to port' item 3 (grouped_agg, K3)"
_SUPPORTED = (AggFn.COUNT, AggFn.COUNT_STAR, AggFn.SUM, AggFn.AVG,
              AggFn.MIN, AggFn.MAX)


class AggMode(enum.Enum):
    PARTIAL = "partial"
    FINAL = "final"
    COMPLETE = "complete"


class _SchemaStub:
    """Placeholder child carrying only a schema (internal op wiring)."""

    def __init__(self, schema: Schema):
        self.children = []
        self._schema = schema

    @property
    def schema(self) -> Schema:
        return self._schema

    @property
    def partition_count(self) -> int:
        return 1


def _sum_type(ct: DataType) -> DataType:
    if ct.is_integer:
        return DataType.int64()
    if ct.id is TypeId.DECIMAL:
        return DataType.decimal(38, ct.scale)
    return DataType.float64()


def _state_fields(agg: AggExpr, name: str, in_schema: Schema) -> List[Field]:
    fn = agg.fn
    if fn in (AggFn.COUNT, AggFn.COUNT_STAR):
        return [Field(f"{name}#count", DataType.int64(), False)]
    ct = infer_dtype(agg.child, in_schema)
    if fn is AggFn.SUM:
        return [Field(f"{name}#sum", _sum_type(ct), True)]
    if fn in (AggFn.MIN, AggFn.MAX):
        return [Field(f"{name}#{fn.value}", ct, True)]
    return [  # AVG
        Field(f"{name}#sum", _sum_type(ct), True),
        Field(f"{name}#count", DataType.int64(), False),
    ]


def _state_width(fn: AggFn) -> int:
    return 2 if fn is AggFn.AVG else 1


def _result_type(a: AggExpr, in_schema: Schema, mode: AggMode) -> DataType:
    if mode is AggMode.FINAL:
        # child is a BoundCol at the first state column (see __init__)
        if a.fn in (AggFn.COUNT, AggFn.COUNT_STAR):
            return DataType.int64()
        if a.fn is AggFn.AVG:
            return DataType.float64()
        return a.child.dtype
    return infer_dtype(a, in_schema)


def _stats(values: torch.Tensor, mask: torch.Tensor):
    """K1 over a column of any fixed-width dtype: bool, int8 and int16
    widen to int32 (sums are int64 either way); min and max come back in
    the column's own dtype."""
    src = values.dtype
    if src in (torch.bool, torch.int8, torch.int16):
        values = values.to(torch.int32)
    s, lo, hi, cnt = masked_stats(values, mask)
    return s, lo.to(src), hi.to(src), cnt


class HashAggregateExec(PhysicalOp):
    def __init__(
        self,
        child: PhysicalOp,
        keys: Sequence[Tuple[ir.Expr, str]],
        aggs: Sequence[Tuple[AggExpr, str]],
        mode: AggMode = AggMode.COMPLETE,
    ):
        if keys:
            raise NotImplementedError(
                f"grouping keys wait for {_ROADMAP_GROUPED}")
        self.children = [child]
        self.mode = mode
        self.keys: List = []
        in_schema = child.schema
        for a, _ in aggs:
            if a.fn not in _SUPPORTED:
                raise NotImplementedError(
                    f"{a.fn.value} waits for {_ROADMAP_GROUPED}")
        if mode is AggMode.FINAL:
            # states are located positionally in the partial output, in
            # agg order (NativeHashAggregateExec.scala:98-161)
            self.aggs = []
            self._final_widths: List[int] = []
            pos = 0
            for a, n in aggs:
                first_state = in_schema.fields[pos]
                if "#dsum" in first_state.name:
                    raise NotImplementedError(
                        f"decimal SUM/AVG states wait for {_ROADMAP_GROUPED}")
                self.aggs.append(
                    (AggExpr(a.fn, ir.BoundCol(pos, first_state.dtype)), n))
                self._final_widths.append(_state_width(a.fn))
                pos += _state_width(a.fn)
        else:
            self.aggs = [
                (AggExpr(a.fn, bind_opt(a.child, in_schema)
                         if a.child is not None else None), n)
                for a, n in aggs
            ]
            for a, _ in self.aggs:
                if a.child is None:
                    continue
                ct = infer_dtype(a.child, in_schema)
                if ct.is_string_like or ct.is_wide_decimal or (
                    ct.id is TypeId.DECIMAL
                    and a.fn in (AggFn.SUM, AggFn.AVG)
                ):
                    raise NotImplementedError(
                        f"{a.fn.value} over {ct} waits for "
                        f"{_ROADMAP_GROUPED}")
        if mode is AggMode.PARTIAL:
            fields: List[Field] = []
            for a, n in self.aggs:
                fields += _state_fields(a, n, in_schema)
            self._schema = Schema(fields)
        else:
            self._schema = Schema([
                Field(n, _result_type(a, in_schema, mode), True)
                for a, n in self.aggs
            ])

    @property
    def schema(self) -> Schema:
        return self._schema

    # ------------------------------------------------------------------
    def execute(self, partition: int, ctx: ExecContext
                ) -> Iterator[ColumnBatch]:
        child_it = self.children[0].execute(partition, ctx)
        if self.mode is AggMode.PARTIAL:
            for cb in child_it:
                yield self._aggregate_batch(cb)
            return
        batches, exceeded = collect_until(
            child_it, ctx.config.max_materialize_rows
        )
        if exceeded:
            yield from self._execute_external(batches, child_it, ctx)
            return
        cb = concat_batches(batches, self.children[0].schema, ctx.device)
        if cb.num_rows == 0:
            # global aggregate over empty input still emits one row
            yield _empty_global_row(self, ctx.device)
            return
        yield self._aggregate_batch(cb)

    def _execute_external(self, head, rest, ctx: ExecContext
                          ) -> Iterator[ColumnBatch]:
        """Oversized keyless input: fold one PARTIAL state row per input
        batch, then merge them with one FINAL pass."""
        in_schema = self.children[0].schema
        if self.mode is AggMode.FINAL:
            # keyless FINAL consumes tiny partial-state rows (one per
            # upstream batch); concat is still bounded
            yield self._aggregate_batch(concat_batches(
                list(head) + list(rest), in_schema, ctx.device))
            return
        partial = HashAggregateExec(
            self.children[0], keys=[], aggs=list(self.aggs),
            mode=AggMode.PARTIAL,
        )
        partials = []
        for cb in head:
            partials.append(partial._aggregate_batch(cb))
        for cb in rest:
            partials.append(partial._aggregate_batch(cb))
        if not partials:
            yield _empty_global_row(self, ctx.device)
            return
        final = HashAggregateExec(
            _SchemaStub(partial.schema), keys=[], aggs=list(self.aggs),
            mode=AggMode.FINAL,
        )
        yield final._aggregate_batch(
            concat_batches(partials, partial.schema, ctx.device))

    # ------------------------------------------------------------------
    def _aggregate_batch(self, cb: ColumnBatch) -> ColumnBatch:
        """One state (or result) row from the batch's live rows."""
        live = cb.live_mask()
        cols = batch_cvs(cb)
        ev = DeviceEvaluator(cb.schema, cols, cb.capacity, cb.device)
        outs: List = []
        pos = 0
        for i, (a, _) in enumerate(self.aggs):
            if self.mode is AggMode.FINAL:
                width = self._final_widths[i]
                outs.extend(self._merge_states(a, cols[pos: pos + width],
                                               live))
                pos += width
            else:
                outs.extend(self._agg_state(a, ev, live))
        out_cols = [
            Column(f.dtype, v.to(torch_dtype(f.dtype)), m)
            for (v, m), f in zip(outs, self._schema.fields)
        ]
        return ColumnBatch(self._schema, out_cols, 1)

    def _agg_state(self, a: AggExpr, ev: DeviceEvaluator,
                   live: torch.Tensor):
        """(value, validity) state/result columns for one aggregate over
        raw input rows."""
        fn = a.fn
        if fn is AggFn.COUNT_STAR:
            return [(live.sum(dtype=torch.int64).reshape(1), None)]
        cv, cm = ev.evaluate(a.child)
        contrib = live if cm is None else live & cm
        if fn is AggFn.COUNT:
            return [(contrib.sum(dtype=torch.int64).reshape(1), None)]
        s, lo, hi, cnt = _stats(cv, contrib)
        any_v = cnt > 0
        if fn is AggFn.MIN:
            return [(lo, any_v)]
        if fn is AggFn.MAX:
            return [(hi, any_v)]
        if fn is AggFn.SUM:
            return [(s, any_v)]
        if self.mode is AggMode.PARTIAL:  # AVG
            return [(s, any_v), (cnt, None)]
        return [(s / cnt.clamp(min=1).to(torch.float64), any_v)]

    def _merge_states(self, a: AggExpr, states, live: torch.Tensor):
        """FINAL: merge PARTIAL state columns into the result column."""
        fn = a.fn
        v, m = states[0]
        contrib = live if m is None else live & m
        if fn in (AggFn.COUNT, AggFn.COUNT_STAR):
            s, _, _, _ = _stats(v, live)
            return [(s, None)]
        if fn is AggFn.AVG:
            s, _, _, _ = _stats(v, contrib)
            c, _, _, _ = _stats(states[1][0], live)
            return [(s.to(torch.float64) / c.clamp(min=1).to(torch.float64),
                     c > 0)]
        s, lo, hi, cnt = _stats(v, contrib)
        out = {AggFn.SUM: s, AggFn.MIN: lo, AggFn.MAX: hi}[fn]
        return [(out, cnt > 0)]


def _empty_global_row(op: HashAggregateExec,
                      device: torch.device) -> ColumnBatch:
    """Global aggregate of an empty stream: COUNT=0, others NULL."""
    cap = get_config().shape_buckets[0]
    cols = []
    for field, (a, _) in zip(op.schema.fields, op.aggs):
        v = torch.zeros(cap, dtype=torch_dtype(field.dtype), device=device)
        m = None
        if a.fn not in (AggFn.COUNT, AggFn.COUNT_STAR):
            m = torch.zeros(cap, dtype=torch.bool, device=device)
        cols.append(Column(field.dtype, v, m))
    return ColumnBatch(op.schema, cols, 1)
