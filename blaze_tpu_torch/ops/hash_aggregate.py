"""Hash aggregate: PARTIAL / FINAL / COMPLETE, keyless and keyed.

Reference counterpart: DataFusion AggregateExec built from proto
(from_proto.rs:452-545) with Spark's two-phase mode mapping
(NativeHashAggregateExec.scala:98-161). A port of the JAX package's
ops/hash_aggregate.py for COUNT, COUNT(*), SUM, AVG, MIN, MAX, FIRST,
LAST and the variance family over fixed-width input. Decimal SUM/AVG
(chunked 128-bit states) and string keys raise NotImplementedError at
construction, naming the ROADMAP item that brings them.

Keyless: one group, so every state is a masked reduction. Kernel K1
(ops/kernels/stats.py) gives a column's sum, min, max and non-null count
in one launch. States are (1,)-shaped device tensors.

Keyed: the JAX package's scatter core. Rows take raw hash-table slots
(ops/hash_table.group_slots: direct indexing for one narrow integer key,
else exact-key open addressing); every reduction runs on kernel K3
(ops/kernels/segreduce.py) over the table's slot domain, and only the
per-group results are gathered at the occupied slots (compacted by K2,
ops/util.occupied_slots), in slot order - the JAX package's group order.
Group keys come out of each group's first row. The table is sized by
the group-capacity ladder (`run_grouped_kernel` in the JAX package):
4096 group slots, then 65,536, then unsliced; more groups
than a tier holds, or a probe loop cut off by its round bound, climb to
the next tier.

A COMPLETE or FINAL input over `max_materialize_rows` rows: keyless, it
folds per-batch PARTIAL states and merges them once; keyed, it takes the
JAX package's grace aggregation (`_execute_external`, `_grace_agg`):
the input is hash-bucketed on its keys (ops/external.py, kernel K4) and
each bucket aggregates alone; a bucket still over the limit is bucketed
again by the next hash bits, and at the greatest depth a COMPLETE bucket
(one hot key) aggregates chunk by chunk into PARTIAL states merged once.
"""

from __future__ import annotations

import enum
import itertools
from typing import Iterator, List, Optional, Sequence, Tuple

import torch

from blaze_tpu_torch.config import get_config
from blaze_tpu_torch.types import DataType, Field, Schema, TypeId
from blaze_tpu_torch.batch import Column, ColumnBatch, torch_dtype
from blaze_tpu_torch.exprs import ir
from blaze_tpu_torch.exprs.optimize import bind_opt
from blaze_tpu_torch.exprs.ir import AggExpr, AggFn
from blaze_tpu_torch.exprs.eval import DeviceEvaluator
from blaze_tpu_torch.exprs.typing import infer_dtype
from blaze_tpu_torch.ops import hash_table as ht
from blaze_tpu_torch.ops.base import ExecContext, PhysicalOp
from blaze_tpu_torch.ops.external import (
    bucket_stream,
    collect_until,
    subdivide_pid_fn,
)
from blaze_tpu_torch.ops.kernels import segreduce
from blaze_tpu_torch.ops.kernels.stats import masked_stats
from blaze_tpu_torch.ops.project import batch_cvs
from blaze_tpu_torch.ops.util import concat_batches, occupied_slots
from blaze_tpu_torch.runtime.dispatch import host_int
from blaze_tpu_torch.runtime.memory import (
    batch_device_bytes,
    choose_external_bucket_count,
    get_device_tracker,
)

_ROADMAP_DECIMAL = ("ROADMAP 'Modules to port' item 3 (decimal SUM/AVG "
                    "states, with decimal128)")
_ROADMAP_STRINGS = ("ROADMAP 'Modules to port' item 3 (dictionary-encoded "
                    "strings)")
_VARIANCE = (AggFn.VAR_SAMP, AggFn.VAR_POP, AggFn.STDDEV_SAMP,
             AggFn.STDDEV_POP)
# first and second tiers of the group-capacity ladder (the JAX package's
# defaults for BLAZE_AGG_TIER1 and agg_group_capacity)
_TIER1_GROUPS = 4096
_TIER2_GROUPS = 65536


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
    if fn in (AggFn.MIN, AggFn.MAX, AggFn.FIRST, AggFn.LAST):
        return [Field(f"{name}#{fn.value}", ct, True)]
    if fn is AggFn.AVG:
        return [
            Field(f"{name}#sum", _sum_type(ct), True),
            Field(f"{name}#count", DataType.int64(), False),
        ]
    # var/stddev family: plain-summable moments
    return [
        Field(f"{name}#n", DataType.float64(), False),
        Field(f"{name}#s1", DataType.float64(), False),
        Field(f"{name}#s2", DataType.float64(), False),
    ]


def _state_width(fn: AggFn) -> int:
    if fn is AggFn.AVG:
        return 2
    return 3 if fn in _VARIANCE else 1


def _result_type(a: AggExpr, in_schema: Schema, mode: AggMode) -> DataType:
    if mode is AggMode.FINAL:
        # child is a BoundCol at the first state column (see __init__)
        if a.fn in (AggFn.COUNT, AggFn.COUNT_STAR):
            return DataType.int64()
        if a.fn is AggFn.AVG or a.fn in _VARIANCE:
            return DataType.float64()
        return a.child.dtype
    return infer_dtype(a, in_schema)


def _check_input_type(what: str, dt: DataType) -> None:
    if dt.is_string_like:
        raise NotImplementedError(f"{what} over {dt} waits for "
                                  f"{_ROADMAP_STRINGS}")
    if dt.is_wide_decimal:
        raise NotImplementedError(f"{what} over {dt} waits for "
                                  f"{_ROADMAP_DECIMAL}")


class _Reductions:
    """Per-group masked reductions of one batch. `sum` (in float64 or
    int64) and `extreme` take the rows where `contrib` holds;
    `count(mask)` counts them. A count that a reduction already produced
    for the same mask is reused, not relaunched, and `contrib` makes one
    mask per pair of live and validity masks, so two aggregates of one
    column share it."""

    def __init__(self):
        self._counts: List[Tuple[torch.Tensor, torch.Tensor]] = []
        self._masks: List[Tuple[torch.Tensor, torch.Tensor,
                                torch.Tensor]] = []

    def contrib(self, live: torch.Tensor,
                valid: Optional[torch.Tensor]) -> torch.Tensor:
        if valid is None:
            return live
        for lv, vm, c in self._masks:
            if lv is live and vm is valid:
                return c
        c = live & valid
        self._masks.append((live, valid, c))
        return c

    def count(self, mask: torch.Tensor) -> torch.Tensor:
        for m, c in self._counts:
            if m is mask:
                return c
        c = self._count(mask)
        self._counts.append((mask, c))
        return c


class _Scalar(_Reductions):
    """Keyless: one group; K1 gives sum, min, max and count at once.
    `scratch` is K1's scratch for a CUDA graph (ops/fused.py); None
    takes the stream's."""

    def __init__(self, scratch: Optional[torch.Tensor] = None):
        super().__init__()
        self.scratch = scratch
        self._stats: List[tuple] = []

    def _count(self, mask):
        return mask.sum(dtype=torch.int64).reshape(1)

    def _k1(self, v, contrib):
        # K1 takes the column in its own dtype; min and max come back in
        # it, the sum in float64 or int64; one call serves every
        # reduction of the same column and mask (SUM and MAX of one)
        for pv, pc, res in self._stats:
            if pv is v and pc is contrib:
                return res
        s, lo, hi, cnt = masked_stats(v, contrib, self.scratch)
        if all(m is not contrib for m, _ in self._counts):
            self._counts.append((contrib, cnt))
        self._stats.append((v, contrib, (s, lo, hi)))
        return s, lo, hi

    def sum(self, v, contrib):
        return self._k1(v, contrib)[0]

    def extreme(self, is_min: bool, v, contrib):
        _, lo, hi = self._k1(v, contrib)
        return lo if is_min else hi


class _SegOps(_Reductions):
    """Keyed: K3 over the raw table-slot domain, taken at the occupied
    slots in the same call. Each reduction hands K3 the column in its
    own dtype and its `contrib` mask: K3 widens in registers and skips
    masked-out rows, so dead rows (which keep arbitrary in-range slots)
    contribute nothing and no masked, widened copy is made first."""

    def __init__(self, gid: torch.Tensor, domain: int,
                 compact_slots: torch.Tensor):
        super().__init__()
        self.gid = gid
        self.domain = domain
        self.compact_slots = compact_slots

    def _count(self, mask):
        # a bool column sums to its count of true rows, in int64
        return segreduce.segment_sum(self.gid, mask, self.domain,
                                     at=self.compact_slots)

    def sum(self, v, contrib):
        # sums accumulate in the state type, float64 or int64
        return segreduce.segment_sum(self.gid, v, self.domain, contrib,
                                     self.compact_slots)

    def extreme(self, is_min: bool, v, contrib):
        red = segreduce.segment_min if is_min else segreduce.segment_max
        # bool, int8 and int16 come back widened to int32
        return red(self.gid, v, self.domain, contrib,
                   self.compact_slots).to(v.dtype)


class HashAggregateExec(PhysicalOp):
    def __init__(
        self,
        child: PhysicalOp,
        keys: Sequence[Tuple[ir.Expr, str]],
        aggs: Sequence[Tuple[AggExpr, str]],
        mode: AggMode = AggMode.COMPLETE,
    ):
        self.children = [child]
        self.mode = mode
        in_schema = child.schema
        self.keys = [(bind_opt(e, in_schema), n) for e, n in keys]
        key_fields = [Field(n, infer_dtype(e, in_schema), True)
                      for e, n in self.keys]
        for f in key_fields:
            _check_input_type("group key", f.dtype)
        if mode is AggMode.FINAL:
            # states are located positionally in the partial output, keys
            # first, then states in agg order
            # (NativeHashAggregateExec.scala:98-161)
            self.aggs = []
            self._final_widths: List[int] = []
            pos = len(self.keys)
            for a, n in aggs:
                first_state = in_schema.fields[pos]
                if "#dsum" in first_state.name:
                    raise NotImplementedError(
                        f"decimal SUM/AVG states wait for {_ROADMAP_DECIMAL}")
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
                _check_input_type(a.fn.value, ct)
                if ct.id is TypeId.DECIMAL and a.fn in (AggFn.SUM,
                                                        AggFn.AVG):
                    raise NotImplementedError(
                        f"{a.fn.value} over {ct} waits for "
                        f"{_ROADMAP_DECIMAL}")
        if mode is AggMode.PARTIAL:
            fields: List[Field] = []
            for a, n in self.aggs:
                fields += _state_fields(a, n, in_schema)
            self._schema = Schema(key_fields + fields)
        else:
            self._schema = Schema(key_fields + [
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
                out = self._aggregate_batch(cb)
                if out.num_rows > 0:
                    yield out
            return
        batches, exceeded = collect_until(
            child_it, ctx.config.max_materialize_rows
        )
        if exceeded:
            yield from self._execute_external(batches, child_it, ctx)
            return
        cb = concat_batches(batches, self.children[0].schema, ctx.device)
        if cb.num_rows == 0:
            if not self.keys:
                # global aggregate over empty input still emits one row
                yield _empty_global_row(self, ctx.device)
            return
        yield self._aggregate_batch(cb)

    def _execute_external(self, head, rest, ctx: ExecContext
                          ) -> Iterator[ColumnBatch]:
        """Oversized input. Keyed: grace aggregation. Keyless: fold one
        PARTIAL state row per input batch, then merge them with one
        FINAL pass."""
        in_schema = self.children[0].schema
        if self.keys:
            tracker = get_device_tracker()
            track_key = (id(self), ctx.partition_id)
            head_bytes = sum(batch_device_bytes(b) for b in head)
            tracker.track(track_key, head_bytes)
            try:
                n_b = choose_external_bucket_count(2 * head_bytes,
                                                   ctx.config)
                yield from self._grace_agg(rest, head, ctx, in_schema,
                                           n_b, depth=0)
            finally:
                tracker.release(track_key)
            return
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

    _MAX_GRACE_DEPTH = 2
    _GRACE_FANOUT = 4

    def _grace_agg(self, rest, head, ctx: ExecContext, in_schema: Schema,
                   n_b: int, depth: int, modulus: Optional[int] = None
                   ) -> Iterator[ColumnBatch]:
        """One grace level. A bucket over the limit is bucketed again by
        the next hash bits (many distinct keys); at the greatest depth
        (one hot key) a COMPLETE bucket aggregates chunk by chunk, which
        no hash split can do, and a FINAL one whole: its states stay
        mergeable."""
        key_exprs = [e for e, _ in self.keys]
        if modulus is None:
            modulus, pid = n_b, None
        else:
            pid = subdivide_pid_fn(key_exprs, modulus, n_b)
            modulus *= n_b
        bucketed = bucket_stream(rest, key_exprs, n_b, ctx, in_schema,
                                 head=head, pid_fn=pid)
        ctx.metrics.add("external_agg_buckets", n_b)
        try:
            limit = ctx.config.max_materialize_rows
            for b in range(n_b):
                it = bucketed.bucket(b)
                chunk, exceeded = collect_until(it, limit)
                if not chunk:
                    continue
                if exceeded and depth < self._MAX_GRACE_DEPTH:
                    ctx.metrics.add("external_agg_rebuckets", 1)
                    yield from self._grace_agg(
                        it, chunk, ctx, in_schema, self._GRACE_FANOUT,
                        depth + 1, modulus)
                    continue
                if exceeded and self.mode is AggMode.COMPLETE:
                    ctx.metrics.add("external_agg_hot_buckets", 1)
                    yield from self._aggregate_chunked(
                        itertools.chain(chunk, it), in_schema, limit,
                        ctx.device)
                    continue
                chunk += list(it)
                out = self._aggregate_batch(
                    concat_batches(chunk, in_schema, ctx.device))
                if out.num_rows:
                    yield out
        finally:
            bucketed.cleanup()

    def _aggregate_chunked(self, batches: Iterator[ColumnBatch],
                           in_schema: Schema, limit: int,
                           device: torch.device) -> Iterator[ColumnBatch]:
        """One oversized COMPLETE bucket, streamed: a PARTIAL state per
        chunk of just over `limit` rows, then one FINAL merge."""
        partial = HashAggregateExec(
            self.children[0], keys=list(self.keys), aggs=list(self.aggs),
            mode=AggMode.PARTIAL)
        partials: List[ColumnBatch] = []
        chunk: List[ColumnBatch] = []
        rows = 0
        for cb in batches:
            chunk.append(cb)
            rows += cb.num_rows
            if rows > limit:
                partials.append(partial._aggregate_batch(
                    concat_batches(chunk, in_schema, device)))
                chunk, rows = [], 0
        if chunk:
            partials.append(partial._aggregate_batch(
                concat_batches(chunk, in_schema, device)))
        partials = [p for p in partials if p.num_rows]
        if not partials:
            return
        final = HashAggregateExec(
            _SchemaStub(partial.schema),
            keys=[(ir.BoundCol(i, partial.schema.fields[i].dtype), n)
                  for i, (_, n) in enumerate(self.keys)],
            aggs=list(self.aggs), mode=AggMode.FINAL)
        out = final._aggregate_batch(
            concat_batches(partials, partial.schema, device))
        if out.num_rows:
            yield out

    # ------------------------------------------------------------------
    def _aggregate_batch(self, cb: ColumnBatch) -> ColumnBatch:
        """The state (or result) rows of the batch's live rows: one row
        keyless, one per group keyed."""
        live = cb.live_mask()
        cols = batch_cvs(cb)
        ev = DeviceEvaluator(cb.schema, cols, cb.capacity, cb.device)
        if self.keys:
            outs, red, n = self._group(ev, live, cb.capacity)
        else:
            outs, red, n = [], _Scalar(), 1
        pos = len(self.keys)
        for i, (a, _) in enumerate(self.aggs):
            if self.mode is AggMode.FINAL:
                width = self._final_widths[i]
                outs.extend(_merge_states(
                    a, cols[pos: pos + width], live, red, cb.capacity))
                pos += width
            else:
                outs.extend(_agg_state(a, ev, live, red, cb.capacity,
                                       self.mode))
        out_cols = [
            Column(f.dtype, v.to(torch_dtype(f.dtype)), m)
            for (v, m), f in zip(outs, self._schema.fields)
        ]
        return ColumnBatch(self._schema, out_cols, n)

    def _group(self, ev: DeviceEvaluator, live: torch.Tensor,
               capacity: int):
        """Group slots under the group-capacity ladder; returns the key
        output columns, the keyed reductions and the group count."""
        keys_cv = [ev.evaluate(e) for e, _ in self.keys]
        gcap = min(capacity, _TIER2_GROUPS)
        if gcap >= capacity:
            tiers: List[Optional[int]] = [None]
        elif gcap <= _TIER1_GROUPS:
            tiers = [gcap, None]
        else:
            tiers = [_TIER1_GROUPS, gcap, None]
        full_t = ht.table_size_for(capacity)
        for gc in tiers:
            out_cap = capacity if gc is None else gc
            tsize = min(ht.table_size_for(min(capacity, 2 * out_cap)),
                        full_t)
            slot, rep_tab, overflow = ht.group_slots(
                keys_cv, live, capacity, tsize,
                max_rounds=16 if tsize < full_t else None)
            occupied = rep_tab != capacity
            n_groups = torch.where(
                overflow, torch.full((), out_cap + 1, dtype=torch.int64,
                                     device=live.device),
                occupied.sum(dtype=torch.int64))
            n = host_int(n_groups, "n_groups")
            if gc is None or n <= gc:
                break
        occ = occupied_slots(occupied, out_cap)
        # each group's first row carries its key values
        bpos = torch.index_select(rep_tab, 0, occ).clamp(0, capacity - 1)
        outs = [
            (torch.index_select(v, 0, bpos),
             torch.index_select(m, 0, bpos) if m is not None else None)
            for v, m in keys_cv
        ]
        red = _SegOps(slot.to(torch.int32), tsize, occ)
        return outs, red, n


def _agg_state(a: AggExpr, ev: DeviceEvaluator, live: torch.Tensor,
               red: _Reductions, capacity: int, mode: AggMode):
    """(value, validity) state/result columns for one aggregate over
    raw input rows."""
    fn = a.fn
    if fn is AggFn.COUNT_STAR:
        return [(red.count(live), None)]
    cv, cm = ev.evaluate(a.child)
    contrib = red.contrib(live, cm)
    if fn is AggFn.COUNT:
        return [(red.count(contrib), None)]
    if fn in (AggFn.SUM, AggFn.AVG):
        s = red.sum(cv, contrib)
        cnt = red.count(contrib)
        if fn is AggFn.SUM:
            return [(s, cnt > 0)]
        if mode is AggMode.PARTIAL:
            return [(s, cnt > 0), (cnt, None)]
        return [(s / cnt.clamp(min=1).to(torch.float64), cnt > 0)]
    if fn in (AggFn.MIN, AggFn.MAX):
        return [(red.extreme(fn is AggFn.MIN, cv, contrib),
                 red.count(contrib) > 0)]
    if fn in (AggFn.FIRST, AggFn.LAST):
        return [_first_last(fn, cv, contrib, red, capacity)]
    # var/stddev family: moments
    x = cv.to(torch.float64)
    n = red.count(contrib).to(torch.float64)
    s1 = red.sum(x, contrib)
    s2 = red.sum(x * x, contrib)
    if mode is AggMode.PARTIAL:
        return [(n, None), (s1, None), (s2, None)]
    return [_finalize_var(fn, n, s1, s2)]


def _merge_states(a: AggExpr, states, live: torch.Tensor, red: _Reductions,
                  capacity: int):
    """FINAL: merge PARTIAL state columns into the result column."""
    fn = a.fn
    v, m = states[0]
    contrib = red.contrib(live, m)
    if fn in (AggFn.COUNT, AggFn.COUNT_STAR):
        return [(red.sum(v, live), None)]
    if fn is AggFn.SUM:
        return [(red.sum(v, contrib), red.count(contrib) > 0)]
    if fn in (AggFn.MIN, AggFn.MAX):
        return [(red.extreme(fn is AggFn.MIN, v, contrib),
                 red.count(contrib) > 0)]
    if fn is AggFn.AVG:
        s = red.sum(v, contrib)
        c = red.sum(states[1][0], live)
        return [(s.to(torch.float64) / c.clamp(min=1).to(torch.float64),
                 c > 0)]
    if fn in (AggFn.FIRST, AggFn.LAST):
        return [_first_last(fn, v, contrib, red, capacity)]
    n, s1, s2 = (red.sum(sv, live) for sv, _ in states)
    return [_finalize_var(fn, n, s1, s2)]


def _first_last(fn: AggFn, v: torch.Tensor, contrib: torch.Tensor,
                red: _Reductions, capacity: int):
    """FIRST/LAST: the value at the smallest / largest contributing row
    position of each group."""
    pos = torch.arange(capacity, dtype=torch.int32, device=v.device)
    best = red.extreme(fn is AggFn.FIRST, pos, contrib)
    idx = best.clamp(0, capacity - 1).to(torch.int64)
    return torch.index_select(v, 0, idx), red.count(contrib) > 0


def _finalize_var(fn: AggFn, n, s1, s2):
    mean = s1 / n.clamp(min=1.0)
    m2 = s2 - s1 * mean  # sum((x-mean)^2) = s2 - s1^2/n
    pop = fn in (AggFn.VAR_POP, AggFn.STDDEV_POP)
    denom = (n if pop else n - 1.0).clamp(min=1.0)
    var = m2.clamp(min=0.0) / denom
    valid = n > (0.0 if pop else 1.0)
    if fn in (AggFn.STDDEV_SAMP, AggFn.STDDEV_POP):
        var = torch.sqrt(var)
    return var, valid


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
