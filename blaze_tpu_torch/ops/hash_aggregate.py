"""Hash aggregate: PARTIAL / FINAL / COMPLETE, keyless and keyed.

Reference counterpart: DataFusion AggregateExec built from proto
(from_proto.rs:452-545) with Spark's two-phase mode mapping
(NativeHashAggregateExec.scala:98-161). A port of the JAX package's
ops/hash_aggregate.py for COUNT, COUNT(*), SUM, AVG, MIN, MAX, FIRST,
LAST and the variance family over fixed-width input, and for string
keys: key and argument nodes with a string input are evaluated on the
host first (ops/host_lower.py), and a string key groups by its codes
on one duplicate-free dictionary (a batch's own; `concat_batches`
unifies the batches it joins, so FINAL merges PARTIAL states across
batches and tasks). COUNT, FIRST and LAST take string arguments, as
the JAX package allows; the key and FIRST/LAST outputs keep their
dictionaries. MIN/MAX over strings raise, as in the JAX package.

Decimal SUM and AVG (any precision) keep the JAX package's chunked
128-bit state (`_decimal_chunks`): four int64 columns of 32-bit chunk
sums, `{name}#dsum{scale}_c{k}`, which never overflow, summed by the
same kernels as any int64 sum (K1 keyless, K3 keyed); a COMPLETE or
FINAL output reassembles them exactly on the host, once a batch of
groups, in Python ints (`_reassemble_decimal`): decimal(38, s) for SUM,
NULL past decimal(38) (Spark non-ANSI), AVG at scale s+4 rounded
HALF_UP. COUNT, FIRST and LAST of a decimal(>18) pass its limb pairs
through; MIN, MAX and the moments of one, and decimal(>18) group keys,
are refused with the JAX package's words.

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

import numpy as np
import torch

from blaze_tpu_torch.config import get_config
from blaze_tpu_torch.types import DataType, Field, Schema, TypeId
from blaze_tpu_torch.batch import (
    Column,
    ColumnBatch,
    _h2d,
    torch_dtype,
    zero_values,
)
from blaze_tpu_torch.exprs import ir
from blaze_tpu_torch.exprs.optimize import bind_opt
from blaze_tpu_torch.exprs.ir import AggExpr, AggFn
from blaze_tpu_torch.exprs.eval import DeviceEvaluator
from blaze_tpu_torch.exprs.typing import infer_dtype
from blaze_tpu_torch.ops import hash_table as ht
from blaze_tpu_torch.ops.base import ExecContext, PhysicalOp
from blaze_tpu_torch.ops.host_lower import lower_strings_host, needs_host
from blaze_tpu_torch.ops.external import (
    bucket_stream,
    collect_until,
    subdivide_pid_fn,
)
from blaze_tpu_torch.ops.kernels import segreduce
from blaze_tpu_torch.ops.kernels.stats import masked_stats
from blaze_tpu_torch.ops.project import batch_cvs, passthrough_dictionary
from blaze_tpu_torch.ops.util import (
    concat_batches,
    occupied_slots,
    unify_columns,
)
from blaze_tpu_torch.runtime.dispatch import host_int
from blaze_tpu_torch.runtime.memory import (
    batch_device_bytes,
    choose_external_bucket_count,
    get_device_tracker,
)

_STRING_ARG_FNS = (AggFn.COUNT, AggFn.FIRST, AggFn.LAST)
_VARIANCE = (AggFn.VAR_SAMP, AggFn.VAR_POP, AggFn.STDDEV_SAMP,
             AggFn.STDDEV_POP)
# first and second tiers of the group-capacity ladder (the JAX package's
# defaults for BLAZE_AGG_TIER1 and agg_group_capacity)
_TIER1_GROUPS = 4096
_TIER2_GROUPS = 65536
#: probe rounds of a grouping inside a CUDA graph (the JAX package's
#: round bound of its sliced tiers, hash_aggregate.py:885-886)
GRAPH_ROUNDS = 16


def group_tiers(capacity: int, group_cap: Optional[int]
                ) -> List[Optional[int]]:
    """The group-capacity ladder of a batch (the JAX package's
    `run_grouped_kernel`): static slot counts to try in turn, None for
    the batch's whole capacity. `group_cap` None or at least the
    capacity: one tier."""
    if group_cap is None or group_cap >= capacity:
        return [None]
    if group_cap <= _TIER1_GROUPS:
        return [group_cap, None]
    return [_TIER1_GROUPS, group_cap, None]


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
    if fn in (AggFn.SUM, AggFn.AVG) and ct.id is TypeId.DECIMAL:
        # the chunked 128-bit-exact sum state; the scale rides in the
        # field name, so a FINAL side that sees only the partial schema
        # (across a shuffle) finalizes exactly
        fields = [Field(f"{name}#dsum{ct.scale}_c{k}", DataType.int64(),
                        k == 0) for k in range(4)]
        if fn is AggFn.AVG:
            fields.append(Field(f"{name}#count", DataType.int64(), False))
        return fields
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


def _state_width(fn: AggFn, chunked: bool = False) -> int:
    """State columns of one aggregate; `chunked` for a decimal SUM/AVG
    (its first state field carries the #dsum marker)."""
    if fn is AggFn.SUM:
        return 4 if chunked else 1
    if fn is AggFn.AVG:
        return 5 if chunked else 2
    return 3 if fn in _VARIANCE else 1


def parse_dsum_scale(field_name: str) -> Optional[int]:
    """The scale in a chunked decimal state field's name, or None (the
    JAX package's `_parse_dsum_scale`)."""
    marker = "#dsum"
    i = field_name.find(marker)
    if i < 0:
        return None
    rest = field_name[i + len(marker):]
    j = rest.find("_c")
    if j <= 0:
        return None
    try:
        return int(rest[:j])
    except ValueError:
        return None


def dsum_scale(a: AggExpr, in_schema: Schema, mode: AggMode
               ) -> Optional[int]:
    """The input scale of a decimal SUM/AVG (chunked state), else
    None; FINAL reads it from the state field's name."""
    if a.fn not in (AggFn.SUM, AggFn.AVG):
        return None
    if mode is AggMode.FINAL:
        return parse_dsum_scale(in_schema.fields[a.child.index].name)
    ct = infer_dtype(a.child, in_schema)
    return ct.scale if ct.id is TypeId.DECIMAL else None


def _decimal_chunks(cv: torch.Tensor) -> List[torch.Tensor]:
    """Decimal unscaled values as four int64 columns of 32-bit chunks,
    value = sum(c_k * 2^(32k)), c3 carrying the sign, so chunk sums
    never overflow int64: a narrow value is its int64, a wide one its
    (cap, 2) [lo, hi] limbs (the JAX package's `_decimal_chunks`)."""
    if cv.dim() == 1:
        v = cv.to(torch.int64)
        z = torch.zeros_like(v)
        return [v & 0xFFFFFFFF, v >> 32, z, z]  # >> carries the sign
    lo, hi = cv[:, 0], cv[:, 1]
    return [lo & 0xFFFFFFFF, (lo >> 32) & 0xFFFFFFFF, hi & 0xFFFFFFFF,
            hi >> 32]


_DEC38_MAX = 10**38 - 1
_U64 = (1 << 64) - 1


def _reassemble_decimal(chunk_cols: List[np.ndarray],
                        any_v: Optional[np.ndarray],
                        count: Optional[np.ndarray], scale: int, avg: bool,
                        n_live: Optional[int] = None):
    """Host-exact reassembly of chunked decimal sums -> (limbs, mask)
    (the JAX package's `_reassemble_decimal`): a SUM past decimal(38)
    is NULL (Spark non-ANSI); AVG divides at scale+4 with HALF_UP in
    Python ints. The bigint work covers the first `n_live` rows; the
    rest stay zero."""
    cap = len(chunk_cols[0])
    n = cap if n_live is None else min(n_live, cap)
    total = (chunk_cols[0][:n].astype(object)
             + (chunk_cols[1][:n].astype(object) << 32)
             + (chunk_cols[2][:n].astype(object) << 64)
             + (chunk_cols[3][:n].astype(object) << 96))
    if avg:
        mul = 10 ** (min(scale + 4, 38) - scale)
        safe = np.maximum(count[:n], 1).astype(object)
        num = total * mul
        q = num // safe
        r = num - q * safe
        half_up = np.where(num >= 0, 2 * r >= safe, 2 * r > safe)
        total = q + half_up.astype(object)
    overflow = np.abs(total) > _DEC38_MAX
    mask = np.zeros(cap, dtype=bool)
    mask[:n] = (any_v[:n] if any_v is not None else True) & ~overflow
    t_mod = np.mod(np.where(overflow, 0, total), 1 << 128)
    limbs = np.zeros((cap, 2), dtype=np.int64)
    for j, part in enumerate((t_mod & _U64, t_mod >> 64)):
        limbs[:n, j] = np.where(part >= (1 << 63), part - (1 << 64),
                                part).astype(np.int64)
    return limbs, mask


def _result_type(a: AggExpr, in_schema: Schema, mode: AggMode) -> DataType:
    if mode is AggMode.FINAL:
        # child is a BoundCol at the first state column (see __init__)
        if a.fn in (AggFn.COUNT, AggFn.COUNT_STAR):
            return DataType.int64()
        dscale = dsum_scale(a, in_schema, mode)
        if dscale is not None:
            return DataType.decimal(
                38, min(dscale + 4, 38) if a.fn is AggFn.AVG else dscale)
        if a.fn is AggFn.AVG or a.fn in _VARIANCE:
            return DataType.float64()
        return a.child.dtype
    return infer_dtype(a, in_schema)


def _check_input_type(dt: DataType, fn: AggFn) -> None:
    if dt.is_string_like and fn not in _STRING_ARG_FNS:
        # the JAX package refuses them too
        # (blaze_tpu/ops/hash_aggregate.py:417-422)
        raise NotImplementedError(
            f"{fn.value} over {dt}: MIN/MAX/SUM/AVG over strings are "
            "host-tier work in the JAX package and the port alike")
    if dt.is_wide_decimal and fn not in _WIDE_ARG_FNS:
        # 128-bit ordering and moments need host math: the JAX
        # package's refusal and words (hash_aggregate.py:423-435)
        raise NotImplementedError(
            f"{fn.value} over decimal(>18) is host-tier work")


_WIDE_ARG_FNS = (AggFn.SUM, AggFn.AVG, AggFn.COUNT, AggFn.FIRST,
                 AggFn.LAST)


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
        # decimal chunk columns by argument expression: SUM and AVG of
        # one argument share them, and so their reductions
        self.chunks: dict = {}

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
        self._sums: List[tuple] = []

    def _count(self, mask):
        # a bool column sums to its count of true rows, in int64
        return segreduce.segment_sum(self.gid, mask, self.domain,
                                     at=self.compact_slots)

    def sum(self, v, contrib):
        # sums accumulate in the state type, float64 or int64; one
        # launch serves every sum of the same column and mask (a
        # decimal SUM and AVG share their chunk columns)
        for pv, pc, s in self._sums:
            if pv is v and pc is contrib:
                return s
        s = segreduce.segment_sum(self.gid, v, self.domain, contrib,
                                  self.compact_slots)
        self._sums.append((v, contrib, s))
        return s

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
            if f.dtype.is_wide_decimal:
                # the JAX package's refusal and words
                raise NotImplementedError(
                    "group keys of decimal(>18) are host-tier work")
        if mode is AggMode.FINAL:
            # states are located positionally in the partial output, keys
            # first, then states in agg order
            # (NativeHashAggregateExec.scala:98-161)
            self.aggs = []
            self._final_widths: List[int] = []
            pos = len(self.keys)
            for a, n in aggs:
                first_state = in_schema.fields[pos]
                width = _state_width(
                    a.fn, parse_dsum_scale(first_state.name) is not None)
                self.aggs.append(
                    (AggExpr(a.fn, ir.BoundCol(pos, first_state.dtype)), n))
                self._final_widths.append(width)
                pos += width
        else:
            self.aggs = [
                (AggExpr(a.fn, bind_opt(a.child, in_schema)
                         if a.child is not None else None), n)
                for a, n in aggs
            ]
            for a, _ in self.aggs:
                if a.child is None:
                    continue
                _check_input_type(infer_dtype(a.child, in_schema), a.fn)
        self._dscales = [dsum_scale(a, in_schema, mode)
                         for a, _ in self.aggs]
        self._host = mode is not AggMode.FINAL and any(
            needs_host(e, in_schema) for e in self._lowered_inputs())
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
    def _lowered_inputs(self) -> List[ir.Expr]:
        """Key expressions, then each aggregate argument (not FINAL)."""
        return [e for e, _ in self.keys] + [
            a.child for a, _ in self.aggs if a.child is not None]

    def _aggregate_batch(self, cb: ColumnBatch) -> ColumnBatch:
        """The state (or result) rows of the batch's live rows: one row
        keyless, one per group keyed."""
        live = cb.live_mask()
        key_exprs = [e for e, _ in self.keys]
        aggs = [a for a, _ in self.aggs]
        if self._host:
            exprs, _, cb = lower_strings_host(self._lowered_inputs(), cb)
            key_exprs, it = exprs[: len(key_exprs)], \
                iter(exprs[len(key_exprs):])
            aggs = [a if a.child is None else AggExpr(a.fn, next(it))
                    for a in aggs]
        cb = _unique_key_dictionaries(cb, key_exprs)
        cols = batch_cvs(cb)
        ev = DeviceEvaluator(cb.schema, cols, cb.capacity, cb.device)
        if self.keys:
            outs, red, n = self._group(ev, key_exprs, live, cb.capacity)
        else:
            outs, red, n = [], _Scalar(), 1
        dicts = [passthrough_dictionary(e, cb) for e in key_exprs]
        # per aggregate: (its state or result columns, the input scale
        # of a decimal SUM/AVG to reassemble or None, is it an AVG)
        groups = []
        pos = len(self.keys)
        for i, a in enumerate(aggs):
            dscale = self._dscales[i]
            if self.mode is AggMode.FINAL:
                width = self._final_widths[i]
                st = _merge_states(a, cols[pos: pos + width], live, red,
                                   cb.capacity, dscale is not None)
                d = cb.columns[pos].dictionary
                pos += width
            else:
                st = _agg_state(a, ev, live, red, cb.capacity, self.mode)
                d = None if a.child is None \
                    or a.fn not in (AggFn.FIRST, AggFn.LAST) \
                    else passthrough_dictionary(a.child, cb)
            if self.mode is AggMode.PARTIAL:
                dscale = None  # states leave as they are
            groups.append((st, dscale, a.fn is AggFn.AVG))
            dicts += [d] + [None] * (len(st) - 1)
        if any(g[1] is not None for g in groups):
            groups = _finish_decimals(groups, n, cb.device)
        outs += [cv for st, _, _ in groups for cv in st]
        out_cols = [
            Column(f.dtype, v.to(torch_dtype(f.dtype)), m, d)
            for (v, m), f, d in zip(outs, self._schema.fields, dicts)
        ]
        return ColumnBatch(self._schema, out_cols, n)

    def direct_keys(self) -> bool:
        """One integer (or bool) key: the grouping may take the direct
        arm (`hash_table.group_slots`)."""
        if len(self.keys) != 1:
            return False
        dt = infer_dtype(self.keys[0][0], self.children[0].schema)
        return not dt.is_wide_decimal and not dt.is_string_like and \
            torch_dtype(dt) in (torch.bool, torch.int8, torch.int16,
                                torch.int32, torch.int64)

    def partial_states(self, schema: Schema, cols, capacity: int,
                       device, live: torch.Tensor,
                       group_cap: Optional[int],
                       rounds: Optional[int] = GRAPH_ROUNDS,
                       direct: bool = False):
        """One batch's keyed PARTIAL state columns and its group count,
        with no host readback: the JAX package's fused batch kernel on
        the scatter core (`_build_kernel`'s `use_scatter` arm,
        hash_aggregate.py:776-907), what a CUDA graph replays.

        The states are cut to `out_cap` = `group_cap` slots (or the
        whole capacity); the count is a device int64 (1,) tensor, and
        `out_cap` + 1 when the groups outgrow the slots or the probe
        loop leaves rows after `rounds` rounds. The scatter core
        compares exact key values, so unlike the JAX package's
        hash-lane sort it needs no -1 collision sentinel and no
        lexsort retry: the overflow count is the only retry signal.
        `rounds` None (an eager run only) probes until every row has a
        slot, with one readback a round. `direct` (`direct_keys`) runs
        the direct arm of the grouping alone; a key range that does not
        fit then gives the count -1, and the caller runs the batch
        again without it. Keys and arguments are device-typed (the
        fusion pass's gate, planner/fuse.py)."""
        ev = DeviceEvaluator(schema, cols, capacity, device)
        keys_cv = [ev.evaluate(e) for e, _ in self.keys]
        out_cap = capacity if group_cap is None or group_cap >= capacity \
            else group_cap
        slots = _slots(keys_cv, live, capacity, out_cap, rounds, direct)
        outs, red = _slot_outputs(keys_cv, slots, capacity, out_cap)
        for a, _ in self.aggs:
            outs.extend(_agg_state(a, ev, live, red, capacity,
                                   AggMode.PARTIAL))
        return [(v.to(torch_dtype(f.dtype)), m)
                for (v, m), f in zip(outs, self._schema.fields)], slots[3]

    def _group(self, ev: DeviceEvaluator, key_exprs: List[ir.Expr],
               live: torch.Tensor, capacity: int):
        """Group slots under the group-capacity ladder; returns the key
        output columns, the keyed reductions and the group count. A
        string key groups by its codes."""
        keys_cv = [ev.evaluate(e) for e in key_exprs]
        for gc in group_tiers(capacity, min(capacity, _TIER2_GROUPS)):
            out_cap = capacity if gc is None else gc
            slots = _slots(keys_cv, live, capacity, out_cap, None)
            n = host_int(slots[3], "n_groups")
            if gc is None or n <= gc:
                break
        outs, red = _slot_outputs(keys_cv, slots, capacity, out_cap)
        return outs, red, n


def _slots(keys_cv, live: torch.Tensor, capacity: int, out_cap: int,
           rounds: Optional[int], direct: bool = False):
    """The scatter core's grouping of a batch into a table sized for
    `out_cap` groups: (slot, rep_tab, table size, group count (1,)
    int64), the count `out_cap` + 1 when the groups outgrow the slots
    or the probe loop leaves rows. `rounds` runs that many probe rounds
    with no readback (`hash_table.group_slots(static=True)`), `direct`
    the direct arm alone (the count -1 when the key range does not
    fit); None reads the branch and each round back, unbounded on the
    whole-capacity table and GRAPH_ROUNDS on a sliced one."""
    full_t = ht.table_size_for(capacity)
    tsize = min(ht.table_size_for(min(capacity, 2 * out_cap)), full_t)
    static = rounds is not None
    if not static and tsize < full_t:
        rounds = GRAPH_ROUNDS  # a sliced table may not fit every row
    direct = direct and static
    slot, rep_tab, overflow = ht.group_slots(
        keys_cv, live, capacity, tsize, max_rounds=rounds, static=static,
        direct_only=direct)
    n = torch.where(overflow, torch.full((), -1 if direct else out_cap + 1,
                                         dtype=torch.int64,
                                         device=live.device),
                    (rep_tab != capacity).sum(dtype=torch.int64))
    return slot, rep_tab, tsize, n.reshape(1)


def _slot_outputs(keys_cv, slots, capacity: int, out_cap: int):
    """The key output columns (each group's first row) and the keyed
    reductions over the table's raw slot domain, taken at the occupied
    slots (K2) in slot order."""
    slot, rep_tab, tsize, _ = slots
    occ = occupied_slots(rep_tab != capacity, out_cap)
    # each group's first row carries its key values
    bpos = torch.index_select(rep_tab, 0, occ).clamp(0, capacity - 1)
    outs = [(torch.index_select(v, 0, bpos),
             torch.index_select(m, 0, bpos) if m is not None else None)
            for v, m in keys_cv]
    return outs, _SegOps(slot.to(torch.int32), tsize, occ)


def _unique_key_dictionaries(cb: ColumnBatch, key_exprs) -> ColumnBatch:
    """The batch with each string key column's dictionary free of
    repeated values (an Arrow input's need not be), so equal strings
    have equal codes."""
    cols = None
    for e in key_exprs:
        if isinstance(e, ir.BoundCol) and e.dtype.is_string_like:
            c = cb.columns[e.index]
            u = unify_columns([c])[0]
            if u is not c:
                cols = list(cb.columns) if cols is None else cols
                cols[e.index] = u
    if cols is None:
        return cb
    return ColumnBatch(cb.schema, cols, cb.num_rows, cb.selection)


def _finish_decimals(groups, n: int, device: torch.device):
    """Each decimal SUM/AVG's chunk states reassembled into its result
    column (the JAX package's output arm, hash_aggregate.py:742-772):
    every chunk, validity and count array of the batch crosses in one
    fetch, the first `n` rows reassemble in Python ints, and the limbs
    and validity go back to `device`."""
    from blaze_tpu_torch.runtime.pack import get_packed

    fetch = []
    for st, dscale, avg in groups:
        if dscale is not None:
            fetch += [v for v, _ in st[:4]] + [st[0][1]]
            if avg:
                fetch.append(st[4][0])
    host = iter(get_packed(fetch))
    out = []
    for st, dscale, avg in groups:
        if dscale is None:
            out.append((st, dscale, avg))
            continue
        chunks = [np.asarray(next(host)) for _ in range(4)]
        any_v = np.asarray(next(host))
        count = np.asarray(next(host)) if avg else None
        limbs, mask = _reassemble_decimal(chunks, any_v, count, dscale,
                                          avg, n_live=n)
        out.append(([(_h2d(limbs, device), _h2d(mask, device))], None,
                    avg))
    return out


def _agg_state(a: AggExpr, ev: DeviceEvaluator, live: torch.Tensor,
               red: _Reductions, capacity: int, mode: AggMode):
    """(value, validity) state/result columns for one aggregate over
    raw input rows. A decimal SUM/AVG gives its chunk sums (and count),
    which a COMPLETE output reassembles."""
    fn = a.fn
    chunked = dsum_scale(a, ev.schema, mode) is not None
    if fn is AggFn.COUNT_STAR:
        return [(red.count(live), None)]
    cv, cm = ev.evaluate(a.child)
    contrib = red.contrib(live, cm)
    if fn is AggFn.COUNT:
        return [(red.count(contrib), None)]
    if chunked:
        # four int64 chunk sums: K1 keyless, K3 keyed
        key = (repr(a.child), id(contrib))
        if key not in red.chunks:
            red.chunks[key] = _decimal_chunks(cv)
        sums = [red.sum(c, contrib) for c in red.chunks[key]]
        cnt = red.count(contrib)
        out = [(sums[0], cnt > 0)] + [(c, None) for c in sums[1:]]
        return out + [(cnt, None)] if fn is AggFn.AVG else out
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
                  capacity: int, chunked: bool = False):
    """FINAL: merge PARTIAL state columns into the result column; a
    decimal SUM/AVG (`chunked`) into merged chunk sums (and count),
    which the output reassembles."""
    fn = a.fn
    v, m = states[0]
    contrib = red.contrib(live, m)
    if chunked:
        # an empty state's chunks hold 0, the additive neutral
        sums = [red.sum(c, live) for c, _ in states[:4]]
        out = [(sums[0], red.count(contrib) > 0)] + [
            (c, None) for c in sums[1:]]
        if fn is AggFn.AVG:
            out.append((red.sum(states[4][0], live), None))
        return out
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
        v = zero_values(field.dtype, cap, device)
        m = None
        if a.fn not in (AggFn.COUNT, AggFn.COUNT_STAR):
            m = torch.zeros(cap, dtype=torch.bool, device=device)
        cols.append(Column(field.dtype, v, m))
    return ColumnBatch(op.schema, cols, 1)
