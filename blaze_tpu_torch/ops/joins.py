"""Equi-joins: broadcast hash join and sort-merge join.

A port of the JAX package's ops/joins.py. Reference counterparts:
DataFusion HashJoinExec CollectLeft (from_proto.rs:349-428, wrapper
NativeBroadcastHashJoinExec.scala:96-123) and the custom SortMergeJoinExec
(sort_merge_join_exec.rs; wrapper NativeSortMergeJoinExec.scala:87-121).
Join conditions are not evaluated inside the join - the Spark-side
converter plants a filter above (BlazeConverters.scala:244-301).

Both joins share one core over a materialized build batch (`_JoinCore`).
The build relation becomes one of four indexes:

- `table_direct`: one narrow integer key whose live span is at most
  min(2^24, max(4096, 8 x rows)): a key -> row array, probed by one
  gather (one readback for the key span, one for duplicates);
- `table_kr`: one narrow key (int8-32, bool, float32): a fused key|row
  table, one gather and one compare a probe round;
- `table`: any other keys: the generic row table, probed with an exact
  key comparison;
- `sorted`: build keys that repeat (or `join_core="sort"`): build rows
  sorted stably by their murmur3 hash (kernel K4's `hashes` on the
  card), each probe row's run found by binary search, one readback a
  probe batch for the pair count, the pairs expanded and their keys
  compared exactly.

A table core emits probe row i as output row i, gathering only the build
side; the sorted core emits a probe row's pairs in build-row order.
Outer, semi and anti joins come from matched flags. Every gather and
scatter index is clamped into range first: a CUDA gather past the end
is a device-side assert, where JAX clamps quietly.

String keys join on codes. The build relation's key column is on one
duplicate-free dictionary (`concat_batches` unifies it), and each probe
batch's key codes are mapped into that dictionary's code space on the
host side of the dictionary (`pc.index_in`, one gather of codes on the
device); a probe string the build lacks maps to -1, which no build code
equals. So the build index is built once per build relation, where the
JAX package unifies both dictionaries per probe batch and rebuilds the
index when build codes move (`_unify_key_pair`, `_ensure_index`): the
same matches. Output columns keep their own codes and dictionaries.
Decimal(>18) columns ride as payload through every core and the grace
buckets; decimal(>18) keys raise NotImplementedError with the JAX
package's words, as it refuses them (blaze_tpu/ops/joins.py:118-120).
"""

from __future__ import annotations

import enum
import itertools
import threading
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from blaze_tpu_torch.batch import (
    Column,
    ColumnBatch,
    row_mask,
    torch_dtype,
    zero_values,
)
from blaze_tpu_torch.config import get_config, resolve_join_core
from blaze_tpu_torch.exprs import ir
from blaze_tpu_torch.ops import hash_table as ht
from blaze_tpu_torch.ops.base import ExecContext, PhysicalOp
from blaze_tpu_torch.ops.kernels import murmur3
from blaze_tpu_torch.ops.util import (
    concat_batches,
    ensure_compacted,
    remap_codes,
    unify_columns,
)
from blaze_tpu_torch.runtime import dispatch
from blaze_tpu_torch.runtime.dispatch import host_bool, host_int, host_ints
from blaze_tpu_torch.types import DataType, Field, Schema

_INT_KEYS = (torch.int8, torch.int16, torch.int32, torch.int64)
_CORE_TOKENS = itertools.count()


class JoinType(enum.Enum):
    INNER = "inner"
    LEFT = "left"
    RIGHT = "right"
    FULL = "full"
    LEFT_SEMI = "left_semi"
    LEFT_ANTI = "left_anti"
    # Spark's NOT IN (null-aware anti join): any NULL build key empties
    # the result, and probe rows with NULL keys never qualify
    LEFT_ANTI_NULL_AWARE = "left_anti_null_aware"


_EMITS_PAIRS = (JoinType.INNER, JoinType.LEFT, JoinType.RIGHT,
                JoinType.FULL)


def _joined_schema(left: Schema, right: Schema, jt: JoinType) -> Schema:
    if jt in (JoinType.LEFT_SEMI, JoinType.LEFT_ANTI,
              JoinType.LEFT_ANTI_NULL_AWARE):
        return left
    nullable_left = jt in (JoinType.RIGHT, JoinType.FULL)
    nullable_right = jt in (JoinType.LEFT, JoinType.FULL)
    fields = [
        Field(f.name, f.dtype, f.nullable or nullable_left) for f in left
    ] + [
        Field(f.name, f.dtype, f.nullable or nullable_right) for f in right
    ]
    return Schema(fields)


def check_key_types(left: Schema, left_keys: Sequence[int], right: Schema,
                    right_keys: Sequence[int]) -> None:
    """Raise NotImplementedError for a key type the port cannot join:
    decimal(>18), or a string key against a non-string one."""
    for i, j in zip(left_keys, right_keys):
        lt, rt = left.fields[i].dtype, right.fields[j].dtype
        for dt in (lt, rt):
            if dt.is_wide_decimal:
                # the JAX package's words (blaze_tpu/ops/joins.py)
                raise NotImplementedError(
                    "join keys of decimal(>18) are host-tier work")
        if lt.is_string_like != rt.is_string_like:
            raise NotImplementedError(
                f"join keys of {lt} and {rt}: a string key joins a string "
                "key")


def _key_hash_cols(cols: List[Column]) -> List[Tuple]:
    """(values, validity, dtype) triples for murmur3. Equal keys hash
    equal: the hash takes -0.0 as 0.0 and every NaN as one NaN, and a
    string key's codes (on the build's dictionary) hash as int32."""
    return [(c.values, c.validity,
             DataType.int32() if c.dtype.is_string_like else c.dtype)
            for c in cols]


def probe_codes(build: Column, probe: Column) -> Column:
    """A probe string key's codes mapped into the build key's
    dictionary (which holds each value once): equal strings get equal
    codes, and a value the build lacks gets -1. A probe row's NULL
    stays NULL."""
    import pyarrow as pa
    import pyarrow.compute as pc

    from blaze_tpu_torch.batch import string_value_type

    typ = string_value_type(build.dtype)
    bd = build.dictionary if build.dictionary is not None \
        else pa.array([], type=typ)
    if probe.dictionary is None or len(probe.dictionary) == 0:
        mapping = np.full(1, -1, dtype=np.int32)
    else:
        mapping = np.asarray(pc.index_in(
            probe.dictionary.cast(typ), value_set=bd.cast(typ)).fill_null(-1),
            dtype=np.int32)
    return Column(build.dtype, remap_codes(probe.values, mapping),
                  probe.validity, bd)


def _kr_eligible(cols: List[Column]) -> bool:
    """One narrow key: the fused key|row table applies."""
    return len(cols) == 1 and cols[0].values.dtype in (
        torch.bool, torch.float32, torch.int8, torch.int16, torch.int32)


def _key_cols(cols: List[Column]):
    return [(c.values, c.validity) for c in cols]


def _live(num_rows: int, cols: List[Column], capacity: int,
          device) -> torch.Tensor:
    """Rows below num_rows whose keys are all non-NULL (NULL join keys
    never match)."""
    live = row_mask(num_rows, capacity, device)
    for c in cols:
        if c.validity is not None:
            live = live & c.validity
    return live


def _count_into(n: int, idx: torch.Tensor, valid: torch.Tensor
                ) -> torch.Tensor:
    """bool (n,): whether any valid entry points at each position
    (`idx` already clamped into [0, n))."""
    hits = torch.zeros(n, dtype=torch.int32, device=idx.device)
    hits.index_add_(0, idx, valid.to(torch.int32))
    return hits > 0


def _gather(cols: List[Column], idx: torch.Tensor) -> List[Column]:
    return [Column(c.dtype, torch.index_select(c.values, 0, idx),
                   None if c.validity is None
                   else torch.index_select(c.validity, 0, idx),
                   c.dictionary)
            for c in cols]


class _JoinCore:
    """The equi-join over one materialized build batch (module
    docstring). `track_build` keeps `matched_build`, the build rows
    some probe row matched, for the join types that emit build rows."""

    def __init__(self, build: ColumnBatch, build_keys: List[int],
                 track_build: bool = True):
        self.build = build
        self.build_keys = build_keys
        self.track_build = track_build
        self.matched_build = torch.zeros(build.capacity, dtype=torch.bool,
                                         device=build.device)
        self._index = None
        self._build_keys: Optional[List[Column]] = None
        # a core may serve probe batches from several threads: index
        # builds and demotions run under this lock
        self._index_lock = threading.Lock()
        # repeated build keys rule every table core out for good
        self._table_demoted = False
        # a probe key the kr or direct table cannot take: generic table
        self._force_generic = False
        # the probe rounds that resolve every lookup in the table
        # (`table_state_static`), and a name for this core's table in
        # the fused join's graph keys (a graph reads its addresses)
        self._rounds: Optional[int] = None
        self.token = next(_CORE_TOKENS)

    def _build_key_cols(self) -> List[Column]:
        """The build key columns; a string key on a dictionary holding
        each value once (deduplicated once per core)."""
        if self._build_keys is None:
            self._build_keys = [
                unify_columns([c])[0] if c.dtype.is_string_like else c
                for c in (self.build.columns[i] for i in self.build_keys)]
        return self._build_keys

    def _ensure_index(self, build_cols: List[Column]) -> None:
        if self._index is not None:
            return
        b = self.build
        cap, nrows, dev = b.capacity, b.num_rows, b.device
        live = _live(nrows, build_cols, cap, dev)
        scatter = (not self._table_demoted and
                   resolve_join_core(get_config().join_core) == "scatter")
        if scatter:
            kr = _kr_eligible(build_cols) and not self._force_generic
            v = build_cols[0].values
            if kr and v.dtype in _INT_KEYS and nrows > 0:
                # dense-domain keys: a direct key -> row array (the
                # TPC-DS surrogate-key pattern; Spark's LongHashedRelation
                # has the same dense path)
                info = torch.iinfo(v.dtype)
                kmin, kmax = host_ints(torch.stack([
                    torch.where(live, v, info.max).min().to(torch.int64),
                    torch.where(live, v, info.min).max().to(torch.int64),
                ]), "join_keyspan")
                span = kmax - kmin + 1
                # sparse domains waste memory and cache: past 8x the
                # rows (or 2^24 slots) the key|row table wins
                if 0 < span <= min(1 << 24, max(4096, 8 * nrows)):
                    tab, dup = ht.insert_direct(
                        v, live, cap, kmin, ht.direct_table_size(span))
                    if not host_bool(dup, "join_dup"):
                        self._set_index("table_direct", (tab, kmin, span))
                        return
                    # repeated keys: straight to the sorted core
                    self._table_demoted = True
            if not self._table_demoted:
                # sized off the live rows, not the padded capacity
                tsize = ht.probe_table_size(max(1, nrows))
                keys = _key_cols(build_cols)
                h = ht.cheap_hash(keys, cap)
                if kr:
                    tab, dup = ht.insert_kr(ht.key_u32(*keys[0]), h, live,
                                            cap, tsize)
                else:
                    _slot, tab, dup, _ovf = ht.insert(
                        h, keys, live, cap, tsize, null_equal=False,
                        sync="join_insert_round")
                if not host_bool(dup, "join_dup"):
                    self._set_index("table_kr" if kr else "table", tab)
                    return
                self._table_demoted = True
        # NULL keys enter the sorted index and fail the equality check;
        # padding rows get HASH_PAD, so they herd into one run at the
        # top instead of adding phantom candidates to every probe row
        # whose key equals the padding value
        h = murmur3.hashes(_key_hash_cols(build_cols), nrows)
        h_sorted, order = torch.sort(h, stable=True)
        self._set_index("sorted", (h_sorted, order))

    def _set_index(self, mode: str, index) -> None:
        self._index = (mode, index)
        self._rounds = None
        dispatch.record("join_core." + mode)

    def table_state_static(self, probe_keys: List[int], probe_schema):
        """The table core's state for the fused join+aggregate (the JAX
        package's `_JoinCore.table_state_static`, joins.py:459), decided
        from the probe fields' types alone, since the probe keys are
        evaluated inside the consumer's graph: (mode, index, rounds) for
        the unique-build table cores `table_direct`, `table_kr` and
        `table`, where `rounds` (None for the direct table) is the probe
        rounds that resolve every lookup (`hash_table.probe_rounds`,
        once per table). None for string keys on either side, wide
        decimal probe keys and the sorted core (repeated build keys or
        `join_core="sort"`): the caller materializes the pairs. A probe
        dtype the kr or direct table cannot take rebuilds the generic
        table, as `probe` does."""
        build_cols = self._build_key_cols()
        if any(c.dtype.is_string_like for c in build_cols):
            return None
        fields = [probe_schema.fields[i] for i in probe_keys]
        if any(f.dtype.is_string_like or f.dtype.is_wide_decimal
               for f in fields):
            return None
        p_dtypes = [torch_dtype(f.dtype) for f in fields]
        with self._index_lock:
            self._ensure_index(build_cols)
            mode = self._index[0]
            if (mode == "table_direct"
                    and not all(dt in _INT_KEYS for dt in p_dtypes)) or (
                    mode == "table_kr" and not all(
                        b.values.dtype == dt
                        for b, dt in zip(build_cols, p_dtypes))):
                self._force_generic = True
                self._index = None
                self._ensure_index(build_cols)
            mode, index = self._index
            if mode == "sorted":
                return None
            if mode != "table_direct" and self._rounds is None:
                empty = ht.KR_EMPTY if mode == "table_kr" \
                    else self.build.capacity
                self._rounds = ht.probe_rounds(index, empty)
            return mode, index, self._rounds

    def _check_probe_dtypes(self, build_cols: List[Column],
                            probe_cols: List[Column]) -> None:
        """The kr encoding cannot express a probe key of another dtype,
        and the direct table only integer probe keys: rebuild as the
        generic table, whose hash is value-consistent across integer
        widths and whose equality promotes."""
        mode = self._index[0]
        if mode == "table_direct":
            ok = all(p.values.dtype in _INT_KEYS for p in probe_cols)
        elif mode == "table_kr":
            ok = all(b.values.dtype == p.values.dtype
                     for b, p in zip(build_cols, probe_cols))
        else:
            ok = True
        if not ok:
            self._force_generic = True
            self._index = None
            self._ensure_index(build_cols)

    def probe(self, probe_cb: ColumnBatch, probe_keys: List[int]):
        """Match one probe batch. A table core resolves every probe row
        here; the sorted core sizes the pair expansion (one readback).
        Returns the state for emit_pairs(), which also updates
        matched_build."""
        probe_cb = ensure_compacted(probe_cb)
        build_cols = self._build_key_cols()
        probe_cols = [probe_cb.columns[i] for i in probe_keys]
        probe_cols = [probe_codes(b, p) if p.dtype.is_string_like else p
                      for b, p in zip(build_cols, probe_cols)]
        with self._index_lock:
            self._ensure_index(build_cols)
            self._check_probe_dtypes(build_cols, probe_cols)
            mode, index = self._index
        pcap, dev = probe_cb.capacity, probe_cb.device
        if mode != "sorted":
            live = _live(probe_cb.num_rows, probe_cols, pcap, dev)
            pkeys = _key_cols(probe_cols)
            if mode == "table_direct":
                tab, base, span = index
                match_idx, matched = ht.lookup_direct(
                    tab, base, span, pkeys[0][0], live)
            else:
                h = ht.cheap_hash(pkeys, pcap)
                if mode == "table_kr":
                    match_idx, matched = ht.lookup_kr(
                        index, ht.key_u32(*pkeys[0]), h, live)
                else:
                    match_idx, matched = ht.lookup(
                        index, h, pkeys, _key_cols(build_cols), live,
                        self.build.capacity)
            # no readback: a probe row matches at most one build row
            return ("table", probe_cb, match_idx, matched, pcap)

        h_sorted, order = index
        # mixed-width keys: murmur3 is dtype-semantic (hashInt of an
        # int32 differs from hashLong of the equal int64), so the probe
        # key is cast to the build key's dtype for bucketing only; a
        # value the cast changes lands in some run whose candidates the
        # exact, promoting comparison rejects
        hash_p = [
            p if p.values.dtype == b.values.dtype
            else Column(b.dtype, p.values.to(b.values.dtype), p.validity)
            for b, p in zip(build_cols, probe_cols)
        ]
        h = murmur3.hashes(_key_hash_cols(hash_p), probe_cb.num_rows)
        lo = torch.searchsorted(h_sorted, h, side="left")
        hi = torch.searchsorted(h_sorted, h, side="right")
        # a NULL key leaves the hash at its seed, so every NULL-key
        # probe row would meet every NULL-key build row in one run:
        # such rows never match, and take no candidates (the JAX
        # package expands them and rejects them by the key comparison)
        counts = torch.where(_live(probe_cb.num_rows, probe_cols, pcap, dev),
                             hi - lo, torch.zeros_like(lo))
        total = host_int(counts.sum(), "join_pairs")
        pair_cap = max(get_config().bucket_for(total), 1)
        return ("sorted", probe_cb, build_cols, probe_cols, counts, lo,
                order, total, pair_cap)

    def emit_pairs(self, state, out_build_cols: List[Column],
                   out_probe_cols: List[Column], build_first: bool):
        """Expand the pairs, compare their keys exactly, gather both
        sides' output columns and fold the matched flags. Returns
        (out_columns, valid, pair_cap, matched_probe)."""
        if state[0] == "table":
            return self._emit_table(state, out_build_cols, out_probe_cols,
                                    build_first)
        (_tag, probe_cb, build_cols, probe_cols, counts, lo, order, total,
         pair_cap) = state
        bcap, pcap = self.build.capacity, probe_cb.capacity
        dev = probe_cb.device
        ends = torch.cumsum(counts, 0)
        pos = torch.arange(pair_cap, dtype=torch.int64, device=dev)
        pair_p = torch.searchsorted(ends, pos, right=True).clamp(0, pcap - 1)
        within = pos - torch.index_select(ends - counts, 0, pair_p)
        sorted_pos = (torch.index_select(lo, 0, pair_p) + within).clamp(
            0, bcap - 1)
        pair_b = torch.index_select(order, 0, sorted_pos)
        valid = (pos < total) & torch.index_select(
            row_mask(self.build.num_rows, bcap, dev), 0, pair_b)
        for b, p in zip(build_cols, probe_cols):
            bm = None if b.validity is None \
                else torch.index_select(b.validity, 0, pair_b)
            pm = None if p.validity is None \
                else torch.index_select(p.validity, 0, pair_p)
            valid = valid & ht._pairwise_eq(
                torch.index_select(b.values, 0, pair_b), bm,
                torch.index_select(p.values, 0, pair_p), pm, False)
        matched_p = _count_into(pcap, pair_p, valid) & row_mask(
            probe_cb.num_rows, pcap, dev)
        if self.track_build:
            self.matched_build = self.matched_build | _count_into(
                bcap, pair_b, valid)
        bcols = _gather(out_build_cols, pair_b)
        pcols = _gather(out_probe_cols, pair_p)
        out = bcols + pcols if build_first else pcols + bcols
        return out, valid, pair_cap, matched_p

    def _emit_table(self, state, out_build_cols: List[Column],
                    out_probe_cols: List[Column], build_first: bool):
        """Output row i is probe row i: the probe columns pass through
        and only the build side gathers."""
        _tag, probe_cb, match_idx, matched, pair_cap = state
        bcap = self.build.capacity
        valid = matched & row_mask(probe_cb.num_rows, probe_cb.capacity,
                                   probe_cb.device)
        pair_b = match_idx.clamp(0, bcap - 1).to(torch.int64)
        if self.track_build:
            self.matched_build = self.matched_build | _count_into(
                bcap, pair_b, valid)
        bcols = _gather(out_build_cols, pair_b)
        pcols = list(out_probe_cols)
        out = bcols + pcols if build_first else pcols + bcols
        return out, valid, pair_cap, valid


def _null_side(fields: Sequence[Field], capacity: int,
               device) -> List[Column]:
    """All-NULL columns of the other side, as device zeros."""
    return [
        Column(f.dtype, zero_values(f.dtype, capacity, device),
               torch.zeros(capacity, dtype=torch.bool, device=device))
        for f in fields
    ]


class HashJoinExec(PhysicalOp):
    """Broadcast hash join, CollectLeft: the LEFT child is materialized
    (the broadcast relation), the RIGHT child streams (reference
    from_proto.rs:349-428 PartitionMode::CollectLeft)."""

    # join types whose build-side output depends on matched state across
    # all probe partitions: each partition OR-merges its matched-build
    # flags into a shared accumulator and the last one to finish emits
    _BUILD_EMITTING = frozenset(
        {JoinType.LEFT, JoinType.FULL, JoinType.LEFT_SEMI,
         JoinType.LEFT_ANTI, JoinType.LEFT_ANTI_NULL_AWARE})
    #: the child the core indexes
    build_child = 0

    _FINGERPRINT_STABLE = True

    def _fingerprint_params(self) -> str:
        return (f"{self.join_type.name};l={self.left_keys};"
                f"r={self.right_keys}")

    def __init__(self, left: PhysicalOp, right: PhysicalOp,
                 left_keys: Sequence[str], right_keys: Sequence[str],
                 join_type: JoinType = JoinType.INNER):
        if join_type is JoinType.LEFT_ANTI_NULL_AWARE:
            raise NotImplementedError(
                "null-aware anti join runs through SortMergeJoinExec")
        self.children = [left, right]
        self.left_keys = [left.schema.index_of(k) for k in left_keys]
        self.right_keys = [right.schema.index_of(k) for k in right_keys]
        check_key_types(left.schema, self.left_keys, right.schema,
                        self.right_keys)
        self.join_type = join_type
        self._schema = _joined_schema(left.schema, right.schema, join_type)
        self._build: Optional[ColumnBatch] = None
        self._build_lock = threading.Lock()
        # epilogue coordination: a set of finished partition ids (not a
        # counter, so an abandoned or re-run partition stays
        # idempotent), reset after each epilogue so the plan can run
        # again
        self._epi_lock = threading.Lock()
        self._epi_matched: Optional[torch.Tensor] = None
        self._epi_parts: set = set()

    @property
    def schema(self) -> Schema:
        return self._schema

    @property
    def partition_count(self) -> int:
        return self.children[1].partition_count

    def describe(self) -> str:
        return f"HashJoinExec[{self.join_type.name}]"

    def _collect_build(self, ctx: ExecContext) -> ColumnBatch:
        """Collect the build relation once, shared by every probe
        partition."""
        with self._build_lock:
            if self._build is None:
                left = self.children[0]
                # a broadcast child replays the whole relation from any
                # one partition; collecting all would repeat its rows
                parts = [0] if getattr(left, "is_broadcast", False) \
                    else range(left.partition_count)
                batches = [b for p in parts for b in left.execute(p, ctx)]
                self._build = concat_batches(batches, left.schema,
                                             ctx.device)
            return self._build

    def execute(self, partition: int, ctx: ExecContext
                ) -> Iterator[ColumnBatch]:
        left, right = self.children
        jt = self.join_type
        build = self._collect_build(ctx)
        core = _JoinCore(build, self.left_keys,
                         track_build=jt in self._BUILD_EMITTING)
        emit = jt in _EMITS_PAIRS
        for pb in right.execute(partition, ctx):
            state = core.probe(pb, self.right_keys)
            pb = state[1]
            out_cols, valid, pair_cap, matched_p = core.emit_pairs(
                state, build.columns if emit else [],
                pb.columns if emit else [], build_first=True)
            if emit:
                yield ColumnBatch(self._schema, out_cols, pair_cap, valid)
            if jt in (JoinType.RIGHT, JoinType.FULL):
                un = row_mask(pb.num_rows, pb.capacity, pb.device) \
                    & ~matched_p
                lnull = _null_side(left.schema.fields, pb.capacity,
                                   pb.device)
                yield ColumnBatch(self._schema, lnull + list(pb.columns),
                                  pb.num_rows, un)
        if jt in self._BUILD_EMITTING:
            yield from self._build_epilogue(
                core.matched_build, build, partition,
                right.partition_count)

    def _build_epilogue(self, local_matched: torch.Tensor,
                        build: ColumnBatch, partition: int, n_parts: int
                        ) -> Iterator[ColumnBatch]:
        """OR-merge this partition's matched-build flags; the run that
        completes the partition set emits the build-side output."""
        right = self.children[1]
        jt = self.join_type
        with self._epi_lock:
            if self._epi_matched is None:
                self._epi_matched = local_matched
            else:
                self._epi_matched = self._epi_matched | local_matched
            self._epi_parts.add(partition)
            if len(self._epi_parts) < n_parts:
                return
            matched = self._epi_matched
            self._epi_matched = None
            self._epi_parts = set()
        live_b = row_mask(build.num_rows, build.capacity, build.device)
        if jt in (JoinType.LEFT, JoinType.FULL):
            rnull = _null_side(right.schema.fields, build.capacity,
                               build.device)
            yield ColumnBatch(self._schema, list(build.columns) + rnull,
                              build.num_rows, live_b & ~matched)
        elif jt is JoinType.LEFT_SEMI:
            yield ColumnBatch(self._schema, list(build.columns),
                              build.num_rows, live_b & matched)
        elif jt is JoinType.LEFT_ANTI:
            yield ColumnBatch(self._schema, list(build.columns),
                              build.num_rows, live_b & ~matched)


class SortMergeJoinExec(PhysicalOp):
    """Sort-merge join over co-partitioned inputs. The reference streams
    both sides with single-row cursors (sort_merge_join_exec.rs:293-601);
    here each partition pair is materialized and joined with the shared
    core, the RIGHT side indexed, so the output follows the LEFT
    (streamed) side's order. Semi and anti joins are left-side
    (sort_merge_join_exec.rs:603). Past `max_materialize_rows` both
    sides are co-bucketed on their keys (grace join, kernel K4)."""

    build_child = 1

    _FINGERPRINT_STABLE = True

    def _fingerprint_params(self) -> str:
        return (f"{self.join_type.name};l={self.left_keys};"
                f"r={self.right_keys}")

    def __init__(self, left: PhysicalOp, right: PhysicalOp,
                 left_keys: Sequence[str], right_keys: Sequence[str],
                 join_type: JoinType = JoinType.INNER):
        self.children = [left, right]
        self.left_keys = [left.schema.index_of(k) for k in left_keys]
        self.right_keys = [right.schema.index_of(k) for k in right_keys]
        check_key_types(left.schema, self.left_keys, right.schema,
                        self.right_keys)
        self.join_type = join_type
        self._schema = _joined_schema(left.schema, right.schema, join_type)

    @property
    def schema(self) -> Schema:
        return self._schema

    @property
    def partition_count(self) -> int:
        return self.children[0].partition_count

    def describe(self) -> str:
        return f"SortMergeJoinExec[{self.join_type.name}]"

    def execute(self, partition: int, ctx: ExecContext
                ) -> Iterator[ColumnBatch]:
        from blaze_tpu_torch.ops.external import collect_until
        from blaze_tpu_torch.runtime.memory import (
            batch_device_bytes,
            choose_external_bucket_count,
            get_device_tracker,
        )

        left, right = self.children
        limit = ctx.config.max_materialize_rows
        r_it = right.execute(partition, ctx)
        r_head, r_exc = collect_until(r_it, limit)
        l_it = left.execute(partition, ctx)
        l_head, l_exc = collect_until(l_it, limit)
        if self.join_type is JoinType.LEFT_ANTI_NULL_AWARE:
            # "any build NULL empties the result" is a property of the
            # whole build side, so NAAJ cannot bucket
            yield from self._join_bucket(l_head + list(l_it),
                                         r_head + list(r_it), ctx)
            return
        if not (r_exc or l_exc):
            yield from self._join_bucket(l_head, r_head, ctx)
            return
        # grace join: equal keys land in one bucket on both sides, so
        # every join type is right bucket by bucket. The bucket count
        # comes from the device budget; the heads are at the cap, so
        # twice them estimates the streams
        head_bytes = sum(batch_device_bytes(b) for b in l_head + r_head)
        tracker = get_device_tracker()
        track_key = (id(self), ctx.partition_id)
        tracker.track(track_key, head_bytes)
        try:
            n_b = choose_external_bucket_count(2 * head_bytes, ctx.config)
            yield from self._grace_join(l_it, r_it, l_head, r_head, ctx,
                                        n_b, depth=0)
        finally:
            tracker.release(track_key)

    _MAX_GRACE_DEPTH = 2
    _GRACE_FANOUT = 4

    def _grace_join(self, l_it, r_it, l_head, r_head, ctx: ExecContext,
                    n_b: int, depth: int, modulus: Optional[int] = None
                    ) -> Iterator[ColumnBatch]:
        """One grace level: bucket both sides, join the buckets that
        fit; a bucket still over the cap is bucketed again by the next
        hash bits, and one that survives every level (a hot key) is
        joined whole."""
        from blaze_tpu_torch.ops.external import (
            bucket_stream,
            collect_until,
            subdivide_pid_fn,
        )

        left, right = self.children
        rkeys = [ir.BoundCol(i, right.schema.fields[i].dtype)
                 for i in self.right_keys]
        # murmur3 is dtype-semantic: a left key of another type is
        # bucketed as its cast to the right key's type, so equal keys
        # land in one bucket (the JAX package hashes each side in its
        # own type and loses such matches: ROADMAP section 3)
        lkeys = []
        for i, rk in zip(self.left_keys, rkeys):
            lk = ir.BoundCol(i, left.schema.fields[i].dtype)
            lkeys.append(lk if lk.dtype == rk.dtype else ir.Cast(lk, rk.dtype))
        if modulus is None:
            modulus, l_pid, r_pid = n_b, None, None
        else:
            l_pid = subdivide_pid_fn(lkeys, modulus, n_b)
            r_pid = subdivide_pid_fn(rkeys, modulus, n_b)
            modulus *= n_b
        bl = br = None
        try:
            bl = bucket_stream(l_it, lkeys, n_b, ctx, left.schema,
                               head=l_head, pid_fn=l_pid)
            br = bucket_stream(r_it, rkeys, n_b, ctx, right.schema,
                               head=r_head, pid_fn=r_pid)
            ctx.metrics.add("external_join_buckets", n_b)
            limit = ctx.config.max_materialize_rows
            for b in range(n_b):
                lb_it, rb_it = bl.bucket(b), br.bucket(b)
                lb_head, l_exc = collect_until(lb_it, limit)
                rb_head, r_exc = collect_until(rb_it, limit)
                if (l_exc or r_exc) and depth < self._MAX_GRACE_DEPTH:
                    ctx.metrics.add("external_join_rebuckets", 1)
                    yield from self._grace_join(
                        lb_it, rb_it, lb_head, rb_head, ctx,
                        self._GRACE_FANOUT, depth + 1, modulus)
                    continue
                if l_exc or r_exc:
                    ctx.metrics.add("external_join_hot_buckets", 1)
                    lb_head += list(lb_it)
                    rb_head += list(rb_it)
                if lb_head or rb_head:
                    yield from self._join_bucket(lb_head, rb_head, ctx)
        finally:
            if bl is not None:
                bl.cleanup()
            if br is not None:
                br.cleanup()

    def _join_bucket(self, left_batches, right_batches, ctx: ExecContext
                     ) -> Iterator[ColumnBatch]:
        left, right = self.children
        jt = self.join_type
        build = concat_batches(right_batches, right.schema, ctx.device)
        core = _JoinCore(build, self.right_keys,
                         track_build=jt in (JoinType.RIGHT, JoinType.FULL))
        probe = concat_batches(left_batches, left.schema, ctx.device)
        state = core.probe(probe, self.left_keys)
        probe = state[1]
        emit = jt in _EMITS_PAIRS
        out_cols, valid, pair_cap, matched_p = core.emit_pairs(
            state, build.columns if emit else [],
            probe.columns if emit else [], build_first=False)
        dev = probe.device
        live_p = row_mask(probe.num_rows, probe.capacity, dev)
        if emit:
            yield ColumnBatch(self._schema, out_cols, pair_cap, valid)
            if jt in (JoinType.LEFT, JoinType.FULL):
                rnull = _null_side(right.schema.fields, probe.capacity, dev)
                yield ColumnBatch(self._schema, list(probe.columns) + rnull,
                                  probe.num_rows, live_p & ~matched_p)
            if jt in (JoinType.RIGHT, JoinType.FULL):
                live_b = row_mask(build.num_rows, build.capacity, dev)
                lnull = _null_side(left.schema.fields, build.capacity, dev)
                yield ColumnBatch(self._schema, lnull + list(build.columns),
                                  build.num_rows,
                                  live_b & ~core.matched_build)
        elif jt is JoinType.LEFT_SEMI:
            yield ColumnBatch(self._schema, list(probe.columns),
                              probe.num_rows, live_p & matched_p)
        elif jt is JoinType.LEFT_ANTI:
            yield ColumnBatch(self._schema, list(probe.columns),
                              probe.num_rows, live_p & ~matched_p)
        elif jt is JoinType.LEFT_ANTI_NULL_AWARE:
            # NOT IN: probe rows with NULL keys never qualify, and any
            # NULL build key empties the result (a device bool, no
            # readback)
            live_b = row_mask(build.num_rows, build.capacity, dev)
            build_null = (live_b & ~_keys_valid(build, self.right_keys)
                          ).any()
            yield ColumnBatch(
                self._schema, list(probe.columns), probe.num_rows,
                live_p & ~matched_p & _keys_valid(probe, self.left_keys)
                & ~build_null)


def _keys_valid(cb: ColumnBatch, keys: Sequence[int]) -> torch.Tensor:
    ok = torch.ones(cb.capacity, dtype=torch.bool, device=cb.device)
    for i in keys:
        m = cb.columns[i].validity
        if m is not None:
            ok = ok & m
    return ok
