"""Sort: pipeline-breaking multi-key sort.

Reference counterpart: DataFusion SortExec, partition-preserving
(from_proto.rs:306-348; wrapper NativeSortExec.scala). A port of the JAX
package's ops/sort.py: collect the partition into one padded device
buffer, argsort it (ops/util.sort_indices: one int64 sort a key on the
packed path, iterated stable sorts on the lexsort path), gather, then
re-slice into bucket-sized batches. An input past
`max_materialize_rows` takes one of three routes:

- with a small fetch (<= max_materialize_rows // 2), the running top-k:
  sort and trim per chunk, memory O(fetch + chunk);
- with plain column keys, the run merge: each chunk is sorted and
  spilled as a run of segmented IPC parts (io/ipc.py), then the runs
  merge batch by batch;
- else (expression keys) a host sort in pyarrow over order lanes the
  device computes.

A string key sorts by its dictionary ranks in UTF-8 byte order (Spark's
UTF8String.compareTo; `ops/util.lexicographic_codes`), equal strings at
equal ranks; ranks compare only on one dictionary, so the run merge
takes each round's bound from the round's unified pool and the host
sort orders the strings themselves. A key expression with a string input
is evaluated on the host (ops/host_lower.py).

Task metrics carry `dispatch.sort_route.<in_memory|topk|run_merge|host>`,
`dispatch.sort_spilled_runs` and `dispatch.host_sorts`.

A decimal(>18) key is its two limbs as adjacent lanes, the high limb
signed and the low limb with its top bit flipped into signed order
(the JAX package's `sort_batch`). For the device sort each limb is cut
into its 32-bit halves, so the key is four 32-bit lanes, which both
sort cores take; the run merge and the host sort read the two limbs
as int64 order lanes.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import tempfile
from typing import Iterator, List, Optional, Tuple

import torch

from blaze_tpu_torch.types import Schema
from blaze_tpu_torch.batch import Column, ColumnBatch
from blaze_tpu_torch.exprs import ir
from blaze_tpu_torch.exprs.eval import DeviceEvaluator
from blaze_tpu_torch.exprs.optimize import bind_opt
from blaze_tpu_torch.exprs.typing import infer_dtype
from blaze_tpu_torch.ops.base import ExecContext, PhysicalOp
from blaze_tpu_torch.ops.external import collect_until
from blaze_tpu_torch.ops.host_lower import lower_strings_host, needs_host
from blaze_tpu_torch.ops.project import batch_cvs, passthrough_dictionary
from blaze_tpu_torch.ops.util import (
    _null_rank,
    compact,
    concat_batches,
    ensure_compacted,
    lexicographic_codes,
    slice_to_batches,
    sort_indices,
    take_batch,
)
from blaze_tpu_torch.runtime import dispatch

@dataclasses.dataclass(frozen=True)
class SortKey:
    expr: ir.Expr
    ascending: bool = True
    nulls_first: bool = True


class SortExec(PhysicalOp):
    _FINGERPRINT_STABLE = True

    def _fingerprint_params(self) -> str:
        return f"{self.keys!r};fetch={self.fetch}"

    def __init__(self, child: PhysicalOp, keys: List[SortKey],
                 fetch: Optional[int] = None):
        self.children = [child]
        self.keys = [
            SortKey(bind_opt(k.expr, child.schema), k.ascending,
                    k.nulls_first)
            for k in keys
        ]
        self.fetch = fetch

    @property
    def schema(self) -> Schema:
        return self.children[0].schema

    def describe(self) -> str:
        return f"SortExec[keys={len(self.keys)}, fetch={self.fetch}]"

    def execute(self, partition: int, ctx: ExecContext
                ) -> Iterator[ColumnBatch]:
        it = self.children[0].execute(partition, ctx)
        limit = ctx.config.max_materialize_rows
        batches, exceeded = collect_until(it, limit)
        if exceeded:
            if self.fetch is not None and self.fetch <= limit // 2:
                return self._execute_topk(batches, it, ctx)
            if all(isinstance(k.expr, ir.BoundCol) for k in self.keys):
                return self._execute_run_merge(batches, it, ctx)
            return self._execute_host_sort(batches, it, ctx)
        dispatch.record("sort_route.in_memory")
        cb = concat_batches(batches, self.schema, ctx.device)
        if cb.num_rows == 0:
            return iter(())
        cb = sort_batch(cb, self.keys)
        if self.fetch is not None and cb.num_rows > self.fetch:
            cb = ColumnBatch(cb.schema, cb.columns, self.fetch)
        return iter(slice_to_batches(cb, ctx.config.batch_size))

    def _execute_topk(self, head, rest, ctx) -> Iterator[ColumnBatch]:
        """Oversized sort with a small fetch: keep only the running
        top-k (sort + trim per chunk)."""
        dispatch.record("sort_route.topk")
        limit = ctx.config.max_materialize_rows
        acc = None
        chunk = head
        while chunk:
            pool = ([acc] if acc is not None else []) + list(chunk)
            cb = sort_batch(concat_batches(pool, self.schema, ctx.device),
                            self.keys)
            acc = ColumnBatch(cb.schema, cb.columns,
                              min(self.fetch, cb.num_rows))
            chunk, _ = collect_until(rest, limit)
        if acc is None or acc.num_rows == 0:
            return
        yield from slice_to_batches(acc, ctx.config.batch_size)

    def _execute_run_merge(self, head, rest, ctx) -> Iterator[ColumnBatch]:
        """External sort: device-sort each chunk into a spilled run
        (segmented IPC), then merge the runs batch by batch. A round
        sorts the leftover and one batch of every run, and emits the
        prefix no later batch can precede: the rows at or below the
        least of the runs' last rows in the sort order."""
        from blaze_tpu_torch.io.ipc import encode_ipc_segment

        dispatch.record("sort_route.run_merge")
        limit = ctx.config.max_materialize_rows
        bs = ctx.config.batch_size
        fd, spill = tempfile.mkstemp(prefix="blz-sortrun-",
                                     dir=ctx.config.spill_dir())
        os.close(fd)
        try:
            runs: List[Tuple[int, int]] = []  # (offset, length)
            chunk = head
            with open(spill, "wb") as f:
                pos = 0
                while chunk:
                    cb = concat_batches(list(chunk), self.schema,
                                        ctx.device)
                    if cb.num_rows:
                        cb = sort_batch(cb, self.keys)
                        start = pos
                        for piece in slice_to_batches(cb, bs):
                            part = encode_ipc_segment(
                                piece.to_arrow(),
                                ctx.config.ipc_compression_level)
                            f.write(part)
                            pos += len(part)
                        runs.append((start, pos - start))
                    chunk, _ = collect_until(rest, limit)
            dispatch.record("sort_spilled_runs", len(runs))
            yield from self._merge_runs(spill, runs, ctx)
        finally:
            try:
                os.remove(spill)
            except OSError:
                pass

    def _merge_runs(self, spill, runs, ctx) -> Iterator[ColumnBatch]:
        from blaze_tpu_torch.io.ipc import read_file_segment

        bs = ctx.config.batch_size
        iters = [
            (ColumnBatch.from_arrow(rb, device=ctx.device)
             for rb in read_file_segment(spill, off, length))
            for off, length in runs
        ]
        heads: List[Optional[ColumnBatch]] = [next(i, None) for i in iters]
        leftover: Optional[ColumnBatch] = None
        while True:
            live = [h for h in heads if h is not None and h.num_rows]
            if not live and leftover is None:
                return
            parts = ([leftover] if leftover is not None else []) + live
            # one dictionary for the round: string ranks of the bound and
            # of the pool compare
            pool = concat_batches(parts, self.schema, ctx.device)
            leftover = None
            if not live:  # every run is drained: the pool is the rest
                yield from slice_to_batches(sort_batch(pool, self.keys), bs)
                return
            # each live head's last row, by its position in the pool
            ends = list(itertools.accumulate(p.num_rows for p in parts))
            lasts = torch.tensor(ends[len(parts) - len(live):],
                                 device=pool.device) - 1
            k = len(live)
            at = dispatch.host_ints(torch.cat(
                [lane[lasts] for lane in order_lanes(pool, self.keys)]),
                "sort_merge")
            bound = min(tuple(at[j::k]) for j in range(k))
            pool = sort_batch(pool, self.keys)
            n_safe = _count_at_most(pool, self.keys, bound)
            yield from slice_to_batches(
                ColumnBatch(pool.schema, pool.columns, n_safe), bs)
            if n_safe < pool.num_rows:
                pos = torch.arange(pool.capacity, device=pool.device)
                leftover = compact(pool, pos >= n_safe)
            # every live head went into the pool (its unsafe tail is in
            # the leftover now): advance all of them
            for ri, h in enumerate(heads):
                if h is not None:
                    heads[ri] = next(iters[ri], None)

    def _execute_host_sort(self, head, rest, ctx) -> Iterator[ColumnBatch]:
        """Oversized full sort with expression keys: every batch moves to
        host memory with its order lanes (computed on the device, the
        same order as the device sort) and pyarrow sorts by the lanes,
        stably."""
        import pyarrow as pa

        dispatch.record("sort_route.host")
        dispatch.record("host_sorts")
        widths = [_lane_count(infer_dtype(k.expr, self.schema))
                  for k in self.keys]
        names = [f"__sort_lane{i}" for i in range(sum(widths))]
        tables = []
        for b in list(head) + list(rest):
            b = ensure_compacted(b)
            if b.num_rows == 0:
                continue
            rb = b.to_arrow()
            tables.append(_with_lanes(rb, names, _host_lanes(b, self.keys)))
        if not tables:
            return
        # a string key's value lane holds the strings themselves, which
        # pyarrow orders by their bytes; the other lanes are in order
        # already
        orders = []
        it = iter(names)
        for k, w in zip(self.keys, widths):
            desc = not k.ascending and infer_dtype(
                k.expr, self.schema).is_string_like
            orders += [(next(it), "ascending")] + [
                (next(it), "descending" if desc else "ascending")
                for _ in range(w - 1)]
        tbl = pa.concat_tables(tables).sort_by(orders).drop(names)
        if self.fetch is not None:
            tbl = tbl.slice(0, self.fetch)
        for rb in tbl.to_batches(max_chunksize=ctx.config.batch_size):
            if rb.num_rows:
                yield ColumnBatch.from_arrow(rb, device=ctx.device)


def _with_lanes(rb, names, lanes):
    import pyarrow as pa

    t = pa.Table.from_batches([rb])
    for n, lane in zip(names, lanes):
        t = t.append_column(n, lane if isinstance(lane, pa.Array)
                            else pa.array(lane))
    return t


def _host_lanes(cb: ColumnBatch, keys: List[SortKey]) -> list:
    """The host sort's lanes of one batch: `order_lanes`, but a string
    key's value lane is its strings (NULL rows empty), which compare
    across batches where dictionary ranks would not."""
    from blaze_tpu_torch.batch import decode_strings

    n = cb.num_rows
    lanes = [lane[:n].cpu().numpy() for lane in order_lanes(cb, keys)]
    at = 0
    for k in keys:
        col = _key_column(cb, k.expr)
        i = at  # this key's rank lane; its value lane follows
        at += _lane_count(col.dtype)
        if col.dtype.is_string_like:
            codes = col.values[:n].cpu().numpy()
            null = None if col.validity is None \
                else ~col.validity[:n].cpu().numpy()
            lanes[i + 1] = decode_strings(
                codes, null, col.dictionary, col.dtype).fill_null(
                "" if col.dtype.id.value == "utf8" else b"")
    return lanes


def _lane_count(dt) -> int:
    """A key's order lanes: its null rank, then one value lane (two for
    a decimal(>18) key)."""
    return 3 if dt.is_wide_decimal else 2


def order_lanes(cb: ColumnBatch, keys: List[SortKey]) -> List[torch.Tensor]:
    """int64 lanes per key, (null rank, value) or, for a decimal(>18)
    key, (null rank, high limb, low limb in signed order), whose
    lexicographic order over all keys is the sort's: NULLs first or
    last, NaN above +inf, -0.0 equal to +0.0, descending keys
    inverted."""
    lanes = []
    live = torch.ones(cb.capacity, dtype=torch.bool, device=cb.device)
    for k in keys:
        col = _key_column(cb, k.expr)
        v = _sortable(col)
        if col.dtype.is_wide_decimal:
            vals = [v[:, 1], v[:, 0] ^ _MIN64]
            if not k.ascending:
                vals = [torch.bitwise_not(x) for x in vals]
            if col.validity is not None:
                vals = [x.masked_fill(~col.validity, 0) for x in vals]
            lanes += [_null_rank(live, col.validity, k.nulls_first)] + vals
            continue
        if v.is_floating_point():
            f = v.to(torch.float64)
            f = torch.where(f == 0, torch.zeros_like(f), f)
            bits = f.masked_fill(torch.isnan(f), float("nan")).view(
                torch.int64)
            # sign-magnitude -> two's complement: the int order of the
            # bits is the float order, the canonical NaN above +inf
            v = torch.where(bits < 0, bits ^ 0x7FFFFFFFFFFFFFFF, bits)
        else:
            v = v.to(torch.int64)
        if not k.ascending:
            v = torch.bitwise_not(v)
        rank = _null_rank(live, col.validity, k.nulls_first)
        if col.validity is not None:
            v = v.masked_fill(~col.validity, 0)
        lanes += [rank, v]
    return lanes


def _count_at_most(pool: ColumnBatch, keys: List[SortKey],
                   bound: Tuple[int, ...]) -> int:
    """Live rows of a sorted pool at or below `bound` in the sort order
    (they form a prefix)."""
    le = torch.ones(pool.capacity, dtype=torch.bool, device=pool.device)
    for lane, b in reversed(list(zip(order_lanes(pool, keys), bound))):
        le = (lane < b) | ((lane == b) & le)
    return dispatch.host_int((le & pool.live_mask()).sum(), "sort_merge")


_MIN64 = -(1 << 63)


def _limb_lanes(v: torch.Tensor) -> List[torch.Tensor]:
    """A (cap, 2) limb key as four int32 lanes, most significant first,
    whose lexicographic signed order is the 128-bit order: the high
    limb's top half as it is, every other half with its top bit
    flipped from unsigned into signed order."""
    hi, lo = v[:, 1], v[:, 0]
    halves = [hi >> 32, hi & 0xFFFFFFFF, (lo >> 32) & 0xFFFFFFFF,
              lo & 0xFFFFFFFF]
    return [halves[0].to(torch.int32)] + [
        (h ^ 0x80000000).to(torch.int32) for h in halves[1:]]


def sort_batch(cb: ColumnBatch, keys: List[SortKey]) -> ColumnBatch:
    """Sort one compacted batch by the given keys."""
    key_cols = []
    for k in keys:
        col = _key_column(cb, k.expr)
        if col.dtype.is_wide_decimal:
            key_cols += [(lane, col.validity, k.ascending, k.nulls_first)
                         for lane in _limb_lanes(col.values)]
            continue
        key_cols.append((_sortable(col), col.validity, k.ascending,
                         k.nulls_first))
    idx = sort_indices(key_cols, cb.num_rows, cb.capacity, cb.device)
    return take_batch(cb, idx, cb.num_rows)


def _sortable(col: Column) -> torch.Tensor:
    """A key column's values in an order-preserving form: a string
    column's dictionary ranks, any other column's values."""
    if col.dtype.is_string_like:
        return lexicographic_codes(col)
    return col.values


def _key_column(cb: ColumnBatch, e: ir.Expr) -> Column:
    if isinstance(e, ir.BoundCol):
        return cb.columns[e.index]
    if isinstance(e, ir.Col):
        return cb.columns[cb.schema.index_of(e.name)]
    # general expression keys: string nodes on the host, the rest
    # through the device evaluator
    if needs_host(e, cb.schema):
        (e,), _, cb = lower_strings_host([e], cb)
    ev = DeviceEvaluator(cb.schema, batch_cvs(cb), cb.capacity, cb.device)
    v, m = ev.evaluate(e)
    return Column(infer_dtype(e, cb.schema), v, m,
                  passthrough_dictionary(e, cb))
