"""Shared batch utilities for operators: device gather/compact and batch
concatenation."""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from blaze_tpu_torch.config import get_config
from blaze_tpu_torch.types import Schema
from blaze_tpu_torch.batch import Column, ColumnBatch, empty_batch
from blaze_tpu_torch.ops.kernels.compact import compact_perm
from blaze_tpu_torch.runtime.dispatch import host_int


def take_batch(cb: ColumnBatch, indices: torch.Tensor, num_rows: int
               ) -> ColumnBatch:
    """Gather rows by index (device). `indices` length defines capacity."""
    cols = []
    for c in cb.columns:
        v = torch.index_select(c.values, 0, indices)
        m = None
        if c.validity is not None:
            m = torch.index_select(c.validity, 0, indices)
        cols.append(Column(c.dtype, v, m))
    return ColumnBatch(cb.schema, cols, num_rows)


def _compact_indices(mask: torch.Tensor) -> Tuple[torch.Tensor,
                                                  torch.Tensor]:
    """Kept rows packed to the front, 0-filled tail, and the live count
    (kernel K2, ops/kernels/compact.py)."""
    return compact_perm(mask)


def occupied_slots(occupied: torch.Tensor, out_cap: int) -> torch.Tensor:
    """The first `out_cap` occupied slots of a hash table in slot order,
    0-filled past the last (`jnp.nonzero(occupied, size=out_cap,
    fill_value=0)`, hash_aggregate.py:905-907), through K2. Callers keep
    out_cap below the table size."""
    return _compact_indices(occupied)[0][:out_cap]


def compact(cb: ColumnBatch, mask: Optional[torch.Tensor] = None
            ) -> ColumnBatch:
    """Keep rows where mask (AND the batch's own selection) is True, packed
    to the front (one D2H sync for the surviving row count)."""
    live = cb.live_mask()
    if mask is not None:
        live = live & mask
    idx, n = _compact_indices(live)
    return take_batch(cb, idx, host_int(n))


def ensure_compacted(cb: ColumnBatch) -> ColumnBatch:
    """Materialize a pending selection vector (no-op when none)."""
    if cb.selection is None:
        return cb
    return compact(cb)


def concat_batches(batches: List[ColumnBatch], schema: Schema,
                   device: torch.device) -> ColumnBatch:
    """Concatenate live rows of many batches into one padded batch
    (pipeline-breaker materialization)."""
    batches = [ensure_compacted(b) for b in batches]
    batches = [b for b in batches if b.num_rows > 0]
    if not batches:
        return empty_batch(schema, device)
    schema = batches[0].schema
    total = sum(b.num_rows for b in batches)
    cap = get_config().bucket_for(total)
    if len(batches) == 1 and batches[0].capacity == cap:
        return batches[0]  # already compact at the right bucket
    cols: List[Column] = []
    for ci, field in enumerate(schema):
        parts = [b.columns[ci] for b in batches]
        v = torch.cat([p.values[: b.num_rows]
                       for p, b in zip(parts, batches)])
        values = torch.zeros(cap, dtype=v.dtype, device=v.device)
        values[:total] = v
        validity = None
        if any(p.validity is not None for p in parts):
            m = torch.cat([
                p.validity[: b.num_rows] if p.validity is not None
                else torch.ones(b.num_rows, dtype=torch.bool,
                                device=v.device)
                for p, b in zip(parts, batches)
            ])
            validity = torch.zeros(cap, dtype=torch.bool, device=v.device)
            validity[:total] = m
        cols.append(Column(field.dtype, values, validity))
    return ColumnBatch(schema, cols, total)


def slice_to_batches(cb: ColumnBatch, batch_size: int) -> List[ColumnBatch]:
    """Split a large materialized batch back into bucket-sized batches:
    views where a bucket fits in the buffer, else a padded copy."""
    if cb.num_rows <= batch_size:
        return [cb]
    out = []
    for start in range(0, cb.num_rows, batch_size):
        n = min(batch_size, cb.num_rows - start)
        cap = get_config().bucket_for(n)
        cols = [Column(c.dtype, _rows(c.values, start, n, cap),
                       None if c.validity is None
                       else _rows(c.validity, start, n, cap))
                for c in cb.columns]
        out.append(ColumnBatch(cb.schema, cols, n))
    return out


def _rows(t: torch.Tensor, start: int, n: int, cap: int) -> torch.Tensor:
    if start + cap <= t.shape[0]:
        return t[start:start + cap]
    out = torch.zeros(cap, dtype=t.dtype, device=t.device)
    out[:n] = t[start:start + n]
    return out


# ---------------------------------------------------------------------------
# multi-key argsort
# ---------------------------------------------------------------------------

SortLane = Tuple[torch.Tensor, Optional[torch.Tensor], bool, bool]

_U32 = 0xFFFFFFFF
#: the packed path's row-count gate: rank:2 | key:32 | position:posbits
#: must fit a signed int64 (torch sorts no uint64)
PACKED_MAX_ROWS = 1 << 29
_PACKED_DTYPES = (torch.bool, torch.int8, torch.int16, torch.int32,
                  torch.uint8, torch.float32)


def _order_key_u32(v: torch.Tensor, asc: bool) -> torch.Tensor:
    """A <=32-bit value lane as an int64 in [0, 2^32) whose order is the
    requested SQL order: ints sign-flip; floats take the sign-magnitude
    flip with NaN made the canonical +NaN (Spark: NaN greatest) and
    -0.0 made +0.0 (Spark: equal); descending inverts the 32 bits."""
    if v.is_floating_point():
        f = v.to(torch.float32)
        f = torch.where(f == 0, torch.zeros_like(f), f)
        bits = (f.view(torch.int32).to(torch.int64) & _U32).masked_fill(
            torch.isnan(f), 0x7FC00000)
        u = torch.where((bits >> 31) == 1, bits ^ _U32, bits ^ 0x80000000)
    elif v.dtype in (torch.bool, torch.uint8):
        # already in unsigned order: no sign flip
        u = v.to(torch.int64)
    else:
        u = v.to(torch.int32).to(torch.int64) + (1 << 31)
    return u if asc else _U32 - u


def _null_rank(lv: torch.Tensor, mv: Optional[torch.Tensor],
               nulls_first: bool) -> torch.Tensor:
    """0 = a NULL placed first, 1 = a value, 2 = a NULL placed last,
    3 = padding (after everything)."""
    rank = torch.ones(lv.shape, dtype=torch.int64, device=lv.device)
    if mv is not None:
        rank = rank.masked_fill(~mv, 0 if nulls_first else 2)
    return rank.masked_fill(~lv, 3)


def _sort_indices_packed(keys: Sequence[SortLane], num_rows: int,
                         capacity: int, device) -> torch.Tensor:
    """One int64 value sort per key: each pass packs (null rank:2 |
    order key:32 | position:posbits) into one lane and sorts it; the
    low bits carry the permutation, so the pass is stable by
    construction and padding rows (rank 3) sink to the end."""
    posbits = max(1, (capacity - 1).bit_length())
    pos = torch.arange(capacity, dtype=torch.int64, device=device)
    live = pos < num_rows
    idx = None
    for values, validity, asc, nulls_first in reversed(list(keys)):
        v = values if idx is None else values[idx]
        lv = live if idx is None else live[idx]
        mv = None
        if validity is not None:
            mv = validity if idx is None else validity[idx]
        u = _order_key_u32(v, asc)
        if mv is not None:
            # NULL rows carry arbitrary payloads: zero them so the null
            # run keeps the previous pass's (stable) order
            u = u.masked_fill(~mv, 0)
        lane = (((_null_rank(lv, mv, nulls_first) << 32) | u) << posbits) \
            | pos
        order = torch.sort(lane).values & ((1 << posbits) - 1)
        idx = order if idx is None else idx[order]
    # no keys: live rows are a prefix, so the identity is padding-last
    return pos if idx is None else idx


def _stable_order(lanes: Sequence[Optional[torch.Tensor]]) -> torch.Tensor:
    """jnp.lexsort: a stable argsort by every lane, the last lane major
    (one stable sort a lane, minor first; None lanes are all-equal)."""
    order = None
    for lane in lanes:
        if lane is None:
            continue
        x = lane if order is None else lane[order]
        o = torch.sort(x, stable=True).indices
        order = o if order is None else order[o]
    return order


def _invert_order(v: torch.Tensor) -> torch.Tensor:
    if v.is_floating_point():
        return -v
    # bitwise NOT (-v - 1) reverses the order of two's-complement ints
    # without overflow: negation maps INT64_MIN to itself
    return torch.bitwise_not(v.to(torch.int64))


def sort_indices(keys: Sequence[SortLane], num_rows: int, capacity: int,
                 device=None) -> torch.Tensor:
    """Stable multi-key argsort (int64 positions). keys = [(values,
    validity, ascending, nulls_first)]; padding rows always sort last.

    Keys whose values fit 32 bits (bool, int8-32, float32, dates) take
    the packed path below PACKED_MAX_ROWS rows unless `sort_core` is
    "sort"; wider keys (int64, float64, timestamps) take iterated stable
    sorts from the least significant key. Both give the same
    permutation: Spark's order, NaN greatest, -0.0 equal to +0.0."""
    from blaze_tpu_torch.config import resolve_sort_core
    from blaze_tpu_torch.runtime import dispatch

    keys = list(keys)
    if device is None:
        device = keys[0][0].device
    packed_ok = resolve_sort_core(get_config().sort_core) == "scatter"
    if packed_ok and capacity < PACKED_MAX_ROWS and all(
            v.dim() == 1 and v.dtype in _PACKED_DTYPES
            for v, _, _, _ in keys):
        dispatch.record("sort_core.packed")
        return _sort_indices_packed(keys, num_rows, capacity, device)
    dispatch.record("sort_core.lexsort")
    pos = torch.arange(capacity, dtype=torch.int64, device=device)
    live = pos < num_rows
    idx = pos
    for values, validity, asc, nulls_first in reversed(keys):
        v = values[idx]
        lv = live[idx]
        tie = None
        if v.dtype == torch.bool:
            v = v.to(torch.int64)
        if v.is_floating_point():
            # Spark ordering: NaN sorts above every value, +inf included
            nan = torch.isnan(v)
            v = v.masked_fill(nan, float("inf"))
            tie = nan.to(torch.int8)
        if not asc:
            v = _invert_order(v)
            tie = None if tie is None else -tie
        if v.is_floating_point():
            # -0.0 equals +0.0: one bit pattern for the sort
            v = torch.where(v == 0, torch.zeros_like(v), v)
        mv = None
        if validity is not None:
            mv = validity[idx]
            # NULL rows carry arbitrary payloads: neutral value and tie
            # lanes keep the null run in the previous pass's order
            v = v.masked_fill(~mv, 0)
            tie = None if tie is None else tie.masked_fill(~mv, 0)
        order = _stable_order((tie, v, _null_rank(lv, mv, nulls_first)))
        idx = idx[order]
    # padding ranks 3 in the major lane of the last pass: it is last
    return idx
