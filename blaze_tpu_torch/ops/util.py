"""Shared batch utilities for operators: device gather/compact and batch
concatenation."""

from __future__ import annotations

from typing import List, Optional, Tuple

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
