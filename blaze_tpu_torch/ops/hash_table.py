"""Device open-addressing hash table, grouping half: sort-free group
slots for the keyed hash aggregate.

A copy of the grouping half of the JAX package's ops/hash_table.py
(`table_size_for`, `cheap_hash`, `_tri_slot`, `_pairwise_eq`,
`_keys_at`, `insert`, `group_slots`) on torch tensors:

  insert:  every live row hashes to a home slot in a power-of-two table;
           rounds of `scatter_reduce_(slot, row_index, "amin")` claim
           empty slots (the smallest row index wins, whatever order the
           scatter runs in), a gather-back + exact key comparison
           resolves rows whose key already owns the slot, and unresolved
           rows advance along their triangular probe sequence.
  direct:  a single integer key whose live range fits the table takes
           slot = value - min(value), one slot reserved for NULL.

The hash is bit-exact with the JAX one, so `insert` claims the same
slots and the aggregate's group order equals the JAX package's row for
row. torch has no full uint32 arithmetic and its `>>` on int32 is
arithmetic, so the uint32 mixer runs in int64 on values kept in
[0, 2^32) and masked after every step.

`lax.while_loop` and `lax.cond` become host control flow: one blocking
readback per probe round (`active.any()`) and one for the direct-or-hash
branch, both counted in runtime/dispatch. The join half (`insert_kr`,
`lookup_kr`, `lookup`, `insert_direct`, `lookup_direct`,
`probe_table_size`, `key_u32`) waits for ROADMAP 'Modules to port'
item 4 (joins).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from blaze_tpu_torch.exprs.hashing import _mul32
from blaze_tpu_torch.runtime.dispatch import host_bool

KeyCols = Sequence[Tuple[torch.Tensor, Optional[torch.Tensor]]]

_M32 = 0xFFFFFFFF
_F32_MIN_NORMAL = torch.finfo(torch.float32).tiny


def table_size_for(capacity: int) -> int:
    """Power-of-two table with load factor <= 0.5 at full capacity, so
    insertion always terminates (an empty slot exists on every probe
    chain) and expected chains stay O(1)."""
    t = 1024
    while t < 2 * capacity:
        t <<= 1
    return t


def cheap_hash(key_cols: KeyCols, capacity: int) -> torch.Tensor:
    """Fast intra-engine mixer for private table slots (Fibonacci
    multiply + xorshift finalizer), bit-exact with the JAX package's
    `cheap_hash`. Returns the uint32 hash as int64 in [0, 2^32).
    Collisions only cost extra probe rounds, never wrong answers
    (exact-key verification)."""
    phi = 0x9E3779B9
    dev = key_cols[0][0].device
    acc = torch.full((capacity,), 0x243F6A88, dtype=torch.int64, device=dev)
    for v, m in key_cols:
        if v.dtype.is_floating_point:
            # narrow to normalized f32 bits: -0.0 == 0.0 and NaN
            # payloads collapse so equal keys hash equal. Subnormals hash
            # as 0.0, as they do under XLA, which flushes them to zero;
            # key equality stays exact, so they still group apart.
            f32 = v.to(torch.float32)
            f32 = torch.where(f32.abs() < _F32_MIN_NORMAL,
                              torch.zeros_like(f32), f32)
            f32 = torch.where(torch.isnan(f32),
                              torch.full_like(f32, float("nan")), f32)
            u = f32.view(torch.int32).to(torch.int64) & _M32
        elif v.dtype == torch.bool:
            u = v.to(torch.int64)
        else:
            # every integer width folds through int64, so the hash is a
            # function of the value, not the storage width
            b = v.to(torch.int64)
            u = (b ^ ((b >> 32) & _M32)) & _M32
        u = _mul32(u, phi)
        if m is not None:
            u = torch.where(m, u, torch.full_like(u, 0x85EBCA6B))
        acc = (((acc << 5) & _M32) | (acc >> 27)) ^ u
    acc = acc ^ (acc >> 16)
    acc = _mul32(acc, 0x85EBCA6B)
    return acc ^ (acc >> 13)


def _tri_slot(u0: torch.Tensor, r: int, mask: int) -> torch.Tensor:
    """Probe slot r of the triangular sequence h, h+1, h+3, h+6, ...
    (offsets r(r+1)/2, in uint32 arithmetic as in the JAX package)."""
    off = ((r * (r + 1)) & _M32) >> 1
    return (u0 + off) & mask


def _pairwise_eq(av, am, bv, bm, null_equal: bool) -> torch.Tensor:
    """Exact equality of aligned key values; NaN == NaN; NULL semantics
    per `null_equal`."""
    eq = av == bv
    if av.dtype.is_floating_point:
        eq = eq | (torch.isnan(av) & torch.isnan(bv))
    if am is None and bm is None:
        return eq
    ones = torch.ones(av.shape[0], dtype=torch.bool, device=av.device)
    at = am if am is not None else ones
    bt = bm if bm is not None else ones
    if null_equal:
        # (both valid and equal) or (both null)
        return torch.where(at & bt, eq, at == bt)
    return eq & at & bt


def _keys_at(key_cols: KeyCols, idx: torch.Tensor) -> List:
    """Gather (values, validity) of every key column at row indices."""
    return [
        (torch.index_select(v, 0, idx),
         torch.index_select(m, 0, idx) if m is not None else None)
        for v, m in key_cols
    ]


def insert(h: torch.Tensor, key_cols: KeyCols, live: torch.Tensor,
           capacity: int, table_size: int, null_equal: bool,
           max_rounds: Optional[int] = None):
    """Insert all live rows; equal keys share one slot.

    `max_rounds` bounds the probe loop for undersized tables: when it
    trips, the leftover rows surface in `overflow` and the caller
    re-runs with a larger table.

    Returns (slot, rep_tab, overflow):
      slot     int64[capacity]   resolved slot per row (0 for dead rows)
      rep_tab  int32[table_size] minimum row index owning each slot;
               `capacity` marks an empty slot
      overflow bool tensor       rows left unresolved by the round bound
    """
    cap = capacity
    dev = live.device
    mask = table_size - 1
    rowidx = torch.arange(cap, dtype=torch.int32, device=dev)
    empty = torch.full((cap,), cap, dtype=torch.int32, device=dev)
    u0 = h & mask
    tab = torch.full((table_size,), cap, dtype=torch.int32, device=dev)
    final_slot = torch.zeros(cap, dtype=torch.int64, device=dev)
    active = live.clone()
    r = 0
    while (max_rounds is None or r < max_rounds) and \
            host_bool(active.any(), "insert_round"):
        slot = _tri_slot(u0, r, mask)
        occupant = torch.index_select(tab, 0, slot)
        # claim only empty slots: occupied slots are immutable, which
        # preserves the probe-sequence invariant lookups depend on
        cand = torch.where(active & (occupant == cap), rowidx, empty)
        tab.scatter_reduce_(0, slot, cand, "amin")
        rep = torch.index_select(tab, 0, slot)
        reps = rep.clamp(0, cap - 1).to(torch.int64)
        ok = rep != cap
        for (bv, bm), (sv, sm) in zip(_keys_at(key_cols, reps), key_cols):
            ok = ok & _pairwise_eq(sv, sm, bv, bm, null_equal)
        found = active & ok
        final_slot = torch.where(found, slot, final_slot)
        active = active & ~found
        r += 1
    return final_slot, tab, active.any()


def group_slots(key_cols: KeyCols, live: torch.Tensor, capacity: int,
                table_size: int, max_rounds: Optional[int] = None):
    """Slot assignment for grouping (NULL groups with NULL).

    A single integer (or bool) key whose live range fits the table takes
    the direct branch: slot = value - min(value), one reserved slot for
    NULL, no probing. Otherwise, and for several keys or float keys,
    rows hash-insert. The branch is data-dependent: one host readback.

    Returns (slot int64[capacity], rep_tab int32[table_size], overflow)."""
    cap = capacity
    v0 = key_cols[0][0]
    single_int = len(key_cols) == 1 and v0.dim() == 1 and (
        not v0.dtype.is_floating_point)

    def hash_insert():
        h = cheap_hash(key_cols, cap)
        return insert(h, key_cols, live, cap, table_size, True, max_rounds)

    if not single_int:
        return hash_insert()

    v, m = key_cols[0]
    valid = live if m is None else (live & m)
    if v.dtype == torch.bool:
        v = v.to(torch.int32)
    info = torch.iinfo(v.dtype)
    # the min/max run in the key's own dtype; only the two scalars widen
    kmin = torch.where(valid, v, torch.full_like(v, info.max)).min()
    kmax = torch.where(valid, v, torch.full_like(v, info.min)).max()
    diff = kmax.to(torch.int64) - kmin.to(torch.int64)
    # one slot for the NULL group when the key is nullable; int64 wrap
    # on an astronomically wide range makes diff negative, which the
    # >= 0 test rejects
    need = diff + (2 if m is not None else 1)
    in_range = (diff >= 0) & (need <= table_size) & valid.any()
    if not host_bool(in_range, "group_branch"):
        return hash_insert()
    # int8/int16 widen first: their own span can overflow the narrow
    # dtype; invalid rows may wrap but take the null slot below
    vw = v if v.element_size() >= 4 else v.to(torch.int32)
    raw = (vw - kmin.to(vw.dtype)).to(torch.int32).clamp(0, table_size - 1)
    null_slot = (diff + 1).clamp(0, table_size - 1)
    slot = torch.where(valid, raw.to(torch.int64), null_slot)
    rowidx = torch.arange(cap, dtype=torch.int32, device=live.device)
    cand = torch.where(live, rowidx, torch.full_like(rowidx, cap))
    tab = torch.full((table_size,), cap, dtype=torch.int32,
                     device=live.device)
    tab.scatter_reduce_(0, slot, cand, "amin")
    return slot, tab, torch.zeros((), dtype=torch.bool, device=live.device)
