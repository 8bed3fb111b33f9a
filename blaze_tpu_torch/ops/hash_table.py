"""Device open-addressing hash table: sort-free group slots for the
keyed hash aggregate and build tables for the equi-joins.

A copy of the JAX package's ops/hash_table.py on torch tensors. The
grouping half (`table_size_for`, `cheap_hash`, `_tri_slot`,
`_pairwise_eq`, `_keys_at`, `insert`, `group_slots`):

  insert:  every live row hashes to a home slot in a power-of-two table;
           rounds of `scatter_reduce_(slot, row_index, "amin")` claim
           empty slots (the smallest row index wins, whatever order the
           scatter runs in), a gather-back + exact key comparison
           resolves rows whose key already owns the slot, and unresolved
           rows advance along their triangular probe sequence.
  direct:  a single integer key whose live range fits the table takes
           slot = value - min(value), one slot reserved for NULL.

The join half (`probe_table_size`, `key_u32`, `insert_kr`, `lookup_kr`,
`insert_direct`, `lookup_direct`, `direct_table_size`, `lookup`): the
build relation of a join inserts into a table - a dense key -> row
array, a fused key|row table for one narrow key, or the generic row
table above - and each probe row walks its chain to its build row.
Every function returns the JAX function's table and `match_idx`.

The hash is bit-exact with the JAX one, so `insert` claims the same
slots and the aggregate's group order equals the JAX package's row for
row. torch has no full uint32 arithmetic and its `>>` on int32 is
arithmetic, so the uint32 mixer runs in int64 on values kept in
[0, 2^32) and masked after every step; for the same reason the fused
key|row entries are int64 (`insert_kr`).

`lax.while_loop` and `lax.cond` become host control flow: one blocking
readback per probe round (`active.any()`) and one for the direct-or-hash
branch, each counted in runtime/dispatch under its cause. Inside a CUDA
graph (ops/fused.py) no readback may run, so `static=True` takes the
graph's form instead: `insert` and `group_slots` run exactly
`max_rounds` probe rounds and report rows left over as a device
`overflow` flag, and `group_slots` computes both the direct and the
hashed slots and selects one with `torch.where` (the arms of the JAX
package's `lax.cond`). The joins' lookups take a `rounds` count, which
`probe_rounds` computes once per table: the longest probe any key
can walk before an empty slot, so a fixed-round lookup is exact.
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


def probe_table_size(capacity: int) -> int:
    """Table size for join probes: a lookup runs one pass over the probe
    batch per round until the longest chain resolves, so the load
    factor multiplies probe cost. 8x the build rows, at most 2^23 slots,
    and never below `table_size_for` (the JAX package's sizing)."""
    t = table_size_for(capacity)
    while t < 8 * capacity and t < (1 << 23):
        t <<= 1
    return t


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
           max_rounds: Optional[int] = None, sync: str = "insert_round",
           static: bool = False, want_dup: bool = True):
    """Insert all live rows; equal keys share one slot.

    `max_rounds` bounds the probe loop for undersized tables: when it
    trips, the leftover rows surface in `overflow` and the caller
    re-runs with a larger table. `sync` names the per-round readback.
    `static` runs exactly `max_rounds` rounds with no readback (inside
    a CUDA graph); `want_dup=False` skips the duplicate flag (a grouping
    never reads it) and returns a constant False for it.

    Returns (slot, rep_tab, dup, overflow):
      slot     int64[capacity]   resolved slot per row (0 for dead rows)
      rep_tab  int32[table_size] minimum row index owning each slot;
               `capacity` marks an empty slot
      dup      bool tensor       a live row's key was already present
               (its representative is another row)
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
    dup = torch.zeros((), dtype=torch.bool, device=dev)
    if static and max_rounds is None:
        raise ValueError("insert: a static insert needs max_rounds")
    r = 0
    while (max_rounds is None or r < max_rounds) and \
            (static or host_bool(active.any(), sync)):
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
        if want_dup:
            dup = dup | (found & (rep != rowidx)).any()
        final_slot = torch.where(found, slot, final_slot)
        active = active & ~found
        r += 1
    return final_slot, tab, dup, active.any()


def group_slots(key_cols: KeyCols, live: torch.Tensor, capacity: int,
                table_size: int, max_rounds: Optional[int] = None,
                static: bool = False, direct_only: bool = False):
    """Slot assignment for grouping (NULL groups with NULL).

    A single integer (or bool) key whose live range fits the table takes
    the direct branch: slot = value - min(value), one reserved slot for
    NULL, no probing. Otherwise, and for several keys or float keys,
    rows hash-insert. The branch is data-dependent: one host readback;
    with `static` (inside a CUDA graph) both arms run and `torch.where`
    picks one, and the hash insert runs exactly `max_rounds` rounds.
    `direct_only` (static, a single integer key) runs the direct arm
    alone, without the hash arm's probe rounds, and `overflow` then
    means the range did not fit: the caller runs the batch again with
    both arms.

    Returns (slot int64[capacity], rep_tab int32[table_size], overflow)."""
    cap = capacity
    v0 = key_cols[0][0]
    single_int = len(key_cols) == 1 and v0.dim() == 1 and (
        not v0.dtype.is_floating_point)

    def hash_insert():
        h = cheap_hash(key_cols, cap)
        slot, tab, _dup, overflow = insert(
            h, key_cols, live, cap, table_size, True, max_rounds,
            static=static, want_dup=False)
        return slot, tab, overflow

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
    if not static and not host_bool(in_range, "group_branch"):
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
    no_overflow = torch.zeros((), dtype=torch.bool, device=live.device)
    if not static:
        return slot, tab, no_overflow
    if direct_only:
        return slot, tab, ~in_range
    h_slot, h_tab, h_overflow = hash_insert()
    return (torch.where(in_range, slot, h_slot),
            torch.where(in_range, tab, h_tab),
            ~in_range & h_overflow)


# ---------------------------------------------------------------------------
# join half
# ---------------------------------------------------------------------------

def key_u32(v: torch.Tensor, m) -> Optional[torch.Tensor]:
    """Exact 32-bit encoding of one narrow join key as int64 in
    [0, 2^32), or None when the dtype does not fit. Equal encodings are
    equal SQL keys: float32 -0.0 encodes as +0.0 and every NaN as the
    canonical quiet NaN (joins match NaN with NaN); integers of at most
    4 bytes sign-extend to int32 (the JAX package's uint32 view)."""
    if v.dim() != 1:
        return None
    if v.dtype == torch.float32:
        # float64 is not eligible: narrowing would merge keys distinct
        # beyond float32 precision, and this encoding is the equality
        f = torch.where(v == 0.0, torch.zeros_like(v), v)
        bits = f.view(torch.int32).to(torch.int64) & _M32
        return torch.where(torch.isnan(f),
                           torch.full_like(bits, 0x7FC00000), bits)
    if v.dtype == torch.bool:
        return v.to(torch.int64)
    if v.dtype in (torch.int8, torch.int16, torch.int32):
        return v.to(torch.int64) & _M32
    return None


#: the empty entry of a fused key|row table: above every live entry
KR_EMPTY = 0x7FFFFFFFFFFFFFFF
#: rows of a fused key|row table: an entry is key32 << 31 | row, so a
#: row must stay below 2^31 - 1 for the largest entry,
#: (2^32 - 1) << 31 | (2^31 - 2), to stay below KR_EMPTY
KR_MAX_ROWS = (1 << 31) - 1
_KR_ROW = (1 << 31) - 1


def insert_kr(k32: torch.Tensor, h: torch.Tensor, live: torch.Tensor,
              capacity: int, table_size: int):
    """Single-narrow-key insert into a fused key|row table: each probe
    round is one gather and one compare. Returns (tab int64[table_size],
    dup bool tensor).

    The JAX package's entries are the uint64 key32 << 32 | row under a
    `.at[].min`; torch's `amin` scatter takes int64, so an entry here is
    key32 << 31 | row (row < 2^31 - 1, KR_MAX_ROWS): the same order as
    the JAX entries, so a contested slot goes to the same row (the
    smallest key, then the smallest row), and KR_EMPTY above it all."""
    if capacity > KR_MAX_ROWS:
        raise ValueError(f"insert_kr: {capacity} rows; at most "
                         f"{KR_MAX_ROWS} fit the key|row entries")
    dev = live.device
    mask = table_size - 1
    rowidx = torch.arange(capacity, dtype=torch.int64, device=dev)
    entries = (k32 << 31) | rowidx
    empty = torch.full_like(entries, KR_EMPTY)
    u0 = h & mask
    tab = torch.full((table_size,), KR_EMPTY, dtype=torch.int64,
                     device=dev)
    active = live.clone()
    dup = torch.zeros((), dtype=torch.bool, device=dev)
    r = 0
    while host_bool(active.any(), "join_insert_round"):
        slot = _tri_slot(u0, r, mask)
        occupant = torch.index_select(tab, 0, slot)
        cand = torch.where(active & (occupant == KR_EMPTY), entries, empty)
        tab.scatter_reduce_(0, slot, cand, "amin")
        entry = torch.index_select(tab, 0, slot)
        found = active & (entry != KR_EMPTY) & ((entry >> 31) == k32)
        dup = dup | (found & ((entry & _KR_ROW) != rowidx)).any()
        active = active & ~found
        r += 1
    return tab, dup


def _more_rounds(r: int, active: torch.Tensor,
                 rounds: Optional[int]) -> bool:
    """Whether a lookup runs probe round r: every round below `rounds`
    when the table's bound is known (no readback), else the first two
    and then while a probe row is unresolved (one readback a round)."""
    if rounds is not None:
        return r < rounds
    return r < 2 or host_bool(active.any(), "join_probe_round")


def probe_rounds(tab: torch.Tensor, empty: int) -> int:
    """The probe rounds that resolve every lookup in `tab`: for each home
    slot, the rounds of its triangular sequence up to and including its
    first empty slot, at most. A probe row stops at its match or at that
    empty slot, so a lookup of exactly this many rounds is exact. One
    readback a round, once per table (`d2h_syncs.join_chain_round`)."""
    mask = tab.shape[0] - 1
    home = torch.arange(tab.shape[0], dtype=torch.int64, device=tab.device)
    active = torch.ones(tab.shape[0], dtype=torch.bool, device=tab.device)
    r = 0
    while host_bool(active.any(), "join_chain_round"):
        occupant = torch.index_select(tab, 0, _tri_slot(home, r, mask))
        active = active & (occupant != empty)
        r += 1
    return r


def lookup_kr(tab: torch.Tensor, k32: torch.Tensor, h: torch.Tensor,
              probe_live: torch.Tensor, rounds: Optional[int] = None):
    """Probe a fused key|row table: one gather and one compare a round.
    Returns (match_idx int32, -1 where unmatched; matched bool). The
    JAX package runs the rounds past the second on a compacted tail;
    every round here runs at full width, which gives the same
    match_idx. `rounds` (the table's `probe_rounds`) runs that many
    rounds with no readback."""
    mask = tab.shape[0] - 1
    u0 = h & mask
    active = probe_live
    match = torch.full(k32.shape, -1, dtype=torch.int32, device=k32.device)
    r = 0
    # the first two rounds resolve nearly every probe: no readback
    # before the third
    while _more_rounds(r, active, rounds):
        slot = _tri_slot(u0, r, mask)
        entry = torch.index_select(tab, 0, slot)
        is_empty = entry == KR_EMPTY
        hit = active & ~is_empty & ((entry >> 31) == k32)
        match = torch.where(hit, (entry & _KR_ROW).to(torch.int32), match)
        active = active & ~is_empty & ~hit
        r += 1
    return match, match >= 0


#: the empty slot of a direct table: row indices stay below INT32_MAX
DIRECT_EMPTY = 0x7FFFFFFF


def insert_direct(keys: torch.Tensor, live: torch.Tensor, capacity: int,
                  base: int, table_size: int):
    """Dense-domain dimension table: tab[key - base] = row index (the
    smallest row of a key). Surrogate keys are near-contiguous ints, so
    probing is one gather with no hash and no key comparison. Returns
    (tab int32[table_size], dup bool tensor): dup means two live rows
    share a key (the caller demotes to the sorted core)."""
    dev = live.device
    idx = (keys.to(torch.int64) - base).clamp(0, table_size - 1)
    rows = torch.arange(capacity, dtype=torch.int32, device=dev)
    tab = torch.full((table_size,), DIRECT_EMPTY, dtype=torch.int32,
                     device=dev)
    tab.scatter_reduce_(
        0, idx, torch.where(live, rows, torch.full_like(rows, DIRECT_EMPTY)),
        "amin")
    rep = torch.index_select(tab, 0, idx)
    return tab, (live & (rep != rows)).any()


def lookup_direct(tab: torch.Tensor, base: int, span: int,
                  keys: torch.Tensor, probe_live: torch.Tensor):
    """Probe a dense-domain table: one subtract, a range check and one
    gather at a clamped index. Returns (match_idx int32, -1 where
    unmatched; matched bool)."""
    idx = keys.to(torch.int64) - base
    in_range = (idx >= 0) & (idx < span)
    rep = torch.index_select(tab, 0, idx.clamp(0, tab.shape[0] - 1))
    matched = probe_live & in_range & (rep != DIRECT_EMPTY)
    return torch.where(matched, rep, torch.full_like(rep, -1)), matched


def direct_table_size(span: int) -> int:
    """Power-of-two table size for a key span, at least 1024."""
    t = 1024
    while t < span:
        t <<= 1
    return t


def lookup(rep_tab: torch.Tensor, h_probe: torch.Tensor,
           probe_key_cols: KeyCols, build_key_cols: KeyCols,
           probe_live: torch.Tensor, build_capacity: int,
           null_equal: bool = False, rounds: Optional[int] = None):
    """Each probe row's build row (the first inserted row of its key),
    walking the probe chain to the first empty slot. Returns (match_idx
    int32, -1 where unmatched; matched bool). `rounds` as in
    `lookup_kr`."""
    mask = rep_tab.shape[0] - 1
    u0 = h_probe & mask
    active = probe_live
    match = torch.full(h_probe.shape, -1, dtype=torch.int32,
                       device=h_probe.device)
    r = 0
    while _more_rounds(r, active, rounds):
        slot = _tri_slot(u0, r, mask)
        rep = torch.index_select(rep_tab, 0, slot)
        is_empty = rep == build_capacity
        reps = rep.clamp(0, build_capacity - 1).to(torch.int64)
        ok = ~is_empty
        for (bv, bm), (pv, pm) in zip(_keys_at(build_key_cols, reps),
                                      probe_key_cols):
            ok = ok & _pairwise_eq(pv, pm, bv, bm, null_equal)
        hit = active & ok
        match = torch.where(hit, rep, match)
        active = active & ~is_empty & ~hit
        r += 1
    return match, match >= 0
