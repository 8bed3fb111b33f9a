"""Content-addressed decoded-plan cache (zero-copy serve path).

Re-parsing a SUBMIT blob is host work that a repeat plan need not pay
(the JAX package found it the largest phase of a cached repeat on its
probe workload; the port has not measured it on the card). Repeat
plans are the
common case behind a router (affinity placement sends a digest's
repeats to the same replica on purpose), so the service keeps a small
LRU of decode RESULTS keyed by the blake2b digest of the raw blob -
the exact digest `router.placement.affinity_key` already computes, so
the router can forward it in submit meta (`plan_digest`) and the
replica never re-hashes the bytes it already paid to receive.

What a hit buys:

  metadata  -- fingerprint, fingerprint stability, the admission byte
               estimate, and the task's partition are ALWAYS reusable.
               A repeat whose result is in the ResultCache therefore
               never decodes at all (and, via the admission fast path,
               never queues for a reservation either).
  tree      -- the decoded operator tree is MUTATED in place by
               `prepare_decoded_task` (fusion / mesh lowering), so it
               is loaned to at most ONE executing query at a time via
               `borrow_tree`. A borrower that never executes (full
               cache hit) returns the pristine tree on terminal;
               a borrower that executed consumed it, and the next
               cache-missing repeat re-decodes lazily.

Thread-safe; every surface is counters-first (hits / misses /
evictions feed STATS and METRICS on both tiers).
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Any, Optional


def plan_digest(task_bytes: bytes, is_ref: bool) -> str:
    """Content digest of a raw SUBMIT blob. MUST stay byte-identical
    to `router.placement.affinity_key` (which delegates here): the
    router's placement key doubles as the replica's plan-cache key, so
    the digest travels in submit meta instead of being recomputed."""
    h = hashlib.blake2b(task_bytes, digest_size=16)
    h.update(b"ref" if is_ref else b"native")
    return h.hexdigest()


class PlanEntry:
    """One decoded plan: always-reusable metadata plus an exclusively
    loaned decoded tuple (see module docstring for the loan rule)."""

    __slots__ = ("fingerprint", "fingerprint_stable", "estimated_bytes",
                 "partition", "_tree", "_lock")

    def __init__(self, *, fingerprint: str, fingerprint_stable: bool,
                 estimated_bytes: Optional[int], partition: int,
                 tree: Any = None):
        self.fingerprint = fingerprint
        self.fingerprint_stable = bool(fingerprint_stable)
        self.estimated_bytes = estimated_bytes
        self.partition = int(partition)
        self._tree = tree
        self._lock = threading.Lock()

    def borrow_tree(self) -> Any:
        """Take the decoded tuple out of the entry (or None when a
        concurrent borrower holds it / an execution consumed it)."""
        with self._lock:
            tree, self._tree = self._tree, None
            return tree

    def restore_tree(self, tree: Any) -> None:
        """Return a PRISTINE (never-prepared) decoded tuple. Callers
        must not restore a tree that went through
        `prepare_decoded_task` - fusion mutated it in place."""
        if tree is None:
            return
        with self._lock:
            if self._tree is None:
                self._tree = tree

    @property
    def has_tree(self) -> bool:
        with self._lock:
            return self._tree is not None


class DecodedPlanCache:
    """Bounded thread-safe LRU: digest -> PlanEntry."""

    def __init__(self, max_entries: int = 256):
        self.max_entries = max(1, int(max_entries))
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, PlanEntry]" = OrderedDict()
        self.counters = {
            "hits": 0,
            "misses": 0,
            "evictions": 0,
            "puts": 0,
            # metadata hit whose tree was already loaned/consumed: the
            # repeat still skips decode unless it must execute
            "tree_unavailable": 0,
        }

    def get(self, key: str) -> Optional[PlanEntry]:
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self.counters["misses"] += 1
                return None
            self._entries.move_to_end(key)
            self.counters["hits"] += 1
            return entry

    def put(self, key: str, entry: PlanEntry) -> PlanEntry:
        """Insert (first writer wins: a concurrent duplicate decode
        keeps the existing entry so an outstanding loan is not
        orphaned). Returns the entry that is IN the cache."""
        with self._lock:
            existing = self._entries.get(key)
            if existing is not None:
                self._entries.move_to_end(key)
                return existing
            self._entries[key] = entry
            self.counters["puts"] += 1
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)
                self.counters["evictions"] += 1
            return entry

    def note_tree_unavailable(self) -> None:
        with self._lock:
            self.counters["tree_unavailable"] += 1

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "max_entries": self.max_entries,
                **self.counters,
            }
