"""Streaming sort-merge join for inputs sorted on their join keys.

A port of the JAX package's ops/streaming_smj.py. The reference streams
both sorted sides with single-row cursors (sort_merge_join_exec.rs:
293-601); here the stream moves a batch at a time: a sliding window of
right-side batches is kept only as wide as the current left batch's key
range needs (once the left stream has passed a key, right rows below it
never match again), and each left batch joins the window entries whose
key range overlaps its own, each entry with its own join core
(ops/joins._JoinCore), built once for the entry's time in the window.
Memory is O(window), not O(side).

The window's bookkeeping runs on host key matrices: each batch's keys
cross to the host once (one D2H copy). Contract: both inputs sorted
ascending by their join keys (the planner puts sorts under the join, as
Spark does). Every join type but the null-aware anti join; RIGHT and
FULL emit a window batch's unmatched rows when it leaves the window.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch

from blaze_tpu_torch.batch import ColumnBatch, row_mask
from blaze_tpu_torch.ops.base import ExecContext, PhysicalOp
from blaze_tpu_torch.ops.joins import (
    JoinType,
    _JoinCore,
    _joined_schema,
    _null_side,
    check_key_types,
)
from blaze_tpu_torch.ops.util import ensure_compacted
from blaze_tpu_torch.runtime import dispatch
from blaze_tpu_torch.types import Schema


def _to_host(t: torch.Tensor) -> np.ndarray:
    if t.device.type != "cpu":
        dispatch.record("d2h_fetches")
    return t.cpu().numpy()


class _WindowEntry:
    """One right-side batch in the window, with its join core built on
    first probe and kept while the batch stays in the window."""

    __slots__ = ("batch", "min_key", "max_key", "core")

    def __init__(self, batch: ColumnBatch, keys: np.ndarray):
        self.batch = batch
        self.min_key = keys[0]
        self.max_key = keys[-1]
        self.core: Optional[_JoinCore] = None

    def ensure_core(self, right_keys: Sequence[int],
                    track_build: bool) -> _JoinCore:
        if self.core is None:
            self.core = _JoinCore(self.batch, list(right_keys), track_build)
        return self.core

    def matched_rows(self) -> np.ndarray:
        """Host bool mask of the window rows some probe row matched."""
        if self.core is None:
            return np.zeros(self.batch.num_rows, dtype=bool)
        return _to_host(self.core.matched_build[: self.batch.num_rows])


def _key_matrix(cb: ColumnBatch, key_idx: Sequence[int]) -> np.ndarray:
    """(num_rows, n_keys) host array of the key values, for the window's
    range bookkeeping (one D2H copy of the keys)."""
    cols = [_to_host(cb.columns[i].values[: cb.num_rows]) for i in key_idx]
    return np.stack(cols, axis=1) if cols else np.zeros((cb.num_rows, 0))


def _tuple_lt(a: np.ndarray, b: np.ndarray) -> bool:
    """Lexicographic a < b of two key tuples."""
    for x, y in zip(a, b):
        if x < y:
            return True
        if x > y:
            return False
    return False


class StreamingSortMergeJoinExec(PhysicalOp):
    build_child = 1

    _FINGERPRINT_STABLE = True

    def _fingerprint_params(self) -> str:
        return (f"{self.join_type.name};l={self.left_keys};"
                f"r={self.right_keys}")

    def __init__(self, left: PhysicalOp, right: PhysicalOp,
                 left_keys: Sequence[str], right_keys: Sequence[str],
                 join_type: JoinType = JoinType.INNER):
        if join_type is JoinType.LEFT_ANTI_NULL_AWARE:
            raise NotImplementedError(
                "null-aware anti join needs the whole build side (any "
                "NULL key empties the result): materializing SMJ only")
        self.children = [left, right]
        self.left_keys = [left.schema.index_of(k) for k in left_keys]
        self.right_keys = [right.schema.index_of(k) for k in right_keys]
        check_key_types(left.schema, self.left_keys, right.schema,
                        self.right_keys)
        for sch, keys in ((left.schema, self.left_keys),
                          (right.schema, self.right_keys)):
            for i in keys:
                if sch.fields[i].dtype.is_string_like:
                    # as the JAX package (blaze_tpu/ops/streaming_smj.py:
                    # 106-109); the decoder falls back to the
                    # materializing SortMergeJoinExec
                    raise NotImplementedError(
                        "string keys in the streaming sort-merge join: "
                        "the materializing SortMergeJoinExec takes them")
        self.join_type = join_type
        self._schema = _joined_schema(left.schema, right.schema, join_type)

    @property
    def schema(self) -> Schema:
        return self._schema

    @property
    def partition_count(self) -> int:
        return self.children[0].partition_count

    def describe(self) -> str:
        return f"StreamingSortMergeJoinExec[{self.join_type.name}]"

    def execute(self, partition: int, ctx: ExecContext
                ) -> Iterator[ColumnBatch]:
        left, right = self.children
        jt = self.join_type
        right_it = right.execute(partition, ctx)
        window: List[_WindowEntry] = []
        right_done = False

        def pull_right() -> bool:
            nonlocal right_done
            if right_done:
                return False
            for rb in right_it:
                rb = ensure_compacted(rb)
                if rb.num_rows == 0:
                    continue
                window.append(
                    _WindowEntry(rb, _key_matrix(rb, self.right_keys)))
                return True
            right_done = True
            return False

        def evict(before_key: Optional[np.ndarray]
                  ) -> Iterator[ColumnBatch]:
            """Drop the window batches wholly below `before_key` (None:
            all), emitting their unmatched rows for RIGHT and FULL."""
            keep = []
            for entry in window:
                if before_key is None or _tuple_lt(entry.max_key,
                                                   before_key):
                    if jt in (JoinType.RIGHT, JoinType.FULL):
                        matched = entry.matched_rows()
                        if not matched.all():
                            yield self._right_unmatched(entry.batch,
                                                        matched)
                else:
                    keep.append(entry)
            window[:] = keep

        for lb in left.execute(partition, ctx):
            lb = ensure_compacted(lb)
            if lb.num_rows == 0:
                continue
            lkeys = _key_matrix(lb, self.left_keys)
            lmin, lmax = lkeys[0], lkeys[-1]
            # widen the window until the right stream passes lmax
            while (not window
                   or not _tuple_lt(lmax, window[-1].max_key)) \
                    and pull_right():
                pass
            # shrink: whole batches below lmin never match again
            yield from evict(lmin)
            yield from self._join_left_batch(lb, lmax, window)
        yield from evict(None)
        if jt in (JoinType.RIGHT, JoinType.FULL) and not right_done:
            for rb in right_it:
                rb = ensure_compacted(rb)
                if rb.num_rows:
                    yield self._right_unmatched(
                        rb, np.zeros(rb.num_rows, dtype=bool))

    def _join_left_batch(self, lb: ColumnBatch, lmax: np.ndarray,
                         window: List[_WindowEntry]
                         ) -> Iterator[ColumnBatch]:
        """Probe the left batch against each window entry whose key
        range overlaps it (entries below it were evicted before)."""
        right = self.children[1]
        jt = self.join_type
        emit = jt in (JoinType.INNER, JoinType.LEFT, JoinType.RIGHT,
                      JoinType.FULL)
        track = jt in (JoinType.RIGHT, JoinType.FULL)
        probe = lb
        matched_any = None
        for entry in window:
            if _tuple_lt(lmax, entry.min_key):
                continue
            core = entry.ensure_core(self.right_keys, track)
            state = core.probe(probe, self.left_keys)
            probe = state[1]
            out_cols, valid, pair_cap, matched_p = core.emit_pairs(
                state, entry.batch.columns if emit else [],
                probe.columns if emit else [], build_first=False)
            matched_any = matched_p if matched_any is None \
                else matched_any | matched_p
            if emit:
                yield ColumnBatch(self._schema, out_cols, pair_cap, valid)
        live_p = row_mask(probe.num_rows, probe.capacity, probe.device)
        if matched_any is None:
            matched_any = torch.zeros_like(live_p)
        if emit:
            if jt in (JoinType.LEFT, JoinType.FULL):
                rnull = _null_side(right.schema.fields, probe.capacity,
                                   probe.device)
                yield ColumnBatch(self._schema, list(probe.columns) + rnull,
                                  probe.num_rows, live_p & ~matched_any)
        elif jt is JoinType.LEFT_SEMI:
            yield ColumnBatch(self._schema, list(probe.columns),
                              probe.num_rows, live_p & matched_any)
        elif jt is JoinType.LEFT_ANTI:
            yield ColumnBatch(self._schema, list(probe.columns),
                              probe.num_rows, live_p & ~matched_any)

    def _right_unmatched(self, rb: ColumnBatch, matched: np.ndarray
                         ) -> ColumnBatch:
        left = self.children[0]
        un = np.zeros(rb.capacity, dtype=bool)
        un[: rb.num_rows] = ~matched
        lnull = _null_side(left.schema.fields, rb.capacity, rb.device)
        return ColumnBatch(self._schema, lnull + list(rb.columns),
                           rb.num_rows,
                           torch.from_numpy(un).to(rb.device))
