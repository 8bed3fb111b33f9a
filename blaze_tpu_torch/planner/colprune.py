"""Scan-level column pruning + filter pushdown (the JAX package's
planner/colprune.py, on the port's operators).

Reference counterpart: the reference's ParquetExec receives an explicit
projection (field indices picked by Spark, NativeParquetScanExec.scala:
105-107) and a pruning predicate evaluated against parquet statistics
(from_proto.rs:202-212); DataFusion additionally re-evaluates pushed-down
row filters on the CPU inside the scan. This engine's plans arrive as
whole subtrees (the proto carries the full operator chain), so the
equivalent decisions are made here by analysis:

- `install(root)` walks the physical plan top-down computing, for every
  `ParquetScanExec`, the set of column positions any ancestor can ever
  read. Unreferenced columns are neither decoded from parquet nor
  transferred to the device - the scan substitutes shared device-resident
  zero placeholders so schema positions (and therefore every BoundCol in
  the plan) stay valid. On a network-attached TPU this directly cuts the
  H2D byte volume, which is the dominant e2e cost for IO-heavy queries.

- With `with_filters=True` (only safe on freshly-decoded trees - the
  executor's `decode_task` path, where no scan object is shared with
  another live plan), conjuncts of a `FilterExec` sitting directly above
  a scan that are exactly evaluable by pyarrow (`col <cmp> literal`) are
  attached to the scan. The scan evaluates them on the host during decode
  (vectorized C++), BEFORE padding/transfer, and also reuses them for
  row-group statistics pruning. The device `FilterExec` still re-applies
  the full predicate, so a conservative mismatch can only cost work,
  never correctness; conjuncts are chosen so pyarrow's NULL/NaN
  comparison semantics drop exactly the rows the device mask would.

Correctness invariant: a column is prunable only if NO ancestor reads it.
The analysis is conservative - any operator it does not understand marks
all of its children's columns as required.

Port differences: the walk knows the port's fused operators
(ops/fused.py: FusedPipelineExec, FusedAggregateExec,
FusedWindowAggExec, HostFinalAggExec), a window's folded chain, and the
exchanges (parallel/exchange.py), whose map stage writes only what the
consumer and the partition keys read. The pushed conjuncts are the JAX
package's; the scan applies them in Spark's order, where NaN is above
every value (ops/parquet_scan.py `_apply_host_filters`).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

from blaze_tpu_torch.exprs import ir
from blaze_tpu_torch.types import Schema


# ---------------------------------------------------------------------------
# expression column references
# ---------------------------------------------------------------------------

def expr_cols(e: Optional[ir.Expr], schema: Schema) -> Set[int]:
    out: Set[int] = set()
    stack = [e]
    while stack:
        x = stack.pop()
        if x is None:
            continue
        if isinstance(x, ir.BoundCol):
            out.add(x.index)
        elif isinstance(x, ir.Col):
            out.add(schema.index_of(x.name))
        else:
            stack.extend(ir.children(x))
    return out


def split_conjuncts(e: ir.Expr) -> List[ir.Expr]:
    if isinstance(e, ir.BinaryOp) and e.op is ir.Op.AND:
        return split_conjuncts(e.left) + split_conjuncts(e.right)
    return [e]


_CMPS = (ir.Op.LT, ir.Op.LTE, ir.Op.GT, ir.Op.GTE, ir.Op.EQ, ir.Op.NEQ)
_FLIP = {ir.Op.LT: ir.Op.GT, ir.Op.GT: ir.Op.LT,
         ir.Op.LTE: ir.Op.GTE, ir.Op.GTE: ir.Op.LTE}


def _cast_is_widening(src, dst) -> bool:
    """True when comparing the uncast column equals comparing the cast
    value under arrow/device promotion: exact value-preserving widenings
    only. Narrowing/truncating casts (float->int, int64->int32, ...)
    change comparison results and must NOT be stripped."""
    import numpy as np

    try:
        s = np.dtype(src.physical_dtype())
        d = np.dtype(dst.physical_dtype())
    except Exception:
        return False
    if s.kind == "b" and d.kind in "if":
        return True
    if s.kind in "iu" and d.kind in "iu":
        return d.itemsize >= s.itemsize and s.kind == d.kind
    if s.kind in "iu" and d.kind == "f":
        # int->float: both pyarrow's promotion and the device cast go
        # through double, so the comparison agrees even where float64
        # cannot represent the int exactly
        return d.itemsize == 8
    if s.kind == "f" and d.kind == "f":
        return d.itemsize >= s.itemsize
    return False


def _strip_numeric_cast(e: ir.Expr, schema: Schema) -> ir.Expr:
    """Peel value-preserving widening casts off a column ref (the device
    filter re-checks survivors, but host-dropped rows are unrecoverable,
    so only casts that provably keep the comparison identical qualify)."""
    from blaze_tpu_torch.exprs.typing import infer_dtype

    while isinstance(e, ir.Cast):
        try:
            src = infer_dtype(e.child, schema)
        except Exception:
            return e
        if src.id.name in ("DECIMAL",) or e.to.id.name in ("DECIMAL",):
            return e
        if not _cast_is_widening(src, e.to):
            return e
        e = e.child
    return e


def pushable_conjunct(e: ir.Expr, schema: Schema
                      ) -> Optional[Tuple[str, ir.Op, object]]:
    """`(column_name, cmp, literal)` if pyarrow can evaluate this conjunct
    with SQL-compatible semantics, else None."""
    if not (isinstance(e, ir.BinaryOp) and e.op in _CMPS):
        return None
    lhs, rhs, op = e.left, e.right, e.op
    lc = _strip_numeric_cast(lhs, schema)
    rc = _strip_numeric_cast(rhs, schema)
    col, lit = None, None
    if isinstance(lc, (ir.Col, ir.BoundCol)) and isinstance(rc, ir.Literal):
        col, lit = lc, rc
    elif isinstance(rc, (ir.Col, ir.BoundCol)) and isinstance(
        lc, ir.Literal
    ):
        col, lit = rc, lc
        op = _FLIP.get(op, op)
    if col is None or lit.value is None:
        return None
    v = lit.value
    if isinstance(v, float) and v != v:  # NaN literal: never pushable
        return None
    if not isinstance(v, (int, float, bool, str)):
        return None
    idx = col.index if isinstance(col, ir.BoundCol) else (
        schema.index_of(col.name)
    )
    field = schema.fields[idx]
    # engine literals for these types are internal representations
    # (i64-unscaled decimals, epoch ints) that pyarrow would compare
    # against the REAL arrow values - never pushable as-is
    if field.dtype.id.name in ("DECIMAL", "TIMESTAMP_US", "DATE32"):
        return None
    lit_id = getattr(lit.dtype, "id", None)
    if lit_id is not None and lit_id.name in (
        "DECIMAL", "TIMESTAMP_US", "DATE32"
    ):
        return None
    return (field.name, op, v)


# ---------------------------------------------------------------------------
# plan walk
# ---------------------------------------------------------------------------

def _walk(op, req: Optional[Set[int]], acc: "_Acc") -> None:
    from blaze_tpu_torch.ops.filter import FilterExec
    from blaze_tpu_torch.ops.fused import (
        FusedAggregateExec,
        FusedPipelineExec,
        FusedWindowAggExec,
        HostFinalAggExec,
    )
    from blaze_tpu_torch.ops.hash_aggregate import HashAggregateExec
    from blaze_tpu_torch.ops.joins import HashJoinExec, SortMergeJoinExec
    from blaze_tpu_torch.ops.limit import LimitExec
    from blaze_tpu_torch.ops.parquet_scan import ParquetScanExec
    from blaze_tpu_torch.ops.project import ProjectExec
    from blaze_tpu_torch.ops.rename import RenameColumnsExec
    from blaze_tpu_torch.ops.sort import SortExec
    from blaze_tpu_torch.ops.streaming_smj import StreamingSortMergeJoinExec
    from blaze_tpu_torch.ops.union import CoalescePartitionsExec, UnionExec
    from blaze_tpu_torch.ops.window import WindowExec
    from blaze_tpu_torch.ops.debug import DebugExec
    from blaze_tpu_torch.parallel.exchange import (
        BroadcastExchangeExec,
        CoalescedShuffleReader,
        ShuffleExchangeExec,
    )

    if isinstance(op, ParquetScanExec):
        acc.record_scan(op, req, [])
        return
    if isinstance(op, (FusedPipelineExec, FusedAggregateExec)):
        _walk_fused(op, req, acc)
        return
    if isinstance(op, HostFinalAggExec):
        # finalizes the whole state row: every state is read
        _walk(op.children[0], None, acc)
        return
    if isinstance(op, FusedWindowAggExec):
        win = op.window
        need: Set[int] = set()
        for a, _ in op.agg.aggs:
            need |= expr_cols(a, win.schema)
        _walk_window(win, need, acc)
        return
    if isinstance(op, ShuffleExchangeExec):
        # the map stage writes the columns its consumers read; the
        # partitioner reads its keys
        child = op.children[0]
        kc: Set[int] = set()
        for k in op.keys:
            kc |= expr_cols(k, child.schema)
        _walk(child, None if req is None else set(req) | kc, acc)
        return
    if isinstance(op, (BroadcastExchangeExec, CoalescedShuffleReader)):
        _walk(op.children[0], None if req is None else set(req), acc)
        return
    if isinstance(op, FilterExec):
        child = op.children[0]
        pred_cols = expr_cols(op.predicate, child.schema)
        child_req = None if req is None else set(req) | pred_cols
        if isinstance(child, ParquetScanExec):
            filters = _scan_filters([op.predicate], child.schema)
            acc.record_scan(child, child_req, filters)
            return
        _walk(child, child_req, acc)
        return
    if isinstance(op, ProjectExec):
        child = op.children[0]
        idxs = (
            range(len(op.exprs)) if req is None else sorted(req)
        )
        child_req: Set[int] = set()
        for i in idxs:
            child_req |= expr_cols(op.exprs[i][0], child.schema)
        _walk(child, child_req, acc)
        return
    if isinstance(op, (RenameColumnsExec, LimitExec,
                       CoalescePartitionsExec)):
        _walk(op.children[0], None if req is None else set(req), acc)
        return
    if isinstance(op, DebugExec):
        # DebugExec materializes EVERY batch via to_arrow() for logging
        # (the reference logs full batches too, debug_exec.rs:44-58), so
        # a pruned placeholder column would crash the log path - require
        # all child columns
        _walk(op.children[0], None, acc)
        return
    if isinstance(op, SortExec):
        child = op.children[0]
        kc: Set[int] = set()
        for k in op.keys:
            kc |= expr_cols(k.expr, child.schema)
        _walk(child, None if req is None else set(req) | kc, acc)
        return
    if isinstance(op, UnionExec):
        for c in op.children:
            _walk(c, None if req is None else set(req), acc)
        return
    if isinstance(op, HashAggregateExec):
        child = op.children[0]
        need: Set[int] = set()
        for e, _ in op.keys:
            need |= expr_cols(e, child.schema)
        for a, _ in op.aggs:
            need |= expr_cols(a, child.schema)
        if op.mode.name == "FINAL":
            # FINAL locates states positionally across the whole partial
            # schema - everything is required
            need = None  # type: ignore[assignment]
        _walk(child, need, acc)
        return
    if isinstance(op, (HashJoinExec, SortMergeJoinExec,
                       StreamingSortMergeJoinExec)):
        from blaze_tpu_torch.ops.joins import JoinType

        left, right = op.children
        n_l = len(left.schema)
        semi = op.join_type in (
            JoinType.LEFT_SEMI, JoinType.LEFT_ANTI,
            JoinType.LEFT_ANTI_NULL_AWARE,
        )  # semi/anti: output is the left side only
        if req is None:
            lr: Optional[Set[int]] = None
            rr: Optional[Set[int]] = None
        elif semi:
            lr = set(req) | set(op.left_keys)
            rr = set(op.right_keys)
        else:
            lr = {i for i in req if i < n_l} | set(op.left_keys)
            rr = {i - n_l for i in req if i >= n_l} | set(op.right_keys)
        _walk(left, lr, acc)
        _walk(right, rr, acc)
        return
    if isinstance(op, WindowExec):
        _walk_window(op, req, acc)
        return
    # unknown operator: conservative - children fully required
    for c in getattr(op, "children", []):
        _walk(c, None, acc)


def _walk_window(op, req: Optional[Set[int]], acc: "_Acc") -> None:
    """A window: its outputs past the input's are its functions; it
    reads its keys and sources. A folded chain (`_fused_pipeline`)
    sits between the window's input schema and its child."""
    in_schema = op._in_schema
    n_in = len(in_schema)
    need = (
        set(range(n_in)) if req is None
        else {i for i in req if i < n_in}
    )
    for e in op.partition_by:
        need |= expr_cols(e, in_schema)
    for k in op.order_by:
        need |= expr_cols(k.expr, in_schema)
    for f in op.functions:
        if f.source is not None:
            need |= expr_cols(f.source, in_schema)
    if op._fused_pipeline is not None:
        _walk_fused(op._fused_pipeline, need, acc)
    else:
        _walk(op.children[0], need, acc)


def _walk_fused(op, req: Optional[Set[int]], acc: "_Acc") -> None:
    """FusedPipelineExec / FusedAggregateExec: replay the stage chain
    in reverse to push requirements down to the fused leaf; collect
    pushable filters from the leading Filter stages (whose input schema
    is still the leaf's - Filter and Rename preserve positions)."""
    from blaze_tpu_torch.ops.filter import FilterExec
    from blaze_tpu_torch.ops.fused import FusedAggregateExec
    from blaze_tpu_torch.ops.parquet_scan import ParquetScanExec
    from blaze_tpu_torch.ops.project import ProjectExec
    from blaze_tpu_torch.ops.rename import RenameColumnsExec

    if isinstance(op, FusedAggregateExec):
        pipeline = op.pipeline
        agg = op.agg
        need: Optional[Set[int]] = set()
        pipe_schema = pipeline.schema
        for e, _ in agg.keys:
            need |= expr_cols(e, pipe_schema)
        for a, _ in agg.aggs:
            need |= expr_cols(a, pipe_schema)
        if agg.mode.name == "FINAL":
            need = None  # states located positionally: all required
    else:
        pipeline = op
        need = None if req is None else set(req)

    leaf = pipeline.children[0]
    stages = pipeline.stages
    for st in reversed(stages):
        child_schema = st.children[0].schema
        if isinstance(st, ProjectExec):
            idxs = range(len(st.exprs)) if need is None else sorted(need)
            nxt: Set[int] = set()
            for i in idxs:
                nxt |= expr_cols(st.exprs[i][0], child_schema)
            need = nxt
        elif isinstance(st, FilterExec):
            if need is not None:
                need |= expr_cols(st.predicate, child_schema)
        elif isinstance(st, RenameColumnsExec):
            pass  # positions preserved
        else:
            need = None
            break

    if isinstance(leaf, ParquetScanExec):
        preds = []
        for st in stages:
            if isinstance(st, FilterExec):
                preds.append(st.predicate)
            elif isinstance(st, RenameColumnsExec):
                continue
            else:
                break
        acc.record_scan(leaf, need, _scan_filters(preds, leaf.schema))
    else:
        _walk(leaf, need, acc)


def _scan_filters(predicates: Sequence[ir.Expr], schema: Schema
                  ) -> List[Tuple[str, ir.Op, object]]:
    out = []
    for p in predicates:
        for c in split_conjuncts(p):
            t = pushable_conjunct(c, schema)
            if t is not None:
                out.append(t)
    return out


# ---------------------------------------------------------------------------
# accumulation + installation
# ---------------------------------------------------------------------------

class _Acc:
    def __init__(self):
        self.required: Dict[int, Optional[Set[int]]] = {}
        self.filters: Dict[int, List] = {}
        self.scans: Dict[int, object] = {}

    def record_scan(self, scan, req: Optional[Set[int]],
                    filters: List) -> None:
        sid = id(scan)
        self.scans[sid] = scan
        if sid in self.required:
            prev = self.required[sid]
            self.required[sid] = (
                None if (prev is None or req is None) else prev | req
            )
        else:
            self.required[sid] = None if req is None else set(req)
        prev_f = self.filters.get(sid)
        if prev_f is None:
            self.filters[sid] = list(filters)
        elif prev_f != list(filters):
            # same scan object reached through two different filter
            # contexts: pushing either filter would drop the other
            # branch's rows
            self.filters[sid] = []


import threading

_INSTALL_LOCK = threading.Lock()


def install(root, with_filters: bool = False) -> None:
    """Attach pruning/pushdown hints to every ParquetScanExec in `root`.

    Required-column hints only ever GROW on a scan instance (union with
    anything previously installed, under a lock - scheduler threads
    install concurrently), so a scan shared across plans stays correct -
    stale entries just prune less. Filter hints are attached only with
    `with_filters=True`, which callers must reserve for trees whose
    scans are not shared with any other live plan (the per-task decode
    path)."""
    if getattr(root, "_colprune_installed", False) and not with_filters:
        return  # hints never shrink; this tree was already analyzed
    acc = _Acc()
    _walk(root, None, acc)
    try:
        root._colprune_installed = True
    except Exception:
        pass  # exotic roots without attribute support just re-walk
    with _INSTALL_LOCK:
        for sid, scan in acc.scans.items():
            req = acc.required[sid]
            if not hasattr(scan, "_hint_required"):
                scan._hint_required = (
                    None if req is None else frozenset(req)
                )
            elif scan._hint_required is None or req is None:
                scan._hint_required = None
            else:
                scan._hint_required = frozenset(
                    scan._hint_required | req
                )
            if with_filters:
                scan._hint_filters = tuple(acc.filters.get(sid, []))
