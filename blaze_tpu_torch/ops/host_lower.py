"""Split expression trees at the string-type boundary.

A port of the JAX package's ops/host_lower.py. `lower_strings_host(exprs,
batch)` rewrites each bound expression so that any node with a direct
string-typed input is evaluated on the host (pyarrow,
exprs/host_eval.py) and replaced by a reference to a new column
appended to an augmented batch. Device code then never sees string
semantics: int32 codes pass through untouched, and host-computed
bool/int/string columns come back in.

A hoisted node is evaluated one of two ways, with the same result:

- over the dictionary, when the node reads exactly one column, a string
  column (`s = 'TN'`, `substring(s, 1, 5)`, `s LIKE 'a%'`): the node is
  evaluated once per dictionary entry and once for a NULL input (a NULL
  row is not a dictionary entry), and the card gathers each row's
  result by its code - no row leaves the card. Counted as
  `dispatch.host_lower_dictionary`;
- over the rows, otherwise: the batch's live prefix is decoded (one D2H
  fetch, counted by `d2h_fetches` on the card), evaluated row by row in
  pyarrow and copied back. Counted as `dispatch.host_lower_rows`.

A projected string constant becomes a one-entry dictionary column with
every code 0 (no host work).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import pyarrow as pa
import torch

from blaze_tpu_torch.batch import (
    Column,
    ColumnBatch,
    _h2d,
    host_columns,
    string_value_type,
)
from blaze_tpu_torch.exprs import ir
from blaze_tpu_torch.exprs.host_eval import HostEvaluator
from blaze_tpu_torch.exprs.typing import infer_dtype
from blaze_tpu_torch.runtime import dispatch
from blaze_tpu_torch.types import Field, Schema, from_arrow_type


def _positional_arrays(cb: ColumnBatch) -> List[pa.Array]:
    """Arrow arrays of the first num_rows rows, selection ignored (row i
    must stay row i of the device buffers)."""
    rb = ColumnBatch(cb.schema, cb.columns, cb.num_rows, None).to_arrow()
    return [rb.column(i) for i in range(rb.num_columns)]


def _refs(e: ir.Expr) -> set:
    if isinstance(e, ir.BoundCol):
        return {e.index}
    out: set = set()
    for c in ir.children(e):
        out |= _refs(c)
    return out


def _table_gather(table: np.ndarray, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] on idx's device (idx already in range)."""
    return torch.index_select(_h2d(np.ascontiguousarray(table),
                                   idx.device), 0, idx)


class _Lowerer:
    def __init__(self, cb: ColumnBatch):
        self.cb = cb
        self.schema = cb.schema
        self.new_fields: List[Field] = []
        self.new_columns: List[Column] = []
        self._arrays: Optional[List[pa.Array]] = None
        self._cache: Dict[str, ir.Expr] = {}

    def aug_schema(self) -> Schema:
        return Schema(list(self.schema.fields) + self.new_fields)

    def columns(self) -> List[Column]:
        return list(self.cb.columns) + self.new_columns

    def arrays(self) -> List[pa.Array]:
        if self._arrays is None:
            self._arrays = _positional_arrays(ColumnBatch(
                self.aug_schema(), self.columns(), self.cb.num_rows))
        return self._arrays

    def lower(self, e: ir.Expr, root: bool = False) -> ir.Expr:
        if isinstance(e, ir.Literal):
            if root and e.dtype is not None and e.dtype.is_string_like:
                # a PROJECTED string constant: a one-entry dictionary
                # column. Literals inside expressions stay: their parent
                # is host-evaluated and reads them natively
                return self._hoist_literal(e)
            return e
        e = ir.with_children(e, [self.lower(c) for c in ir.children(e)])
        if isinstance(e, ir.BoundCol):
            return e
        if _hoisted_here(e, self.aug_schema()):
            return self._hoist(e)
        return e

    def _append(self, dt, col: Column, arr: Optional[pa.Array]) -> ir.Expr:
        idx = len(self.schema) + len(self.new_fields)
        self.new_fields.append(Field(f"__host_{idx}", dt, True))
        self.new_columns.append(col)
        if self._arrays is not None:
            if arr is None:
                self._arrays = None  # decoded again when next needed
            else:
                self._arrays = self._arrays + [arr]
        return ir.BoundCol(idx, dt)

    def _hoist_literal(self, e: ir.Literal) -> ir.Expr:
        key = repr(e)
        if key not in self._cache:
            cap, dev = self.cb.capacity, self.cb.device
            typ = string_value_type(e.dtype)
            codes = torch.zeros(cap, dtype=torch.int32, device=dev)
            if e.value is None:
                col = Column(e.dtype, codes,
                             torch.zeros(cap, dtype=torch.bool, device=dev),
                             pa.array([], type=typ))
            else:
                col = Column(e.dtype, codes, None,
                             pa.array([e.value], type=typ))
            arr = pa.array([e.value] * self.cb.num_rows, type=typ)
            self._cache[key] = self._append(e.dtype, col, arr)
        return self._cache[key]

    def _hoist(self, e: ir.Expr) -> ir.Expr:
        key = repr(e)
        if key not in self._cache:
            refs = _refs(e)
            cols = self.columns()
            if len(refs) == 1 and self.aug_schema().fields[
                    next(iter(refs))].dtype.is_string_like \
                    and cols[next(iter(refs))].dictionary is not None:
                dt, col, arr = self._over_dictionary(e, next(iter(refs)))
            else:
                dt, col, arr = self._over_rows(e)
            self._cache[key] = self._append(dt, col, arr)
        return self._cache[key]

    def _over_rows(self, e: ir.Expr):
        dispatch.record("host_lower_rows")
        arr = _typed(e, self.aug_schema(), HostEvaluator(
            self.aug_schema(), self.arrays()).evaluate(e))
        dt = from_arrow_type(arr.type)
        tmp = ColumnBatch.from_arrow(
            pa.RecordBatch.from_arrays([arr], names=["x"]),
            capacity=self.cb.capacity, device=self.cb.device)
        return dt, tmp.columns[0], arr

    def _over_dictionary(self, e: ir.Expr, ci: int):
        """Evaluate `e` over the column's dictionary plus one NULL entry,
        then gather each row's result by its code on the card."""
        dispatch.record("host_lower_dictionary")
        src = self.columns()[ci]
        d = src.dictionary.cast(string_value_type(src.dtype))
        nd = len(d)
        domain = pa.concat_arrays([d, pa.nulls(1, type=d.type)])
        # the other positions are never read (the node reads column ci)
        arrays = [pa.nulls(nd + 1)] * len(self.aug_schema())
        arrays[ci] = domain
        out = _typed(e, self.aug_schema(),
                     HostEvaluator(self.aug_schema(), arrays).evaluate(e))
        dt = from_arrow_type(out.type)
        # each row's dictionary slot, NULL rows at the extra entry
        slot = src.values.to(torch.int64).clamp(0, max(nd - 1, 0))
        if src.validity is not None:
            slot = torch.where(src.validity, slot,
                               torch.full_like(slot, nd))
        _, [(vals, valid, dictionary)] = host_columns(
            pa.RecordBatch.from_arrays([out], names=["x"]))
        values = _table_gather(vals, slot)
        validity = None if valid is None else _table_gather(valid, slot)
        return dt, Column(dt, values, validity, dictionary), None


def _typed(e: ir.Expr, schema: Schema, arr) -> pa.Array:
    """A host result as one array; an all-NULL result of Arrow's null
    type takes the node's own type."""
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    if pa.types.is_null(arr.type):
        from blaze_tpu_torch.types import to_arrow_type

        arr = pa.nulls(len(arr), type=to_arrow_type(infer_dtype(e, schema)))
    return arr


def lower_strings_host(
    exprs: Sequence[ir.Expr], cb: ColumnBatch
) -> Tuple[List[ir.Expr], int, ColumnBatch]:
    """(rewritten exprs, number of new columns, augmented batch)."""
    lw = _Lowerer(cb)
    out = [lw.lower(e, root=True) for e in exprs]
    if not lw.new_columns:
        return list(out), 0, cb
    aug = ColumnBatch(lw.aug_schema(), lw.columns(), cb.num_rows,
                      cb.selection)
    return list(out), len(lw.new_columns), aug


def needs_host(e: ir.Expr, schema: Schema) -> bool:
    """True when lowering would hoist a node of `e`: a non-passthrough
    node with a string input, or a projected string constant."""
    if isinstance(e, ir.Literal):
        return e.dtype is not None and e.dtype.is_string_like
    return _needs_host(e, schema)


def _hoisted_here(e: ir.Expr, schema: Schema) -> bool:
    """A node the host evaluates: one with a string input, or a cast to
    a string (a device cannot make strings)."""
    if isinstance(e, ir.Cast) and e.to.is_string_like:
        return True
    return any(infer_dtype(c, schema).is_string_like
               for c in ir.children(e))


def _needs_host(e: ir.Expr, schema: Schema) -> bool:
    if isinstance(e, (ir.BoundCol, ir.Col, ir.Literal)):
        return False
    return _hoisted_here(e, schema) or any(
        _needs_host(c, schema) for c in ir.children(e))
