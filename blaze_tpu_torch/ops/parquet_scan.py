"""Parquet scan: host decode -> device columns.

Reference counterpart: DataFusion ParquetExec with pruning predicate,
driven by per-partition FileGroups (from_proto.rs:202-212; Spark side
NativeParquetScanExec.scala:61-107 builds the groups/projection/filters).

Parquet decode is host work (pyarrow's C++ reader) producing record
batches of `batch_size` rows, each padded and packed on the host into a
pinned staging buffer and copied to the device in one transfer
(batch.PackedColumnBatch, runtime/pack.py). A string column's int32
codes travel inside that copy; its dictionary, encoded per batch (so
each row group and file has its own), stays on the host beside it.
Decode and copy run on a prefetch thread (runtime/prefetch.py) ahead of
the device compute. Row-group pruning evaluates the pruning predicate
against row-group statistics before any IO, and byte ranges in a
FileRange select row groups the way Spark's splits do.

The planner's hints (planner/colprune.py, installed by the executor)
narrow the read: a column no ancestor reads is neither decoded nor
copied (a shared zero placeholder keeps its schema position), and the
`col <cmp> literal` conjuncts pushed from the filter above the scan
skip row groups by their statistics and, with
`EngineConfig.host_filter_pushdown`, drop rows on the host before the
copy (`_apply_host_filters`). The device filter still applies the
whole predicate. Both
keep Spark's order, where NaN is above every value: a NaN row passes a
pushed `>` or `>=`, and float statistics never prove that no row
passes one (parquet's min and max leave NaN out).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Sequence

from blaze_tpu_torch.types import Schema, TypeId, from_arrow_schema
from blaze_tpu_torch.batch import ColumnBatch, PackedColumnBatch
from blaze_tpu_torch.exprs import ir
from blaze_tpu_torch.obs import trace as obs_trace
from blaze_tpu_torch.ops.base import ExecContext, PhysicalOp
from blaze_tpu_torch.testing import chaos


@dataclasses.dataclass(frozen=True)
class FileRange:
    path: str
    start: int = 0
    length: int = 0  # 0 = whole file


class ParquetScanExec(PhysicalOp):
    _FINGERPRINT_STABLE = True

    def _fingerprint_params(self) -> str:
        # content identity = file ranges + projection + pruning
        # predicate (file content changes under one path are the result
        # cache's TTL to cover, as in the JAX package)
        groups = "|".join(
            ",".join(f"{fr.path}:{fr.start}:{fr.length}" for fr in g)
            for g in self.file_groups
        )
        proj = ",".join(self.projection) if self.projection else "*"
        return f"{groups};proj={proj};prune={self.pruning_predicate!r}"

    def __init__(
        self,
        file_groups: Sequence[Sequence[FileRange]],
        schema: Optional[Schema] = None,
        projection: Optional[Sequence[str]] = None,
        pruning_predicate: Optional[ir.Expr] = None,
    ):
        import pyarrow.parquet as pq

        self.children = []
        self.file_groups = [list(g) for g in file_groups]
        self.projection = list(projection) if projection else None
        self.pruning_predicate = pruning_predicate
        if schema is None:
            from blaze_tpu_torch.io.object_store import store_for

            first = self.file_groups[0][0].path
            aschema = pq.read_schema(store_for(first).open_input(first))
            if self.projection:
                import pyarrow as pa

                aschema = pa.schema(
                    [aschema.field(n) for n in self.projection]
                )
            schema = from_arrow_schema(aschema)
        elif self.projection and list(schema.names()) != self.projection:
            # index-bound pruning-predicate columns were bound against
            # the FULL file schema; rewrite them to name references
            # before the schema narrows
            if pruning_predicate is not None:
                full = schema
                self.pruning_predicate = ir.transform(
                    pruning_predicate,
                    lambda e: ir.Col(full.fields[e.index].name)
                    if isinstance(e, ir.BoundCol)
                    else e,
                )
            # the operator's schema is the PROJECTED one
            # (NativeParquetScanExec.scala:105-107)
            schema = Schema(
                [
                    schema.fields[schema.index_of(n)]
                    for n in self.projection
                ]
            )
        self._schema = schema

    @property
    def schema(self) -> Schema:
        return self._schema

    @property
    def partition_count(self) -> int:
        return len(self.file_groups)

    def execute(self, partition: int, ctx: ExecContext
                ) -> Iterator[ColumnBatch]:
        import pyarrow.parquet as pq

        from blaze_tpu_torch.io.object_store import store_for
        from blaze_tpu_torch.runtime.pack import Staging
        from blaze_tpu_torch.runtime.prefetch import prefetch

        import pyarrow as pa

        cfg = ctx.config
        cols = self.projection or [f.name for f in self._schema]
        staging = Staging() if ctx.device.type == "cuda" else None
        filters = list(getattr(self, "_hint_filters", ()) or ())
        row_filters = filters if cfg.host_filter_pushdown else []
        read_names, keep_names, present = self._read_plan(cols,
                                                          row_filters)
        ctx.metrics.add("columns_decoded", len(read_names))
        ctx.metrics.add("columns_in_schema", len(cols))

        def decode() -> Iterator[ColumnBatch]:
            for fr in self.file_groups[partition]:
                # obs seam: one span a file range (open, row-group
                # selection and the batch iteration); rec= explicitly,
                # since the prefetch thread drains this generator
                span_cm = (
                    obs_trace.span("parquet_decode", rec=ctx.tracer,
                                   partition=partition, path=fr.path)
                    if obs_trace.ACTIVE else obs_trace.NULL
                )
                with span_cm:
                    yield from decode_range(fr)

        def decode_range(fr) -> Iterator[ColumnBatch]:
            if chaos.ACTIVE:
                # chaos seam: parquet decode / object-store read failure
                # for this file range (inside the span)
                chaos.fire("parquet.decode", partition=partition,
                           path=fr.path)
            pf = pq.ParquetFile(store_for(fr.path).open_input(fr.path))
            groups = self._select_row_groups(pf, fr, filters)
            if groups:
                yield from batches(pf, groups)

        def batches(pf, groups) -> Iterator[ColumnBatch]:
            for rb in pf.iter_batches(
                batch_size=cfg.batch_size, row_groups=groups,
                columns=read_names, use_threads=True,
            ):
                ctx.metrics.add("input_rows", rb.num_rows)
                ctx.metrics.add("input_batches", 1)
                if row_filters:
                    before = rb.num_rows
                    rb = _apply_host_filters(rb, row_filters)
                    ctx.metrics.add("pushdown_filtered_rows",
                                    before - rb.num_rows)
                if rb.num_rows == 0:
                    continue
                if present is None:
                    yield PackedColumnBatch.from_arrow(
                        rb, device=ctx.device, staging=staging)
                    continue
                sub = pa.record_batch([rb.column(c) for c in keep_names],
                                      names=keep_names)
                yield PackedColumnBatch.from_arrow_pruned(
                    sub, self._schema, present, device=ctx.device,
                    staging=staging)

        # overlap parquet decode + H2D with downstream device compute
        yield from prefetch(decode(), depth=2)

    # ------------------------------------------------------------------
    def _read_plan(self, cols: List[str], filters=()):
        """(columns to decode, columns to keep, their schema positions or
        None for all) under the colprune hints: the required columns and
        those a pushed conjunct in `filters` reads; with none required
        (COUNT(*)), the cheapest column, for its row count."""
        required = getattr(self, "_hint_required", None)
        if required is None:
            return cols, cols, None
        req_names = {cols[i] for i in required if i < len(cols)}
        filt_names = {name for name, _, _ in filters}
        read_names = [c for c in cols if c in req_names or c in filt_names]
        if not read_names:
            def decode_cost(c):
                dt = self._schema.fields[self._schema.index_of(c)].dtype
                penalty = 100 if dt.is_dictionary_encoded else 0
                return penalty + dt.physical_dtype().itemsize

            read_names = [min(cols, key=decode_cost)]
        keep_names = [c for c in cols if c in req_names] or read_names[:1]
        if keep_names == cols and read_names == cols:
            return cols, cols, None
        return read_names, keep_names, [cols.index(c) for c in keep_names]

    def _select_row_groups(self, pf, fr: FileRange,
                           filters=()) -> List[int]:
        """Row groups whose byte midpoint falls in the split range (Spark's
        split ownership rule) and that survive stats pruning (the pruning
        predicate and the pushed conjuncts)."""
        md = pf.metadata
        out = []
        for i in range(md.num_row_groups):
            rg = md.row_group(i)
            if fr.length > 0:
                mid = row_group_midpoint(rg)
                if not (fr.start <= mid < fr.start + fr.length):
                    continue
            if self.pruning_predicate is not None and not _may_match(
                self.pruning_predicate, rg, self._schema
            ):
                continue
            if any(not _minmax_may_match(_rg_stats(name, rg), op, value)
                   for name, op, value in filters):
                continue
            out.append(i)
        return out


def row_group_midpoint(rg) -> int:
    """The byte midpoint of a row group in its file, which decides the
    split that owns it (Spark's rule): its first page (the dictionary
    page where a column has one) plus half of its compressed bytes. A
    column chunk's `file_offset` is no position (pyarrow's writer leaves
    it 0), and `total_byte_size` counts uncompressed bytes: the JAX
    package's rule on those two gives every row group to the first
    split."""
    cols = [rg.column(i) for i in range(rg.num_columns)]
    start = min(c.dictionary_page_offset if c.has_dictionary_page
                else c.data_page_offset for c in cols)
    return start + sum(c.total_compressed_size for c in cols) // 2


def _apply_host_filters(rb, filters):
    """The pushed `(name, cmp, literal)` conjuncts, with pyarrow compute,
    before any padding or copy. A NULL comparison drops the row, as the
    device mask does; a NaN passes `>` and `>=` (Spark's order, which
    the device filter keeps; pyarrow's comparison alone would drop it).
    A conjunct pyarrow cannot evaluate is skipped: the device filter
    re-applies the whole predicate."""
    import pyarrow as pa
    import pyarrow.compute as pc

    fns = {
        ir.Op.LT: pc.less, ir.Op.LTE: pc.less_equal,
        ir.Op.GT: pc.greater, ir.Op.GTE: pc.greater_equal,
        ir.Op.EQ: pc.equal, ir.Op.NEQ: pc.not_equal,
    }
    mask = None
    for name, op, value in filters:
        col = rb.column(name)
        try:
            m = fns[op](col, value)
        except (pa.ArrowException, TypeError):
            continue
        if op in (ir.Op.GT, ir.Op.GTE) and pa.types.is_floating(col.type):
            m = pc.or_(m, pc.is_nan(col))
        mask = m if mask is None else pc.and_(mask, m)
    if mask is None:
        return rb
    return rb.filter(mask)


def _rg_stats(name: str, rg):
    for ci in range(rg.num_columns):
        c = rg.column(ci)
        if c.path_in_schema == name:
            return c.statistics
    return None


def _minmax_may_match(stats, op: ir.Op, value) -> bool:
    """False only when the row group's min/max prove that no row passes
    the comparison."""
    if stats is None or not stats.has_min_max:
        return True
    if op in (ir.Op.GT, ir.Op.GTE) and stats.physical_type in ("FLOAT",
                                                               "DOUBLE"):
        return True  # min/max leave NaN out, and NaN passes (Spark)
    lo, hi = stats.min, stats.max
    try:
        if op is ir.Op.EQ:
            return lo <= value <= hi
        if op is ir.Op.LT:
            return lo < value
        if op is ir.Op.LTE:
            return lo <= value
        if op is ir.Op.GT:
            return hi > value
        if op is ir.Op.GTE:
            return hi >= value
    except TypeError:
        return True
    return True


def _may_match(pred: ir.Expr, rg, schema: Schema) -> bool:
    """Conservative stats-based pruning: False only when the predicate
    provably rejects the whole row group. Handles comparisons between a
    column and a literal plus AND/OR composition (the reference gets the
    equivalent from DataFusion's PruningPredicate)."""
    from blaze_tpu_torch.exprs.ir import BinaryOp, Col, BoundCol, Literal, Op

    if isinstance(pred, BinaryOp) and pred.op in (Op.AND, Op.OR):
        left = _may_match(pred.left, rg, schema)
        right = _may_match(pred.right, rg, schema)
        return (left and right) if pred.op is Op.AND else (left or right)
    if not isinstance(pred, BinaryOp):
        return True
    col, lit, op = None, None, pred.op
    flip = {Op.LT: Op.GT, Op.GT: Op.LT, Op.LTE: Op.GTE, Op.GTE: Op.LTE}
    if isinstance(pred.left, (Col, BoundCol)) and isinstance(
        pred.right, Literal
    ):
        col, lit = pred.left, pred.right
    elif isinstance(pred.right, (Col, BoundCol)) and isinstance(
        pred.left, Literal
    ):
        col, lit = pred.right, pred.left
        op = flip.get(op, op)
    if col is None or lit.value is None:
        return True
    name = col.name if isinstance(col, Col) else schema.fields[col.index].name
    return _minmax_may_match(_rg_stats(name, rg), op, _stats_value(lit))


def _stats_value(lit) -> object:
    """A literal as parquet statistics hold its column's values: a
    decimal literal's unscaled int becomes the Decimal it stands for
    (decimal statistics are Decimals; compared with the unscaled int,
    50.00 would read as 5000). The JAX package compares the unscaled
    int and prunes row groups that match."""
    if lit.dtype is None or lit.dtype.id is not TypeId.DECIMAL:
        return lit.value
    import decimal

    with decimal.localcontext() as ctx:
        ctx.prec = 80
        return decimal.Decimal(int(lit.value)).scaleb(-lit.dtype.scale)
