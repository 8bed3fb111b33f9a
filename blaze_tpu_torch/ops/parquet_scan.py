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
FileRange select row groups the way Spark's splits do. Column pruning
and host filter pushdown (planner/colprune in the JAX package) wait
for ROADMAP 'Modules to port' item 2: every column of the scan's
schema is read and the filter runs on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Sequence

from blaze_tpu_torch.types import Schema, TypeId, from_arrow_schema
from blaze_tpu_torch.batch import ColumnBatch, PackedColumnBatch
from blaze_tpu_torch.exprs import ir
from blaze_tpu_torch.ops.base import ExecContext, PhysicalOp


@dataclasses.dataclass(frozen=True)
class FileRange:
    path: str
    start: int = 0
    length: int = 0  # 0 = whole file


class ParquetScanExec(PhysicalOp):
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

        cfg = ctx.config
        cols = self.projection or [f.name for f in self._schema]
        staging = Staging() if ctx.device.type == "cuda" else None

        def decode() -> Iterator[ColumnBatch]:
            for fr in self.file_groups[partition]:
                pf = pq.ParquetFile(store_for(fr.path).open_input(fr.path))
                groups = self._select_row_groups(pf, fr)
                if not groups:
                    continue
                for rb in pf.iter_batches(
                    batch_size=cfg.batch_size, row_groups=groups,
                    columns=cols, use_threads=True,
                ):
                    ctx.metrics.add("input_rows", rb.num_rows)
                    ctx.metrics.add("input_batches", 1)
                    if rb.num_rows == 0:
                        continue
                    yield PackedColumnBatch.from_arrow(
                        rb, device=ctx.device, staging=staging)

        # overlap parquet decode + H2D with downstream device compute
        yield from prefetch(decode(), depth=2)

    # ------------------------------------------------------------------
    def _select_row_groups(self, pf, fr: FileRange) -> List[int]:
        """Row groups whose byte midpoint falls in the split range (Spark's
        split ownership rule) and that survive stats pruning."""
        md = pf.metadata
        out = []
        for i in range(md.num_row_groups):
            rg = md.row_group(i)
            if fr.length > 0:
                start = rg.column(0).file_offset
                mid = start + rg.total_byte_size // 2
                if not (fr.start <= mid < fr.start + fr.length):
                    continue
            if self.pruning_predicate is not None and not _may_match(
                self.pruning_predicate, rg, self._schema
            ):
                continue
            out.append(i)
        return out


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
