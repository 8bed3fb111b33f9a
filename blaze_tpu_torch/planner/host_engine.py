"""Host fallback engine: executes PlanSpec subtrees in pandas.

The role the JVM row-based execution plays for the reference: any node the
convert strategy rejects (disabled op, unsupported expression, Window, ...)
runs here, and `HostFallbackExec` bridges the result back into device
batches - the ConvertToNative analog (ConvertToNativeExec.scala:61-95);
the reverse bridge (native subtree consumed by a host node) is a plain
`to_arrow()/to_pandas()` - the ConvertToUnsafeRow analog
(ConvertToUnsafeRowExec.scala:50-90).

The JAX package's planner/host_engine.py on the port: a planned host
node's batches re-enter the native tier on the consuming task's
device (`ctx.device`), never on the CPU by default."""

from __future__ import annotations

from typing import Iterator, List, Optional

import numpy as np
import pandas as pd
import pyarrow as pa

from blaze_tpu_torch.types import Schema, from_arrow_schema
from blaze_tpu_torch.batch import ColumnBatch
from blaze_tpu_torch.exprs import ir
from blaze_tpu_torch.exprs.host_eval import HostEvaluator
from blaze_tpu_torch.exprs.ir import AggFn
from blaze_tpu_torch.ops.base import ExecContext, PhysicalOp
from blaze_tpu_torch.planner import spec as S


def _eval_expr_pd(df: pd.DataFrame, e: ir.Expr) -> pa.Array:
    rb = pa.RecordBatch.from_pandas(df, preserve_index=False)
    schema = from_arrow_schema(rb.schema)
    bound = ir.bind(e, schema)
    ev = HostEvaluator(schema, [rb.column(i) for i in range(rb.num_columns)])
    out = ev.evaluate(bound)
    if isinstance(out, pa.ChunkedArray):
        out = out.combine_chunks()
    return out


_PD_AGG = {
    AggFn.SUM: "sum",
    AggFn.MIN: "min",
    AggFn.MAX: "max",
    AggFn.AVG: "mean",
    AggFn.COUNT: "count",
    AggFn.COUNT_STAR: "size",
    AggFn.VAR_SAMP: "var",
    AggFn.STDDEV_SAMP: "std",
    AggFn.FIRST: "first",
    AggFn.LAST: "last",
}


def execute_host(node: S.PlanSpec) -> pd.DataFrame:
    """Interpret a PlanSpec subtree in pandas."""
    if isinstance(node, S.MemorySpec):
        return node.dataframe.copy()
    if isinstance(node, S.ScanSpec):
        frames = [_read_range(fr, node.projection)
                  for group in node.file_groups for fr in group]
        df = pd.concat(frames, ignore_index=True)
        if node.predicate is not None:
            mask = _eval_expr_pd(df, node.predicate).to_pandas()
            df = df[mask.fillna(False).to_numpy(dtype=bool)]
        return df.reset_index(drop=True)
    if isinstance(node, S.ProjectSpec):
        df = execute_host(node.children[0])
        out = {}
        for e, name in node.exprs:
            out[name] = _eval_expr_pd(df, e).to_pandas()
        return pd.DataFrame(out)
    if isinstance(node, S.FilterSpec):
        df = execute_host(node.children[0])
        mask = _eval_expr_pd(df, node.predicate).to_pandas()
        return df[mask.fillna(False).to_numpy(dtype=bool)].reset_index(
            drop=True
        )
    if isinstance(node, S.SortSpec):
        df = execute_host(node.children[0])
        cols, ascs, poss = [], [], []
        tmp = df.copy()
        for i, (e, asc, nf) in enumerate(node.keys):
            cname = f"__sk{i}"
            tmp[cname] = _eval_expr_pd(df, e).to_pandas()
            cols.append(cname)
            ascs.append(asc)
            poss.append("first" if nf else "last")
        tmp = tmp.sort_values(
            cols, ascending=ascs, kind="stable",
            na_position=poss[0] if poss else "first",
        ).drop(columns=cols)
        if node.fetch:
            tmp = tmp.head(node.fetch)
        return tmp.reset_index(drop=True)
    if isinstance(node, S.UnionSpec):
        return pd.concat(
            [execute_host(c) for c in node.children], ignore_index=True
        )
    if isinstance(node, S.LimitSpec):
        return execute_host(node.children[0]).head(node.limit).reset_index(
            drop=True
        )
    if isinstance(node, S.AggSpec):
        df = execute_host(node.children[0])
        key_names = []
        tmp = pd.DataFrame(index=df.index)
        for e, name in node.keys:
            tmp[name] = _eval_expr_pd(df, e).to_pandas()
            key_names.append(name)
        agg_cols = {}
        for i, (a, name) in enumerate(node.aggs):
            if a.child is not None:
                tmp[f"__a{i}"] = _eval_expr_pd(df, a.child).to_pandas()
            else:
                tmp[f"__a{i}"] = 1
        if key_names:
            g = tmp.groupby(key_names, dropna=False, sort=False)
            out = pd.DataFrame()
            parts = {}
            for i, (a, name) in enumerate(node.aggs):
                fn = _PD_AGG[a.fn]
                col = g[f"__a{i}"]
                parts[name] = getattr(col, fn)() if fn != "size" \
                    else col.size()
            out = pd.DataFrame(parts).reset_index()
            return out
        parts = {}
        for i, (a, name) in enumerate(node.aggs):
            fn = _PD_AGG[a.fn]
            col = tmp[f"__a{i}"]
            parts[name] = [
                getattr(col, fn)() if fn != "size" else len(col)
            ]
        return pd.DataFrame(parts)
    if isinstance(node, S.JoinSpec):
        l = execute_host(node.children[0])
        r = execute_host(node.children[1])
        how = {
            "inner": "inner", "left": "left", "right": "right",
            "full": "outer",
        }.get(node.join_type)
        if how is None:
            lk = list(node.left_keys)
            rk = list(node.right_keys)
            matched = l.merge(
                r[rk].drop_duplicates(), left_on=lk, right_on=rk,
                how="inner",
            )[l.columns]
            if node.join_type == "left_semi":
                out = matched.drop_duplicates()
            elif node.join_type == "left_anti_null_aware":
                if r[rk].isna().any().any():
                    out = l.iloc[0:0]  # any build NULL -> empty (NOT IN)
                else:
                    key = l[lk].apply(tuple, axis=1)
                    mkey = set(matched[lk].apply(tuple, axis=1))
                    out = l[~key.isin(mkey) & l[lk].notna().all(axis=1)]
            else:  # left_anti
                key = l[lk].apply(tuple, axis=1)
                mkey = set(matched[lk].apply(tuple, axis=1))
                out = l[~key.isin(mkey)]
            df = out.reset_index(drop=True)
        else:
            df = l.merge(
                r, left_on=list(node.left_keys),
                right_on=list(node.right_keys), how=how,
            )
        if node.condition is not None:
            mask = _eval_expr_pd(df, node.condition).to_pandas()
            df = df[mask.fillna(False).to_numpy(dtype=bool)]
        return df.reset_index(drop=True)
    if isinstance(node, S.ExchangeSpec):
        # partitioning is a no-op for the single-frame host engine
        return execute_host(node.children[0])
    if isinstance(node, S.WindowSpec):
        return _execute_window(node)
    raise NotImplementedError(type(node))


def _read_range(fr, projection) -> pd.DataFrame:
    """A FileRange (or a path) as a frame: a byte range holds the row
    groups whose midpoint falls in it, the native scan's split rule
    (ops/parquet_scan.py), so splits of one file read each row once.
    (The JAX package's host engine reads the whole file per range.)"""
    import pyarrow.parquet as pq

    from blaze_tpu_torch.ops.parquet_scan import row_group_midpoint

    path = fr.path if hasattr(fr, "path") else fr
    columns = list(projection) if projection else None
    if not getattr(fr, "length", 0):
        return pq.read_table(path, columns=columns).to_pandas()
    pf = pq.ParquetFile(path)
    md = pf.metadata
    groups = []
    for i in range(md.num_row_groups):
        if fr.start <= row_group_midpoint(md.row_group(i)) \
                < fr.start + fr.length:
            groups.append(i)
    return pf.read_row_groups(groups, columns=columns).to_pandas()


def _execute_window(node: S.WindowSpec) -> pd.DataFrame:
    """Window functions stay host-tier (the reference keeps Window on the
    JVM too, inserting row barriers before it - BlazeConverters.scala:
    93-107). Supported: row_number, rank, dense_rank, lag, lead, and
    sum/min/max/avg/count over the whole partition frame."""
    df = execute_host(node.children[0])
    out = df.copy()
    pb = list(node.partition_by)
    ob = list(node.order_by)
    fn = node.function
    ordered = df.sort_values(ob, kind="stable") if ob else df

    def grouped(frame):
        return frame.groupby(pb, sort=False) if pb else None

    if fn == "row_number":
        g = grouped(ordered)
        rn = (g.cumcount() + 1) if g is not None else pd.Series(
            np.arange(1, len(ordered) + 1), index=ordered.index
        )
        out[node.output] = rn.sort_index()
        return out
    if fn in ("rank", "dense_rank"):
        method = "min" if fn == "rank" else "dense"
        key = df[ob[0]] if len(ob) == 1 else df[ob].apply(tuple, axis=1)
        if pb:
            r = key.groupby(
                [df[c] for c in pb], sort=False
            ).rank(method=method)
        else:
            r = key.rank(method=method)
        out[node.output] = r.astype(np.int64)
        return out
    if fn in ("lag", "lead"):
        shift = 1 if fn == "lag" else -1
        src = node.source or ob[0]
        g = grouped(ordered)
        s = (
            g[src].shift(shift) if g is not None
            else ordered[src].shift(shift)
        )
        out[node.output] = s.sort_index()
        return out
    if fn in ("sum", "min", "max", "mean", "avg", "count"):
        src = node.source or ob[0]
        agg = "mean" if fn == "avg" else fn
        if pb:
            s = df.groupby(pb, sort=False)[src].transform(agg)
        else:
            s = pd.Series(
                getattr(df[src], agg)(), index=df.index
            )
        out[node.output] = s
        return out
    raise NotImplementedError(fn)


# ---------------------------------------------------------------------------
# graceful degradation: native partition -> host re-execution
# ---------------------------------------------------------------------------


def op_to_spec(op: PhysicalOp,
               partition: Optional[int] = None) -> Optional[S.PlanSpec]:
    """Best-effort reverse mapping PhysicalOp -> PlanSpec so a partition
    that failed RESOURCE_EXHAUSTED on device can re-run through the
    pandas host engine (the native->Spark degradation analog,
    SURVEY 5.3). `partition` narrows leaf scans to ONE partition's
    inputs; interior ops keep their (already bound) expressions - the
    host evaluator resolves BoundCol positionally against the same
    child schema order the device tier used.

    Returns None when any node has no host equivalent (fused pipelines,
    partial/final aggregates, exchanges); the caller then re-raises the
    original device error instead of degrading."""
    from blaze_tpu_torch.ops.filter import FilterExec
    from blaze_tpu_torch.ops.hash_aggregate import AggMode, HashAggregateExec
    from blaze_tpu_torch.ops.limit import LimitExec
    from blaze_tpu_torch.ops.memory_scan import MemoryScanExec
    from blaze_tpu_torch.ops.parquet_scan import ParquetScanExec
    from blaze_tpu_torch.ops.project import ProjectExec
    from blaze_tpu_torch.ops.sort import SortExec
    from blaze_tpu_torch.ops.union import CoalescePartitionsExec, UnionExec

    if isinstance(op, HostFallbackExec):
        return op.node
    if isinstance(op, ParquetScanExec):
        groups = op.file_groups
        if partition is not None:
            if partition >= len(groups):
                # partition index does not line up with this leaf -
                # refusing beats silently un-narrowing (which would
                # duplicate every other partition's rows)
                return None
            groups = [groups[partition]]
        # the pruning predicate is an OPTIMIZATION derived from the
        # filter above the scan; dropping it is safe (the filter
        # re-applies), keeping it as a data filter would not be
        return S.ScanSpec(
            file_groups=groups, projection=op.projection,
        )
    if isinstance(op, MemoryScanExec):
        parts = op.partitions
        if partition is not None:
            if partition >= len(parts):
                return None  # see the parquet-leaf guard above
            parts = [parts[partition]]
        frames = [
            (cb if isinstance(cb, pa.RecordBatch) else cb.to_arrow()
             ).to_pandas()
            for part in parts for cb in part
        ]
        if frames:
            df = pd.concat(frames, ignore_index=True)
        else:
            from blaze_tpu_torch.types import to_arrow_schema

            df = pa.Table.from_batches(
                [], to_arrow_schema(op.schema)
            ).to_pandas()
        return S.MemorySpec(dataframe=df)
    if isinstance(op, CoalescePartitionsExec):
        # coalesce = every child partition, concatenated
        return op_to_spec(op.children[0], None)
    if isinstance(op, UnionExec):
        if partition is None:
            kids = [op_to_spec(c, None) for c in op.children]
            if any(k is None for k in kids):
                return None
            return S.UnionSpec(children=kids)
        # a union partition IS one child partition (positional append,
        # ops/union.py execute): translate the union-global index to
        # (child, local partition) and degrade just that subtree
        for child in op.children:
            n = child.partition_count
            if partition < n:
                return op_to_spec(child, partition)
            partition -= n
        return None  # index out of range: refuse
    child = (
        op_to_spec(op.children[0], partition) if op.children else None
    )
    if op.children and child is None:
        return None
    if isinstance(op, FilterExec):
        return S.FilterSpec(children=[child], predicate=op.predicate)
    if isinstance(op, ProjectExec):
        return S.ProjectSpec(children=[child], exprs=list(op.exprs))
    if isinstance(op, SortExec):
        return S.SortSpec(
            children=[child],
            keys=[(k.expr, k.ascending, k.nulls_first)
                  for k in op.keys],
            fetch=op.fetch,
        )
    if isinstance(op, LimitExec):
        return S.LimitSpec(children=[child], limit=op.limit)
    if isinstance(op, HashAggregateExec):
        if op.mode is not AggMode.COMPLETE:
            return None  # partial/final splice states positionally
        return S.AggSpec(
            children=[child], keys=list(op.keys),
            aggs=list(op.aggs), mode="complete",
        )
    return None


def execute_partition_host(op: PhysicalOp, partition: int,
                           ctx: ExecContext) -> List[pa.RecordBatch]:
    """Degradation entry: re-execute ONE partition of a native plan on
    the host engine, returning Arrow batches cast to the plan's
    schema. Raises NotImplementedError when the tree has no host
    mapping - callers treat that as 'degradation unavailable' and
    surface the original device error."""
    spec = op_to_spec(op, partition)
    if spec is None:
        raise NotImplementedError(
            f"no host mapping for {type(op).__name__} tree"
        )
    from blaze_tpu_torch.types import to_arrow_schema

    df = execute_host(spec)
    ctx.metrics.add("degraded_rows", len(df))
    target = to_arrow_schema(op.schema)
    tbl = pa.Table.from_pandas(df, preserve_index=False)
    if tbl.schema != target:
        tbl = tbl.rename_columns(target.names).cast(target)
    out = []
    for rb in tbl.to_batches(max_chunksize=ctx.config.batch_size):
        if rb.num_rows:
            ctx.metrics.add("output_rows", rb.num_rows)
            ctx.metrics.add("output_batches", 1)
            out.append(rb)
    return out


class HostFallbackExec(PhysicalOp):
    """Run a PlanSpec subtree on the host engine and re-enter the native
    tier as device batches (ConvertToNative analog)."""

    def __init__(self, node: S.PlanSpec, num_partitions: int = 1):
        self.children = []
        self.node = node
        self._n = num_partitions
        self._df: Optional[pd.DataFrame] = None
        self._schema: Optional[Schema] = None

    def _frame(self) -> pd.DataFrame:
        if self._df is None:
            self._df = execute_host(self.node)
        return self._df

    @property
    def schema(self) -> Schema:
        if self._schema is None:
            rb = pa.RecordBatch.from_pandas(
                self._frame(), preserve_index=False
            )
            self._schema = from_arrow_schema(rb.schema)
        return self._schema

    @property
    def partition_count(self) -> int:
        return self._n

    def execute(self, partition: int, ctx: ExecContext
                ) -> Iterator[ColumnBatch]:
        df = self._frame()
        n = len(df)
        per = (n + self._n - 1) // self._n if self._n else n
        lo = partition * per
        hi = min(n, lo + per)
        if hi <= lo:
            return
        rb = pa.RecordBatch.from_pandas(
            df.iloc[lo:hi], preserve_index=False
        )
        bs = ctx.config.batch_size
        for start in range(0, rb.num_rows, bs):
            yield ColumnBatch.from_arrow(
                rb.slice(start, min(bs, rb.num_rows - start)),
                device=ctx.device,
            )
