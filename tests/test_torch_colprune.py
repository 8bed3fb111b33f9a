"""The port's scan hints (planner/colprune.py, ops/parquet_scan.py)
against the JAX package's, on the CPU: each plan is built twice from one
description, once with each package's operators, and both packages'
`install` must give every scan the same required columns and the same
pushed conjuncts. Results are held against pandas and numpy oracles on
small parquet files made from seeded generators: pruned results equal
unpruned ones. The NaN rule is Spark's (NaN above every value), pinned
against a numpy oracle of Spark's order, not against the JAX package,
whose pyarrow pushdown drops NaN rows (ROADMAP section 3)."""

import types

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from blaze_tpu_torch.batch import PackedColumnBatch
from blaze_tpu_torch.ops.base import ExecContext
from blaze_tpu_torch.plan.serde import task_to_proto
from blaze_tpu_torch.runtime.executor import execute_task, run_plan


def package(jax: bool) -> types.SimpleNamespace:
    """The classes a plan description needs, from one package."""
    if jax:
        from blaze_tpu import ops
        from blaze_tpu.exprs import ir
        from blaze_tpu.ops.fused import fuse_pipelines
        from blaze_tpu.ops.parquet_scan import FileRange, ParquetScanExec
        from blaze_tpu.planner.colprune import install
        from blaze_tpu.types import DataType
    else:
        from blaze_tpu_torch import ops
        from blaze_tpu_torch.exprs import ir
        from blaze_tpu_torch.ops.parquet_scan import FileRange, \
            ParquetScanExec
        from blaze_tpu_torch.planner.colprune import install
        from blaze_tpu_torch.planner.fuse import fuse_pipelines
        from blaze_tpu_torch.types import DataType
    return types.SimpleNamespace(
        ops=ops, ir=ir, Col=ir.Col, Lit=ir.Literal, AggExpr=ir.AggExpr,
        AggFn=ir.AggFn, DataType=DataType, FileRange=FileRange,
        Scan=ParquetScanExec, fuse=fuse_pipelines, install=install)


@pytest.fixture(scope="module")
def pq_file(tmp_path_factory):
    rng = np.random.default_rng(7)
    n = 40_000
    tbl = pa.table({
        "a": rng.integers(0, 100, n).astype(np.int32),
        "b": rng.random(n).astype(np.float32) * 100,
        "c": rng.integers(0, 10, n).astype(np.int64),
        "unused_wide": rng.random(n),
        "s": pa.array([None if i % 97 == 0 else f"v{i % 5}"
                       for i in range(n)]),
    })
    path = str(tmp_path_factory.mktemp("cp") / "t.parquet")
    pq.write_table(tbl, path, row_group_size=8_000)
    return path, tbl


# ---------------------------------------------------------------------------
# plan descriptions: (plan, its scans) in the package `P`
# ---------------------------------------------------------------------------

def _scan(P, path):
    return P.Scan([[P.FileRange(path)]])


def agg_filter_project(P, path):
    sc = _scan(P, path)
    o = P.ops
    plan = o.HashAggregateExec(
        o.ProjectExec(o.FilterExec(sc, (P.Col("b") > 50.0)
                                   & (P.Col("a") < 90)),
                      [(P.Col("b") * 2.0, "b2")]),
        keys=[], aggs=[(P.AggExpr(P.AggFn.SUM, P.Col("b2")), "t")],
        mode=o.AggMode.COMPLETE)
    return plan, [sc]


def fused_keyed(P, path):
    sc = _scan(P, path)
    o = P.ops
    plan = P.fuse(o.HashAggregateExec(
        o.ProjectExec(o.FilterExec(sc, P.Col("c") == 3),
                      [(P.Col("b"), "b"), (P.Col("a"), "a")]),
        keys=[(P.Col("a"), "a")],
        aggs=[(P.AggExpr(P.AggFn.SUM, P.Col("b")), "t")],
        mode=o.AggMode.COMPLETE))
    return plan, [sc]


def fused_keyless(P, path):
    sc = _scan(P, path)
    o = P.ops
    plan = P.fuse(o.HashAggregateExec(
        o.ProjectExec(o.FilterExec(sc, (P.Col("b") > 50.0)
                                   & (P.Col("a") < 90)),
                      [(P.Col("b") * P.Col("c").cast(P.DataType.float64()),
                        "r")]),
        keys=[], aggs=[(P.AggExpr(P.AggFn.SUM, P.Col("r")), "t"),
                       (P.AggExpr(P.AggFn.COUNT_STAR, None), "n")],
        mode=o.AggMode.COMPLETE))
    return plan, [sc]


def join_split(P, path):
    left, right = _scan(P, path), _scan(P, path)
    o = P.ops
    plan = o.ProjectExec(
        o.HashJoinExec(left, right, ["a"], ["a"], o.JoinType.INNER),
        [(P.Col("b"), "lb")])
    return plan, [left, right]


def semi_join(P, path):
    left, right = _scan(P, path), _scan(P, path)
    o = P.ops
    plan = o.ProjectExec(
        o.SortMergeJoinExec(o.FilterExec(left, P.Col("c") < 4), right,
                            ["a"], ["c"], o.JoinType.LEFT_SEMI),
        [(P.Col("b"), "b")])
    return plan, [left, right]


def conflicting_filters(P, path):
    sc = _scan(P, path)
    o = P.ops
    plan = o.HashJoinExec(
        o.ProjectExec(o.FilterExec(sc, P.Col("a") > 50), [(P.Col("a"), "x")]),
        o.ProjectExec(o.FilterExec(sc, P.Col("a") <= 50),
                      [(P.Col("a"), "y")]),
        ["x"], ["y"], o.JoinType.INNER)
    return plan, [sc]


def sort_limit(P, path):
    sc = _scan(P, path)
    o = P.ops
    plan = o.LimitExec(o.SortExec(
        o.ProjectExec(sc, [(P.Col("a"), "a"), (P.Col("b"), "b")]),
        [o.SortKey(P.Col("b"), True, True)]), 5)
    return plan, [sc]


def widening_cast(P, path):
    sc = _scan(P, path)
    return P.ops.FilterExec(
        sc, P.Col("b").cast(P.DataType.float64()) > 50.0), [sc]


def narrowing_cast(P, path):
    sc = _scan(P, path)
    return P.ops.FilterExec(
        sc, P.Col("b").cast(P.DataType.int32()) == 3), [sc]


def string_eq_and_flipped(P, path):
    sc = _scan(P, path)
    o = P.ops
    twenty = P.Lit(20, P.DataType.int32())
    pred = (P.Col("s") == "v2") & (twenty > P.Col("a")) & (P.Col("c") != 7)
    return o.HashAggregateExec(
        o.FilterExec(sc, pred), keys=[],
        aggs=[(P.AggExpr(P.AggFn.COUNT_STAR, None), "n")],
        mode=o.AggMode.COMPLETE), [sc]


def count_star(P, path):
    sc = _scan(P, path)
    o = P.ops
    return o.HashAggregateExec(
        sc, keys=[], aggs=[(P.AggExpr(P.AggFn.COUNT_STAR, None), "n")],
        mode=o.AggMode.COMPLETE), [sc]


def debug_above_scan(P, path):
    sc = _scan(P, path)
    o = P.ops
    return o.ProjectExec(o.DebugExec(sc, "dbg"),
                         [(P.Col("b") * 2.0, "b2")]), [sc]


def union_rename(P, path):
    a, b = _scan(P, path), _scan(P, path)
    o = P.ops
    plan = o.ProjectExec(
        o.UnionExec([o.RenameColumnsExec(a, ["p", "q", "r", "u", "v"]),
                     o.RenameColumnsExec(b, ["p", "q", "r", "u", "v"])]),
        [(P.Col("r") + 1, "r1")])
    return plan, [a, b]


PLANS = [agg_filter_project, fused_keyed, fused_keyless, join_split,
         semi_join, conflicting_filters, sort_limit, widening_cast,
         narrowing_cast, string_eq_and_flipped, count_star,
         debug_above_scan, union_rename]


def hints(P, describe, path):
    """Each scan's (required names or None, pushed conjuncts) after
    `install(plan, with_filters=True)`."""
    plan, scans = describe(P, path)
    P.install(plan, with_filters=True)
    out = []
    for sc in scans:
        names = [f.name for f in sc.schema]
        req = sc._hint_required
        out.append((None if req is None else sorted(names[i] for i in req),
                    [(n, op.name, v) for n, op, v in sc._hint_filters]))
    return out


@pytest.mark.parametrize("describe", PLANS, ids=lambda f: f.__name__)
def test_hints_equal_jax(pq_file, describe):
    path, _ = pq_file
    assert hints(package(False), describe, path) == \
        hints(package(True), describe, path)


def test_expected_hints(pq_file):
    """A few of the shared answers spelled out."""
    path, _ = pq_file
    P = package(False)
    assert hints(P, agg_filter_project, path) == [
        (["a", "b"], [("b", "GT", 50.0), ("a", "LT", 90)])]
    assert hints(P, fused_keyed, path) == [(["a", "b", "c"],
                                            [("c", "EQ", 3)])]
    assert hints(P, join_split, path) == [(["a", "b"], []), (["a"], [])]
    assert hints(P, conflicting_filters, path) == [(["a"], [])]
    assert hints(P, narrowing_cast, path) == [(None, [])]
    assert hints(P, string_eq_and_flipped, path)[0][1] == [
        ("s", "EQ", "v2"), ("a", "LT", 20), ("c", "NEQ", 7)]
    assert hints(P, count_star, path) == [([], [])]
    assert hints(P, debug_above_scan, path) == [(None, [])]


def test_unknown_op_is_conservative(pq_file):
    path, _ = pq_file
    P = package(False)
    sc = _scan(P, path)

    class Weird:
        children = [sc]

    P.install(Weird())
    assert sc._hint_required is None


def test_required_only_grows_across_plans(pq_file):
    path, _ = pq_file
    P = package(False)
    sc = _scan(P, path)
    names = [f.name for f in sc.schema]
    P.install(P.ops.ProjectExec(sc, [(P.Col("a"), "a")]))
    assert {names[i] for i in sc._hint_required} == {"a"}
    P.install(P.ops.ProjectExec(sc, [(P.Col("c"), "c")]))
    assert {names[i] for i in sc._hint_required} == {"a", "c"}


def test_window_fused_chain_and_exchanges(pq_file, tmp_path):
    """Port walks the JAX package's lacks: a window's folded chain (its
    keys are bound to the chain's output), the fused window aggregate,
    and the exchanges, whose map stage writes only what is read."""
    from blaze_tpu_torch.ops import ProjectExec, WindowExec, WindowFn
    from blaze_tpu_torch.parallel import (
        BroadcastExchangeExec,
        ShuffleExchangeExec,
    )

    path, _ = pq_file
    P = package(False)
    o = P.ops
    sc = _scan(P, path)
    win = WindowExec(
        ProjectExec(sc, [(P.Col("c"), "k"), (P.Col("b"), "v")]),
        partition_by=[P.Col("k")], order_by=[o.SortKey(P.Col("v"))],
        functions=[WindowFn("row_number", None, "rn")])
    plan = P.fuse(ProjectExec(win, [(P.Col("rn"), "rn")]))
    assert plan.children[0]._fused_pipeline is not None
    P.install(plan)
    names = [f.name for f in sc.schema]
    assert sorted(names[i] for i in sc._hint_required) == ["b", "c"]

    sc2 = _scan(P, path)
    agg = o.HashAggregateExec(
        ProjectExec(WindowExec(sc2, partition_by=[P.Col("a")],
                               order_by=[o.SortKey(P.Col("b"))],
                               functions=[WindowFn("row_number", None,
                                                   "rn")]),
                    [(P.Col("rn"), "rn")]), keys=[],
        aggs=[(P.AggExpr(P.AggFn.SUM, P.Col("rn")), "s")],
        mode=o.AggMode.COMPLETE)
    P.install(P.fuse(agg))
    assert sorted(names[i] for i in sc2._hint_required) == ["a", "b"]

    fact, dim = _scan(P, path), _scan(P, path)
    ex = ShuffleExchangeExec(
        o.HashJoinExec(BroadcastExchangeExec(dim), fact, ["a"], ["c"],
                       o.JoinType.INNER), [P.Col("c")], 3, "range",
        shuffle_dir=str(tmp_path))
    P.install(ProjectExec(ex, [(P.Col("b"), "b")]))
    # the join's output repeats the names: Col("c") binds the build's
    assert sorted(names[i] for i in dim._hint_required) == ["a", "b", "c"]
    assert sorted(names[i] for i in fact._hint_required) == ["c"]


# ---------------------------------------------------------------------------
# results: pruned and pushed equal unpruned, against oracles
# ---------------------------------------------------------------------------

def _cpu():
    return ExecContext(device="cpu")


def _unpruned(plan):
    """`plan` with hint installation skipped: every column is read."""
    plan._colprune_installed = True
    return plan


def test_e2e_pruned_equals_unpruned(pq_file):
    from blaze_tpu_torch.config import EngineConfig

    path, tbl = pq_file
    P = package(False)
    blob = task_to_proto(agg_filter_project(P, path)[0], 0)
    ctx = ExecContext(device="cpu", config=EngineConfig(
        device="cpu", host_filter_pushdown=True))
    got = list(execute_task(blob, ctx))[0]
    base = run_plan(_unpruned(agg_filter_project(P, path)[0]), _cpu())
    df = tbl.to_pandas()
    live = (df.b > 50.0) & (df.a < 90)
    exp = float((df.b[live].astype(np.float64) * 2.0).sum())
    assert abs(got.column(0)[0].as_py() - exp) <= 1e-9 * exp
    assert got.column(0)[0].as_py() == base.column(0)[0].as_py()
    c = ctx.metrics.counters
    assert (c["columns_decoded"], c["columns_in_schema"]) == (2, 5)
    assert c["pushdown_filtered_rows"] == int((~live).sum())


def test_keyed_pruned_equals_unpruned(pq_file):
    path, tbl = pq_file
    P = package(False)
    got = run_plan(fused_keyed(P, path)[0], _cpu()).to_pandas()
    base = run_plan(_unpruned(fused_keyed(P, path)[0]), _cpu()).to_pandas()
    got, base = (t.sort_values("a").reset_index(drop=True)
                 for t in (got, base))
    df = tbl.to_pandas()
    exp = df[df.c == 3].astype({"b": np.float64}).groupby("a").b.sum() \
        .sort_index()
    np.testing.assert_array_equal(got.a, exp.index)
    np.testing.assert_allclose(got.t, exp.values, rtol=1e-9)
    np.testing.assert_array_equal(got.t, base.t)


def test_pushdown_metrics_and_rowgroup_skip(pq_file):
    path, _ = pq_file
    P = package(False)
    sc = _scan(P, path)
    plan = P.ops.FilterExec(sc, P.Col("a") < 0)  # empty by the stats
    P.install(plan, with_filters=True)
    ctx = _cpu()
    assert run_plan(plan, ctx).num_rows == 0
    assert ctx.metrics.counters.get("input_rows", 0) == 0


@pytest.mark.parametrize("describe,oracle", [
    (count_star, lambda df: len(df)),
    (string_eq_and_flipped,
     lambda df: int(((df.s == "v2") & (df.a < 20) & (df.c != 7)).sum())),
], ids=["count_star", "string_eq"])
def test_count_tasks(pq_file, describe, oracle):
    path, tbl = pq_file
    blob = task_to_proto(describe(package(False), path)[0], 0)
    rows = list(execute_task(blob, _cpu()))
    assert rows[0].column(0)[0].as_py() == oracle(tbl.to_pandas())


def test_sort_limit_result(pq_file):
    path, tbl = pq_file
    out = run_plan(sort_limit(package(False), path)[0], _cpu()).to_pandas()
    exp = tbl.to_pandas()[["a", "b"]].sort_values("b", kind="stable") \
        .head(5)
    np.testing.assert_array_equal(out.b.values, exp.b.values)


@pytest.fixture(scope="module")
def nan_file(tmp_path_factory):
    """Float column `b` with NaN and NULL rows; the second row group's
    numbers all lie below 0.5, so its statistics alone would skip it
    under `b > 0.5` though its NaN rows pass in Spark's order."""
    rng = np.random.default_rng(3)
    n = 3000
    b = rng.random(n).astype(np.float32)
    b[1000:2000] *= 0.4
    b[::7] = np.nan
    null = rng.random(n) < 0.05
    path = str(tmp_path_factory.mktemp("nan") / "nan.parquet")
    pq.write_table(pa.table({"a": np.arange(n, dtype=np.int32),
                             "b": pa.array(b, mask=null)}), path,
                   row_group_size=1000)
    return path, b, null


SPARK_CMP = {
    # Spark's order: NaN equals NaN and lies above every number
    "GT": lambda b, v: (b > v) | np.isnan(b),
    "GTE": lambda b, v: (b >= v) | np.isnan(b),
    "LT": lambda b, v: (b < v) & ~np.isnan(b),
    "LTE": lambda b, v: (b <= v) & ~np.isnan(b),
    "EQ": lambda b, v: b == v,
    "NEQ": lambda b, v: (b != v) | np.isnan(b),
}


@pytest.mark.parametrize("op", sorted(SPARK_CMP))
@pytest.mark.parametrize("pushdown", [True, False])
def test_nan_rows_follow_spark(nan_file, op, pushdown):
    from blaze_tpu_torch.config import EngineConfig

    path, b, null = nan_file
    P = package(False)
    o = P.ops
    col = P.Col("b")
    pred = {"GT": col > 0.5, "GTE": col >= 0.5, "LT": col < 0.5,
            "LTE": col <= 0.5, "EQ": col == float(b[1]),
            "NEQ": col != 0.5}[op]
    plan = o.HashAggregateExec(
        o.FilterExec(_scan(P, path), pred), keys=[],
        aggs=[(P.AggExpr(P.AggFn.COUNT_STAR, None), "n")],
        mode=o.AggMode.COMPLETE)
    ctx = ExecContext(device="cpu",
                      config=EngineConfig(device="cpu",
                                          host_filter_pushdown=pushdown))
    rows = list(execute_task(task_to_proto(plan, 0), ctx))
    v = float(b[1]) if op == "EQ" else np.float32(0.5)
    exp = int((SPARK_CMP[op](b, v) & ~null).sum())
    assert rows[0].column(0)[0].as_py() == exp
    assert ctx.metrics.counters["input_rows"] == len(b)  # no group skipped
    if pushdown:
        assert ctx.metrics.counters["pushdown_filtered_rows"] == \
            len(b) - exp
    else:
        assert "pushdown_filtered_rows" not in ctx.metrics.counters


@pytest.mark.parametrize("op", ["GT", "GTE", "LT"])
def test_host_filter_follows_spark_nan_order(op):
    """The host filter alone, on a batch with NaN and NULL rows: a NaN
    passes `>` and `>=` and fails `<` (Spark's order), a NULL fails
    every comparison."""
    from blaze_tpu_torch.exprs import ir
    from blaze_tpu_torch.ops.parquet_scan import _apply_host_filters

    b = np.array([0.9, np.nan, 0.1, 0.5, np.nan, 0.7], np.float32)
    null = np.array([False, False, False, False, True, True])
    rb = pa.record_batch([pa.array(b, mask=null)], names=["b"])
    out = _apply_host_filters(rb, [("b", getattr(ir.Op, op), 0.5)])
    keep = SPARK_CMP[op](b, np.float32(0.5)) & ~null
    assert out.column(0).null_count == 0
    np.testing.assert_array_equal(out.column(0).to_numpy(), b[keep])


def test_decimal_literal_not_pushable(tmp_path):
    """A decimal literal is its unscaled int; it is never pushed, and
    stats pruning reads it as the Decimal it stands for."""
    import decimal

    n = 100
    tbl = pa.table({"price": pa.array(
        [decimal.Decimal(f"{i + 1}.00") for i in range(n)],
        type=pa.decimal128(9, 2))})
    path = str(tmp_path / "dec.parquet")
    pq.write_table(tbl, path, row_group_size=25)
    for jax in (False, True):
        P = package(jax)
        sc = _scan(P, path)
        plan = P.ops.FilterExec(
            sc, P.Col("price") > P.Lit(5000, P.DataType.decimal(9, 2)))
        P.install(plan, with_filters=True)
        assert sc._hint_filters == ()
    P = package(False)
    o = P.ops
    sc = _scan(P, path)
    plan = o.HashAggregateExec(
        o.FilterExec(sc, P.Col("price") > P.Lit(
            5000, P.DataType.decimal(9, 2))), keys=[],
        aggs=[(P.AggExpr(P.AggFn.COUNT_STAR, None), "n")],
        mode=o.AggMode.COMPLETE)
    rows = list(execute_task(task_to_proto(plan, 0), _cpu()))
    assert rows[0].column(0)[0].as_py() == 50


def test_narrowing_cast_result(tmp_path):
    tbl = pa.table({"b": np.array([3.7, 3.2, 4.0, 2.9, 3.0])})
    path = str(tmp_path / "cast.parquet")
    pq.write_table(tbl, path)
    P = package(False)
    o = P.ops
    plan = o.HashAggregateExec(
        o.FilterExec(_scan(P, path), P.Col("b").cast(P.DataType.int32())
                     == 3), keys=[],
        aggs=[(P.AggExpr(P.AggFn.COUNT_STAR, None), "n")],
        mode=o.AggMode.COMPLETE)
    rows = list(execute_task(task_to_proto(plan, 0), _cpu()))
    assert rows[0].column(0)[0].as_py() == 3


def test_debug_exec_requires_all_columns(tmp_path):
    tbl = pa.table({"s": pa.array(["aa", "bb", "cc", "dd"]),
                    "v": np.array([1.0, 2.0, 3.0, 4.0])})
    path = str(tmp_path / "dbg.parquet")
    pq.write_table(tbl, path)
    P = package(False)
    plan = P.ops.ProjectExec(P.ops.DebugExec(_scan(P, path), "dbg"),
                             [(P.Col("v") * 2.0, "v2")])
    out = pa.Table.from_batches(list(execute_task(task_to_proto(plan, 0),
                                                  _cpu())))
    np.testing.assert_allclose(np.sort(out.column("v2").to_numpy()),
                               [2.0, 4.0, 6.0, 8.0])


def test_reference_projection_contract_pruned_batches(tmp_path):
    """The full schema plus a projection (the reference's
    NativeParquetScanExec contract) gives pruned batches positioned by
    the projected schema."""
    from blaze_tpu_torch.types import Field, Schema

    tbl = pa.table({"a": np.arange(8, dtype=np.int32),
                    "b": np.arange(8, dtype=np.float32) * 1.5,
                    "c": np.arange(8, dtype=np.int64) + 100})
    path = str(tmp_path / "proj.parquet")
    pq.write_table(tbl, path)
    P = package(False)
    full = Schema([Field("a", P.DataType.int32(), True),
                   Field("b", P.DataType.float32(), True),
                   Field("c", P.DataType.int64(), True)])
    sc = P.Scan([[P.FileRange(path)]], full, projection=["c", "b"])
    assert list(sc.schema.names()) == ["c", "b"]
    plan = P.ops.ProjectExec(sc, [(P.Col("c") + 1, "c1")])
    out = pa.Table.from_batches(list(execute_task(task_to_proto(plan, 0),
                                                  _cpu())))
    np.testing.assert_array_equal(np.sort(out.column("c1").to_numpy()),
                                  np.arange(8) + 101)


def test_pruned_batch_placeholders_and_graph_input(tmp_path):
    """A pruned scan batch: one packed buffer of the read columns,
    shared zero placeholders elsewhere (a string one renders as NULLs),
    its layout key naming the holes; a fused graph's static input over
    it (ops/fused._static_input) keeps the placeholders and views the
    buffer for the rest."""
    from blaze_tpu_torch.ops.fused import _static_input

    tbl = pa.table({"s": pa.array(["x", "y", "z"]),
                    "v": np.array([1.0, 2.0, 3.0]),
                    "w": pa.array([1, None, 3], pa.int32())})
    path = str(tmp_path / "ph.parquet")
    pq.write_table(tbl, path)
    P = package(False)
    sc = _scan(P, path)
    sc._hint_required = {1, 2}
    (cb,) = list(sc.execute(0, _cpu()))
    assert isinstance(cb, PackedColumnBatch) and cb.placeholders == (0,)
    assert cb.key[-1] == (0,)
    rb = cb.to_arrow()
    assert rb.column("s").null_count == 3
    assert rb.column("v").to_pylist() == [1.0, 2.0, 3.0]
    assert rb.column("w").to_pylist() == [1, None, 3]
    (cb2,) = list(sc.execute(0, _cpu()))
    assert cb2.columns[0].values is cb.columns[0].values  # shared
    buf, cols = _static_input(cb)
    assert cols[0][0] is cb.columns[0].values and cols[0][1] is None
    for (v, m), c in zip(cols[1:], cb.columns[1:]):
        assert v.data_ptr() != c.values.data_ptr()
        assert bool((v == c.values).all())
        assert (m is None) == (c.validity is None)


def test_boundcol_pruning_predicate_with_projection(tmp_path):
    from blaze_tpu_torch.exprs import ir
    from blaze_tpu_torch.types import Field, Schema

    tbl = pa.table({
        "a": np.concatenate([np.arange(8), np.arange(8) + 100])
        .astype(np.int64),
        "b": np.arange(16).astype(np.float32),
        "c": np.zeros(16, dtype=np.int64),
    })
    path = str(tmp_path / "bc.parquet")
    pq.write_table(tbl, path, row_group_size=8)
    P = package(False)
    full = Schema([Field("a", P.DataType.int64(), True),
                   Field("b", P.DataType.float32(), True),
                   Field("c", P.DataType.int64(), True)])
    pred = ir.BinaryOp(ir.Op.GT, ir.BoundCol(0, P.DataType.int64()),
                       ir.Literal(50, P.DataType.int64()))
    sc = P.Scan([[P.FileRange(path)]], full, projection=["b", "a"],
                pruning_predicate=pred)
    out = pa.Table.from_batches(list(execute_task(task_to_proto(
        P.ops.ProjectExec(sc, [(P.Col("a"), "a")]), 0), _cpu())))
    np.testing.assert_array_equal(np.sort(out.column("a").to_numpy()),
                                  np.arange(8) + 100)
