"""The port's planner (planner/{spec,convert,host_engine,distribute}.py)
against the JAX package's, on the CPU. Each PlanSpec is built twice from
one description, once with each package's spec classes and IR; both
packages' `convert_plan` must tag every node alike (the dry-run tags,
the per-op gates, the strategy heuristics, the non-equi and skew join
fallbacks, the window and exchange specs) and build the same operator
types. A tag that differs would mean a node the port sends to pandas
where the JAX package runs it natively (or the reverse), which a result
check alone would not show. Results are held against pandas oracles
over frames made from seeded numpy generators; the JAX package's plans
are converted, not run."""

import types

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import chip_smoke
from blaze_tpu_torch.ops.base import ExecContext
from blaze_tpu_torch.runtime.executor import run_plan


def package(jax: bool) -> types.SimpleNamespace:
    if jax:
        import blaze_tpu.planner as planner
        from blaze_tpu.exprs import ir
        from blaze_tpu.ops.parquet_scan import FileRange
    else:
        import blaze_tpu_torch.planner as planner
        from blaze_tpu_torch.exprs import ir
        from blaze_tpu_torch.ops.parquet_scan import FileRange
    return types.SimpleNamespace(planner=planner, ir=ir, FileRange=FileRange)


def df_sales(n=1000, seed=5):
    rng = np.random.default_rng(seed)
    return pd.DataFrame({"k": rng.integers(0, 9, n),
                         "v": rng.integers(0, 100, n),
                         "p": np.round(rng.random(n) * 10, 3)})


def _cpu():
    return ExecContext(device="cpu")


# ---------------------------------------------------------------------------
# spec descriptions: (spec, strategy kwargs) in package `P`
# ---------------------------------------------------------------------------

def agg_over_exchange(P, _):
    S, ir = P.planner, P.ir
    df = df_sales()
    filt = S.FilterSpec(children=[S.MemorySpec(dataframe=df, partitions=3)],
                        predicate=ir.Col("v") > 50)
    return S.AggSpec(
        children=[S.ExchangeSpec(children=[filt], keys=[ir.Col("k")],
                                 num_partitions=4)],
        keys=[(ir.Col("k"), "k")],
        aggs=[(ir.AggExpr(ir.AggFn.SUM, ir.Col("p")), "s")],
        mode="complete"), {}


def window_row_number(P, _):
    S = P.planner
    return S.WindowSpec(children=[S.MemorySpec(dataframe=df_sales(100))],
                        partition_by=["k"], order_by=["v"],
                        function="row_number", output="rn"), {}


def window_unsupported(P, _):
    S = P.planner
    return S.WindowSpec(children=[S.MemorySpec(dataframe=df_sales(100))],
                        partition_by=["k"], order_by=["v"],
                        function="ntile", output="n"), {}


def filter_over_host_window(P, _):
    S, ir = P.planner, P.ir
    win = S.WindowSpec(children=[S.MemorySpec(dataframe=df_sales(200))],
                       partition_by=["k"], order_by=["v"],
                       function="row_number", output="rn")
    return S.FilterSpec(children=[win], predicate=ir.Col("rn") == 1), \
        {"enable_window": False}


def sort_gate_off(P, _):
    S, ir = P.planner, P.ir
    return S.SortSpec(children=[S.MemorySpec(dataframe=df_sales(50))],
                      keys=[(ir.Col("v"), True, True)]), \
        {"enable_sort": False}


def non_equi_join(P, _):
    S = P.planner
    return S.JoinSpec(children=[
        S.MemorySpec(dataframe=pd.DataFrame({"a": [1, 2, 3]})),
        S.MemorySpec(dataframe=pd.DataFrame({"b": [2, 3, 4]}))],
        kind="smj", left_keys=[], right_keys=[], join_type="inner"), {}


def join_condition(P, _):
    S, ir = P.planner, P.ir
    return S.JoinSpec(children=[
        S.MemorySpec(dataframe=pd.DataFrame({"a": [1, 2, 2],
                                             "x": [10, 20, 30]})),
        S.MemorySpec(dataframe=pd.DataFrame({"b": [1, 2], "y": [5, 25]}))],
        kind="smj", left_keys=["a"], right_keys=["b"], join_type="inner",
        condition=ir.Col("x") > ir.Col("y")), {}


def parquet_scan_spec(P, path):
    S, ir = P.planner, P.ir
    return S.ProjectSpec(children=[S.ScanSpec(
        file_groups=[[P.FileRange(path)]], projection=["a", "b"],
        predicate=ir.Col("a") >= 95)], exprs=[(ir.Col("b") + 1, "b1")]), {}


def broadcast_exchange(P, _):
    S = P.planner
    return S.ExchangeSpec(children=[S.MemorySpec(dataframe=df_sales(60),
                                                 partitions=2)],
                          mode="broadcast"), {}


def bhj_over_broadcast(P, _):
    S = P.planner
    build = S.ExchangeSpec(children=[S.MemorySpec(
        dataframe=pd.DataFrame({"a": [1, 2], "x": [10, 20]}),
        partitions=3)], mode="broadcast")
    return S.JoinSpec(children=[build, S.MemorySpec(
        dataframe=pd.DataFrame({"b": [1, 1, 2, 3], "y": [1, 2, 3, 4]}),
        partitions=2)], kind="bhj", left_keys=["a"], right_keys=["b"],
        join_type="inner"), {}


def skew_join(P, _):
    S = P.planner
    return S.JoinSpec(children=[
        S.MemorySpec(dataframe=pd.DataFrame({"a": [1, 2]})),
        S.MemorySpec(dataframe=pd.DataFrame({"b": [1, 2]}))],
        kind="smj", left_keys=["a"], right_keys=["b"], join_type="inner",
        skewed=True), {}


def _never_agg(P):
    S, ir = P.planner, P.ir
    return S.AggSpec(children=[S.MemorySpec(dataframe=df_sales())],
                     keys=[(ir.Col("k"), "k")],
                     aggs=[(ir.AggExpr(ir.AggFn.SUM, ir.Col("v")), "s")],
                     mode="complete", strategy="never")


def scan_parent_heuristic(P, _):
    return _never_agg(P), {}


def heuristics_off(P, _):
    return _never_agg(P), {"enable_scan_parent_heuristic": False,
                           "enable_agg_child_heuristic": False}


def _chain(P):
    S, ir = P.planner, P.ir
    node = S.MemorySpec(dataframe=df_sales())
    for i in range(6):
        node = S.ProjectSpec(children=[node], exprs=[
            (ir.Col("k"), "k"), (ir.Col("v") + i, "v")])
    return node


def codegen_chain_default(P, _):
    return _chain(P), {}


def codegen_chain_on(P, _):
    return _chain(P), {"enable_codegen_chain_heuristic": True}


def range_exchange(P, _):
    S, ir = P.planner, P.ir
    return S.ExchangeSpec(children=[S.MemorySpec(dataframe=df_sales())],
                          keys=[ir.Col("k")], num_partitions=3,
                          mode="range"), {}


def union_limit_sort(P, _):
    S, ir = P.planner, P.ir
    df = df_sales(300)
    u = S.UnionSpec(children=[S.MemorySpec(dataframe=df, partitions=2),
                              S.MemorySpec(dataframe=df)])
    return S.LimitSpec(children=[S.SortSpec(
        children=[u], keys=[(ir.Col("p"), False, False),
                            (ir.Col("v"), True, True)], fetch=None)],
        limit=7), {}


def agg_gate_off(P, _):
    S, ir = P.planner, P.ir
    return S.AggSpec(
        children=[S.FilterSpec(children=[S.MemorySpec(dataframe=df_sales())],
                               predicate=ir.Col("v") > 10)],
        keys=[(ir.Col("k"), "k")],
        aggs=[(ir.AggExpr(ir.AggFn.AVG, ir.Col("p")), "m"),
              (ir.AggExpr(ir.AggFn.COUNT_STAR, None), "n")],
        mode="complete"), {"enable_aggr": False}


def join_agg_native(P, paths):
    fact, dim = paths
    return chip_smoke.join_agg_spec(
        P, chip_smoke.byte_splits(P.FileRange, fact, 4), dim), {}


def join_agg_fallback(P, paths):
    fact, dim = paths
    return chip_smoke.join_agg_spec(
        P, chip_smoke.byte_splits(P.FileRange, fact, 4), dim), \
        {"enable_bhj": False}


def q6_planned(P, paths):
    fact, _ = paths
    return chip_smoke.q6_spec(
        P, chip_smoke.byte_splits(P.FileRange, fact, 4)), {}


SPECS = [agg_over_exchange, window_row_number, window_unsupported,
         filter_over_host_window, sort_gate_off, non_equi_join,
         join_condition, parquet_scan_spec, broadcast_exchange,
         bhj_over_broadcast, skew_join, scan_parent_heuristic,
         heuristics_off, codegen_chain_default, codegen_chain_on,
         range_exchange, union_limit_sort, agg_gate_off, join_agg_native,
         join_agg_fallback, q6_planned]
NEEDS = {parquet_scan_spec: "ab", join_agg_native: "join",
         join_agg_fallback: "join", q6_planned: "join"}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A small a/b file, and store_sales and item files in chip_smoke's
    shapes (bench.py's join_agg), 40,000 fact rows in 4 row groups."""
    d = tmp_path_factory.mktemp("planner")
    ab = str(d / "ab.parquet")
    pq.write_table(pa.table({"a": list(range(100)),
                             "b": [i * 2 for i in range(100)]}), ab)
    rows = 40_000
    item, qty, price = chip_smoke.store_sales_columns(rows, 11)
    fact = str(d / "store_sales.parquet")
    pq.write_table(pa.table({"item": item, "qty": qty, "price": price}),
                   fact, row_group_size=10_000)
    brands = chip_smoke.item_brands(rows, 11)
    dim = str(d / "item.parquet")
    pq.write_table(pa.table({
        "i_item": np.arange(chip_smoke.ITEMS, dtype=np.int32),
        "i_brand": brands}), dim)
    return {"ab": ab, "join": (fact, dim),
            "arrays": (item, qty, price, brands)}


def _arg(describe, files):
    need = NEEDS.get(describe)
    return files[need] if need else None


def converted(P, describe, arg):
    """(spec tags, built operator types) of one description."""
    spec, kwargs = describe(P, arg)
    op = P.planner.convert_plan(spec, P.planner.ConvertStrategy(**kwargs),
                                fuse=False)
    return chip_smoke.spec_tags(spec), [type(o).__name__
                                        for o in _preorder(op)]


def _preorder(op):
    out = [op]
    for c in op.children:
        out += _preorder(c)
    return out


# The JAX package's `_convert_native` imports SortKey inside its window
# branch (blaze_tpu/planner/convert.py:384), which makes the name local
# to the whole function: its SortSpec conversion raises UnboundLocalError
# and tryConvert quietly builds a HostFallbackExec for a node tagged
# native. The port converts the sort natively (and would raise on such a
# fault). The tags agree; the built operators differ only there.
JAX_SORT_ON_HOST = {
    union_limit_sort: (
        ["LimitExec", "SortExec", "UnionExec", "MemoryScanExec",
         "MemoryScanExec"],
        ["LimitExec", "HostFallbackExec"]),
}


@pytest.mark.parametrize("describe", SPECS, ids=lambda f: f.__name__)
def test_tags_and_operators_equal_jax(files, describe):
    arg = _arg(describe, files)
    port_tags, port_ops = converted(package(False), describe, arg)
    jax_tags, jax_ops = converted(package(True), describe, arg)
    assert port_tags == jax_tags
    assert (port_ops, jax_ops) == JAX_SORT_ON_HOST.get(
        describe, (jax_ops, jax_ops))


def test_fallback_tags_pinned_for_chip_smoke(files):
    """chip_smoke's plan_fallback checks the card's tags against
    PLAN_FALLBACK_TAGS; here they are the JAX package's."""
    spec, kwargs = join_agg_fallback(package(True), files["join"])
    package(True).planner.convert_plan(
        spec, package(True).planner.ConvertStrategy(**kwargs))
    assert chip_smoke.tag_counts(spec) == chip_smoke.PLAN_FALLBACK_TAGS
    spec, _ = join_agg_native(package(True), files["join"])
    package(True).planner.convert_plan(spec)
    assert chip_smoke.tag_counts(spec)["host"] == 0


# ---------------------------------------------------------------------------
# results of the port's plans against pandas
# ---------------------------------------------------------------------------

def _port(describe, files, fuse=True):
    P = package(False)
    spec, kwargs = describe(P, _arg(describe, files))
    return P.planner.convert_plan(spec, P.planner.ConvertStrategy(**kwargs),
                                  fuse=fuse)


def test_native_pipeline_result(files):
    op = _port(agg_over_exchange, files)
    assert "HostFallbackExec" not in [type(o).__name__
                                      for o in _preorder(op)]
    got = run_plan(op, _cpu()).to_pandas().sort_values("k") \
        .reset_index(drop=True)
    df = df_sales()
    ref = df[df.v > 50].groupby("k")["p"].sum().reset_index(name="s")
    np.testing.assert_array_equal(got["k"], ref["k"])
    np.testing.assert_allclose(got["s"], ref["s"], rtol=1e-12)


def test_window_results(files):
    got = run_plan(_port(window_row_number, files), _cpu()).to_pandas()
    df = df_sales(100)
    exp = df.sort_values(["k", "v"], kind="stable")
    exp = exp.assign(rn=exp.groupby("k").cumcount() + 1)
    assert sorted(map(tuple, got[["k", "v", "rn"]].values.tolist())) == \
        sorted(map(tuple, exp[["k", "v", "rn"]].values.tolist()))
    op = _port(filter_over_host_window, files)
    assert type(op.children[0]).__name__ == "HostFallbackExec"
    got = run_plan(op, _cpu()).to_pandas()
    assert len(got) == df_sales(200).k.nunique()


def test_host_fallbacks_results(files):
    got = run_plan(_port(sort_gate_off, files), _cpu()).to_pandas()
    assert got["v"].is_monotonic_increasing and len(got) == 50
    got = run_plan(_port(join_condition, files), _cpu()).to_pandas()
    assert set(map(tuple, got.values.tolist())) == {(1, 10, 1, 5),
                                                    (2, 30, 2, 25)}
    got = run_plan(_port(agg_gate_off, files), _cpu()).to_pandas() \
        .sort_values("k").reset_index(drop=True)
    df = df_sales()
    d = df[df.v > 10]
    exp = d.groupby("k").agg(m=("p", "mean"), n=("p", "size")) \
        .reset_index()
    np.testing.assert_array_equal(got.k, exp.k)
    np.testing.assert_array_equal(got.n, exp.n)
    np.testing.assert_allclose(got.m, exp.m, rtol=1e-12)


def test_scan_and_exchange_results(files):
    got = run_plan(_port(parquet_scan_spec, files), _cpu()).to_pandas()
    assert sorted(got["b1"]) == [191, 193, 195, 197, 199]
    got = run_plan(_port(bhj_over_broadcast, files), _cpu()).to_pandas()
    assert sorted(got["y"].tolist()) == [1, 2, 3]
    op = _port(broadcast_exchange, files)
    ctx = _cpu()
    per = [sum(b.num_rows for b in op.execute(p, ctx)) for p in range(2)]
    assert per == [60, 60]
    tbl = run_plan(_port(range_exchange, files), _cpu())
    assert tbl.num_rows == 1000
    # a global sort under a limit: insert_exchanges coalesces the
    # union's partitions below the sort (the JAX package runs this sort
    # on its host engine, JAX_SORT_ON_HOST)
    from blaze_tpu_torch.planner.distribute import insert_exchanges

    got = run_plan(insert_exchanges(_port(union_limit_sort, files)),
                   _cpu()).to_pandas()
    df = pd.concat([df_sales(300)] * 2, ignore_index=True)
    exp = df.sort_values(["p", "v"], ascending=[False, True],
                         kind="stable").head(7)
    np.testing.assert_array_equal(got.p, exp.p)


def test_window_functions_host_tier(files):
    P = package(False)
    S = P.planner
    df = pd.DataFrame({"k": [1, 1, 1, 2, 2], "v": [30, 10, 20, 5, 5]})
    for fn, src, exp in [
        ("rank", None, [3, 1, 2, 1, 1]),
        ("dense_rank", None, [3, 1, 2, 1, 1]),
        ("lag", "v", [20.0, None, 10.0, None, 5.0]),
        ("sum", "v", [60, 60, 60, 10, 10]),
        ("avg", "v", [20.0, 20.0, 20.0, 5.0, 5.0]),
    ]:
        spec = S.WindowSpec(children=[S.MemorySpec(dataframe=df)],
                            partition_by=["k"], order_by=["v"], function=fn,
                            source=src, output="w")
        host = S.convert_plan(spec, S.ConvertStrategy(enable_window=False))
        got = run_plan(host, _cpu()).to_pandas()["w"].tolist()
        assert [None if x != x else x for x in got] == exp, fn
        nat = run_plan(S.convert_plan(spec), _cpu()).to_pandas()
        key = lambda t: (t[0], t[1], t[2] is None, t[2] or 0.0)  # noqa
        assert sorted(((int(r.k), int(r.v),
                        None if r.w != r.w else float(r.w))
                       for r in nat.itertuples()), key=key) == sorted(
            ((int(k), int(v), None if x is None else float(x))
             for k, v, x in zip(df.k, df.v, exp)), key=key), fn


@pytest.mark.parametrize("describe", [join_agg_native, join_agg_fallback],
                         ids=["native", "fallback"])
def test_join_agg_through_exchanges(files, describe, tmp_path):
    """chip_smoke's plan_join_agg and plan_fallback at 40,000 rows:
    convert_plan, insert_exchanges into 8 partitions, the scheduler;
    COUNT per brand exact, SUM within 1e-9 (check_join_agg). The
    fallback runs the join subtree on the host engine, whose scan reads
    each byte range's row groups once."""
    from blaze_tpu_torch.planner.distribute import insert_exchanges
    from blaze_tpu_torch.runtime.scheduler import run_plan_parallel

    item, _, price, brands = files["arrays"]
    op = insert_exchanges(_port(describe, files), 8,
                          shuffle_dir=str(tmp_path))
    ctx = _cpu()
    table = run_plan_parallel(op, ctx=ctx)
    chip_smoke.check_join_agg(table, item, price, brands, describe.__name__)
    host = [o for o in chip_smoke._ops(op)
            if type(o).__name__ == "HostFallbackExec"]
    assert len(host) == (describe is join_agg_fallback)
    if not host:
        (fact,) = [s for s in chip_smoke.scan_reads(op)
                   if "qty" in s["schema"]]
        assert fact["decoded"] == ["item", "price"]
        assert ctx.metrics.counters["exchange_map_tasks"] == 4


def test_q6_over_partitions_through_exchanges(files, tmp_path):
    """chip_smoke's plan_q6 at 40,000 rows: the fusion pass makes the
    keyless COMPLETE a carry under HostFinalAggExec; over 4 partitions
    insert_exchanges splits it into the carry's PARTIAL a partition, a
    single exchange and the FINAL, so the plan gives one row, equal to
    numpy's (COUNT exact, SUM within 1e-9)."""
    from blaze_tpu_torch.ops import AggMode, HashAggregateExec
    from blaze_tpu_torch.ops.fused import FusedAggregateExec
    from blaze_tpu_torch.planner.distribute import insert_exchanges
    from blaze_tpu_torch.runtime.scheduler import run_plan_parallel

    _, qty, price, _ = files["arrays"]
    op = insert_exchanges(_port(q6_planned, files), 8,
                          shuffle_dir=str(tmp_path))
    assert isinstance(op, HashAggregateExec) and op.mode is AggMode.FINAL
    (carry,) = [o for o in chip_smoke._ops(op)
                if isinstance(o, FusedAggregateExec)]
    assert not carry.fetch_host and carry.partition_count == 4
    ctx = _cpu()
    table = run_plan_parallel(op, ctx=ctx)
    assert table.num_rows == 1
    chip_smoke.check_q6(table.to_batches(), qty, price, "plan_q6")
    assert ctx.metrics.counters["exchange_map_tasks"] == 4


def test_byte_splits_own_one_row_group_each(files):
    """The fact file's 4 row groups in 4 byte ranges: each range owns
    the row group whose midpoint it holds, so every partition, native
    or on the host engine, reads 10,000 rows of its own."""
    from blaze_tpu_torch.ops import FileRange, ParquetScanExec
    from blaze_tpu_torch.planner.host_engine import _read_range

    fact, _ = files["join"]
    splits = chip_smoke.byte_splits(FileRange, fact, 4)
    scan = ParquetScanExec(splits)
    ctx = _cpu()
    native = [pa.Table.from_batches([cb.to_arrow() for cb in
                                     scan.execute(p, ctx)])
              for p in range(4)]
    item = files["arrays"][0]
    for p, (t, (fr,)) in enumerate(zip(native, splits)):
        part = item[p * 10_000:(p + 1) * 10_000]
        np.testing.assert_array_equal(t.column("item").to_numpy(), part)
        np.testing.assert_array_equal(_read_range(fr, ["item"]).item, part)


def test_native_conversion_failure_raises(files, monkeypatch):
    """A node the dry run tags native and whose conversion then raises
    fails convert_plan: it never becomes a host node unseen."""
    from blaze_tpu_torch.planner import convert

    real = convert._convert_native

    def broken(node, strategy):
        if type(node).__name__ == "FilterSpec":
            raise RuntimeError("planted conversion fault")
        return real(node, strategy)

    monkeypatch.setattr(convert, "_convert_native", broken)
    with pytest.raises(RuntimeError, match="planted conversion fault"):
        _port(agg_over_exchange, files)


def test_op_to_spec_and_host_degradation(files):
    """execute_partition_host re-runs one partition of a native plan on
    the host engine: a filter and projection over a parquet scan's one
    partition, and a memory scan's."""
    from blaze_tpu_torch.exprs.ir import Col
    from blaze_tpu_torch.ops import FilterExec, ProjectExec
    from blaze_tpu_torch.planner.host_engine import (
        execute_partition_host,
        op_to_spec,
    )

    op = _port(parquet_scan_spec, files, fuse=False)
    rbs = execute_partition_host(op, 0, _cpu())
    assert sorted(pa.Table.from_batches(rbs).column("b1").to_pylist()) == \
        [191, 193, 195, 197, 199]
    mem = _port(agg_over_exchange, files, fuse=False)
    scan = mem.children[0].children[0].children[0]
    plan = ProjectExec(FilterExec(scan, Col("v") > 90), [(Col("k"), "k")])
    spec = op_to_spec(plan, 1)
    assert type(spec).__name__ == "ProjectSpec"
    rbs = execute_partition_host(plan, 1, _cpu())
    part = df_sales().iloc[334:668]
    assert pa.Table.from_batches(rbs).column("k").to_pylist() == \
        part[part.v > 90].k.tolist()
    assert op_to_spec(mem, 0) is None  # exchanges have no host mapping
