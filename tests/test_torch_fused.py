"""Fusion in the port (ops/fused.py, planner/fuse.py) and packed
batches (runtime/pack.py, batch.PackedColumnBatch), on the CPU.

The same TaskDefinition bytes run through both packages'
`execute_task`, and both fuse the decoded plan: the JAX package into
jitted programs, the port into FusedPipelineExec, FusedAggregateExec's
keyless carry and HostFinalAggExec (on the CPU the port's fused nodes
run their code eagerly; the graphs run on the card, in chip_smoke.py).
Tolerances: COUNT exact, SUM within 1e-9 relative (the carry adds batch
sums in stream order), MIN/MAX within 4 ulp (float64 logs and square
roots differ by a few ulp between torch and XLA), everything else
exact. Each JAX result is computed once per module.
"""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from blaze_tpu.config import EngineConfig as JaxConfig
from blaze_tpu.exprs.ir import AggExpr as JAggExpr, AggFn as JAggFn
from blaze_tpu.exprs.ir import Col as JCol
from blaze_tpu.exprs.ir import Literal as JLiteral
from blaze_tpu.exprs.ir import ScalarFn as JScalarFn
from blaze_tpu.ops import (
    AggMode as JAggMode,
    FilterExec as JFilter,
    HashAggregateExec as JAgg,
    ProjectExec as JProject,
)
from blaze_tpu.ops.base import ExecContext as JaxContext
from blaze_tpu.ops.parquet_scan import FileRange as JRange
from blaze_tpu.ops.parquet_scan import ParquetScanExec as JScan
from blaze_tpu.plan.serde import task_to_proto as jax_task_to_proto
from blaze_tpu.runtime.executor import execute_task as jax_execute_task
from blaze_tpu.types import DataType as JDataType

from blaze_tpu_torch.batch import ColumnBatch, PackedColumnBatch
from blaze_tpu_torch.config import EngineConfig
from blaze_tpu_torch.ops import (
    AggMode,
    ExecContext,
    HashAggregateExec,
    ParquetScanExec,
)
from blaze_tpu_torch.ops.fused import (
    FusedAggregateExec,
    FusedPipelineExec,
    HostFinalAggExec,
)
from blaze_tpu_torch.runtime import dispatch
from blaze_tpu_torch.runtime.executor import decode_task, execute_task
from blaze_tpu_torch.types import TypeId

from test_torch_hash_aggregate import assert_rows_equal
from torch_support import assert_arrow_equal, computed_once

ROWS = 5000
BATCH = 1024  # five batches, the last one short: the carry merges


def _write(path, nulls_nan=False, seed=11):
    rng = np.random.default_rng(seed)
    item = rng.integers(0, 1 << 17, ROWS).astype(np.int32)
    qty = rng.integers(1, 10, ROWS).astype(np.int32)
    price = (rng.random(ROWS) * 100).astype(np.float32)
    mask = None
    if nulls_nan:
        price[rng.integers(0, ROWS, 20)] = np.nan
        price[:3] = [-0.0, 0.0, 50.0]
        mask = rng.random(ROWS) < 0.05
        mask[:3] = False
    pq.write_table(pa.table({"item": item, "qty": qty,
                             "price": pa.array(price, mask=mask)}),
                   path, compression="zstd", row_group_size=2048)
    return str(path)


F32 = JDataType.float32()


def _expr_chain_score():
    """bench.py's expr_chain score (bench.py:1142-1149)."""
    rev = JCol("price") * JCol("qty").cast(F32)
    return JScalarFn("ln", (rev + JLiteral(1.0, F32),)) * JScalarFn(
        "sqrt", (JScalarFn("abs", (JCol("price") - JLiteral(50.0, F32),)),))


def _plans(path):
    scan = JScan([[JRange(path)]])
    q6_proj = JProject(
        JFilter(scan, (JCol("price") > 50.0) & (JCol("qty") < 8)),
        [(JCol("price") * JCol("qty").cast(F32), "rev")])
    expr = JProject(JScan([[JRange(path)]]),
                    [(_expr_chain_score().cast(JDataType.float64()), "sc")])
    wide = JProject(
        JFilter(JScan([[JRange(path)]]), JCol("qty") < 8),
        [(JCol("price"), "price"), (JCol("qty"), "qty"),
         (JCol("item"), "item")])
    return {
        "q6": JAgg(q6_proj, keys=[],
                   aggs=[(JAggExpr(JAggFn.SUM, JCol("rev")), "t"),
                         (JAggExpr(JAggFn.COUNT_STAR, None), "n")],
                   mode=JAggMode.COMPLETE),
        "expr_chain": JAgg(expr, keys=[],
                           aggs=[(JAggExpr(JAggFn.SUM, JCol("sc")), "s"),
                                 (JAggExpr(JAggFn.MAX, JCol("sc")), "m")],
                           mode=JAggMode.COMPLETE),
        # every mergeable keyless state: min/max of float and int, avg,
        # counts, the variance family
        "keyless_all": JAgg(wide, keys=[], aggs=[
            (JAggExpr(JAggFn.MIN, JCol("price")), "min_p"),
            (JAggExpr(JAggFn.MAX, JCol("price")), "max_p"),
            (JAggExpr(JAggFn.MIN, JCol("qty")), "min_q"),
            (JAggExpr(JAggFn.MAX, JCol("item")), "max_i"),
            (JAggExpr(JAggFn.AVG, JCol("qty")), "avg_q"),
            (JAggExpr(JAggFn.COUNT, JCol("price")), "cnt_p"),
            (JAggExpr(JAggFn.SUM, JCol("item")), "sum_i"),
            (JAggExpr(JAggFn.VAR_SAMP, JCol("qty")), "var_q"),
            (JAggExpr(JAggFn.STDDEV_POP, JCol("qty")), "stddev_q")],
            mode=JAggMode.COMPLETE),
        "keyless_first": JAgg(wide, keys=[], aggs=[
            (JAggExpr(JAggFn.FIRST, JCol("qty")), "f"),
            (JAggExpr(JAggFn.SUM, JCol("qty")), "s")],
            mode=JAggMode.COMPLETE),
        "keyed": JAgg(wide, keys=[(JCol("qty"), "qty")], aggs=[
            (JAggExpr(JAggFn.SUM, JCol("price")), "sum_p"),
            (JAggExpr(JAggFn.MAX, JCol("price")), "max_p")],
            mode=JAggMode.COMPLETE),
        "select": q6_proj,
    }


PLANS = ["q6", "expr_chain", "keyless_all", "keyless_first", "keyed",
         "select"]
CASES = [(p, n) for p in PLANS for n in (False, True)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{(plan, nulls_nan): (blob, port batches, JAX batches, path)}; the
    JAX side without host filter pushdown (ROADMAP section 3), its
    files, blobs and results made once a session for all xdist
    workers."""
    jax_side = computed_once(tmp_path_factory, "fused-jax-runs",
                             lambda: _jax_runs(tmp_path_factory))
    out = {}
    for key, (blob, exp, path) in jax_side.items():
        got = list(execute_task(blob, ExecContext(
            device="cpu", config=EngineConfig(batch_size=BATCH))))
        out[key] = (blob, got, exp, path)
    return out


def _jax_runs(tmp_path_factory):
    out = {}
    for nulls_nan in (False, True):
        path = _write(tmp_path_factory.mktemp("fused") / "ss.parquet",
                      nulls_nan)
        plans = _plans(path)
        for name in PLANS:
            blob = jax_task_to_proto(plans[name], 0)
            exp = list(jax_execute_task(blob, JaxContext(
                config=JaxConfig(batch_size=BATCH,
                                 host_filter_pushdown=False),
                mesh_mode="off")))
            out[(name, nulls_nan)] = (blob, exp, path)
    return out


def _ulps(a: float, b: float) -> int:
    ia, ib = (np.array([v], np.float64).view(np.int64)[0] for v in (a, b))
    return abs(int(ia) - int(ib))


@pytest.mark.parametrize("plan,nulls_nan", CASES)
def test_fused_task_matches_jax(plan, nulls_nan, runs):
    _, got, exp, _ = runs[(plan, nulls_nan)]
    g, e = pa.Table.from_batches(got), pa.Table.from_batches(exp)
    assert g.schema.names == e.schema.names
    assert [f.type for f in g.schema] == [f.type for f in e.schema]
    if plan == "select":
        assert g.num_rows > 1000
        assert_arrow_equal(g, e)
        return
    if plan == "keyed":
        assert_rows_equal(g.sort_by("qty"), e.sort_by("qty"))
        return
    assert g.num_rows == e.num_rows == 1
    for name in g.schema.names:
        gv, ev = g.column(name)[0].as_py(), e.column(name)[0].as_py()
        if ev is None or gv is None:
            assert gv is None and ev is None, name
        elif isinstance(ev, float) and ev != ev:
            assert gv != gv, name
        elif name in ("t", "s", "sum_i", "avg_q") or \
                name.startswith(("var", "stddev")):
            assert abs(gv - ev) <= 1e-9 * abs(ev), (name, gv, ev)
        elif name == "m":
            assert _ulps(gv, ev) <= 4, (name, gv, ev)
        else:
            assert gv == ev, (name, gv, ev)


def test_expr_chain_numpy_oracles(runs):
    """expr_chain against bench.py's own check (expr_cpu_numpy, 1e-4)
    and a numpy oracle in the plan's own types: rev and +1 in float32,
    ln and sqrt of the float32 values widened to float64, abs(price-50)
    in float32, the product in float64 (SUM 1e-9 relative, MAX 4 ulp)."""
    _, got, _, path = runs[("expr_chain", False)]
    t = pq.read_table(path)
    price = t.column("price").to_numpy()
    qty = t.column("qty").to_numpy()
    s, m = got[0].column(0)[0].as_py(), got[0].column(1)[0].as_py()
    r = price * qty.astype(np.float32)
    bench = (np.log(r + np.float32(1.0))
             * np.sqrt(np.abs(price - np.float32(50.0)))).astype(np.float64)
    assert abs(s - bench.sum()) / max(abs(bench.sum()), 1) < 1e-4
    assert abs(m - bench.max()) / max(abs(bench.max()), 1) < 1e-4
    typed = (np.log((r + np.float32(1.0)).astype(np.float64))
             * np.sqrt(np.abs(price - np.float32(50.0)).astype(np.float64)))
    assert abs(s - typed.sum()) <= 1e-9 * abs(typed.sum())
    assert _ulps(m, typed.max()) <= 4


def _plan_of(runs, plan):
    blob = runs[(plan, False)][0]
    op, _ = decode_task(blob, ExecContext(device="cpu"))
    return op


def test_keyless_task_fuses_into_the_carry(runs):
    op = _plan_of(runs, "q6")
    assert isinstance(op, HostFinalAggExec)
    fused = op.children[0]
    assert isinstance(fused, FusedAggregateExec) and fused.fetch_host
    assert fused.plan == ["add", "add"]
    assert [type(s).__name__ for s in fused.pipeline.stages] == \
        ["FilterExec", "ProjectExec"]
    assert isinstance(fused.children[0], ParquetScanExec)
    assert fused.pipeline.capturable


def test_keyed_task_keeps_its_aggregate_over_a_fused_chain(runs):
    """A keyed COMPLETE task: HostFinalAggExec over a keyed
    FusedAggregateExec (the grouped carry) over its two-stage chain."""
    op = _plan_of(runs, "keyed")
    assert isinstance(op, HostFinalAggExec) and op.template.keys
    assert not op.to_device  # the root: the task boundary reads it
    fused = op.children[0]
    assert isinstance(fused, FusedAggregateExec) and fused.fetch_host
    assert fused.agg.keys and fused.agg.mode is AggMode.PARTIAL
    assert fused.plan == ["add", "max"]
    assert len(fused.pipeline.stages) == 2
    assert isinstance(fused.children[0], ParquetScanExec)
    assert fused.capturable


def test_first_last_stay_unfused_aggregates(runs):
    op = _plan_of(runs, "keyless_first")
    assert isinstance(op, HashAggregateExec) and not op.keys
    assert isinstance(op.children[0], FusedPipelineExec)


def test_select_task_is_one_fused_pipeline(runs):
    op = _plan_of(runs, "select")
    assert isinstance(op, FusedPipelineExec)
    assert isinstance(op.children[0], ParquetScanExec)


def test_keyless_partial_task_is_one_state_row(runs):
    """A keyless PARTIAL task fuses into the carry and emits one state
    row for the stream; FINAL over it equals the COMPLETE task."""
    from blaze_tpu_torch.ops.hash_aggregate import _SchemaStub
    from blaze_tpu_torch.plan.serde import task_to_proto, task_from_proto

    blob = runs[("keyless_all", True)][0]
    complete, _, _, _ = task_from_proto(blob)
    partial = HashAggregateExec(complete.children[0], keys=[],
                                aggs=list(complete.aggs),
                                mode=AggMode.PARTIAL)
    ctx = ExecContext(device="cpu", config=EngineConfig(batch_size=BATCH))
    op, _ = decode_task(task_to_proto(partial, 0), ctx)
    assert isinstance(op, FusedAggregateExec) and not op.fetch_host
    states = list(op.execute(0, ctx))
    assert len(states) == 1 and states[0].num_rows == 1
    final = HashAggregateExec(_SchemaStub(partial.schema), keys=[],
                              aggs=list(complete.aggs), mode=AggMode.FINAL)
    out = final._aggregate_batch(states[0]).to_arrow()
    exp = runs[("keyless_all", True)][1][0]
    assert_rows_equal(pa.Table.from_batches([out]),
                      pa.Table.from_batches([exp]))


def test_cpu_batches_run_eagerly_and_are_counted(runs):
    blob = runs[("q6", False)][0]
    with dispatch.counting() as c:
        list(execute_task(blob, ExecContext(
            device="cpu", config=EngineConfig(batch_size=BATCH))))
    assert c.counts["graph_eager_batches"] == -(-ROWS // BATCH)
    assert "graph_replays" not in c.counts
    assert "graph_captures" not in c.counts


def _key_pipeline(fields, names=("a", "b")):
    """Filter(x > 0) over Project[x AS names[0], y AS names[1]] over a
    leaf of `fields` ((name, DataType)), fused."""
    from blaze_tpu_torch.exprs.ir import Col
    from blaze_tpu_torch.ops import FilterExec, MemoryScanExec, ProjectExec
    from blaze_tpu_torch.types import Field, Schema

    leaf = MemoryScanExec([[]], Schema([Field(n, t) for n, t in fields]))
    proj = ProjectExec(leaf, [(Col("x"), names[0]), (Col("y"), names[1])])
    return FusedPipelineExec(leaf, [proj, FilterExec(proj, Col("a") > 0)])


def _key_cases():
    from blaze_tpu_torch.types import DataType

    i32, f32 = DataType.int32(), DataType.float32()
    base = [("x", i32), ("y", f32), ("z", i32)]
    return {
        # one dtype sequence, another column order
        "swapped_columns": [("z", i32), ("y", f32), ("x", i32)],
        # one physical dtype, another logical type
        "date32_for_int32": [("x", i32), ("y", f32), ("z", DataType.date32())],
        "decimal_scale": ([("x", DataType.decimal(12, 2)), ("y", f32)],
                          [("x", DataType.decimal(12, 3)), ("y", f32)]),
        # one leaf, the project's output names swapped
        "project_names": base,
    }, base


@pytest.mark.parametrize("case", ["swapped_columns", "date32_for_int32",
                                  "decimal_scale", "project_names"])
def test_graph_key_tells_leaf_schemas_and_stage_names_apart(case):
    """Batches of one physical layout share a captured graph only where
    the fused chain's key is equal. The key names the leaf's fields
    (name, logical type, nullability) and each stage's bound
    expressions (each column as its position and type), so two tasks
    whose scans order or type their columns differently, or whose
    projects name their outputs differently, never replay one another's
    graph; the same plan over the same leaf keys equal."""
    cases, base = _key_cases()
    other = cases[case]
    if case == "decimal_scale":
        base, other = other
    names = ("b", "a") if case == "project_names" else ("a", "b")
    k = _key_pipeline(base).structure_key()
    assert _key_pipeline(base).structure_key() == k
    assert _key_pipeline(other, names).structure_key() != k


# ---------------------------------------------------------------------------
# packed batches
# ---------------------------------------------------------------------------

def _all_types_batch(n, with_nulls):
    import datetime
    from decimal import Decimal

    rng = np.random.default_rng(n)

    def m():
        return (rng.random(n) < 0.2) if with_nulls else None

    cols = {
        "b": pa.array(rng.random(n) < 0.5, mask=m()),
        "i8": pa.array(rng.integers(-128, 127, n).astype(np.int8), mask=m()),
        "i16": pa.array(rng.integers(-999, 999, n).astype(np.int16),
                        mask=m()),
        "i32": pa.array(rng.integers(-10 ** 9, 10 ** 9, n).astype(np.int32),
                        mask=m()),
        "i64": pa.array(rng.integers(-2 ** 62, 2 ** 62, n), mask=m()),
        "f32": pa.array(rng.random(n).astype(np.float32), mask=m()),
        "f64": pa.array(np.where(rng.random(n) < 0.1, np.nan,
                                 rng.random(n) - 0.5), mask=m()),
        "d": pa.array([datetime.date(1970, 1, 1)
                       + datetime.timedelta(days=int(v))
                       for v in rng.integers(-10 ** 5, 10 ** 5, n)],
                      pa.date32(), mask=m()),
        "ts": pa.array(rng.integers(-2 ** 50, 2 ** 50, n),
                       pa.timestamp("us"), mask=m()),
        "dec": pa.array([Decimal(int(v)) / 100 for v in
                         rng.integers(-10 ** 9, 10 ** 9, n)],
                        pa.decimal128(12, 2), mask=m()),
        "nul": pa.nulls(n),
    }
    return pa.record_batch(cols)


@pytest.mark.parametrize("n,with_nulls", [(1, False), (300, True),
                                          (1024, False), (3000, True)])
def test_packed_batch_round_trips_every_dtype(n, with_nulls):
    """Every port dtype (bool, int8-64, float32/64, date32, timestamp,
    decimal(<=18), the NULL type), with and without NULLs, packed into
    one buffer and read back through to_arrow, equals the input and the
    unpacked batch; every column is a view of the one buffer, whose
    header holds the live row count."""
    rb = _all_types_batch(n, with_nulls)
    packed = PackedColumnBatch.from_arrow(rb, device="cpu")
    plain = ColumnBatch.from_arrow(rb, device="cpu")
    assert int(packed.buf[:8].view(torch.int64)[0]) == n
    lo = packed.buf.data_ptr()
    hi = lo + packed.buf.numel()
    for c, p in zip(packed.columns, plain.columns):
        for t, u in ((c.values, p.values), (c.validity, p.validity)):
            assert (t is None) == (u is None)
            if t is None:
                continue
            assert lo <= t.data_ptr() < hi and t.data_ptr() % 16 == 0
            assert t.dtype == u.dtype and t.shape == u.shape
            # bit for bit, NaN and padding included
            assert torch.equal(t.view(torch.uint8), u.view(torch.uint8))
    assert packed.key[0] == packed.capacity
    assert_arrow_equal(pa.Table.from_batches([packed.to_arrow()]),
                       pa.Table.from_batches([rb]))
    assert packed.schema.field("nul").dtype.id is TypeId.NULL


def test_scan_yields_packed_batches(runs):
    path = runs[("q6", True)][3]
    scan = ParquetScanExec([[__import__(
        "blaze_tpu_torch.ops", fromlist=["FileRange"]).FileRange(path)]])
    ctx = ExecContext(device="cpu", config=EngineConfig(batch_size=BATCH))
    batches = list(scan.execute(0, ctx))
    assert len(batches) == -(-ROWS // BATCH)
    assert all(isinstance(b, PackedColumnBatch) for b in batches)
    # the short last batch keeps its bucket's layout key
    assert batches[-1].num_rows == ROWS % BATCH
    assert batches[-1].key == batches[0].key or \
        batches[-1].capacity != batches[0].capacity


def test_one_k1_call_serves_every_reduction_of_a_column(monkeypatch):
    """SUM, MIN, MAX and AVG of one nullable column share one masked
    statistics call (K1 on the card) and one contributing-row mask;
    another column takes its own."""
    from blaze_tpu_torch import interop
    from blaze_tpu_torch.exprs.ir import AggExpr, AggFn, Col
    from blaze_tpu_torch.ops import hash_aggregate as ha
    from blaze_tpu_torch.ops.hash_aggregate import _SchemaStub
    from blaze_tpu_torch.ops.kernels.stats import masked_stats
    from blaze_tpu_torch.types import DataType, Field, Schema

    calls = []

    def counted(v, mask, scratch=None):
        calls.append(v)
        return masked_stats(v, mask, scratch)

    monkeypatch.setattr(ha, "masked_stats", counted)
    schema = Schema([Field("x", DataType.float64()),
                     Field("y", DataType.int32())])
    rng = np.random.default_rng(3)
    cb = interop.batch_from_numpy(
        schema, [rng.random(256), rng.integers(0, 9, 256).astype(np.int32)],
        [rng.random(256) < 0.8, None], None, 200, "cpu")
    agg = HashAggregateExec(_SchemaStub(schema), keys=[], aggs=[
        (AggExpr(fn, Col("x")), f"{fn.value}_x")
        for fn in (AggFn.SUM, AggFn.MIN, AggFn.MAX, AggFn.AVG)
    ] + [(AggExpr(AggFn.MAX, Col("y")), "max_y")], mode=AggMode.COMPLETE)
    out = agg._aggregate_batch(cb).to_arrow()
    assert len(calls) == 2
    x = cb.columns[0].values.numpy()[:200]
    x = x[cb.columns[0].validity.numpy()[:200]]
    assert out.column("min_x")[0].as_py() == x.min()
    assert out.column("max_x")[0].as_py() == x.max()
    assert abs(out.column("sum_x")[0].as_py() - x.sum()) <= 1e-12 * x.sum()
