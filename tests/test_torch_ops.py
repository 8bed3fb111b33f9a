"""The PyTorch port's filter, project and aggregate against the JAX
package's operators, on identical batches (numpy buffers through
interop.batch_from_numpy), run on the CPU.

Expressions are built in the port's IR and cross to the JAX IR through
the shared wire format. Outputs must be Arrow-equal, except float sums,
which agree within 1e-12 of the sum of magnitudes (summation order
differs).
"""

import numpy as np
import pytest

from blaze_tpu import ops as jax_ops
from blaze_tpu.config import EngineConfig as JaxConfig
from blaze_tpu.ops.base import ExecContext as JaxContext
from blaze_tpu.plan import plan_pb2 as jax_pb
from blaze_tpu.plan import serde as jax_serde
from blaze_tpu.runtime.executor import run_plan as jax_run_plan

from blaze_tpu_torch import interop
from blaze_tpu_torch.config import EngineConfig
from blaze_tpu_torch.exprs.ir import AggExpr, AggFn, Col
from blaze_tpu_torch.ops import (
    AggMode,
    ExecContext,
    FilterExec,
    HashAggregateExec,
    MemoryScanExec,
    ProjectExec,
)
from blaze_tpu_torch.plan import serde
from blaze_tpu_torch.runtime.executor import run_plan
from blaze_tpu_torch.types import DataType, Field, Schema

from torch_support import assert_arrow_equal, jax_batch, jax_schema

SCHEMA = Schema([
    Field("a", DataType.int32()),
    Field("l", DataType.int64()),
    Field("x", DataType.float64()),
    Field("f", DataType.float32()),
    Field("p", DataType.bool_()),
    Field("d", DataType.date32()),
])
CAP = 1024
ROWS = [1000, 613, 1024, 37]


def jx(e):
    """The same expression in the JAX package's IR, across the wire."""
    wire = serde.expr_to_proto(e).SerializeToString()
    return jax_serde.expr_from_proto(jax_pb.ExprProto.FromString(wire))


def _batch_buffers(seed, rows, nan=True, nulls=True):
    rng = np.random.default_rng(seed)
    a = rng.integers(-100, 100, CAP).astype(np.int32)
    ll = rng.integers(-2 ** 40, 2 ** 40, CAP, dtype=np.int64)
    x = (rng.random(CAP) - 0.3) * 1000
    if nan:
        x[rng.integers(0, rows, 2)] = np.nan
    f = (rng.random(CAP) * 100).astype(np.float32)
    p = rng.random(CAP) < 0.5
    d = rng.integers(-1000, 1000, CAP).astype(np.int32)
    validity = [
        (rng.random(CAP) < 0.8) if nulls and name in ("a", "x", "p")
        else None
        for name in SCHEMA.names()
    ]
    sel = rng.random(CAP) < 0.9
    return [a, ll, x, f, p, d], validity, sel


def _scans(nan=True, nulls=True, n_batches=len(ROWS)):
    port, ref = [], []
    for i, rows in enumerate(ROWS[:n_batches]):
        values, validity, sel = _batch_buffers(100 + i, rows, nan, nulls)
        port.append(interop.batch_from_numpy(
            SCHEMA, values, validity, sel, rows, "cpu"))
        ref.append(jax_batch(SCHEMA, values, validity, sel, rows))
    return (MemoryScanExec([port], SCHEMA),
            jax_ops.MemoryScanExec([ref], jax_schema(SCHEMA)))


def _run(port_op, jax_op, max_rows=1 << 22):
    got = run_plan(port_op, ExecContext(config=EngineConfig(
        device="cpu", max_materialize_rows=max_rows)))
    exp = jax_run_plan(jax_op, JaxContext(
        config=JaxConfig(max_materialize_rows=max_rows), mesh_mode="off"))
    return got, exp


PREDICATE = (Col("x") > 0.0) & (Col("a") < 60)
PROJECTION = [
    (Col("a"), "a"),
    (Col("x") * 2.0, "x2"),
    (Col("f") * Col("a").cast(DataType.float32()), "fa"),
    (Col("l") + Col("a"), "la"),
    (Col("p"), "p"),
    (Col("d"), "d"),
]


def test_filter_project_matches_jax():
    pscan, jscan = _scans()
    port = ProjectExec(FilterExec(pscan, PREDICATE), PROJECTION)
    ref = jax_ops.ProjectExec(jax_ops.FilterExec(jscan, jx(PREDICATE)),
                              [(jx(e), n) for e, n in PROJECTION])
    got, exp = _run(port, ref)
    assert got.num_rows > 0
    assert_arrow_equal(got, exp)


AGGS = [
    (AggFn.COUNT, "a"), (AggFn.COUNT_STAR, None), (AggFn.SUM, "a"),
    (AggFn.SUM, "l"), (AggFn.SUM, "x"), (AggFn.SUM, "f"), (AggFn.AVG, "a"),
    (AggFn.AVG, "f"), (AggFn.MIN, "a"), (AggFn.MAX, "x"), (AggFn.MIN, "f"),
    (AggFn.MAX, "l"), (AggFn.MIN, "d"), (AggFn.MAX, "p"),
]


def _agg_list(fa_sum=False):
    aggs = [(AggExpr(fn, Col(c) if c else None), f"{fn.value}_{c}")
            for fn, c in AGGS]
    if fa_sum:
        aggs.append((AggExpr(AggFn.SUM, Col("fa")), "sum_fa"))
    return aggs


def _assert_agg_equal(got, exp):
    """One row; float SUM/AVG within 1e-12 relative (the inputs have no
    heavy cancellation, so this is within 1e-12 of the sum of
    magnitudes), everything else exact, NaN equal to NaN."""
    assert got.num_rows == exp.num_rows == 1
    assert got.schema.names == exp.schema.names
    for name in exp.schema.names:
        g, e = got.column(name), exp.column(name)
        assert g.type == e.type, name
        gv, ev = g[0].as_py(), e[0].as_py()
        if isinstance(ev, float) and ev != ev:
            assert gv != gv, name
        elif isinstance(ev, float) and name.startswith(("sum", "avg")):
            assert abs(gv - ev) <= 1e-12 * abs(ev), (name, gv, ev)
        else:
            assert gv == ev, (name, gv, ev)


@pytest.mark.parametrize("variant", ["complete", "external", "filtered",
                                     "all_filtered", "no_nan"])
def test_keyless_aggregate_matches_jax(variant):
    """COMPLETE keyless aggregates: concatenated input, the external
    per-batch fold (max_materialize_rows crossed), behind a filter and
    project, with every row filtered away (null SUM, COUNT 0)."""
    pscan, jscan = _scans(nan=variant != "no_nan")
    aggs = _agg_list()
    port_in, jax_in = pscan, jscan
    if variant in ("filtered", "all_filtered"):
        pred = PREDICATE if variant == "filtered" else Col("a") > 1000
        proj = [(Col(n), n) for n in SCHEMA.names()] + [
            (Col("f") * Col("a").cast(DataType.float32()), "fa")]
        port_in = ProjectExec(FilterExec(pscan, pred), proj)
        jax_in = jax_ops.ProjectExec(jax_ops.FilterExec(jscan, jx(pred)),
                                     [(jx(e), n) for e, n in proj])
        aggs = _agg_list(fa_sum=True)
    port = HashAggregateExec(port_in, [], aggs, AggMode.COMPLETE)
    ref = jax_ops.HashAggregateExec(jax_in, [],
                                    [(jx(a), n) for a, n in aggs],
                                    jax_ops.AggMode.COMPLETE)
    got, exp = _run(port, ref,
                    max_rows=1500 if variant == "external" else 1 << 22)
    _assert_agg_equal(got, exp)
    if variant == "all_filtered":
        assert got.column("count_star_None")[0].as_py() == 0
        assert got.column("sum_x")[0].as_py() is None


def test_partial_then_final_matches_jax():
    """PARTIAL per batch, FINAL over the stacked state rows."""
    pscan, jscan = _scans(nan=False)
    aggs = _agg_list()
    jaggs = [(jx(a), n) for a, n in aggs]
    port_p = HashAggregateExec(pscan, [], aggs, AggMode.PARTIAL)
    ref_p = jax_ops.HashAggregateExec(jscan, [], jaggs,
                                      jax_ops.AggMode.PARTIAL)
    got, exp = _run(port_p, ref_p)
    assert got.schema.names == exp.schema.names
    assert got.num_rows == exp.num_rows == len(ROWS)
    port = HashAggregateExec(port_p, [], aggs, AggMode.FINAL)
    ref = jax_ops.HashAggregateExec(ref_p, [], jaggs, jax_ops.AggMode.FINAL)
    got, exp = _run(port, ref)
    _assert_agg_equal(got, exp)


def test_empty_input_gives_the_global_row():
    """No input batches: COUNT 0 and every other aggregate NULL
    (_empty_global_row), as in the JAX package."""
    pscan, jscan = _scans(n_batches=0)
    aggs = _agg_list()
    port = HashAggregateExec(pscan, [], aggs, AggMode.COMPLETE)
    ref = jax_ops.HashAggregateExec(jscan, [],
                                    [(jx(a), n) for a, n in aggs],
                                    jax_ops.AggMode.COMPLETE)
    got, exp = _run(port, ref)
    assert_arrow_equal(got, exp)


@pytest.mark.parametrize("keys,aggs", [
    ([(Col("a"), "a")], [(AggExpr(AggFn.COUNT_STAR, None), "n")]),
    ([], [(AggExpr(AggFn.VAR_POP, Col("x")), "var"),
          (AggExpr(AggFn.STDDEV_SAMP, Col("f")), "std")]),
    ([], [(AggExpr(AggFn.FIRST, Col("x")), "v"),
          (AggExpr(AggFn.LAST, Col("a")), "w")]),
], ids=["grouped", "variance", "first"])
def test_second_slice_aggregates_match_jax(keys, aggs):
    """What the first slice refused and this one runs: a keyed COUNT(*),
    keyless VAR/STDDEV and FIRST/LAST, against the JAX package (NaN
    rows included; variance within 1e-9 relative, the rest exact)."""
    pscan, jscan = _scans()
    port = HashAggregateExec(pscan, keys, aggs, AggMode.COMPLETE)
    ref = jax_ops.HashAggregateExec(jscan, [(jx(e), n) for e, n in keys],
                                    [(jx(a), n) for a, n in aggs],
                                    jax_ops.AggMode.COMPLETE)
    got, exp = _run(port, ref)
    assert got.num_rows == exp.num_rows > 0
    assert got.schema == exp.schema
    for name in exp.schema.names:
        g = got.column(name).to_numpy(zero_copy_only=False)
        e = exp.column(name).to_numpy(zero_copy_only=False)
        np.testing.assert_allclose(g.astype(float), e.astype(float),
                                   rtol=1e-9 if name in ("var", "std") else 0,
                                   equal_nan=True, err_msg=name)


NARROW = Schema([
    Field("b", DataType.int8()),
    Field("h", DataType.int16()),
    Field("p", DataType.bool_()),
])


def _narrow_scans():
    """Batches of int8, int16 and bool columns with nulls and a
    selection, the same in both packages."""
    port, ref = [], []
    for i, rows in enumerate(ROWS):
        rng = np.random.default_rng(200 + i)
        values = [rng.integers(-128, 128, CAP).astype(np.int8),
                  rng.integers(-2 ** 15, 2 ** 15, CAP).astype(np.int16),
                  rng.random(CAP) < 0.7]
        validity = [rng.random(CAP) < 0.8 for _ in values]
        sel = rng.random(CAP) < 0.9
        port.append(interop.batch_from_numpy(
            NARROW, values, validity, sel, rows, "cpu"))
        ref.append(jax_batch(NARROW, values, validity, sel, rows))
    return (MemoryScanExec([port], NARROW),
            jax_ops.MemoryScanExec([ref], jax_schema(NARROW)))


@pytest.mark.parametrize("col", ["b", "h", "p"])
@pytest.mark.parametrize("mode", ["complete", "partial_final"])
def test_keyless_narrow_columns_match_jax(mode, col):
    """SUM, MIN, MAX and AVG over an int8, int16 or bool column, keyless,
    COMPLETE or PARTIAL per batch then FINAL: K1 takes the column in its
    own dtype (no widening pass before it), against the JAX package."""
    pscan, jscan = _narrow_scans()
    aggs = [(AggExpr(fn, Col(col)), f"{fn.value}_{col}")
            for fn in (AggFn.SUM, AggFn.MIN, AggFn.MAX, AggFn.AVG)]
    jaggs = [(jx(a), n) for a, n in aggs]
    if mode == "complete":
        port = HashAggregateExec(pscan, [], aggs, AggMode.COMPLETE)
        ref = jax_ops.HashAggregateExec(jscan, [], jaggs,
                                        jax_ops.AggMode.COMPLETE)
    else:
        port = HashAggregateExec(
            HashAggregateExec(pscan, [], aggs, AggMode.PARTIAL), [], aggs,
            AggMode.FINAL)
        ref = jax_ops.HashAggregateExec(
            jax_ops.HashAggregateExec(jscan, [], jaggs,
                                      jax_ops.AggMode.PARTIAL),
            [], jaggs, jax_ops.AggMode.FINAL)
    got, exp = _run(port, ref)
    _assert_agg_equal(got, exp)


_WIDE = Schema([
    Field("s", DataType.utf8()), Field("w", DataType.decimal(30, 2)),
    Field("m", DataType.decimal(12, 2)), Field("a", DataType.int32()),
])


# decimal SUM/AVG run since the decimal128 slice: what stays refused is
# what the JAX package refuses, in its words (a decimal(>18) group key,
# MIN/MAX of a decimal(>18) value)
@pytest.mark.parametrize("schema,keys,aggs,match", [
    (_WIDE, [(Col("w"), "w")], [(AggExpr(AggFn.SUM, Col("m")), "t")],
     "group keys of decimal\\(>18\\) are host-tier work"),
    (_WIDE, [(Col("s"), "s")], [(AggExpr(AggFn.MIN, Col("w")), "t")],
     "min over decimal\\(>18\\) is host-tier work"),
    (_WIDE, [(Col("w"), "w")], [(AggExpr(AggFn.COUNT_STAR, None), "n")],
     "group keys of decimal\\(>18\\) are host-tier work"),
    # MIN/MAX over strings are host-tier work in both packages
    (_WIDE, [], [(AggExpr(AggFn.MIN, Col("s")), "lo")], "host-tier"),
], ids=["decimal_sum", "string_key", "wide_decimal_key", "string_min"])
def test_out_of_slice_aggregates_raise(schema, keys, aggs, match):
    """What the JAX package refuses raises at construction, in its
    words."""
    scan = MemoryScanExec([[]], schema)
    with pytest.raises(NotImplementedError, match=match):
        HashAggregateExec(scan, keys, aggs, AggMode.COMPLETE)


def test_keyed_input_over_materialize_limit_raises():
    """A keyed COMPLETE input over max_materialize_rows no longer raises
    (it did until the exchange tier, ROADMAP item 6, was ported): it
    takes grace aggregation, whose groups equal the in-memory
    aggregate's (tests/test_torch_exchange.py holds grace against the
    JAX package)."""
    pscan, _ = _scans()
    keyed = HashAggregateExec(pscan, [(Col("a"), "a")],
                              [(AggExpr(AggFn.COUNT_STAR, None), "n")],
                              AggMode.COMPLETE)
    ctx = ExecContext(config=EngineConfig(device="cpu",
                                          max_materialize_rows=1500))
    got = run_plan(keyed, ctx)
    assert ctx.metrics.counters["external_agg_buckets"] == 32
    whole = run_plan(keyed, ExecContext(device="cpu"))
    order = [("a", "ascending")]
    assert_arrow_equal(got.sort_by(order), whole.sort_by(order))
    assert sum(got.column("n").to_pylist()) == sum(
        int(b.live_mask().sum()) for b in pscan.partitions[0])
