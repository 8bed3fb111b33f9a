"""The PyTorch port's keyed hash aggregate against the JAX package's, on
identical batches (numpy buffers through interop.batch_from_numpy), run
on the CPU, where K3 takes its plain version.

The hash is bit-exact with the JAX one, so groups come out in the same
order: results are compared row for row. Integer, count, key, MIN/MAX
and FIRST/LAST columns must be equal; float SUM/AVG within 1e-12
relative (the sums add in another order on the card); VAR/STDDEV within
1e-9 relative, since they subtract two such sums. NaN equals NaN.
"""

import numpy as np
import pyarrow.types as pat
import pytest

from blaze_tpu import ops as jax_ops
from blaze_tpu.config import EngineConfig as JaxConfig
from blaze_tpu.config import get_config as jax_get_config
from blaze_tpu.config import set_config as jax_set_config
from blaze_tpu.ops.base import ExecContext as JaxContext
from blaze_tpu.runtime.executor import run_plan as jax_run_plan

from blaze_tpu_torch import interop
from blaze_tpu_torch.config import EngineConfig
from blaze_tpu_torch.exprs.ir import AggExpr, AggFn, Col
from blaze_tpu_torch.ops import (
    AggMode,
    ExecContext,
    HashAggregateExec,
    MemoryScanExec,
)
from blaze_tpu_torch.ops import hash_aggregate as port_hash_aggregate
from blaze_tpu_torch.runtime import dispatch
from blaze_tpu_torch.runtime.executor import run_plan
from blaze_tpu_torch.types import DataType, Field, Schema

from test_torch_ops import jx
from torch_support import jax_batch, jax_schema

SCHEMA = Schema([
    Field("k", DataType.int32()),
    Field("k64", DataType.int64()),
    Field("kf", DataType.float32()),
    Field("kb", DataType.bool_()),
    Field("a", DataType.int32()),
    Field("l", DataType.int64()),
    Field("x", DataType.float64()),
    Field("f", DataType.float32()),
    Field("d", DataType.date32()),
])
CAP = 1024
ROWS = [1000, 613, 1024, 37]
NULLABLE = ("k", "kf", "kb", "a", "x")


def _buffers(seed, rows, cap=CAP, n_keys=None):
    rng = np.random.default_rng(seed)
    k = rng.integers(-20, 20, cap).astype(np.int32)
    k64 = rng.integers(-2 ** 40, 2 ** 40, cap, dtype=np.int64)
    k64[: cap // 2] = k64[0]  # one heavy group among many singletons
    kf = rng.choice(np.array([0.0, -0.0, np.nan, 1.5, -2.5, np.inf],
                             np.float32), cap)
    kb = rng.random(cap) < 0.5
    a = rng.integers(-100, 100, cap).astype(np.int32)
    ll = rng.integers(-2 ** 40, 2 ** 40, cap, dtype=np.int64)
    x = (rng.random(cap) - 0.3) * 1000
    x[rng.integers(0, rows, 2)] = np.nan
    f = (rng.random(cap) * 100).astype(np.float32)
    d = rng.integers(-1000, 1000, cap).astype(np.int32)
    if n_keys is not None:
        k = rng.integers(0, n_keys, cap).astype(np.int32)
        k64 = rng.permutation(cap).astype(np.int64) * 7919 + seed * cap
    validity = [(rng.random(cap) < 0.85) if f.name in NULLABLE else None
                for f in SCHEMA]
    sel = rng.random(cap) < 0.9
    return [k, k64, kf, kb, a, ll, x, f, d], validity, sel


def _scans(rows=ROWS, cap=CAP, n_keys=None, nulls=True):
    port, ref = [], []
    for i, n in enumerate(rows):
        values, validity, sel = _buffers(200 + i, n, cap, n_keys)
        if not nulls:
            validity = [None] * len(validity)
        port.append(interop.batch_from_numpy(
            SCHEMA, values, validity, sel, n, "cpu"))
        ref.append(jax_batch(SCHEMA, values, validity, sel, n))
    return (MemoryScanExec([port], SCHEMA),
            jax_ops.MemoryScanExec([ref], jax_schema(SCHEMA)))


ALL_AGGS = [
    (AggFn.COUNT, "a"), (AggFn.COUNT_STAR, None), (AggFn.SUM, "a"),
    (AggFn.SUM, "l"), (AggFn.SUM, "x"), (AggFn.SUM, "f"), (AggFn.AVG, "a"),
    (AggFn.AVG, "f"), (AggFn.MIN, "a"), (AggFn.MAX, "x"), (AggFn.MIN, "f"),
    (AggFn.MAX, "l"), (AggFn.MIN, "d"), (AggFn.MAX, "kb"),
    (AggFn.FIRST, "x"), (AggFn.LAST, "a"), (AggFn.FIRST, "f"),
    (AggFn.VAR_SAMP, "x"), (AggFn.VAR_POP, "f"), (AggFn.STDDEV_SAMP, "a"),
    (AggFn.STDDEV_POP, "d"),
]


def _aggs(spec=ALL_AGGS):
    return [(AggExpr(fn, Col(c) if c else None), f"{fn.value}_{c}")
            for fn, c in spec]


def _jaggs(aggs):
    return [(jx(a), n) for a, n in aggs]


def _run(port_op, jax_op):
    got = run_plan(port_op, ExecContext(config=EngineConfig(device="cpu")))
    exp = jax_run_plan(jax_op, JaxContext(config=jax_get_config(),
                                          mesh_mode="off"))
    return got, exp


def assert_rows_equal(got, exp):
    """Row for row: floats of SUM/AVG within 1e-12 relative, of
    VAR/STDDEV within 1e-9 relative, everything else exact."""
    assert got.schema.names == exp.schema.names
    assert got.num_rows == exp.num_rows
    for name in exp.schema.names:
        g = got.column(name).combine_chunks()
        e = exp.column(name).combine_chunks()
        assert g.type == e.type, name
        np.testing.assert_array_equal(np.asarray(g.is_null()),
                                      np.asarray(e.is_null()), err_msg=name)
        if pat.is_floating(g.type):
            gv = g.fill_null(0).to_numpy()
            ev = e.fill_null(0).to_numpy()
            rtol = 0.0
            if name.startswith(("sum", "avg")):
                rtol = 1e-12
            elif name.startswith(("var", "stddev")):
                rtol = 1e-9
            np.testing.assert_allclose(gv, ev, rtol=rtol, atol=0,
                                       equal_nan=True, err_msg=name)
        else:
            assert g.equals(e), name


KEY_SETS = {
    "int_direct": ["k"],
    "int64_hash": ["k64"],
    "float_nan_zero": ["kf"],
    "multi_bool_float_int": ["kb", "kf", "k"],
}


@pytest.mark.parametrize("keys", list(KEY_SETS))
def test_keyed_complete_matches_jax(keys):
    """COMPLETE over four concatenated batches: null keys, NaN and +/-0.0
    float keys, a bool key, every non-decimal aggregate function."""
    pscan, jscan = _scans()
    key_list = [(Col(c), c) for c in KEY_SETS[keys]]
    aggs = _aggs()
    port = HashAggregateExec(pscan, key_list, aggs, AggMode.COMPLETE)
    ref = jax_ops.HashAggregateExec(jscan, [(jx(e), n) for e, n in key_list],
                                    _jaggs(aggs), jax_ops.AggMode.COMPLETE)
    got, exp = _run(port, ref)
    assert got.num_rows > 3
    assert_rows_equal(got, exp)


def test_keyed_partial_then_final_matches_jax():
    """PARTIAL per batch (state batches equal the JAX package's), then
    FINAL over the stacked states."""
    pscan, jscan = _scans()
    key_list = [(Col("k"), "k"), (Col("kb"), "kb")]
    jkeys = [(jx(e), n) for e, n in key_list]
    aggs = _aggs()
    port_p = HashAggregateExec(pscan, key_list, aggs, AggMode.PARTIAL)
    ref_p = jax_ops.HashAggregateExec(jscan, jkeys, _jaggs(aggs),
                                      jax_ops.AggMode.PARTIAL)
    got, exp = _run(port_p, ref_p)
    assert got.num_rows > len(ROWS)
    assert_rows_equal(got, exp)
    port = HashAggregateExec(port_p, key_list, aggs, AggMode.FINAL)
    ref = jax_ops.HashAggregateExec(ref_p, jkeys, _jaggs(aggs),
                                    jax_ops.AggMode.FINAL)
    got, exp = _run(port, ref)
    assert_rows_equal(got, exp)


@pytest.fixture
def group_capacity_8192(monkeypatch):
    """A second tier of 8192 groups in both packages, so a 16,384-row
    input climbs the ladder 4096 -> 8192 -> unsliced."""
    jax_saved = jax_get_config()
    monkeypatch.setattr(port_hash_aggregate, "_TIER2_GROUPS", 8192)
    jax_set_config(JaxConfig(agg_group_capacity=8192))
    yield
    jax_set_config(jax_saved)


@pytest.mark.parametrize("case", ["direct_over_4096_groups",
                                  "hash_round_bound"])
def test_keyed_ladder_matches_jax(case, group_capacity_8192, monkeypatch):
    """More groups than the first tier's 4096: the direct branch climbs
    to the 8192 tier; 16,000 distinct two-column keys overflow the
    first tier's 16,384-slot table within its 16 probe rounds, then the
    8192 tier's group count, and finish unsliced."""
    monkeypatch.delenv("BLAZE_AGG_TIER1", raising=False)
    if case == "direct_over_4096_groups":
        pscan, jscan = _scans(rows=[4000] * 3, cap=4096, n_keys=6000,
                              nulls=False)
        key_list = [(Col("k"), "k")]
    else:
        pscan, jscan = _scans(rows=[4000] * 4, cap=4096, n_keys=6000,
                              nulls=False)
        key_list = [(Col("k64"), "k64"), (Col("kb"), "kb")]
    aggs = _aggs([(AggFn.COUNT_STAR, None), (AggFn.SUM, "x"),
                  (AggFn.MIN, "f"), (AggFn.FIRST, "a")])
    port = HashAggregateExec(pscan, key_list, aggs, AggMode.COMPLETE)
    ref = jax_ops.HashAggregateExec(jscan, [(jx(e), n) for e, n in key_list],
                                    _jaggs(aggs), jax_ops.AggMode.COMPLETE)
    with dispatch.counting() as c:
        got = run_plan(port, ExecContext(config=EngineConfig(device="cpu")))
    exp = jax_run_plan(ref, JaxContext(config=jax_get_config(),
                                       mesh_mode="off"))
    assert got.num_rows > 4096
    assert_rows_equal(got, exp)
    if case == "direct_over_4096_groups":
        assert c.counts["d2h_syncs.n_groups"] == 2
        assert c.counts.get("d2h_syncs.insert_round", 0) == 0
    else:
        assert c.counts["d2h_syncs.n_groups"] == 3
        # the first tier stops at its bound of 16 rounds
        assert c.counts["d2h_syncs.insert_round"] >= 16 + 2


def test_keyed_empty_input_yields_no_batch():
    """An empty keyed input gives no rows (no global row), as in the JAX
    package; a PARTIAL batch with no live rows is skipped."""
    pscan, jscan = _scans(rows=[])
    aggs = _aggs([(AggFn.COUNT_STAR, None), (AggFn.SUM, "x")])
    key_list = [(Col("k"), "k")]
    port = HashAggregateExec(pscan, key_list, aggs, AggMode.COMPLETE)
    ref = jax_ops.HashAggregateExec(jscan, [(jx(e), n) for e, n in key_list],
                                    _jaggs(aggs), jax_ops.AggMode.COMPLETE)
    got, exp = _run(port, ref)
    assert got.num_rows == exp.num_rows == 0
    assert got.schema.names == exp.schema.names
    values, validity, _ = _buffers(1, 100)
    cb = interop.batch_from_numpy(SCHEMA, values, validity,
                                  np.zeros(CAP, bool), 100, "cpu")
    partial = HashAggregateExec(MemoryScanExec([[cb]], SCHEMA), key_list,
                                aggs, AggMode.PARTIAL)
    assert run_plan(partial, ExecContext(device="cpu")).num_rows == 0


@pytest.mark.parametrize("keyed", [False, True])
@pytest.mark.parametrize("mode", ["complete", "partial_final"])
def test_var_pop_of_one_float64_row_is_zero(keyed, mode):
    """Spark's VAR_POP and STDDEV_POP of a one-row float64 group are 0.0
    (x = 123.456789; the oracle is Spark's: s2 - s1 * mean rounds twice
    to exactly 0). The JAX package's result here is a reference fault:
    XLA contracts s2 - s1 * mean into one FMA
    (blaze_tpu/ops/hash_aggregate.py:1277-1282), which leaves the
    rounding error of s1 * mean behind."""
    import pyarrow as pa

    from blaze_tpu_torch.batch import ColumnBatch

    rb = pa.record_batch({"g": pa.array([7], pa.int32()),
                          "x": pa.array([123.456789], pa.float64())})
    cb = ColumnBatch.from_arrow(rb, device="cpu")
    scan = MemoryScanExec([[cb]], cb.schema)
    keys = [(Col("g"), "g")] if keyed else []
    aggs = [(AggExpr(AggFn.VAR_POP, Col("x")), "vp"),
            (AggExpr(AggFn.STDDEV_POP, Col("x")), "sp")]
    if mode == "complete":
        plan = HashAggregateExec(scan, keys, aggs, AggMode.COMPLETE)
    else:
        plan = HashAggregateExec(
            HashAggregateExec(scan, keys, aggs, AggMode.PARTIAL),
            keys and [(Col("g"), "g")], aggs, AggMode.FINAL)
    out = run_plan(plan, ExecContext(device="cpu")).to_pydict()
    assert out["vp"] == [0.0] and out["sp"] == [0.0]
