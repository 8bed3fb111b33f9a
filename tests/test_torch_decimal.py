"""decimal128 in the PyTorch port against the JAX package and Python's
Decimal, on the CPU.

The port's twins of tests/test_decimal128.py, tests/test_decimal_casts.py
and the decimal, round, NULL-group/join, NaN and bigint goldens of
tests/test_spark_semantics_goldens.py, plus the port's own checks: the
int128 primitives against the JAX package's and Python ints, a decimal
SUM through a TaskDefinition round trip and the fused keyless carry,
decimal(>18) payloads through every join core and the grace buckets,
and the key refusals in the JAX package's words.

Both packages read the same Arrow batches (so the same numpy limbs).
Results are exact: Arrow-equal after a canonical row order, and equal
to the Python Decimal oracle; DIV to float64 is within the reference's
own tolerance (assert_allclose's 1e-7). Each JAX reference runs once
per session, over every case at once (`computed_once`), so JAX compiles
a handful of programs in all.
"""

import decimal
from decimal import ROUND_HALF_UP, Decimal

import numpy as np
import pyarrow as pa
import pytest
import torch

from blaze_tpu import ColumnBatch as JBatch
from blaze_tpu import ops as J
from blaze_tpu.exprs import int128 as ji128
from blaze_tpu.exprs.ir import AggExpr as JAgg, AggFn as JFn, Col as JCol
from blaze_tpu.plan import plan_pb2 as jax_pb
from blaze_tpu.plan import serde as jax_serde
from blaze_tpu.runtime.executor import run_plan as jax_run_plan

from blaze_tpu_torch import interop
from blaze_tpu_torch.batch import ColumnBatch
from blaze_tpu_torch.config import EngineConfig, get_config, set_config
from blaze_tpu_torch.exprs import int128 as i128
from blaze_tpu_torch.exprs.ir import (
    AggExpr,
    AggFn,
    BinaryOp,
    Col,
    Literal,
    Op,
)
from blaze_tpu_torch.ops import (
    AggMode,
    ExecContext,
    FilterExec,
    HashAggregateExec,
    MemoryScanExec,
    ProjectExec,
    SortExec,
)
from blaze_tpu_torch.ops.sort import SortKey
from blaze_tpu_torch.plan import serde
from blaze_tpu_torch.runtime.executor import run_plan
from blaze_tpu_torch.types import DataType

from torch_support import assert_arrow_equal, computed_once

CPU = ExecContext(device="cpu")
D38 = 10**38 - 1


def _dec(unscaled, scale):
    """Python Decimal of an unscaled int, exactly."""
    with decimal.localcontext() as c:
        c.prec = 80
        return Decimal(unscaled).scaleb(-scale)


def _unscaled(d, scale):
    with decimal.localcontext() as c:
        c.prec = 80
        return int(d.scaleb(scale))


def _arr(unscaled, p, s):
    return pa.array([None if u is None else _dec(u, s) for u in unscaled],
                    pa.decimal128(p, s))


def _scan(rb):
    cb = ColumnBatch.from_arrow(rb, device="cpu")
    return MemoryScanExec([[cb]], cb.schema)


def _jscan(rb):
    cb = JBatch.from_arrow(rb)
    return J.MemoryScanExec([[cb]], cb.schema)


def jx(e):
    """The same expression in the JAX package's IR, across the wire."""
    wire = serde.expr_to_proto(e).SerializeToString()
    return jax_serde.expr_from_proto(jax_pb.ExprProto.FromString(wire))


def _sorted(t, keys):
    return t.sort_by([(k, "ascending") for k in keys])


# ---------------------------------------------------------------------------
# int128 primitives
# ---------------------------------------------------------------------------

EDGES = [0, 1, -1, 1 << 63, -(1 << 63), (1 << 63) - 1, 1 << 64,
         -(1 << 64), (1 << 64) - 1, D38, -D38, 10**37, -(10**37),
         (1 << 127) - 1, -(1 << 127)]


def _pairs(n=600, seed=11):
    rng = np.random.default_rng(seed)
    vals = list(EDGES)
    while len(vals) < n:
        bits = int(rng.integers(1, 128))
        v = int.from_bytes(rng.bytes(16), "little") % (1 << bits)
        vals.append(-v if rng.random() < 0.5 else v)
    a = vals
    b = vals[len(EDGES):] + vals[:len(EDGES)]
    rng.shuffle(b)
    return a, b


def _limbs(vals):
    return np.array([i128.python_limbs(v) for v in vals], dtype=np.int64)


def _value(lo, hi):
    return (int(hi) << 64) | (int(lo) & ((1 << 64) - 1))


@pytest.fixture(scope="module")
def int128_cases(tmp_path_factory):
    """Every signed op of the port and the JAX package on the same limb
    pairs; the JAX side runs eagerly, op by op."""
    import jax.numpy as jnp

    a, b = _pairs()
    out = {"port": _int128_ops(a, b, i128, torch.from_numpy)}
    out["jax"] = computed_once(tmp_path_factory, "decimal-int128",
                               lambda: _int128_ops(a, b, ji128, jnp.asarray))
    return a, b, out


def _int128_ops(a, b, mod, conv):
    """{op: its output lanes as numpy (uint64 read as int64)}."""
    la, lb = _limbs(a), _limbs(b)
    ma = mod.from_limbs(conv(la[:, 0]), conv(la[:, 1]))
    mb = mod.from_limbs(conv(lb[:, 0]), conv(lb[:, 1]))
    res = {"add": mod.signed_add(ma, mb)}
    for down in (0, 2, 10, 19, 28):
        res[f"mul{down}"] = mod.signed_mul(ma, mb, down)
    for k in (1, 19, 20, 37):
        res[f"up{k}"] = mod.rescale_up(ma[0], ma[1], k) + (ma[2],)
    for k in (1, 9, 10, 28):
        lo, hi = mod.div_pow10_half_up(ma[0], ma[1], k)
        res[f"div{k}"] = (lo, hi, ma[2])
    res["float"] = (mod.to_float64(conv(la[:, 0]), conv(la[:, 1])),)
    res["narrow"] = mod.from_narrow(conv(la[:, 0]))
    return {k: [np.asarray(x).view(np.int64) if np.asarray(x).dtype
                == np.uint64 else np.asarray(x) for x in v]
            for k, v in res.items()}


@pytest.mark.parametrize("op", ["add", "mul0", "mul2", "mul10", "mul19",
                                "mul28", "up1", "up19", "up20", "up37",
                                "div1", "div9", "div10", "div28", "float",
                                "narrow"])
def test_int128_ops_match_jax_bit_for_bit(int128_cases, op):
    """The int64-only formulation gives the JAX package's uint64 bits."""
    _, _, out = int128_cases
    for p, j in zip(out["port"][op], out["jax"][op]):
        np.testing.assert_array_equal(p, j)


def test_int128_ops_match_python_ints(int128_cases):
    a, b, out = int128_cases
    port = out["port"]

    def signed(lo, hi, neg):
        mag = _value(lo, hi) & ((1 << 128) - 1)
        return -mag if neg else mag

    fits = [abs(x) <= D38 and abs(y) <= D38 for x, y in zip(a, b)]
    mlo, mhi, neg, ok = port["add"]
    for i, (x, y) in enumerate(zip(a, b)):
        if fits[i]:
            assert bool(ok[i]) == (abs(x + y) <= D38)
            if ok[i]:
                assert signed(mlo[i], mhi[i], neg[i]) == x + y
    for down in (0, 2, 10, 19, 28):
        mlo, mhi, neg, ok = port[f"mul{down}"]
        for i, (x, y) in enumerate(zip(a, b)):
            p = abs(x * y)
            if abs(x) >= 1 << 127 or abs(y) >= 1 << 127:
                continue
            if p >= 1 << 128:
                assert not ok[i]
                continue
            q, r = divmod(p, 10**down)
            q += 2 * r >= 10**down
            assert bool(ok[i]) == (q <= D38), (x, y, down)
            if ok[i]:
                want = -q if (x < 0) != (y < 0) else q
                assert signed(mlo[i], mhi[i], neg[i]) == want
    for k in (1, 19, 20, 37):
        lo, hi, ovf, _ = port[f"up{k}"]
        for i, x in enumerate(a):
            if abs(x) < 1 << 127:
                e = abs(x) * 10**k
                assert bool(ovf[i]) == (e >= 1 << 128)
                if not ovf[i]:
                    assert _value(lo[i], hi[i]) & ((1 << 128) - 1) == e
    lo, hi = port["narrow"][:2]
    for i, (x_lo, _) in enumerate(_limbs(a)):
        assert _value(lo[i], hi[i]) & ((1 << 128) - 1) == abs(int(x_lo))


# ---------------------------------------------------------------------------
# batches: scan round trip, interop, packed batches
# ---------------------------------------------------------------------------

WIDE = [0, 1, -1, 1 << 100, -(1 << 100), 10**37, -(10**37), D38, -D38,
        (1 << 64) - 1, 1 << 64, -(1 << 63), None]


def test_wide_decimal_scan_roundtrip():
    """A decimal(38, 2) column loads as (cap, 2) limbs, the JAX
    package's bytes, and leaves Arrow-equal; interop carries the JAX
    batch's padded limbs across; a packed batch holds them too."""
    from blaze_tpu_torch.batch import PackedColumnBatch

    rb = pa.record_batch({"d": _arr(WIDE, 38, 2),
                          "n": _arr([5, -5, None] * 4 + [7], 18, 3)})
    cb = ColumnBatch.from_arrow(rb, device="cpu")
    jb = JBatch.from_arrow(rb)
    assert tuple(cb.columns[0].values.shape) == (256, 2)
    np.testing.assert_array_equal(cb.columns[0].values.numpy(),
                                  np.asarray(jb.columns[0].values))
    assert cb.to_arrow().equals(rb)
    assert ColumnBatch.from_pydict(rb.to_pydict(), cb.schema,
                                   device="cpu").to_arrow().equals(rb)
    assert cb.slice_host(3, 6).to_arrow().equals(rb.slice(3, 6))
    back = interop.batch_from_numpy(
        cb.schema, [np.asarray(c.values) for c in jb.columns],
        [None if c.validity is None else np.asarray(c.validity)
         for c in jb.columns], None, jb.num_rows, "cpu")
    assert back.to_arrow().equals(rb)
    vals, _, _, _ = interop.batch_to_numpy(back)
    np.testing.assert_array_equal(vals[0], np.asarray(jb.columns[0].values))
    with pytest.raises(ValueError, match="shape"):
        interop.batch_from_numpy(cb.schema, [vals[1], vals[1]],
                                 [None, None], None, 4, "cpu")
    packed = PackedColumnBatch.from_arrow(rb, device="cpu")
    assert tuple(packed.columns[0].values.shape) == (256, 2)
    assert packed.to_arrow().equals(rb)
    # the D2H fetch's packing (`get_packed` on the card) keeps shapes
    from blaze_tpu_torch.runtime.pack import concat_bytes, split_bytes

    parts = [c.values for c in cb.columns] + [cb.columns[0].validity]
    for got, t in zip(split_bytes(concat_bytes(parts).numpy(), parts),
                      parts):
        np.testing.assert_array_equal(got, t.numpy())


# ---------------------------------------------------------------------------
# SUM / AVG: keyless, keyed, PARTIAL -> Arrow IPC -> FINAL
# ---------------------------------------------------------------------------

AGG_ROWS = 300


def _agg_batch(seed=7, rows=AGG_ROWS):
    """Groups g; n: decimal(18, 2) whose sums pass int64; w: decimal(38,
    2) past 2^64 (below 2^104, so AVG at scale 6 fits); o: decimal(38,
    0) near 10^38, whose group 0 overflows decimal(38); NULLs in each,
    and a group that is all NULL."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 6, rows)
    n = [int(x) for x in rng.integers(-10**17, 10**17, rows)]
    w = [int(x) << int(s) for x, s in zip(
        rng.integers(-(1 << 60), 1 << 60, rows), rng.integers(0, 44, rows))]
    o = [D38 if gi == 0 else int(x)
         for gi, x in zip(g, rng.integers(-10**15, 10**15, rows))]
    for col in (n, w, o):
        for i in rng.choice(rows, rows // 10, replace=False):
            col[i] = None
    for i in range(rows):
        if g[i] == 5:
            n[i] = w[i] = o[i] = None
    return pa.record_batch({
        "g": pa.array(g.astype(np.int32)),
        "n": _arr(n, 18, 2), "w": _arr(w, 38, 2), "o": _arr(o, 38, 0)})


AGGS = [(AggFn.SUM, "n"), (AggFn.AVG, "n"), (AggFn.SUM, "w"),
        (AggFn.AVG, "w"), (AggFn.SUM, "o"), (AggFn.COUNT, "w"),
        (AggFn.FIRST, "w")]
#: the PARTIAL -> FINAL cases leave COUNT out: its state is a plain
#: int64 count, and the JAX FINAL compiles a second apiece
PF_AGGS = [a for a in AGGS if a[0] is not AggFn.COUNT]


def _aggs(agg_cls, col_cls, fn_cls, aggs=AGGS):
    return [(agg_cls(fn_cls(f.value), col_cls(c)), f"{f.value}_{c}")
            for f, c in aggs]


def _oracle_group(rows_of):
    """Python-int SUM / HALF_UP AVG per aggregate over one group's rows."""
    out = {}
    for f, c in AGGS:
        vals = [v for v in rows_of[c] if v is not None]
        scale = {"n": 2, "w": 2, "o": 0}[c]
        name = f"{f.value}_{c}"
        if f is AggFn.COUNT:
            out[name] = len(vals)
            continue
        if f is AggFn.FIRST:  # the first non-NULL value, as both packages
            out[name] = vals[0] if vals else None
            continue
        if not vals:
            out[name] = None
            continue
        us = [_unscaled(v, scale) for v in vals]
        if f is AggFn.SUM:
            t = sum(us)
            out[name] = None if abs(t) > D38 else _dec(t, scale)
        else:
            with decimal.localcontext() as ctx:
                ctx.prec = 80
                q = int((Decimal(sum(us)) * 10**4 / Decimal(len(us)))
                        .to_integral_value(ROUND_HALF_UP))
            out[name] = None if abs(q) > D38 else _dec(q, scale + 4)
    return out


def _oracle(rb, keyed):
    d = rb.to_pydict()
    groups = sorted(set(d["g"])) if keyed else [None]
    rows = []
    for gv in groups:
        idx = [i for i, x in enumerate(d["g"]) if keyed is False or x == gv]
        r = _oracle_group({c: [d[c][i] for i in idx] for c in d})
        if keyed:
            r = {"g": gv, **r}
        rows.append(r)
    return rows


def _partial_final(rb, keyed, port):
    """PARTIAL over two halves, each state batch through Arrow IPC
    bytes (the shuffle's slot), then FINAL."""
    from blaze_tpu_torch.io.ipc import decode_ipc_parts, encode_ipc_segment

    keys = [(Col("g"), "g")] if keyed else []
    jkeys = [(JCol("g"), "g")] if keyed else []
    halves = [rb.slice(0, AGG_ROWS // 2), rb.slice(AGG_ROWS // 2)]
    if port:
        parts, schema = [], None
        for h in halves:
            p = HashAggregateExec(_scan(h), keys, _aggs(AggExpr, Col, AggFn, PF_AGGS),
                                  AggMode.PARTIAL)
            schema = p.schema
            for cb in p.execute(0, CPU):
                wire = encode_ipc_segment(cb.to_arrow())
                for back in decode_ipc_parts(wire):
                    parts.append(ColumnBatch.from_arrow(back, device="cpu"))
        final = HashAggregateExec(MemoryScanExec([parts], schema), keys,
                                  _aggs(AggExpr, Col, AggFn, PF_AGGS), AggMode.FINAL)
        return run_plan(final, CPU)
    parts, schema = [], None
    for h in halves:
        p = J.HashAggregateExec(_jscan(h), jkeys, _aggs(JAgg, JCol, JFn, PF_AGGS),
                                J.AggMode.PARTIAL)
        schema = p.schema
        for cb in p.execute(0, J.ExecContext()):
            parts.append(JBatch.from_arrow(cb.to_arrow()))
    final = J.HashAggregateExec(J.MemoryScanExec([parts], schema), jkeys,
                                _aggs(JAgg, JCol, JFn, PF_AGGS), J.AggMode.FINAL)
    return jax_run_plan(final)


AGG_CASES = ["keyless", "keyed", "keyless_partial_final",
             "keyed_partial_final"]


@pytest.fixture(scope="module")
def agg_results(tmp_path_factory):
    rb = _agg_batch()
    refs = computed_once(tmp_path_factory, "decimal-aggs",
                         lambda: _jax_aggs(rb))
    out = {}
    for case in AGG_CASES:
        keyed = case.startswith("keyed")
        if case.endswith("partial_final"):
            out[case] = (_partial_final(rb, keyed, True), refs.get(case))
            continue
        keys = [(Col("g"), "g")] if keyed else []
        out[case] = (run_plan(HashAggregateExec(
            _scan(rb), keys, _aggs(AggExpr, Col, AggFn), AggMode.COMPLETE),
            CPU), None)
    return rb, out


def _jax_aggs(rb):
    """The JAX package's result of the keyed PARTIAL -> FINAL case: its
    states, reductions and reassembly. (Its keyless COMPLETE decimal
    SUM/AVG is held by the TaskDefinition twin below; every case is
    held to the Python Decimal oracle.)"""
    return {"keyed_partial_final": _partial_final(rb, True, False)}


@pytest.mark.parametrize("case", AGG_CASES)
def test_decimal_sum_avg_match_jax_and_decimal(agg_results, case):
    """SUM and AVG of decimal(18, 2) past int64, of decimal(38, 2) past
    2^64 and of decimal(38, 0) past decimal(38) (NULL), COUNT and FIRST
    of a wide column, equal to the Python Decimal oracle; the keyed
    PARTIAL -> IPC -> FINAL case also Arrow-equal to the JAX package."""
    rb, results = agg_results
    got, exp = results[case]
    keyed = case.startswith("keyed")
    if keyed:
        got = _sorted(got, ["g"])
    if exp is not None:
        assert_arrow_equal(got, _sorted(exp, ["g"]))
    for want, row in zip(_oracle(rb, keyed), got.to_pylist()):
        for k, v in row.items():
            assert v == want[k], (case, k, v, want[k])
    sums = got.column("sum_w").to_pylist()
    assert any(v is not None and abs(_unscaled(v, 2)) >= 1 << 64
               for v in sums)
    assert any(v is not None for v in got.column("avg_w").to_pylist())
    assert got.column("sum_o").to_pylist()[0] is None  # past decimal(38)
    assert got.schema.field("avg_w").type == pa.decimal128(38, 6)
    assert got.schema.field("sum_n").type == pa.decimal128(38, 2)


# ---------------------------------------------------------------------------
# expressions: comparisons, the routing gate, arithmetic, casts
# ---------------------------------------------------------------------------

CMP_VALS = [0, 1, -1, 1 << 70, -(1 << 70), (1 << 70) + 1, 1 << 100,
            -(1 << 100), 10**37, -(10**37), (1 << 64) - 1, 1 << 64]
PIVOT = 1 << 70
CMP_OPS = [("gt", Op.GT, lambda a, b: a > b), ("lt", Op.LT, lambda a, b: a < b),
           ("gte", Op.GTE, lambda a, b: a >= b),
           ("lte", Op.LTE, lambda a, b: a <= b),
           ("eq", Op.EQ, lambda a, b: a == b),
           ("neq", Op.NEQ, lambda a, b: a != b)]


def _cmp_batch():
    n = len(CMP_VALS) + 1
    return pa.record_batch({"d": _arr(CMP_VALS + [None], 38, 2),
                            "d2": _arr([PIVOT] * n, 38, 2)})


@pytest.mark.parametrize("name", [n for n, _, _ in CMP_OPS])
def test_wide_decimal_comparisons(name, cmp_results):
    """The two-limb compare, across the 64-bit limb boundary, with
    negatives and a NULL: FilterExec against Python ints, and the
    comparison's values against the JAX evaluator's."""
    op, pyop = {n: (o, f) for n, o, f in CMP_OPS}[name]
    rb = _cmp_batch()
    got = run_plan(FilterExec(_scan(rb), BinaryOp(op, Col("d"), Col("d2"))),
                   CPU).column("d").to_pylist()
    assert [_unscaled(v, 2) for v in got] == \
        [v for v in CMP_VALS if pyop(v, PIVOT)]
    port, ref = cmp_results
    assert port.column(name).equals(ref.column(name))


def _wide_literal():
    """decimal(38, 2) literal 2^62 - 1 (unscaled): it fits the wire's
    int64 literal."""
    return Literal((1 << 62) - 1, DataType.decimal(38, 2))


@pytest.fixture(scope="module")
def cmp_results(tmp_path_factory):
    """Every comparison, and a comparison with a wide literal, as one
    projection in each package (one JAX program)."""
    rb = _cmp_batch()
    exprs = [(BinaryOp(op, Col("d"), Col("d2")), n) for n, op, _ in CMP_OPS]
    exprs.append((BinaryOp(Op.LT, Col("d"), _wide_literal()), "lit"))
    port = run_plan(ProjectExec(_scan(rb), exprs), CPU)
    ref = computed_once(tmp_path_factory, "decimal-compare",
                        lambda: jax_run_plan(J.ProjectExec(
                            _jscan(rb), [(jx(e), n) for e, n in exprs])))
    return port, ref


def test_wide_literal_comparison_matches_jax(cmp_results):
    port, ref = cmp_results
    assert port.column("lit").equals(ref.column("lit"))
    assert port.column("lit").to_pylist() == [
        v < (1 << 62) - 1 for v in CMP_VALS] + [None]


def test_wide_decimal_routing_gate():
    """The JAX package's gate: a float comparand and nested wide
    arithmetic raise at construction in both packages, with its words;
    direct +, -, *, / and comparisons run; a passthrough stays exact."""
    rb = pa.record_batch({"d": _arr([1 << 90, 5], 38, 2)})
    cases = [
        (FilterExec, J.FilterExec, lambda C: C("d") > 1.0,
         "predicates on decimal(>18) are host-tier work"),
        (lambda s, e: ProjectExec(s, [(e, "x")]),
         lambda s, e: J.ProjectExec(s, [(e, "x")]),
         lambda C: (C("d") + 1) + 2,
         "compute on decimal(>18) is host-tier work"),
    ]
    for port_op, jax_op, build, words in cases:
        with pytest.raises(NotImplementedError) as pe:
            port_op(_scan(rb), build(Col))
        with pytest.raises(NotImplementedError) as je:
            jax_op(_jscan(rb), build(JCol))
        assert str(pe.value) == str(je.value) == words
    got = run_plan(ProjectExec(_scan(rb), [(Col("d") + 1, "x"),
                                           (Col("d"), "d")]), CPU)
    assert [_unscaled(v, 2) for v in got.column("x").to_pylist()] == \
        [(1 << 90) + 100, 105]
    assert got.column("d").to_pylist() == rb.column("d").to_pylist()


ARITH = [(2, 2, Op.ADD), (4, 4, Op.SUB), (0, 0, Op.ADD), (2, 2, Op.MUL),
         (6, 3, Op.MUL), (9, 9, Op.MUL)]
ARITH_ROWS = 400


def _arith_batch(seed=31):
    rng = np.random.default_rng(seed)

    def rand_unscaled(max_digits):
        digits = int(rng.integers(1, max_digits + 1))
        v = int("".join(map(str, rng.integers(0, 10, digits))))
        return -v if rng.random() < 0.5 else v

    cols = {}
    raw = {}
    for i, (ls, rs, _) in enumerate(ARITH):
        lu = [rand_unscaled(38) for _ in range(ARITH_ROWS)]
        ru = [rand_unscaled(30) for _ in range(ARITH_ROWS)]
        for j in range(0, ARITH_ROWS, 5):  # narrow magnitudes too
            ru[j] = rand_unscaled(9)
            lu[j] = rand_unscaled(18)
        raw[i] = (lu, ru)
        cols[f"l{i}"] = _arr(lu, 38, ls)
        cols[f"r{i}"] = _arr(ru, 38, rs)
    return pa.record_batch(cols), raw


def _arith_exprs():
    out = [(BinaryOp(op, Col(f"l{i}"), Col(f"r{i}")), f"x{i}")
           for i, (_, _, op) in enumerate(ARITH)]
    # a narrow operand, a wide literal, DIV to float64
    out += [(BinaryOp(Op.ADD, Col("l0"), Col("n")), "wide_plus_narrow"),
            (BinaryOp(Op.MUL, Col("l0"), _wide_literal()), "times_lit"),
            (BinaryOp(Op.DIV, Col("l0"), Col("r0")), "div")]
    return out


@pytest.fixture(scope="module")
def arith_results(tmp_path_factory):
    rb, raw = _arith_batch()
    rng = np.random.default_rng(4)
    rb = rb.append_column("n", _arr(
        [int(x) for x in rng.integers(-10**17, 10**17, ARITH_ROWS)], 18, 2))
    exprs = _arith_exprs()
    port = run_plan(ProjectExec(_scan(rb), exprs), CPU)
    # the JAX evaluator holds a wide literal as one int64 lane, which
    # its wide arithmetic cannot index: times_lit is the port's alone
    ref = computed_once(tmp_path_factory, "decimal-arith",
                        lambda: jax_run_plan(J.ProjectExec(_jscan(rb), [
                            (jx(e), n) for e, n in exprs
                            if n != "times_lit"])))
    return rb, raw, port, ref


@pytest.mark.parametrize("i", range(len(ARITH)))
def test_wide_decimal_arith_fuzz_vs_python_decimal(arith_results, i):
    """128-bit +, -, * against Python Decimal with HALF_UP at the result
    scale; past decimal(38), and for a product past 128 bits (the JAX
    package's documented deviation), NULL. Equal to the JAX package."""
    rb, raw, port, ref = arith_results
    ls, rs, op = ARITH[i]
    name = f"x{i}"
    assert port.column(name).equals(ref.column(name))
    out_scale = port.schema.field(name).type.scale
    pyop = {Op.ADD: lambda a, b: a + b, Op.SUB: lambda a, b: a - b,
            Op.MUL: lambda a, b: a * b}[op]
    got = port.column(name).to_pylist()
    lu, ru = raw[i]
    with decimal.localcontext() as ctx:
        ctx.prec = 200
        for j in range(ARITH_ROWS):
            exact = pyop(Decimal(lu[j]).scaleb(-ls),
                         Decimal(ru[j]).scaleb(-rs))
            want = int(exact.scaleb(out_scale).to_integral_value(
                ROUND_HALF_UP))
            if (op is Op.MUL and abs(lu[j] * ru[j]) >= 1 << 128) \
                    or abs(want) > D38:
                assert got[j] is None, (j, got[j])
            else:
                assert int(got[j].scaleb(out_scale)) == want, (j, op)


def test_wide_decimal_mixed_operands_match_jax(arith_results):
    """A narrow operand and DIV (float64, within the reference's
    tolerance) against the JAX package and Decimal; a wide literal
    operand against Decimal."""
    rb, raw, port, ref = arith_results
    assert port.column("wide_plus_narrow").equals(
        ref.column("wide_plus_narrow"))
    lu, ru = raw[0]
    n = rb.column("n").to_pylist()
    got = port.column("wide_plus_narrow").to_pylist()
    lit = port.column("times_lit").to_pylist()
    lit_scale = port.schema.field("times_lit").type.scale
    for j in range(ARITH_ROWS):
        want = lu[j] + _unscaled(n[j], 2)
        assert (got[j] is None) == (abs(want) > D38)
        if got[j] is not None:
            assert _unscaled(got[j], 2) == want
        # (l / 100) * (lit / 100), HALF_UP at the result scale
        p, down = lu[j] * ((1 << 62) - 1), 10 ** (4 - lit_scale)
        q, r = divmod(abs(p), down)
        q += 2 * r >= down
        want = -q if p < 0 else q
        assert (lit[j] is None) == (abs(want) > D38 or abs(p) >= 1 << 128)
        if lit[j] is not None:
            assert _unscaled(lit[j], lit_scale) == want
    div = port.column("div").to_pylist()
    np.testing.assert_allclose(
        np.array(div, dtype=float),
        np.array(ref.column("div").to_pylist(), dtype=float))
    np.testing.assert_allclose(  # x / 0 is NULL
        np.array(div, dtype=float),
        [a / b if b else np.nan for a, b in zip(lu, ru)])


def _run_expr(expr, rb):
    """The port evaluator's values of one expression, as Python values
    (unscaled ints for decimals, as the JAX test reads them)."""
    from blaze_tpu_torch.exprs.eval import DeviceEvaluator
    from blaze_tpu_torch.exprs.ir import bind

    cb = ColumnBatch.from_arrow(rb, device="cpu")
    ev = DeviceEvaluator(cb.schema, [(c.values, c.validity)
                                     for c in cb.columns],
                         cb.capacity, cb.device)
    v, m = ev.evaluate(bind(expr, cb.schema))
    n = cb.num_rows
    vals = v[:n].numpy()
    mask = m[:n].numpy() if m is not None else np.ones(n, dtype=bool)
    if vals.ndim == 2:
        return [_value(*vals[i]) if mask[i] else None for i in range(n)]
    return [vals[i].item() if mask[i] else None for i in range(n)]


def _dec_col(vals, p=10, s=2):
    return pa.array([None if v is None else Decimal(v) for v in vals],
                    type=pa.decimal128(p, s))


def test_decimal_casts_twin():
    """tests/test_decimal_casts.py on the port: narrow +, -, * and the
    rescale casts on unscaled int64, DIV to float64, the unscaled round
    trip, timestamp/date casts and the int32 wrap."""
    from blaze_tpu_torch.exprs.ir import ScalarFn

    rb = pa.record_batch([_dec_col(["1.50", "2.25", None]),
                          _dec_col(["0.50", "1.00", "9.99"])],
                         names=["a", "b"])
    assert _run_expr(Col("a") + Col("b"), rb) == [200, 325, None]
    assert _run_expr(Col("a") - Col("b"), rb) == [100, 125, None]
    rb = pa.record_batch([_dec_col(["1.50"]), _dec_col(["2.00"])],
                         names=["a", "b"])
    assert _run_expr(Col("a") * Col("b"), rb) == [300]
    rb = pa.record_batch([_dec_col(["3.00"]), _dec_col(["2.00"])],
                         names=["a", "b"])
    np.testing.assert_allclose(_run_expr(Col("a") / Col("b"), rb), [1.5])
    rb = pa.record_batch([_dec_col(["1.00", "2.50"]),
                          _dec_col(["1.00", "2.49"])], names=["a", "b"])
    assert _run_expr(Col("a") == Col("b"), rb) == [True, False]
    assert _run_expr(Col("a") > Col("b"), rb) == [False, True]
    e = ScalarFn("spark_make_decimal",
                 (ScalarFn("spark_unscaled_value", (Col("a"),)),))
    assert _run_expr(e, rb) == [100, 250]
    rb = pa.record_batch([_dec_col(["1.25"])], names=["a"])
    assert _run_expr(Col("a").cast(DataType.decimal(12, 4)), rb) == [12500]
    assert _run_expr(Col("a").cast(DataType.decimal(12, 1)), rb) == [12]
    np.testing.assert_allclose(
        _run_expr(Col("a").cast(DataType.float64()), rb), [1.25])
    assert _run_expr(Col("a").cast(DataType.int64()), rb) == [1]
    rb = pa.record_batch({"t": pa.array(
        [86_400_000_000 + 3_600_000_000, 0]).cast(pa.timestamp("us"))})
    assert _run_expr(Col("t").cast(DataType.date32()), rb)[1] == 0
    assert _run_expr(Col("t").cast(DataType.date32()).cast(
        DataType.timestamp_us()), rb) == [86_400_000_000, 0]
    rb = pa.record_batch({"a": pa.array([2**31 - 1], type=pa.int32())})
    assert _run_expr(Col("a").cast(DataType.int32())
                     + Col("a").cast(DataType.int32()), rb) == [-2]


def test_wide_casts_against_python():
    """Casts with a decimal(>18) side, 128-bit exact: narrow and
    integer to wide, wide rescale up (NULL past decimal(38)) and down
    (truncated toward zero, as the narrow cast), wide to narrow, to
    float64, to int64 and to bool."""
    wide = [0, 1, -1, 12345, -12345, 1 << 100, -(1 << 100), 10**36, None]
    rb = pa.record_batch({"w": _arr(wide, 38, 2),
                          "n": _arr([5, -5, 0, 10**17, -10**17, 7, -7, 1,
                                     None], 18, 2),
                          "i": pa.array([3, -3, 0, 2**62, -2**62, 1, 2, 3,
                                         None], pa.int64())})
    assert _run_expr(Col("n").cast(DataType.decimal(38, 6)), rb) == [
        50000, -50000, 0, 10**21, -10**21, 70000, -70000, 10000, None]
    assert _run_expr(Col("i").cast(DataType.decimal(38, 3)), rb) == [
        3000, -3000, 0, 2**62 * 1000, -2**62 * 1000, 1000, 2000, 3000,
        None]
    assert _run_expr(Col("w").cast(DataType.decimal(38, 4)), rb) == [
        None if v is None or abs(v * 100) > D38 else v * 100 for v in wide]
    assert _run_expr(Col("w").cast(DataType.decimal(38, 0)), rb) == [
        None if v is None else (abs(v) // 100) * (1 if v >= 0 else -1)
        for v in wide]
    assert _run_expr(Col("w").cast(DataType.decimal(10, 1)), rb)[:5] == [
        0, 0, 0, 1234, -1234]
    np.testing.assert_allclose(
        _run_expr(Col("w").cast(DataType.float64()), rb)[:8],
        [v / 100 for v in wide[:8]])
    assert _run_expr(Col("w").cast(DataType.int64()), rb)[:5] == [
        0, 0, 0, 123, -123]
    assert _run_expr(Col("w").cast(DataType.bool_()), rb) == [
        None if v is None else v != 0 for v in wide]


# ---------------------------------------------------------------------------
# sort keys: both cores, the top-k route, the run merge, the host sort
# ---------------------------------------------------------------------------

def _sort_batch(seed=5, rows=600):
    rng = np.random.default_rng(seed)
    vals = [int(x) << int(s) for x, s in zip(
        rng.integers(-(1 << 60), 1 << 60, rows - 20),
        rng.integers(0, 66, rows - 20))]
    vals += [0, 1, -1, (1 << 64) - 1, 1 << 64, -(1 << 64), 1 << 63,
             -(1 << 63), D38, -D38, 10**37, None, None, None] + \
        [int(x) for x in rng.integers(-5, 5, 6)]
    return pa.record_batch({"d": _arr(vals, 38, 2),
                            "rid": pa.array(np.arange(rows, dtype=np.int32)),
                            "z": pa.array(np.zeros(rows, np.int32))}), vals


SORT_ROUTES = {
    # name: (sort_core, fetch, max_materialize_rows, batch_size, key)
    "packed": ("auto", None, None, 16384, "col"),
    "lexsort": ("sort", None, None, 16384, "col"),
    "topk": ("auto", 40, 250, 128, "col"),
    "run_merge": ("auto", None, 250, 64, "col"),
    "host": ("auto", None, 250, 128, "expr"),
}


@pytest.mark.parametrize("asc,nulls_first", [(True, True), (False, False)])
@pytest.mark.parametrize("route", sorted(SORT_ROUTES))
def test_wide_decimal_sort_keys(route, asc, nulls_first):
    """decimal(>18) sort keys order exactly as Python ints across the
    limb boundary, both directions, NULLs placed as asked, on every
    route; rows move with their keys; the route and core counters name
    the path taken."""
    from blaze_tpu_torch.runtime import dispatch

    core, fetch, limit, bs, key = SORT_ROUTES[route]
    rb, vals = _sort_batch()
    saved = get_config()
    cfg = EngineConfig(device="cpu", sort_core=core, batch_size=bs,
                       max_materialize_rows=limit or (1 << 22),
                       shape_buckets=(64, 128, 256, 1024))
    set_config(cfg)
    try:
        cbs = [ColumnBatch.from_arrow(b, device="cpu")
               for b in pa.Table.from_batches([rb]).to_batches(
                   max_chunksize=bs)]
        scan = MemoryScanExec([cbs], cbs[0].schema)
        e = Col("d") if key == "col" else BinaryOp(Op.ADD, Col("d"),
                                                    Col("z"))
        with dispatch.counting() as c:
            got = run_plan(SortExec(scan, [SortKey(e, asc, nulls_first)],
                                    fetch), ExecContext(device="cpu",
                                                        config=cfg))
    finally:
        set_config(saved)
    route_name = {"packed": "in_memory", "lexsort": "in_memory"}.get(
        route, route)
    assert c.counts.get(f"sort_route.{route_name}", 0) == 1
    if route in ("packed", "lexsort"):
        assert c.counts.get(f"sort_core.{route}", 0) >= 1
        assert not c.counts.get("sort_core." + (
            "lexsort" if route == "packed" else "packed"))
    nn = sorted((v for v in vals if v is not None), reverse=not asc)
    n_null = vals.count(None)
    want = [None] * n_null + nn if nulls_first else nn + [None] * n_null
    if fetch is not None:
        want = want[:fetch]
    d = got.column("d").to_pylist()
    assert [None if x is None else _unscaled(x, 2) for x in d] == want
    rid = got.column("rid").to_pylist()
    assert [vals[r] for r in rid] == want


def test_wide_decimal_sort_matches_jax(tmp_path_factory):
    """The in-memory device sort, Arrow-equal to the JAX package's."""
    rb, _ = _sort_batch()
    port = run_plan(SortExec(_scan(rb), [SortKey(Col("d"), False)]), CPU)
    ref = computed_once(tmp_path_factory, "decimal-sort",
                        lambda: jax_run_plan(J.SortExec(
                            _jscan(rb), [J.SortKey(JCol("d"), False)])))
    assert_arrow_equal(port, ref)


# ---------------------------------------------------------------------------
# TaskDefinitions: a decimal SUM through the wire and the fused carry
# ---------------------------------------------------------------------------

TASK_ROWS = 5000
TASK_BATCH = 1024


def _task_plan(mod, ops, path, keyed):
    """Filter(price > 50.00 AND qty < 8) -> Project(price * qty, price
    cast to decimal(38, 4)) -> SUM/AVG of both and COUNT(*), keyless
    COMPLETE or keyed (item % 7) PARTIAL, in one package's classes."""
    C, L, A, F = mod["Col"], mod["Literal"], mod["AggExpr"], mod["AggFn"]
    T = mod["DataType"]
    scan = ops.ParquetScanExec([[ops.FileRange(path)]])
    filt = ops.FilterExec(scan, (C("price") > L(5000, T.decimal(7, 2)))
                          & (C("qty") < L(8, T.int32())))
    proj = ops.ProjectExec(filt, [
        (C("item") % L(7, T.int32()), "g"),
        (C("price") * C("qty"), "rev"),
        (C("price").cast(T.decimal(38, 4)), "wide")])
    aggs = _task_aggs(A, F, C)
    return ops.HashAggregateExec(
        proj, [(C("g"), "g")] if keyed else [], aggs,
        ops.AggMode.PARTIAL if keyed else ops.AggMode.COMPLETE)


def _task_aggs(A=AggExpr, F=AggFn, C=Col):
    return [(A(F.SUM, C("rev")), "sum_rev"), (A(F.AVG, C("rev")), "avg_rev"),
            (A(F.SUM, C("wide")), "sum_wide"),
            (A(F.AVG, C("wide")), "avg_wide"),
            (A(F.COUNT_STAR, None), "n")]


def _modules(jax_side):
    if jax_side:
        import blaze_tpu.exprs.ir as m
        from blaze_tpu.types import DataType as T
    else:
        import blaze_tpu_torch.exprs.ir as m
        T = DataType
    return {"Col": m.Col, "Literal": m.Literal, "AggExpr": m.AggExpr,
            "AggFn": m.AggFn, "DataType": T}


def _ops(jax_side):
    import types

    if jax_side:
        from blaze_tpu.ops import parquet_scan as ps
        o = J
    else:
        import blaze_tpu_torch.ops as o
        from blaze_tpu_torch.ops import parquet_scan as ps
    return types.SimpleNamespace(
        ParquetScanExec=ps.ParquetScanExec, FileRange=ps.FileRange,
        FilterExec=o.FilterExec, ProjectExec=o.ProjectExec,
        HashAggregateExec=o.HashAggregateExec, AggMode=o.AggMode)


@pytest.fixture(scope="module")
def decimal_tasks(tmp_path_factory):
    """store_sales-like parquet (price decimal(7, 2), qty, item) and,
    per plan, (port blob, JAX blob, port batches, JAX batches, dispatch
    counts of the port run). The file and the JAX runs (of the port's
    blobs) are made once a session."""
    from blaze_tpu_torch.runtime import dispatch
    from blaze_tpu_torch.runtime.executor import execute_task

    path, tbl, jax_runs = computed_once(
        tmp_path_factory, "decimal-tasks",
        lambda: _jax_tasks(tmp_path_factory))
    out = {"table": tbl}
    for keyed in (False, True):
        port_blob = serde.task_to_proto(
            _task_plan(_modules(False), _ops(False), path, keyed), 0)
        jax_blob, exp = jax_runs[keyed]
        with dispatch.counting() as c:
            got = list(execute_task(jax_blob, ExecContext(
                device="cpu", config=EngineConfig(batch_size=TASK_BATCH))))
        out[keyed] = (port_blob, jax_blob, got, exp, dict(c.counts))
    return out


def _jax_tasks(tmp_path_factory):
    import pyarrow.parquet as pq

    from blaze_tpu.config import EngineConfig as JaxConfig
    from blaze_tpu.ops.base import ExecContext as JaxContext
    from blaze_tpu.runtime.executor import execute_task as jax_execute_task

    rng = np.random.default_rng(8)
    price = rng.integers(100, 20000, TASK_ROWS)
    price_valid = rng.random(TASK_ROWS) > 0.05
    tbl = pa.table({
        "item": pa.array(rng.integers(0, 1000, TASK_ROWS).astype(np.int32)),
        "qty": pa.array(rng.integers(1, 11, TASK_ROWS).astype(np.int32)),
        "price": _arr([int(p) if v else None
                       for p, v in zip(price, price_valid)], 7, 2)})
    path = str(tmp_path_factory.mktemp("dec") / "ss.parquet")
    pq.write_table(tbl, path, row_group_size=2048)
    runs = {}
    for keyed in (False, True):
        port_blob = serde.task_to_proto(
            _task_plan(_modules(False), _ops(False), path, keyed), 0)
        jax_blob = jax_serde.task_to_proto(
            _task_plan(_modules(True), _ops(True), path, keyed), 0)
        # the keyed states are held to the JAX package by the
        # PARTIAL -> FINAL twin above; here only the keyless task runs
        runs[keyed] = (jax_blob, None if keyed else list(jax_execute_task(
            port_blob, JaxContext(config=JaxConfig(
                batch_size=TASK_BATCH, host_filter_pushdown=False),
                mesh_mode="off"))))
    return path, tbl, runs


def _task_oracle(tbl, keyed):
    d = tbl.to_pydict()
    groups = {}
    for item, qty, price in zip(d["item"], d["qty"], d["price"]):
        if price is None or not (price > Decimal("50.00") and qty < 8):
            continue
        g = groups.setdefault(item % 7 if keyed else None,
                              {"rev": [], "wide": []})
        g["rev"].append(_unscaled(price, 2) * qty)
        g["wide"].append(_unscaled(price, 2) * 100)
    return groups


def _half_up_div(num, den):
    q, r = divmod(abs(num), den)
    q += 2 * r >= den
    return -q if num < 0 else q


def test_decimal_task_round_trips_the_wire(decimal_tasks):
    """The port writes the JAX package's TaskDefinition bytes for a
    decimal plan (decimal(7, 2) literal, decimal(38, 4) cast, chunked
    SUM/AVG states), keyless COMPLETE and keyed PARTIAL. Each package
    runs the other's keyless bytes to the same Arrow result; the port's
    keyed states, merged by a FINAL, equal the Python oracle."""
    for keyed in (False, True):
        port_blob, jax_blob, got, exp, _ = decimal_tasks[keyed]
        assert port_blob == jax_blob
    _, _, got, exp, _ = decimal_tasks[False]
    assert_arrow_equal(pa.Table.from_batches(got),
                       pa.Table.from_batches(exp))
    states = decimal_tasks[True][2]
    assert states[0].schema.names[1:6] == [
        "sum_rev#dsum2_c0", "sum_rev#dsum2_c1", "sum_rev#dsum2_c2",
        "sum_rev#dsum2_c3", "avg_rev#dsum2_c0"]
    cbs = [ColumnBatch.from_arrow(rb, device="cpu") for rb in states]
    final = run_plan(HashAggregateExec(
        MemoryScanExec([cbs], cbs[0].schema), [(Col("g"), "g")],
        [(AggExpr(a.fn, None), n) for a, n in _task_aggs()],
        AggMode.FINAL), CPU)
    oracle = _task_oracle(decimal_tasks["table"], True)
    for row in final.to_pylist():
        g = oracle[row["g"]]
        assert row["n"] == len(g["rev"])
        assert _unscaled(row["sum_rev"], 2) == sum(g["rev"])
        assert _unscaled(row["avg_rev"], 6) == _half_up_div(
            sum(g["rev"]) * 10**4, len(g["rev"]))
        assert _unscaled(row["sum_wide"], 4) == sum(g["wide"])
        assert _unscaled(row["avg_wide"], 8) == _half_up_div(
            sum(g["wide"]) * 10**4, len(g["wide"]))
    assert final.num_rows == len(oracle) == 7


def test_keyless_decimal_sum_runs_in_the_fused_carry(decimal_tasks):
    """The keyless decimal SUM/AVG decodes into HostFinalAggExec over
    the fused carry (one graph replay a batch on the card; every batch
    eager and counted on the CPU) and equals the Python Decimal
    oracle: exact sums, AVG HALF_UP at scale + 4."""
    from blaze_tpu_torch.ops.fused import FusedAggregateExec, HostFinalAggExec
    from blaze_tpu_torch.runtime.executor import decode_task

    port_blob, _, got, _, counts = decimal_tasks[False]
    op, _ = decode_task(port_blob, CPU)
    assert isinstance(op, HostFinalAggExec)
    assert isinstance(op.children[0], FusedAggregateExec)
    assert op.children[0].plan == ["add"] * 19  # 4 + 5 + 4 + 5 + 1
    assert counts["graph_eager_batches"] == -(-TASK_ROWS // TASK_BATCH)
    assert "graph_captures" not in counts
    g = _task_oracle(decimal_tasks["table"], False)[None]
    row = pa.Table.from_batches(got).to_pylist()[0]
    assert row["n"] == len(g["rev"])
    assert _unscaled(row["sum_rev"], 2) == sum(g["rev"])
    assert _unscaled(row["avg_rev"], 6) == _half_up_div(
        sum(g["rev"]) * 10**4, len(g["rev"]))
    assert _unscaled(row["sum_wide"], 4) == sum(g["wide"])
    assert _unscaled(row["avg_wide"], 8) == _half_up_div(
        sum(g["wide"]) * 10**4, len(g["wide"]))


def test_wide_literal_past_int64_fails_alike_on_the_wire():
    """A decimal literal crosses as the proto's int64 `int_value`
    (blaze_tpu/plan/serde.py:138-139), in both packages: one past int64
    fails to serialize in both, one inside it round trips."""
    from blaze_tpu.exprs.ir import Literal as JLiteral
    from blaze_tpu.types import DataType as JDataType

    big = 1 << 70
    with pytest.raises(ValueError) as pe:
        serde.expr_to_proto(Literal(big, DataType.decimal(38, 2)))
    with pytest.raises(ValueError) as je:
        jax_serde.expr_to_proto(JLiteral(big, JDataType.decimal(38, 2)))
    assert type(pe.value) is type(je.value)
    ok = Literal((1 << 62) - 1, DataType.decimal(38, 10))
    wire = serde.expr_to_proto(ok).SerializeToString()
    back = serde.expr_from_proto(
        serde.pb.ExprProto.FromString(wire))
    assert back.value == ok.value and back.dtype == ok.dtype
    assert jx(ok).dtype.precision == 38


# ---------------------------------------------------------------------------
# joins: decimal(>18) payloads through every core and the grace buckets
# ---------------------------------------------------------------------------

def _join_sides(dup, seed=3):
    """A build side of 120 rows (keys unique or repeating) and a probe
    side of 200 rows in two batches; int32, int64 and float32 copies of
    each key and a decimal(38, 2) payload past 2^64, with NULLs."""
    rng = np.random.default_rng(seed)

    def side(n, keys, prefix):
        w = [int(x) << int(s) for x, s in zip(
            rng.integers(-(1 << 60), 1 << 60, n), rng.integers(0, 60, n))]
        for i in rng.choice(n, n // 8, replace=False):
            w[i] = None
        k = keys.astype(np.int32)
        return pa.table({f"{prefix}k": k, f"{prefix}k64": k.astype(np.int64),
                         f"{prefix}kf": k.astype(np.float32),
                         f"{prefix}w": _arr(w, 38, 2)})

    bkeys = rng.integers(0, 60, 120) if dup else rng.permutation(300)[:120]
    return side(120, bkeys, "l"), side(200, rng.integers(0, 300, 200), "r")


def _batches(tbl, size):
    return [ColumnBatch.from_arrow(b, device="cpu")
            for b in tbl.to_batches(max_chunksize=size)]


JOIN_CASES = {
    # name: (operator, key suffixes, repeating build keys, config, core)
    "table_direct": ("hash", [""], False, {}, "table_direct"),
    "table_kr": ("hash", ["f"], False, {}, "table_kr"),
    "table": ("hash", ["", "64"], False, {}, "table"),
    "sorted": ("hash", [""], True, {}, "sorted"),
    "smj": ("smj", [""], True, {}, "sorted"),
    "smj_grace": ("smj", [""], True,
                  {"max_materialize_rows": 100, "external_buckets": 4},
                  None),
    "streaming_smj": ("streaming", [""], True, {}, None),
}


@pytest.mark.parametrize("case", sorted(JOIN_CASES))
def test_wide_payloads_through_join_cores(case):
    """Each core (and the grace buckets, and the streaming join) joins
    int keys with decimal(>18) payloads on both sides: FULL OUTER
    (INNER for the streaming join) rows equal pyarrow's join, the
    payload limbs intact and the NULL side's limbs NULL."""
    from blaze_tpu_torch.ops import (
        HashJoinExec,
        JoinType,
        SortMergeJoinExec,
    )
    from blaze_tpu_torch.ops.streaming_smj import StreamingSortMergeJoinExec
    from blaze_tpu_torch.runtime import dispatch

    kind, suffixes, dup, extra, core = JOIN_CASES[case]
    left, right = _join_sides(dup)
    lk = [f"lk{s}" for s in suffixes]
    rk = [f"rk{s}" for s in suffixes]
    jt = JoinType.INNER if kind == "streaming" else JoinType.FULL
    if kind == "streaming":
        left = left.sort_by([(lk[0], "ascending")])
        right = right.sort_by([(rk[0], "ascending")])
    cls = {"hash": HashJoinExec, "smj": SortMergeJoinExec,
           "streaming": StreamingSortMergeJoinExec}[kind]
    saved = get_config()
    cfg = EngineConfig(device="cpu", **extra)
    set_config(cfg)
    try:
        lscan = MemoryScanExec([_batches(left, 128)],
                               _batches(left, 128)[0].schema)
        rscan = MemoryScanExec([_batches(right, 100)],
                               _batches(right, 100)[0].schema)
        with dispatch.counting() as c:
            got = run_plan(cls(lscan, rscan, lk, rk, jt),
                           ExecContext(device="cpu", config=cfg))
    finally:
        set_config(saved)
    if core is not None:
        assert c.counts.get(f"join_core.{core}", 0) >= 1, c.counts
    want = left.join(right, lk, rk, join_type="full outer"
                     if jt is JoinType.FULL else "inner",
                     coalesce_keys=False)
    cols = ["lk", "lw", "rk", "rw"]

    def rows(t):
        return sorted(zip(*[t.column(n).to_pylist() for n in cols]),
                      key=lambda r: tuple((x is None, x or 0) for x in r))

    assert rows(got) == rows(want)
    assert got.schema.field("rw").type == pa.decimal128(38, 2)
    if case == "smj_grace":
        assert got.num_rows > 100  # bucketed: over the materialize limit


# ---------------------------------------------------------------------------
# what stays refused, in the JAX package's words
# ---------------------------------------------------------------------------

def _error_text(fn):
    """The innermost NotImplementedError's message that `fn` raises (a
    task wraps it)."""
    with pytest.raises(Exception) as ei:
        fn()
    e = ei.value
    while not isinstance(e, NotImplementedError) and e.__cause__:
        e = e.__cause__
    assert isinstance(e, NotImplementedError), repr(ei.value)
    return str(e)


def test_wide_key_refusals_carry_the_jax_words(tmp_path):
    """decimal(>18) group, join, window and partition keys, and MIN, MAX
    and the moments of a wide value, stay refused as the JAX package
    refuses them, with its words; no refusal in the port names the
    decimal128 ROADMAP item any more."""
    import pathlib

    from blaze_tpu.ops.window import WindowExec as JWindow, WindowFn as JWin
    from blaze_tpu_torch.ops import HashJoinExec, JoinType, ShuffleWriterExec
    from blaze_tpu_torch.ops.window import WindowExec, WindowFn

    rb = pa.record_batch({"d": _arr([1, 2, None], 38, 2),
                          "k": pa.array([1, 2, 3], pa.int32())})
    pairs = [
        (lambda: HashAggregateExec(_scan(rb), [(Col("d"), "d")],
                                   [(AggExpr(AggFn.COUNT_STAR, None), "n")]),
         lambda: J.HashAggregateExec(_jscan(rb), [(JCol("d"), "d")],
                                     [(JAgg(JFn.COUNT_STAR, None), "n")])),
        (lambda: HashAggregateExec(_scan(rb), [], [
            (AggExpr(AggFn.MIN, Col("d")), "m")]),
         lambda: J.HashAggregateExec(_jscan(rb), [], [
             (JAgg(JFn.MIN, JCol("d")), "m")])),
        (lambda: HashAggregateExec(_scan(rb), [], [
            (AggExpr(AggFn.VAR_POP, Col("d")), "m")]),
         lambda: J.HashAggregateExec(_jscan(rb), [], [
             (JAgg(JFn.VAR_POP, JCol("d")), "m")])),
        (lambda: run_plan(HashJoinExec(_scan(rb), _scan(rb), ["d"], ["d"],
                                       JoinType.INNER), CPU),
         lambda: jax_run_plan(J.HashJoinExec(_jscan(rb), _jscan(rb), ["d"],
                                             ["d"], J.JoinType.INNER))),
        (lambda: WindowExec(_scan(rb), [Col("d")], [], [
            WindowFn("row_number", None, "rn")]),
         lambda: JWindow(_jscan(rb), [JCol("d")], [], [
             JWin("row_number", None, "rn")])),
    ]
    words = []
    for port, ref in pairs:
        words.append(_error_text(port))
        assert words[-1] == _error_text(ref)
    assert words == [
        "group keys of decimal(>18) are host-tier work",
        "min over decimal(>18) is host-tier work",
        "var_pop over decimal(>18) is host-tier work",
        "join keys of decimal(>18) are host-tier work",
        "window over decimal(>18) is host-tier work"]
    # a wide partition key: the JAX package's host hash refuses it as
    # "hash of decimal(38,2)"
    writer = ShuffleWriterExec(_scan(rb), [Col("d")], 4,
                               str(tmp_path / "d"), str(tmp_path / "i"))
    assert _error_text(lambda: run_plan(writer, CPU)).startswith(
        "hash of decimal(38,2)")
    root = pathlib.Path(__file__).resolve().parents[1] / "blaze_tpu_torch"
    for path in root.rglob("*.py"):
        assert "item 3" not in path.read_text(), path


# ---------------------------------------------------------------------------
# tests/test_spark_semantics_goldens.py on the port: Spark's answers
# ---------------------------------------------------------------------------

def test_decimal_avg_half_up_golden():
    """AVG(decimal(7, 2)) at scale 6, ties rounded away from zero."""
    rb = pa.record_batch({
        "g": pa.array([1, 1, 2, 2, 2, 3, 3, 3], pa.int32()),
        "d": _arr([100, 101, 1, 2, 2, -1, -2, -2], 7, 2)})
    out = run_plan(HashAggregateExec(
        _scan(rb), [(Col("g"), "g")], [(AggExpr(AggFn.AVG, Col("d")), "a")],
        AggMode.COMPLETE), CPU).to_pydict()
    assert dict(zip(out["g"], [str(x) for x in out["a"]])) == {
        1: "1.005000", 2: "0.016667", 3: "-0.016667"}


def test_round_half_up_golden():
    from blaze_tpu_torch.exprs.ir import ScalarFn

    rb = pa.record_batch({"x": pa.array([0.5, 1.5, 2.5, -0.5, -1.5, 2.675],
                                        pa.float64())})
    out = run_plan(ProjectExec(_scan(rb), [
        (ScalarFn("round", (Col("x"),)), "r0"),
        (ScalarFn("round", (Col("x"), Literal(2, DataType.int32()))), "r2"),
    ]), CPU).to_pydict()
    assert out["r0"] == [1.0, 2.0, 3.0, -1.0, -2.0, 3.0]
    assert out["r2"][5] == pytest.approx(2.68)


def test_null_group_and_join_semantics_golden():
    """NULL keys form one group; NULL join keys match nothing, in both
    joins."""
    from blaze_tpu_torch.ops import HashJoinExec, JoinType, SortMergeJoinExec

    rb = pa.record_batch({"k": pa.array([1, None, None, 2], pa.int32()),
                          "v": pa.array([10, 20, 30, 40], pa.int64())})
    out = run_plan(HashAggregateExec(
        _scan(rb), [(Col("k"), "k")], [(AggExpr(AggFn.SUM, Col("v")), "s")],
        AggMode.COMPLETE), CPU).to_pydict()
    assert dict(zip(out["k"], out["s"])) == {1: 10, 2: 40, None: 50}
    left = pa.record_batch({"k": pa.array([1, None], pa.int32()),
                            "a": pa.array([1, 2], pa.int64())})
    right = pa.record_batch({"k2": pa.array([1, None], pa.int32()),
                             "b": pa.array([10, 20], pa.int64())})
    for cls in (HashJoinExec, SortMergeJoinExec):
        res = run_plan(cls(_scan(left), _scan(right), ["k"], ["k2"],
                           JoinType.INNER), CPU).to_pydict()
        assert res["a"] == [1] and res["b"] == [10], cls


def test_nan_normalization_golden():
    """NaN groups with NaN, apart from +inf; NaN sorts above +inf."""
    nan = float("nan")
    rb = pa.record_batch({"k": pa.array([nan, nan, 1.0, np.inf]),
                          "v": pa.array([1, 2, 4, 8], pa.int64())})
    out = run_plan(HashAggregateExec(
        _scan(rb), [(Col("k"), "k")], [(AggExpr(AggFn.SUM, Col("v")), "s")],
        AggMode.COMPLETE), CPU).to_pydict()
    assert {("nan" if k != k else k): s
            for k, s in zip(out["k"], out["s"])} == {
        "nan": 3, 1.0: 4, np.inf: 8}
    res = run_plan(SortExec(_scan(rb), [SortKey(Col("k"), True, True)]),
                   CPU).to_pydict()["v"]
    assert res[-2:] == [1, 2] and res[:2] == [4, 8]


def test_bigint_sum_overflow_wraps_golden():
    rb = pa.record_batch({"v": pa.array([(1 << 63) - 1, 1], pa.int64())})
    out = run_plan(HashAggregateExec(
        _scan(rb), [], [(AggExpr(AggFn.SUM, Col("v")), "s")],
        AggMode.COMPLETE), CPU).to_pydict()
    assert out["s"] == [-(1 << 63)]


# ---------------------------------------------------------------------------
# wide payloads through the scan, the shuffle and the window
# ---------------------------------------------------------------------------

def test_wide_payloads_through_parquet_shuffle_and_window(tmp_path):
    """decimal(>18) columns load from parquet as limbs; cross a hash
    shuffle (segmented IPC, the 16-byte slot) into the partitions
    Spark's hash of the int key names, byte-equal; and pass through a
    window, each value beside its row."""
    import pyarrow.parquet as pq

    from blaze_tpu_torch.io import ipc
    from blaze_tpu_torch.ops import ShuffleWriterExec
    from blaze_tpu_torch.ops.parquet_scan import FileRange, ParquetScanExec
    from blaze_tpu_torch.ops.window import WindowExec, WindowFn

    import chip_smoke

    rows = 700
    rng = np.random.default_rng(12)
    w = [int(x) << int(s) for x, s in zip(
        rng.integers(-(1 << 60), 1 << 60, rows), rng.integers(0, 66, rows))]
    w[5] = None
    tbl = pa.table({"k": pa.array(rng.integers(0, 50, rows).astype(np.int32)),
                    "rid": pa.array(np.arange(rows, dtype=np.int32)),
                    "w": _arr(w, 38, 6)})
    path = str(tmp_path / "w.parquet")
    pq.write_table(tbl, path, row_group_size=256)
    saved = get_config()
    set_config(EngineConfig(device="cpu", batch_size=256))
    try:
        scan = ParquetScanExec([[FileRange(path)]])
        assert run_plan(scan, CPU).equals(tbl)
        data, index = str(tmp_path / "s.data"), str(tmp_path / "s.index")
        run_plan(ShuffleWriterExec(scan, [Col("k")], 7, data, index), CPU)
        back = []
        for r, (off, n) in enumerate(ipc.partition_ranges(index)):
            for rb in ipc.read_file_segment(data, off, n):
                assert (chip_smoke.spark_pids(rb.column("k").to_numpy(), 7)
                        == r).all()
                back.append(rb)
        assert _sorted(pa.Table.from_batches(back), ["rid"]).equals(tbl)
        win = run_plan(WindowExec(scan, [Col("k")], [SortKey(Col("rid"))],
                                  [WindowFn("row_number", None, "rn")]), CPU)
    finally:
        set_config(saved)
    win = _sorted(win, ["rid"])
    assert win.column("w").to_pylist() == tbl.column("w").to_pylist()


def test_decimal_pruning_reads_literals_at_their_scale(tmp_path):
    """A pruning predicate against a decimal literal compares the row
    group's decimal statistics with the value the literal stands for:
    `p > 50.00` keeps the group [10.00, 99.99] and its 2 rows. The JAX
    package compares the statistics with the unscaled 5000 and prunes
    the group (a reference fault)."""
    import pyarrow.parquet as pq

    from blaze_tpu.exprs.ir import BinaryOp as JBinaryOp, Literal as JLit
    from blaze_tpu.exprs.ir import Op as JOp
    from blaze_tpu.ops.parquet_scan import FileRange as JRange
    from blaze_tpu.ops.parquet_scan import ParquetScanExec as JParquet
    from blaze_tpu.types import DataType as JDataType
    from blaze_tpu_torch.ops.parquet_scan import FileRange, ParquetScanExec

    path = str(tmp_path / "p.parquet")
    pq.write_table(pa.table({"p": _arr([1000, 9999], 7, 2)}), path)
    rows = {}
    for op, lit, want in ((Op.GT, 5000, 2), (Op.GT, 9999, 0),
                          (Op.LT, 1000, 0), (Op.LTE, 1000, 2),
                          (Op.EQ, 4000, 2)):
        scan = ParquetScanExec([[FileRange(path)]], None, None, BinaryOp(
            op, Col("p"), Literal(lit, DataType.decimal(7, 2))))
        rows[op, lit] = run_plan(scan, CPU).num_rows
        assert rows[op, lit] == want, (op, lit)
    jscan = JParquet([[JRange(path)]], None, None, JBinaryOp(
        JOp.GT, JCol("p"), JLit(5000, JDataType.decimal(7, 2))))
    assert jax_run_plan(jscan).num_rows == 0  # the reference's pruning
