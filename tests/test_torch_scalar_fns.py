"""The port's scalar functions (blaze_tpu_torch/exprs/eval.py
`_scalar_fn`) against the JAX package's evaluator on identical batches,
and against Spark oracles where the JAX package departs from Spark.

Inputs are seeded numpy buffers with NULLs, +/-0.0, +/-inf, NaN and
date extremes (no subnormals: XLA flushes them, ROADMAP section 3).
Each expression crosses to the JAX IR through the wire format, as in
test_torch_exprs.py. Results are compared in the physical dtype of the
type `infer_dtype` gives the call (the JAX package leaves some results
in float64 under a narrower declared type; the port casts):

- integer, bool, date, sqrt, abs, ceil/floor and the other exact
  functions: equal bit for bit on every live valid row, with equal
  validity;
- exp, log, trig, pow and atan2: within 4 ulp (torch and XLA use
  different approximations; sqrt is correctly rounded on both: the port
  takes numpy's on the CPU, eval.py `_sqrt`). sinh, cosh and tanh: XLA's
  CPU versions are up to 480 ulp from glibc's (numpy) on these inputs,
  torch's within 1, so the port is held within 2 ulp of numpy and
  within 1024 ulp of the JAX package;
- the Spark-rule functions (logarithms of x <= 0, least with NaN,
  round of a double, isnan and nanvl with NULLs, pmod by a negative
  divisor, null_if of NaN): equal to the JAX package where the two
  rules agree, and to a Spark oracle (numpy, Python's Decimal) on every
  row.
"""

import math
from decimal import ROUND_HALF_UP, Decimal, localcontext

import numpy as np
import pytest

from blaze_tpu.exprs.eval import DeviceEvaluator as JaxEvaluator
from blaze_tpu.exprs.optimize import bind_opt as jax_bind_opt
from blaze_tpu.plan import plan_pb2 as jax_pb
from blaze_tpu.plan import serde as jax_serde

from blaze_tpu_torch import interop
from blaze_tpu_torch.batch import torch_dtype
from blaze_tpu_torch.exprs import ir
from blaze_tpu_torch.exprs.eval import DeviceEvaluator
from blaze_tpu_torch.exprs.ir import Col, ScalarFn
from blaze_tpu_torch.exprs.optimize import bind_opt
from blaze_tpu_torch.exprs.typing import infer_dtype
from blaze_tpu_torch.plan import serde
from blaze_tpu_torch.types import DataType, Field, Schema

from torch_support import jax_batch

CAP, ROWS = 512, 480
ULPS = 4

SCHEMA = Schema([
    Field("a", DataType.int32()),
    Field("b", DataType.int32()),
    Field("l", DataType.int64()),
    Field("x", DataType.float64()),
    Field("y", DataType.float64()),
    Field("f", DataType.float32()),
    Field("u", DataType.float64()),
    Field("dec", DataType.decimal(10, 2)),
    Field("dt", DataType.date32()),
])
SPECIAL = [np.nan, np.inf, -np.inf, 0.0, -0.0, 1.0, -1.0, 0.5, -0.5, 2.5,
           -2.5, 1e300, -1e300, 1e-300, 2.675, 1.005, 0.49999999999999994]
# 0001-01-01, 9999-12-31, the epoch and its eve, leap days, a century
DATES = [-719162, 2932896, 0, -1, 11016, 11017, -25508, 19782, 59, 60,
         -2, 10956, 47541]


def _buffers():
    rng = np.random.default_rng(1207)
    a = rng.integers(-2000, 2000, CAP).astype(np.int32)
    a[:6] = [np.iinfo(np.int32).min, np.iinfo(np.int32).max, -7, 7, 0, 1250]
    b = rng.integers(-9, 9, CAP).astype(np.int32)
    b[:6] = [3, -3, -3, 3, 0, 7]
    ll = rng.integers(-10 ** 12, 10 ** 12, CAP, dtype=np.int64)
    ll[:3] = [np.iinfo(np.int64).max, np.iinfo(np.int64).min, -1250]
    x = (rng.random(CAP) - 0.5) * rng.choice([1e-3, 1.0, 100.0, 1e6], CAP)
    x[:len(SPECIAL)] = SPECIAL
    y = (rng.random(CAP) - 0.5) * 10
    y[:8] = [np.nan, 1.0, np.nan, 0.0, -0.0, np.inf, 0.5, -2.0]
    f = ((rng.random(CAP) - 0.3) * 200).astype(np.float32)
    f[:6] = [np.nan, np.inf, -0.0, 0.0, 50.0, -1.5]
    # the unit interval, where asin and acos are defined, and its ends
    u = rng.random(CAP) * 2 - 1
    u[:5] = [1.0, -1.0, 0.0, -0.0, np.nan]
    dec = rng.integers(-10 ** 6, 10 ** 6, CAP).astype(np.int64)
    dt = rng.integers(-800_000, 2_900_000, CAP).astype(np.int32)
    dt[:len(DATES)] = DATES
    values = [a, b, ll, x, y, f, u, dec, dt]
    validity = [
        rng.random(CAP) < 0.9 if name in ("a", "x", "y", "f", "dt")
        else None
        for name in SCHEMA.names()
    ]
    for m in validity:
        if m is not None:
            # the special rows stay valid
            m[:len(SPECIAL)] = True
    sel = rng.random(CAP) < 0.95
    sel[:len(SPECIAL)] = True
    return values, validity, sel


a, b, ll, x, y, f, u = (Col(n) for n in ("a", "b", "l", "x", "y", "f", "u"))
dec, dt = Col("dec"), Col("dt")


def fn(name, *args):
    return ScalarFn(name, tuple(args))


def lit(v, t=DataType.int32()):
    return ir.Literal(v, t)


EXACT = {
    "sqrt_x": fn("sqrt", x), "sqrt_f": fn("sqrt", f),
    "abs_a": fn("abs", a), "abs_l": fn("abs", ll), "abs_x": fn("abs", x),
    "abs_f": fn("abs", f), "abs_dec": fn("abs", dec),
    "negative_a": fn("negative", a), "negative_x": fn("negative", x),
    "positive_f": fn("positive", f),
    "signum_x": fn("signum", x), "signum_a": fn("signum", a),
    "signum_f": fn("signum", f),
    "ceil_x": fn("ceil", x), "floor_x": fn("floor", x),
    "ceil_f": fn("ceil", f), "floor_a": fn("floor", a),
    "ceil_dec": fn("ceil", dec),
    "trunc_x": fn("trunc", x), "trunc_f": fn("trunc", f),
    "round_a_neg2": fn("round", a, lit(-2)),
    "round_l_neg3": fn("round", ll, lit(-3)),
    "round_a_pos": fn("round", a, lit(2)),
    "greatest_ab": fn("greatest", a, b), "least_ab": fn("least", a, b),
    "greatest_xy": fn("greatest", x, y),
    "greatest_three": fn("greatest", a, b, lit(5)),
    "unscaled": fn("spark_unscaled_value", dec),
    "make_decimal": fn("spark_make_decimal", ll),
    "null_if_ab": fn("null_if", a, b),
    **{f"{p}_dt": fn(p, dt) for p in ("year", "month", "day", "dayofmonth",
                                      "quarter", "dayofweek", "dayofyear")},
    **{f"date_part_{p}": fn("date_part", lit(p, DataType.utf8()), dt)
       for p in ("year", "month", "day", "quarter", "dow", "doy")},
    **{f"trunc_date_{p}": fn("trunc_date", dt, lit(p, DataType.utf8()))
       for p in ("year", "quarter", "month", "week", "mm", "yy")},
}
ULP = {
    **{f"{n}_x": fn(n, x) for n in ("exp", "sin", "cos", "tan", "atan")},
    "asin_u": fn("asin", u), "acos_u": fn("acos", u),
    "exp_f": fn("exp", f),
    "pow_xy": fn("pow", x, y), "pow_fb": fn("pow", f, b),
    "atan2_xy": fn("atan2", x, y),
}
# the hyperbolic functions, held to numpy (glibc) within 2 ulp
HYPERBOLIC = {"sinh_x": (fn("sinh", x), np.sinh, "x"),
              "cosh_x": (fn("cosh", x), np.cosh, "x"),
              "tanh_x": (fn("tanh", x), np.tanh, "x"),
              "tanh_f": (fn("tanh", f), np.tanh, "f")}
XLA_HYPERBOLIC_ULPS = 1024
# Spark-rule functions: (expr, rows where Spark and the JAX package
# agree, from the host inputs)
SPARK_RULE = {
    **{f"{n}_x": (fn(n, x), lambda h: ~(h["x"] <= 0))
       for n in ("ln", "log", "log2", "log10")},
    "ln_f": (fn("ln", f), lambda h: ~(h["f"] <= 0)),
    "least_xy": (fn("least", x, y),
                 lambda h: ~np.isnan(h["x"]) & ~np.isnan(h["y"])),
    "isnan_x": (fn("isnan", x), lambda h: h["x_valid"]),
    "isnan_a": (fn("isnan", a), lambda h: h["a_valid"]),
    "nanvl_xy": (fn("nanvl", x, y),
                 lambda h: h["x_valid"] & h["y_valid"]),
    "pmod_ab": (fn("pmod", a, b), lambda h: h["b"] >= 0),
    "pmod_xy": (fn("pmod", x, y), lambda h: ~(h["y"] < 0)),
    "null_if_xy": (fn("null_if", x, y),
                   lambda h: ~(np.isnan(h["x"]) & np.isnan(h["y"]))),
}


@pytest.fixture(scope="module")
def batches():
    values, validity, sel = _buffers()
    port = interop.batch_from_numpy(SCHEMA, values, validity, sel, ROWS,
                                    "cpu")
    ref = jax_batch(SCHEMA, values, validity, sel, ROWS)
    host = dict(zip(SCHEMA.names(), values))
    for name, m in zip(SCHEMA.names(), validity):
        host[f"{name}_valid"] = np.ones(CAP, bool) if m is None else m
    return port, ref, host


def _to_jax_expr(e):
    wire = serde.expr_to_proto(e).SerializeToString()
    return jax_serde.expr_from_proto(jax_pb.ExprProto.FromString(wire))


def _port(e, port):
    pe = bind_opt(e, port.schema)
    v, m = DeviceEvaluator(
        port.schema, [(c.values, c.validity) for c in port.columns],
        CAP, "cpu").evaluate(pe)
    v = v.expand(CAP).numpy()
    m = np.ones(CAP, bool) if m is None else m.expand(CAP).numpy()
    phys = np.dtype(str(torch_dtype(infer_dtype(pe, port.schema)))
                    .replace("torch.", ""))
    assert v.dtype == phys, (v.dtype, phys)
    return v, m


def _jax(e, ref, dtype):
    je = jax_bind_opt(_to_jax_expr(e), ref.schema)
    v, m = JaxEvaluator(
        ref.schema, [(c.values, c.validity) for c in ref.columns],
        CAP).evaluate(je)
    v = np.broadcast_to(np.asarray(v), (CAP,))
    m = np.ones(CAP, bool) if m is None else np.broadcast_to(
        np.asarray(m), (CAP,))
    if v.dtype != dtype:
        # the JAX package keeps some results in float64 under a narrower
        # declared type; Arrow output casts them as the port does here
        with np.errstate(invalid="ignore", over="ignore"):
            if dtype.kind in "iu" and v.dtype.kind == "f":
                info = np.iinfo(dtype)
                v = np.where(np.isnan(v), 0, np.clip(v, info.min, info.max))
            v = v.astype(dtype)
    return v, m


def _ordered(v):
    """Float bits as integers in the order of the values."""
    i = v.astype(np.float64).view(np.int64)
    return np.where(i < 0, np.int64(-(2 ** 63)) - i, i)


def _assert_same(pv, jv, rows, ulps=0, name=""):
    pv, jv = pv[rows], jv[rows]
    if pv.dtype.kind != "f":
        np.testing.assert_array_equal(pv, jv, err_msg=name)
        return
    pn, jn = np.isnan(pv), np.isnan(jv)
    np.testing.assert_array_equal(pn, jn, err_msg=name)
    pv, jv = pv[~pn], jv[~pn]
    if ulps == 0:
        np.testing.assert_array_equal(pv.view(np.uint8), jv.view(np.uint8),
                                      err_msg=name)
        return
    inf = np.isinf(pv) | np.isinf(jv)
    np.testing.assert_array_equal(pv[inf], jv[inf], err_msg=name)
    d = np.abs(_ordered(pv[~inf]) - _ordered(jv[~inf]))
    assert d.size == 0 or d.max() <= ulps, (name, int(d.max()))


def _compare(name, e, batches, rows_fn=None, ulps=0):
    port, ref, host = batches
    pv, pm = _port(e, port)
    jv, jm = _jax(e, ref, pv.dtype)
    rows = port.live_mask().numpy()
    if rows_fn is not None:
        rows = rows & rows_fn(host)
    np.testing.assert_array_equal(pm[rows], jm[rows], err_msg=name)
    _assert_same(pv, jv, rows & pm, ulps, name)
    return rows.sum()


@pytest.mark.parametrize("name", list(EXACT))
def test_exact_functions_match_jax(name, batches):
    assert _compare(name, EXACT[name], batches) > 400


@pytest.mark.parametrize("name", list(ULP))
def test_transcendentals_match_jax_within_ulps(name, batches):
    assert _compare(name, ULP[name], batches, ulps=ULPS) > 400


@pytest.mark.parametrize("name", list(HYPERBOLIC))
def test_hyperbolic_within_ulps_of_numpy(name, batches):
    e, npfn, col = HYPERBOLIC[name]
    pv, pm, h, live = _eval_rows(e, batches)
    rows = live & pm
    with np.errstate(over="ignore"):
        want = npfn(h[col].astype(np.float64))
    _assert_same(pv, want, rows, 2, name)
    _compare(name, e, batches, ulps=XLA_HYPERBOLIC_ULPS)


@pytest.mark.parametrize("name", list(SPARK_RULE))
def test_spark_rule_functions_match_jax_where_rules_agree(name, batches):
    e, rows_fn = SPARK_RULE[name]
    ulps = ULPS if name.startswith(("ln", "log")) else 0
    assert _compare(name, e, batches, rows_fn, ulps=ulps) > 150


# ---------------------------------------------------------------------------
# Spark oracles
# ---------------------------------------------------------------------------

def _eval_rows(e, batches):
    port, _, host = batches
    pv, pm = _port(e, port)
    return pv, pm, host, port.live_mask().numpy()


@pytest.mark.parametrize("name,npfn", [
    ("ln", np.log), ("log", np.log), ("log2", np.log2),
    ("log10", np.log10)])
def test_logarithms_are_null_at_and_below_zero(name, npfn, batches):
    """Spark's logarithms (UnaryLogExpression) are NULL for x <= 0,
    -0.0 included; NaN stays NaN. The JAX package gives NaN / -inf."""
    pv, pm, h, live = _eval_rows(fn(name, x), batches)
    xv = h["x"]
    exp_valid = h["x_valid"] & ~(xv <= 0)
    np.testing.assert_array_equal(pm[live], exp_valid[live])
    assert (live & h["x_valid"] & (xv <= 0)).sum() > 100
    ok = live & exp_valid
    with np.errstate(invalid="ignore", divide="ignore"):
        _assert_same(pv, npfn(xv), ok, ULPS, name)


def test_least_skips_nan_greatest_keeps_it(batches):
    """Spark orders NaN above every value: least(1.0, NaN) = 1.0,
    greatest(1.0, NaN) = NaN; least is NaN only when both are."""
    lv, lm, h, live = _eval_rows(fn("least", x, y), batches)
    gv, gm, _, _ = _eval_rows(fn("greatest", x, y), batches)
    xv, yv = h["x"], h["y"]
    both = live & h["x_valid"] & h["y_valid"]
    exp_least = np.where(np.isnan(xv), yv,
                         np.where(np.isnan(yv), xv, np.minimum(xv, yv)))
    exp_greatest = np.where(np.isnan(xv) | np.isnan(yv), np.nan,
                            np.maximum(xv, yv))
    assert (both & (np.isnan(xv) != np.isnan(yv))).sum() > 0
    _assert_same(lv, exp_least, both, name="least")
    _assert_same(gv, exp_greatest, both, name="greatest")
    # one NULL operand: the other one
    one = live & (h["x_valid"] != h["y_valid"])
    assert one.sum() > 0 and lm[one].all() and gm[one].all()
    _assert_same(lv, np.where(h["x_valid"], xv, yv), one, name="least1")


def _spark_round(v: float, d: int) -> float:
    """Spark: BigDecimal of the double's shortest form (repr), HALF_UP
    at scale d, back to the nearest double."""
    if math.isnan(v) or math.isinf(v):
        return v
    with localcontext(prec=1000):
        q = Decimal(repr(float(v))).quantize(Decimal(1).scaleb(-d),
                                             rounding=ROUND_HALF_UP)
        return float(q)


ROUND_CASES = [
    (0.49999999999999994, 0, 0.0), (1.005, 2, 1.01), (2.675, 2, 2.68),
    (0.5, 0, 1.0), (-0.5, 0, -1.0), (1.5, 0, 2.0), (2.5, 0, 3.0),
    (-2.5, 0, -3.0), (0.285, 2, 0.29), (float(np.nextafter(1.005, 0)), 2, 1.0),
    (-1.005, 2, -1.01), (1250.0, -2, 1300.0), (-1250.0, -2, -1300.0),
    (1249.9999999999998, -2, 1200.0), (0.125, 2, 0.13), (8.345, 2, 8.35),
    (-0.4, 0, 0.0), (123456.785, 2, 123456.79), (1e300, 2, 1e300),
    (np.inf, 1, np.inf), (7305708532321123.0, 0, 7305708532321123.0),
    (869219332708611.9, 1, 869219332708611.9),
    (2.9803164577788454e17, -2, 2.980316457778845e17),
    (0.0, 400, 0.0), (3.0, -400, 0.0),
]


def _round_batch(values, d):
    sch = Schema([Field("x", DataType.float64())])
    vals = np.asarray(values, dtype=np.float64)
    cb = interop.batch_from_numpy(sch, [vals], [None], None, len(vals),
                                  "cpu")
    e = bind_opt(fn("round", Col("x"), lit(d)), sch)
    v, _ = DeviceEvaluator(sch, [(cb.columns[0].values, None)], len(vals),
                           "cpu").evaluate(e)
    return v.numpy()


@pytest.mark.parametrize("v,d,want", ROUND_CASES)
def test_round_double_spark_cases(v, d, want):
    got = _round_batch([v], d)[0]
    assert got == want or (math.isnan(got) and math.isnan(want)), (v, d, got)
    assert got == _spark_round(v, d) or math.isinf(v)
    assert not (got == 0 and math.copysign(1, got) < 0)


@pytest.mark.parametrize("d", [-21, -3, -1, 0, 1, 2, 3, 6, 12, 15, 21])
def test_round_double_matches_decimal_oracle(d):
    """HALF_UP of the shortest decimal form, against Python's Decimal of
    repr (the shortest form), on doubles whose |x| * 10^d spans 2^-10 to
    2^53 (the band from 2^48 up, where several decimals of d + 1 places
    round to one double, included) and on exact ties at the scale."""
    rng = np.random.default_rng(100 + d)
    lo, hi = np.log(2.0 ** -10 / 10.0 ** d), np.log(2.0 ** 53 / 10.0 ** d)
    vals = np.exp(rng.uniform(lo, hi, 2500))
    band = np.exp(rng.uniform(np.log(2.0 ** 48 / 10.0 ** d), hi, 1000))
    k = np.floor(vals[:1000] * 10.0 ** d)
    ties = (k + 0.5) / 10.0 ** d
    vals = np.concatenate([vals, band, ties, -vals[:500]])
    got = _round_batch(vals, d)
    want = np.array([_spark_round(float(v), d) for v in vals])
    bad = np.flatnonzero(got != want)
    assert bad.size == 0, [(vals[i], got[i], want[i]) for i in bad[:5]]


@pytest.mark.parametrize("d", [22, 25, 30, -25])
def test_round_beyond_scale_21_is_within_an_ulp(d):
    """Pins what stays out of reach (ROADMAP section 3): past |d| = 21
    the power of ten is not an exact double, so the result can be 1 ulp
    off Spark's, and a value next to a tie can round the other way (one
    unit of the scale off); never further."""
    rng = np.random.default_rng(7 + abs(d))
    lo = np.log(2.0 ** -10 / 10.0 ** d)
    vals = np.exp(rng.uniform(lo, np.log(2.0 ** 53 / 10.0 ** d), 2000))
    got = _round_batch(vals, d)
    want = np.array([_spark_round(float(v), d) for v in vals])
    one_ulp = np.abs(_ordered(got) - _ordered(want)) <= 1
    # the other neighbour of a tie: one unit of the scale away, as near
    # as doubles there can be
    next_tie = np.abs(got - want) <= 10.0 ** -d + 2 * np.spacing(
        np.abs(want))
    assert np.all(one_ulp | next_tie)
    assert np.mean(got == want) > 0.4


def test_round_reference_departs_from_spark():
    """Pins why round does not follow the JAX package: its
    floor(x * 10^d + 0.5) gives 1.0 for round(0.49999999999999994) and
    1.0 for round(1.005, 2)."""
    from blaze_tpu.types import DataType as JDataType, Field as JField
    from blaze_tpu.types import Schema as JSchema
    import jax.numpy as jnp

    js = JSchema([JField("x", JDataType.float64())])
    for v, d, spark in ((0.49999999999999994, 0, 0.0), (1.005, 2, 1.01)):
        je = jax_bind_opt(_to_jax_expr(fn("round", Col("x"), lit(d))), js)
        jv, _ = JaxEvaluator(js, [(jnp.asarray([v]), None)], 1).evaluate(je)
        assert float(np.asarray(jv)[0]) != spark
        assert _round_batch([v], d)[0] == spark


def test_isnan_and_nanvl_null_rules(batches):
    """Spark: isnan(NULL) is false (never NULL); nanvl(x, y) is NULL
    where x is NULL, or where x is NaN and y is NULL; otherwise x, or y
    where x is NaN."""
    iv, im, h, live = _eval_rows(fn("isnan", x), batches)
    assert im[live].all()
    np.testing.assert_array_equal(
        iv[live], (h["x_valid"] & np.isnan(h["x"]))[live])
    nv, nm, _, _ = _eval_rows(fn("nanvl", x, y), batches)
    xnan = np.isnan(h["x"])
    exp_m = h["x_valid"] & (~xnan | h["y_valid"])
    np.testing.assert_array_equal(nm[live], exp_m[live])
    assert (live & h["x_valid"] & ~xnan & ~h["y_valid"]).sum() > 0
    _assert_same(nv, np.where(xnan, h["y"], h["x"]), live & exp_m,
                 name="nanvl")


def test_pmod_spark_rule(batches):
    """Spark's pmod: r = a % n; r < 0 ? (r + n) % n : r (so a negative
    divisor can give a negative result); NULL for n = 0."""
    pv, pm, h, live = _eval_rows(fn("pmod", a, b), batches)
    av, bv = h["a"].astype(np.int64), h["b"].astype(np.int64)
    valid = h["a_valid"] & (bv != 0)
    np.testing.assert_array_equal(pm[live], valid[live])
    safe = np.where(bv == 0, 1, bv)
    r = np.fmod(av, safe)
    exp = np.where(r < 0, np.fmod(r + safe, safe), r).astype(np.int32)
    ok = live & valid
    assert (ok & (bv < 0) & (r != 0)).sum() > 20
    np.testing.assert_array_equal(pv[ok], exp[ok])
    for aa, nn, want in ((-7, 3, 2), (7, 3, 1), (-7, -3, -1), (7, -3, 1)):
        sch = Schema([Field("a", DataType.int32()),
                      Field("b", DataType.int32())])
        cb = interop.batch_from_numpy(
            sch, [np.array([aa], np.int32), np.array([nn], np.int32)],
            [None, None], None, 1, "cpu")
        v, _ = DeviceEvaluator(sch, [(c.values, None) for c in cb.columns],
                               1, "cpu").evaluate(
            bind_opt(fn("pmod", Col("a"), Col("b")), sch))
        assert int(v[0]) == want, (aa, nn)


def test_null_if_counts_nan_equal(batches):
    """Spark's NullIf compares with =, under which NaN equals NaN."""
    pv, pm, h, live = _eval_rows(fn("null_if", x, y), batches)
    xv, yv = h["x"], h["y"]
    eq = (xv == yv) | (np.isnan(xv) & np.isnan(yv))
    exp_m = h["x_valid"] & ~(eq & h["x_valid"] & h["y_valid"])
    np.testing.assert_array_equal(pm[live], exp_m[live])
    assert (live & h["x_valid"] & h["y_valid"] & np.isnan(xv)
            & np.isnan(yv)).sum() > 0


@pytest.mark.parametrize("e", [
    fn("hour", dt), fn("upper", Col("a")),
    fn("date_part", lit("century", DataType.utf8()), dt),
], ids=["time_of_day", "string", "unknown_part"])
def test_unported_scalar_functions_raise(e, batches):
    port, _, _ = batches
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _port(e, port)
