"""The PyTorch port's expression evaluator against the JAX package's, on
identical batches (numpy buffers through interop.batch_from_numpy).

Each expression is built once in the port's IR and crosses to the JAX
IR through the shared wire format (expr_to_proto -> expr_from_proto),
so both evaluators see the same tree, bound and literal-narrowed by
their own bind_opt. Live rows must agree exactly: values where valid,
and validity.
"""

import numpy as np
import pytest
import torch

from blaze_tpu.exprs.eval import DeviceEvaluator as JaxEvaluator
from blaze_tpu.exprs.optimize import bind_opt as jax_bind_opt
from blaze_tpu.plan import plan_pb2 as jax_pb
from blaze_tpu.plan import serde as jax_serde

from blaze_tpu_torch import interop
from blaze_tpu_torch.exprs import ir
from blaze_tpu_torch.exprs.eval import DeviceEvaluator
from blaze_tpu_torch.exprs.ir import Col, Op
from blaze_tpu_torch.exprs.optimize import bind_opt
from blaze_tpu_torch.plan import serde
from blaze_tpu_torch.types import DataType, Field, Schema

from torch_support import jax_batch

CAP, ROWS = 256, 230
I32_MIN = np.iinfo(np.int32).min
I64_MAX = np.iinfo(np.int64).max

SCHEMA = Schema([
    Field("a", DataType.int32()),
    Field("b", DataType.int32()),
    Field("l", DataType.int64()),
    Field("x", DataType.float64()),
    Field("y", DataType.float64()),
    Field("f", DataType.float32()),
    Field("p", DataType.bool_()),
    Field("q", DataType.bool_()),
    Field("dec", DataType.decimal(10, 2)),
    Field("dt", DataType.date32()),
])


def _buffers():
    rng = np.random.default_rng(21)
    a = rng.integers(-50, 50, CAP).astype(np.int32)
    a[:4] = [I32_MIN, -7, 7, 0]
    b = rng.integers(-6, 6, CAP).astype(np.int32)
    b[:4] = [-1, 2, -2, 0]
    b[4:8] = [33, -1, 40, 31]
    ll = rng.integers(-2 ** 40, 2 ** 40, CAP, dtype=np.int64)
    ll[:2] = [I64_MAX, -(2 ** 62)]
    x = (rng.random(CAP) - 0.5) * 400
    x[:12] = [np.nan, np.inf, -np.inf, 3e9, -3e9, 2.7, -2.7, 1e20, -1e20,
              127.9, -128.5, 0.0]
    y = (rng.random(CAP) - 0.5) * 400
    y[:6] = [np.nan, 1.0, np.nan, 0.0, -0.0, np.inf]
    f = (rng.random(CAP) * 100).astype(np.float32)
    f[:3] = [50.0, np.nan, 3e9]
    p = rng.random(CAP) < 0.5
    q = rng.random(CAP) < 0.5
    dec = rng.integers(-10 ** 6, 10 ** 6, CAP).astype(np.int64)
    dt = rng.integers(-20000, 20000, CAP).astype(np.int32)
    values = [a, b, ll, x, y, f, p, q, dec, dt]
    validity = [
        rng.random(CAP) < 0.85 if name in ("a", "x", "p", "q") else None
        for name in SCHEMA.names()
    ]
    sel = rng.random(CAP) < 0.9
    return values, validity, sel


def _lit(v, dt=None):
    return ir.Literal(v, dt) if dt is not None else ir.Literal.infer(v)


a, b, ll, x, y, f = (Col(n) for n in ("a", "b", "l", "x", "y", "f"))
p, q, dec, dt = (Col(n) for n in ("p", "q", "dec", "dt"))
F32, I32 = DataType.float32(), DataType.int32()

CASES = {
    # comparisons: Spark NaN order on floats, narrowed literals
    **{f"cmp_xy_{op.name}": ir.BinaryOp(op, x, y)
       for op in (Op.EQ, Op.NEQ, Op.LT, Op.LTE, Op.GT, Op.GTE)},
    "cmp_f_lit": f > 50.0,
    "cmp_f_lit_wide": f >= 50.3,
    "cmp_a_lit": a <= 5,
    "cmp_a_wide_lit": a < (2 ** 40),
    "cmp_l_x": ll < x,
    # arithmetic
    "add": a + b, "sub": a - b, "mul": a * b,
    "div_int": a / b, "mod_int": a % b,
    "div_float": x / y, "mod_float": x % y,
    "mul_wrap": ll * ll,
    "mixed": f * a.cast(F32),
    "add_null_lit": a + _lit(None, I32),
    "neg_int": ir.Negate(a), "neg_float": ir.Negate(x),
    "bitand": ir.BinaryOp(Op.BITAND, a, b),
    "bitor": ir.BinaryOp(Op.BITOR, a, b),
    "bitxor": ir.BinaryOp(Op.BITXOR, a, b),
    "shl": ir.BinaryOp(Op.SHL, a, b),
    "shr": ir.BinaryOp(Op.SHR, a, b),
    # casts: saturating float -> int, NaN -> 0, wrapping int narrowing
    "x_to_i32": x.cast(I32), "x_to_i64": x.cast(DataType.int64()),
    "x_to_i8": x.cast(DataType.int8()), "x_to_i16": x.cast(DataType.int16()),
    "f_to_i32": f.cast(I32), "f_to_i64": f.cast(DataType.int64()),
    "l_to_i32": ll.cast(I32), "l_to_i8": ll.cast(DataType.int8()),
    "a_to_f32": a.cast(F32), "a_to_bool": a.cast(DataType.bool_()),
    "x_to_bool": x.cast(DataType.bool_()),
    "dec_to_f64": dec.cast(DataType.float64()),
    "dec_to_i32": dec.cast(I32),
    "x_to_dec": x.cast(DataType.decimal(10, 2)),
    "dec_up": dec.cast(DataType.decimal(12, 4)),
    "dec_down": dec.cast(DataType.decimal(10, 0)),
    "date_to_ts": dt.cast(DataType.timestamp_us()),
    "ts_to_date": dt.cast(DataType.timestamp_us()).cast(DataType.date32()),
    # decimal arithmetic on unscaled int64
    "dec_add": dec + dec, "dec_mul": dec * dec, "dec_sub_int": dec - a,
    "dec_div": dec / dec, "dec_add_float": dec + x, "dec_mod": dec % dec,
    # three-valued logic and null predicates
    "and": p & q, "or": p | q, "not": ~p, "and_cmp": (a > 0) & p,
    "or_cmp": (x > 0.0) | q,
    "is_null": a.is_null(), "is_not_null": x.is_not_null(),
    "is_null_nonnull_col": b.is_null(),
    # IN lists, CASE, COALESCE
    "in_small": a.isin([1, 2, -7]),
    "in_null_item": ir.InList(a, (_lit(1), _lit(None, I32))),
    "in_large": a.isin(list(range(-20, 0))),
    "not_in": ir.InList(a, (_lit(3), _lit(4)), negated=True),
    "if": ir.If(p, a, b),
    "case_no_else": ir.CaseWhen(((a > 0, x), (b < 0, y))),
    "case_else": ir.CaseWhen(((x > 10.0, a),), b),
    "coalesce": ir.Coalesce((a, b, _lit(0, I32))),
}


@pytest.fixture(scope="module")
def batches():
    values, validity, sel = _buffers()
    port = interop.batch_from_numpy(SCHEMA, values, validity, sel, ROWS,
                                    "cpu")
    ref = jax_batch(SCHEMA, values, validity, sel, ROWS)
    return port, ref


def _to_jax_expr(e):
    """The same tree in the JAX package's IR, across the wire bytes."""
    wire = serde.expr_to_proto(e).SerializeToString()
    return jax_serde.expr_from_proto(jax_pb.ExprProto.FromString(wire))


@pytest.mark.parametrize("name", list(CASES))
def test_evaluator_matches_jax(name, batches):
    port, ref = batches
    e = CASES[name]
    pe = bind_opt(e, port.schema)
    je = jax_bind_opt(_to_jax_expr(e), ref.schema)
    pv, pm = DeviceEvaluator(
        port.schema, [(c.values, c.validity) for c in port.columns],
        CAP, "cpu").evaluate(pe)
    jv, jm = JaxEvaluator(
        ref.schema, [(c.values, c.validity) for c in ref.columns],
        CAP).evaluate(je)
    jv = np.broadcast_to(np.asarray(jv), (CAP,))
    pv = pv.numpy()
    assert pv.dtype == jv.dtype, (pv.dtype, jv.dtype)
    live = port.live_mask().numpy()
    pvalid = np.ones(CAP, bool) if pm is None else pm.numpy()
    jvalid = np.ones(CAP, bool) if jm is None else np.broadcast_to(
        np.asarray(jm), (CAP,))
    np.testing.assert_array_equal(pvalid[live], jvalid[live])
    both = live & pvalid
    np.testing.assert_array_equal(pv[both], jv[both])


def test_literal_dtypes_follow_the_ir(batches):
    """A float literal compared with a float32 column narrows to f32
    (50.0) or widens the compare to f64 (50.3), never torch's default."""
    port, _ = batches
    narrowed = bind_opt(f > 50.0, port.schema)
    assert narrowed.right.dtype == F32
    wide = bind_opt(f > 50.3, port.schema)
    assert wide.right.dtype == DataType.float64()
    ev = DeviceEvaluator(port.schema,
                         [(c.values, c.validity) for c in port.columns],
                         CAP, "cpu")
    v, _ = ev.evaluate(ir.Literal(1, DataType.int64()))
    assert v.dtype == torch.int64 and v.shape == (CAP,)


@pytest.mark.parametrize("e", [
    # scalar functions run since item 10; the time-of-day ones wait
    ir.ScalarFn("hour", (Col("dt"),)),
    ir.Literal("s", DataType.utf8()),
    Col("a").cast(DataType.utf8()),
], ids=["scalar_fn", "string_literal", "string_cast"])
def test_out_of_slice_expressions_raise(e, batches):
    port, _ = batches
    ev = DeviceEvaluator(port.schema,
                         [(c.values, c.validity) for c in port.columns],
                         CAP, "cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ev.evaluate(bind_opt(e, port.schema))
