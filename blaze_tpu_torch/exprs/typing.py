"""Output-type inference for the expression IR.

Promotion rules follow Spark's numeric widening (TinyInt<SmallInt<Int<BigInt<
Float<Double); decimals stay in the engine's i64-unscaled representation
(reference plan.proto:598-601). Plans arriving from a Spark-side converter
already carry explicit Casts (NativeConverters.scala convertExpr), so these
rules only need to cover well-typed trees.
"""

from __future__ import annotations

from blaze_tpu_torch.types import DataType, Schema, TypeId
from blaze_tpu_torch.exprs import ir
from blaze_tpu_torch.exprs.ir import Op

_NUMERIC_ORDER = [
    TypeId.INT8,
    TypeId.INT16,
    TypeId.INT32,
    TypeId.INT64,
    TypeId.FLOAT32,
    TypeId.FLOAT64,
]


def promote(a: DataType, b: DataType) -> DataType:
    if a == b:
        return a
    if a.id is TypeId.NULL:
        return b
    if b.id is TypeId.NULL:
        return a
    if a.id is TypeId.DECIMAL or b.id is TypeId.DECIMAL:
        if a.id is TypeId.DECIMAL and b.id is TypeId.DECIMAL:
            return DataType.decimal(
                max(a.precision, b.precision), max(a.scale, b.scale)
            )
        other = b if a.id is TypeId.DECIMAL else a
        if other.is_integer:
            return a if a.id is TypeId.DECIMAL else b
        return DataType.float64()
    if a.id in _NUMERIC_ORDER and b.id in _NUMERIC_ORDER:
        return DataType(
            _NUMERIC_ORDER[
                max(_NUMERIC_ORDER.index(a.id), _NUMERIC_ORDER.index(b.id))
            ]
        )
    if a.id is TypeId.BOOL and b.id in _NUMERIC_ORDER:
        return b
    if b.id is TypeId.BOOL and a.id in _NUMERIC_ORDER:
        return a
    # date/timestamp comparisons against each other handled by equality of
    # ids above; anything else is a planner bug.
    raise TypeError(f"cannot promote {a} vs {b}")


_DEVICE_FN_TYPES = {
    # name -> fixed result type (None = same as first arg promoted to float)
    "sqrt": TypeId.FLOAT64,
    "exp": TypeId.FLOAT64,
    "ln": TypeId.FLOAT64,
    "log": TypeId.FLOAT64,
    "log2": TypeId.FLOAT64,
    "log10": TypeId.FLOAT64,
    "sin": TypeId.FLOAT64,
    "cos": TypeId.FLOAT64,
    "tan": TypeId.FLOAT64,
    "asin": TypeId.FLOAT64,
    "acos": TypeId.FLOAT64,
    "atan": TypeId.FLOAT64,
    "atan2": TypeId.FLOAT64,
    "sinh": TypeId.FLOAT64,
    "cosh": TypeId.FLOAT64,
    "tanh": TypeId.FLOAT64,
    "pow": TypeId.FLOAT64,
    "isnan": TypeId.BOOL,
}

_STRING_FNS_BOOL = {"starts_with", "ends_with", "contains", "like"}
_STRING_FNS_STR = {
    "lower",
    "upper",
    "trim",
    "ltrim",
    "rtrim",
    "substring",
    "concat",
    "replace",
    "reverse",
}


def expr_computes_wide_decimal(e: ir.Expr, schema: Schema) -> bool:
    """True when any non-passthrough node consumes a decimal(>18) input.
    Wide decimals are limb-pair columns (types.is_wide_decimal) that
    pass through scans/projections/aggregate states exactly, but VALUE
    compute on them needs 128-bit host math - operators raise at
    CONSTRUCTION so the planner's tryConvert falls back to the host
    tier (the window the reference uses, BlazeConverters tryConvert)."""
    if isinstance(e, (ir.BoundCol, ir.Col, ir.Literal)):
        return False
    if (
        isinstance(e, ir.BinaryOp)
        and e.op in ir.COMPARISON_OPS
        and all(
            isinstance(c, (ir.BoundCol, ir.Col, ir.Literal))
            for c in ir.children(e)
        )
    ):
        # comparisons stay on device: the evaluator's two-limb
        # lexicographic compare handles wide pairs - provided all
        # operands are integers-at-one-scale (unscaled values are then
        # directly comparable; rescaling would need 128-bit multiplies,
        # and floats cannot ride the limb compare at all)
        scales = set()
        ok = True
        for c in ir.children(e):
            try:
                dt = infer_dtype(c, schema)
            except Exception:
                ok = False
                break
            if dt.id is TypeId.DECIMAL:
                scales.add(dt.scale)
            elif dt.is_floating or dt.is_string_like:
                ok = False
                break
            else:
                scales.add(0)  # integer comparand = scale 0
        if ok and len(scales) <= 1:
            return False
    if (
        isinstance(e, ir.BinaryOp)
        and e.op in (Op.ADD, Op.SUB, Op.MUL, Op.DIV)
        and all(
            isinstance(c, (ir.BoundCol, ir.Col, ir.Literal))
            for c in ir.children(e)
        )
    ):
        # +,-,* (and / -> float64) over wide decimals run on device
        # since round 4: 128-bit limb arithmetic with Spark overflow-
        # NULL and HALF_UP rounding (exprs/int128.py, evaluator
        # _decimal_arith_wide). Only direct column/literal operands
        # qualify - nested wide arithmetic still composes through the
        # host tier (each node's output would need limb-pair
        # propagation through the expression cache).
        ok = True
        for c in ir.children(e):
            try:
                dt = infer_dtype(c, schema)
            except Exception:
                ok = False
                break
            if not (dt.id is TypeId.DECIMAL or dt.is_integer):
                ok = False
                break
        if ok:
            return False
    for c in ir.children(e):
        if expr_computes_wide_decimal(c, schema):
            return True
        try:
            if infer_dtype(c, schema).is_wide_decimal:
                return True
        except Exception:
            continue
    return False


def infer_dtype(e: ir.Expr, schema: Schema) -> DataType:
    if isinstance(e, ir.Literal):
        return e.dtype
    if isinstance(e, ir.Col):
        return schema.field(e.name).dtype
    if isinstance(e, ir.BoundCol):
        return e.dtype
    if isinstance(e, ir.Cast):
        return e.to
    if isinstance(e, ir.BinaryOp):
        lt = infer_dtype(e.left, schema)
        rt = infer_dtype(e.right, schema)
        if e.op in ir.COMPARISON_OPS or e.op in ir.LOGIC_OPS:
            return DataType.bool_()
        if e.op is Op.DIV and not (lt.is_floating or rt.is_floating) and (
            lt.id is TypeId.DECIMAL or rt.id is TypeId.DECIMAL
        ):
            return DataType.float64()
        return promote(lt, rt)
    if isinstance(e, (ir.Not,)):
        return DataType.bool_()
    if isinstance(e, ir.Negate):
        return infer_dtype(e.child, schema)
    if isinstance(e, (ir.IsNull, ir.IsNotNull)):
        return DataType.bool_()
    if isinstance(e, ir.InList):
        return DataType.bool_()
    if isinstance(e, ir.If):
        return promote(
            infer_dtype(e.then, schema), infer_dtype(e.otherwise, schema)
        )
    if isinstance(e, ir.CaseWhen):
        t = None
        for _, r in e.branches:
            rt = infer_dtype(r, schema)
            t = rt if t is None else promote(t, rt)
        if e.otherwise is not None:
            t = promote(t, infer_dtype(e.otherwise, schema))
        return t
    if isinstance(e, ir.Coalesce):
        t = None
        for a in e.args:
            at = infer_dtype(a, schema)
            t = at if t is None else promote(t, at)
        return t
    if isinstance(e, ir.ScalarFn):
        n = e.name
        if n in _DEVICE_FN_TYPES:
            return DataType(_DEVICE_FN_TYPES[n])
        if n in ("abs", "negative", "positive", "signum", "round", "trunc",
                 "ceil", "floor", "nanvl", "greatest", "least", "pmod"):
            if n in ("ceil", "floor"):
                # Spark: ceil/floor(double) -> bigint
                ct = infer_dtype(e.args[0], schema)
                return (
                    ct if ct.is_integer or ct.id is TypeId.DECIMAL
                    else DataType.int64()
                )
            t = None
            for a in e.args:
                at = infer_dtype(a, schema)
                t = at if t is None else promote(t, at)
            return t
        if n in ("length", "char_length"):
            return DataType.int32()
        if n in _STRING_FNS_BOOL:
            return DataType.bool_()
        if n in _STRING_FNS_STR:
            return DataType.utf8()
        if n == "spark_unscaled_value":
            return DataType.int64()
        if n == "spark_make_decimal":
            return DataType.decimal(38, 0)
        if n in ("murmur3_hash", "hash"):
            return DataType.int32()
        if n in ("year", "month", "day", "dayofmonth", "dayofweek",
                 "dayofyear", "quarter", "hour", "minute", "second",
                 "weekofyear", "date_part", "octet_length"):
            return DataType.int32()
        if n in ("to_date", "trunc_date"):
            return DataType.date32()
        if n == "null_if":
            return infer_dtype(e.args[0], schema)
        if n in ("md5", "sha224", "sha256", "sha384", "sha512"):
            return DataType.utf8()
        raise NotImplementedError(f"unknown scalar fn {n}")
    if isinstance(e, ir.AggExpr):
        from blaze_tpu_torch.exprs.ir import AggFn

        if e.fn in (AggFn.COUNT, AggFn.COUNT_STAR):
            return DataType.int64()
        ct = infer_dtype(e.child, schema)
        if e.fn is AggFn.SUM:
            if ct.is_integer:
                return DataType.int64()
            if ct.id is TypeId.DECIMAL:
                return DataType.decimal(38, ct.scale)
            return DataType.float64()
        if e.fn is AggFn.AVG:
            if ct.id is TypeId.DECIMAL:
                return DataType.decimal(38, min(ct.scale + 4, 38))
            return DataType.float64()
        if e.fn in (AggFn.MIN, AggFn.MAX, AggFn.FIRST, AggFn.LAST):
            return ct
        return DataType.float64()  # var/stddev family
    raise TypeError(f"cannot infer type of {type(e)}")
