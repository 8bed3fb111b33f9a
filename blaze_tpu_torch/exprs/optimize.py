"""Expression-level optimizations applied at operator bind time.

`narrow_literals`: Python-inferred literals arrive as int64/float64 (like
Spark's parser defaults to the widest comfortable type), but comparing or
combining an int32/float32 column with a wide literal promotes the whole
column - and on TPU, 64-bit integer and especially float64 arithmetic is
*emulated* (f32-pair software arithmetic after the no-X64 rewrite), an
order-of-magnitude penalty on the VPU. When the literal's value is exactly
representable in the other operand's narrower type, rewriting the literal
is semantics-preserving and keeps the whole expression in native-width
arithmetic. Lossless-only: 50.0 narrows to f32, 50.3 does not (its f32
rounding would change comparison results), 2^40 never narrows to int32.
"""

from __future__ import annotations

import numpy as np

from blaze_tpu_torch.types import DataType, Schema, TypeId
from blaze_tpu_torch.exprs import ir
from blaze_tpu_torch.exprs.typing import infer_dtype

_NARROWABLE_NUM = {
    TypeId.INT8, TypeId.INT16, TypeId.INT32, TypeId.INT64,
    TypeId.FLOAT32, TypeId.FLOAT64,
}


def _try_narrow(lit: ir.Literal, target: DataType) -> ir.Literal:
    if lit.value is None or lit.dtype == target:
        return lit
    if target.id not in _NARROWABLE_NUM or \
            lit.dtype.id not in _NARROWABLE_NUM:
        return lit
    v = lit.value
    phys = target.physical_dtype()
    if target.id in (TypeId.FLOAT32, TypeId.FLOAT64):
        cast = phys.type(v)
        if float(cast) == float(v) or (np.isnan(cast) and v != v):
            return ir.Literal(float(v), target)
        return lit
    # integer target: must be an integral value in range
    if isinstance(v, float) and not float(v).is_integer():
        return lit
    iv = int(v)
    info = np.iinfo(phys)
    if info.min <= iv <= info.max:
        return ir.Literal(iv, target)
    return lit


def narrow_literals(e: ir.Expr, schema: Schema) -> ir.Expr:
    """Bottom-up literal narrowing across binary ops and IN lists."""

    def rule(x: ir.Expr) -> ir.Expr:
        if isinstance(x, ir.BinaryOp):
            lt = _safe_dtype(x.left, schema)
            rt = _safe_dtype(x.right, schema)
            if isinstance(x.right, ir.Literal) and lt is not None:
                return ir.BinaryOp(
                    x.op, x.left, _try_narrow(x.right, lt)
                )
            if isinstance(x.left, ir.Literal) and rt is not None:
                return ir.BinaryOp(
                    x.op, _try_narrow(x.left, rt), x.right
                )
        if isinstance(x, ir.InList):
            ct = _safe_dtype(x.child, schema)
            if ct is not None:
                return ir.InList(
                    x.child,
                    tuple(
                        _try_narrow(v, ct)
                        if isinstance(v, ir.Literal) else v
                        for v in x.values
                    ),
                    x.negated,
                )
        return x

    return ir.transform(e, rule)


def _safe_dtype(e: ir.Expr, schema: Schema):
    if isinstance(e, ir.Literal):
        return None
    try:
        return infer_dtype(e, schema)
    except Exception:
        return None


def bind_opt(e: ir.Expr, schema: Schema) -> ir.Expr:
    """bind + standard optimization passes (operator entry point)."""
    return narrow_literals(ir.bind(e, schema), schema)
