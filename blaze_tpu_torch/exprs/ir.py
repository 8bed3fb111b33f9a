"""Expression IR.

Frozen dataclass tree; hashable so compiled pipelines can key jit caches on
(plan fingerprint, shape bucket). Mirrors the reference's physical expression
proto surface (plan.proto PhysicalExprNode; NativeConverters.scala convertExpr
coverage) without copying its layout.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple

from blaze_tpu_torch.types import DataType, Schema


class Op(enum.Enum):
    # arithmetic
    ADD = "+"
    SUB = "-"
    MUL = "*"
    DIV = "/"
    MOD = "%"
    # comparison
    EQ = "="
    NEQ = "!="
    LT = "<"
    LTE = "<="
    GT = ">"
    GTE = ">="
    # logic (three-valued)
    AND = "and"
    OR = "or"
    # bitwise
    BITAND = "&"
    BITOR = "|"
    BITXOR = "^"
    SHL = "<<"
    SHR = ">>"


COMPARISON_OPS = {Op.EQ, Op.NEQ, Op.LT, Op.LTE, Op.GT, Op.GTE}
LOGIC_OPS = {Op.AND, Op.OR}


class Expr:
    """Base class. Subclasses are frozen dataclasses."""

    def _b(self, other, op: Op) -> "BinaryOp":
        return BinaryOp(op, self, _lit(other))

    # operator sugar for tests / plan builders
    def __add__(self, o):
        return self._b(o, Op.ADD)

    def __sub__(self, o):
        return self._b(o, Op.SUB)

    def __mul__(self, o):
        return self._b(o, Op.MUL)

    def __truediv__(self, o):
        return self._b(o, Op.DIV)

    def __mod__(self, o):
        return self._b(o, Op.MOD)

    def __eq__(self, o):  # type: ignore[override]
        if isinstance(o, (Expr, int, float, str, bool)):
            return self._b(o, Op.EQ)
        return NotImplemented

    def __ne__(self, o):  # type: ignore[override]
        if isinstance(o, (Expr, int, float, str, bool)):
            return self._b(o, Op.NEQ)
        return NotImplemented

    def __lt__(self, o):
        return self._b(o, Op.LT)

    def __le__(self, o):
        return self._b(o, Op.LTE)

    def __gt__(self, o):
        return self._b(o, Op.GT)

    def __ge__(self, o):
        return self._b(o, Op.GTE)

    def __and__(self, o):
        return self._b(o, Op.AND)

    def __or__(self, o):
        return self._b(o, Op.OR)

    def __invert__(self):
        return Not(self)

    def __hash__(self):
        # dataclass eq=False subclasses inherit identity hash; frozen
        # dataclasses below override via generated __hash__.
        return super().__hash__()

    def is_null(self) -> "IsNull":
        return IsNull(self)

    def is_not_null(self) -> "IsNotNull":
        return IsNotNull(self)

    def isin(self, values) -> "InList":
        return InList(self, tuple(_lit(v) for v in values))

    def cast(self, to: DataType) -> "Cast":
        return Cast(self, to)


def _lit(v) -> Expr:
    if isinstance(v, Expr):
        return v
    return Literal.infer(v)


def _expr_dc(cls):
    """Frozen dataclass with structural hash; __eq__ stays the sugar above."""
    cls = dataclasses.dataclass(frozen=True, eq=False, repr=True)(cls)

    def _hash(self):
        return hash(
            (cls.__name__,)
            + tuple(
                tuple(v) if isinstance(v, list) else v
                for v in (
                    getattr(self, f.name) for f in dataclasses.fields(cls)
                )
            )
        )

    cls.__hash__ = _hash
    return cls


@_expr_dc
class Literal(Expr):
    value: object
    dtype: DataType

    @staticmethod
    def infer(v) -> "Literal":
        if v is None:
            return Literal(None, DataType.null())
        if isinstance(v, bool):
            return Literal(v, DataType.bool_())
        if isinstance(v, int):
            return Literal(v, DataType.int64())
        if isinstance(v, float):
            return Literal(v, DataType.float64())
        if isinstance(v, str):
            return Literal(v, DataType.utf8())
        if isinstance(v, bytes):
            return Literal(v, DataType.binary())
        raise TypeError(f"cannot infer literal type of {v!r}")


@_expr_dc
class Col(Expr):
    """Unresolved column reference by name."""

    name: str

    def bind(self, schema: Schema) -> "BoundCol":
        i = schema.index_of(self.name)
        return BoundCol(i, schema.fields[i].dtype)


@_expr_dc
class BoundCol(Expr):
    """Resolved column reference by position."""

    index: int
    dtype: DataType


@_expr_dc
class Cast(Expr):
    child: Expr
    to: DataType


@_expr_dc
class BinaryOp(Expr):
    op: Op
    left: Expr
    right: Expr


@_expr_dc
class Not(Expr):
    child: Expr


@_expr_dc
class Negate(Expr):
    child: Expr


@_expr_dc
class IsNull(Expr):
    child: Expr


@_expr_dc
class IsNotNull(Expr):
    child: Expr


@_expr_dc
class InList(Expr):
    child: Expr
    values: Tuple[Expr, ...]
    negated: bool = False


@_expr_dc
class If(Expr):
    cond: Expr
    then: Expr
    otherwise: Expr


@_expr_dc
class CaseWhen(Expr):
    """CASE [expr] WHEN v1 THEN r1 ... ELSE e END.

    Normalized at build time to predicate form: branches are
    (condition, result) pairs."""

    branches: Tuple[Tuple[Expr, Expr], ...]
    otherwise: Optional[Expr] = None


@_expr_dc
class ScalarFn(Expr):
    """Named scalar function (reference scalar fn surface,
    NativeConverters.scala:395-489 + spark_ext_function.rs)."""

    name: str
    args: Tuple[Expr, ...]


@_expr_dc
class Coalesce(Expr):
    args: Tuple[Expr, ...]


class AggFn(enum.Enum):
    MIN = "min"
    MAX = "max"
    SUM = "sum"
    AVG = "avg"
    COUNT = "count"  # count(expr): non-null rows
    COUNT_STAR = "count_star"
    VAR_SAMP = "var_samp"
    VAR_POP = "var_pop"
    STDDEV_SAMP = "stddev_samp"
    STDDEV_POP = "stddev_pop"
    FIRST = "first"
    LAST = "last"


@_expr_dc
class AggExpr(Expr):
    """Aggregate call; only valid inside Aggregate plan nodes."""

    fn: AggFn
    child: Optional[Expr]  # None for COUNT(*)


# ---------------------------------------------------------------------------
# tree utilities
# ---------------------------------------------------------------------------

def children(e: Expr) -> Tuple[Expr, ...]:
    if isinstance(e, (Literal, Col, BoundCol)):
        return ()
    if isinstance(e, Cast):
        return (e.child,)
    if isinstance(e, BinaryOp):
        return (e.left, e.right)
    if isinstance(e, (Not, Negate, IsNull, IsNotNull)):
        return (e.child,)
    if isinstance(e, InList):
        return (e.child,) + e.values
    if isinstance(e, If):
        return (e.cond, e.then, e.otherwise)
    if isinstance(e, CaseWhen):
        out = []
        for c, r in e.branches:
            out += [c, r]
        if e.otherwise is not None:
            out.append(e.otherwise)
        return tuple(out)
    if isinstance(e, (ScalarFn, Coalesce)):
        return tuple(e.args)
    if isinstance(e, AggExpr):
        return (e.child,) if e.child is not None else ()
    raise TypeError(f"unknown expr {type(e)}")


def with_children(e: Expr, kids) -> Expr:
    """Shallow rebuild of a node with replacement children (same arity and
    order as `children(e)`)."""
    kids = list(kids)
    if isinstance(e, (Literal, Col, BoundCol)):
        return e
    if isinstance(e, Cast):
        return Cast(kids[0], e.to)
    if isinstance(e, BinaryOp):
        return BinaryOp(e.op, kids[0], kids[1])
    if isinstance(e, Not):
        return Not(kids[0])
    if isinstance(e, Negate):
        return Negate(kids[0])
    if isinstance(e, IsNull):
        return IsNull(kids[0])
    if isinstance(e, IsNotNull):
        return IsNotNull(kids[0])
    if isinstance(e, InList):
        return InList(kids[0], tuple(kids[1:]), e.negated)
    if isinstance(e, If):
        return If(kids[0], kids[1], kids[2])
    if isinstance(e, CaseWhen):
        nb = len(e.branches)
        branches = tuple(
            (kids[2 * i], kids[2 * i + 1]) for i in range(nb)
        )
        otherwise = kids[2 * nb] if e.otherwise is not None else None
        return CaseWhen(branches, otherwise)
    if isinstance(e, ScalarFn):
        return ScalarFn(e.name, tuple(kids))
    if isinstance(e, Coalesce):
        return Coalesce(tuple(kids))
    if isinstance(e, AggExpr):
        return AggExpr(e.fn, kids[0] if kids else None)
    raise TypeError(f"unknown expr {type(e)}")


def transform(e: Expr, fn) -> Expr:
    """Bottom-up rewrite."""
    if isinstance(e, Cast):
        e = Cast(transform(e.child, fn), e.to)
    elif isinstance(e, BinaryOp):
        e = BinaryOp(e.op, transform(e.left, fn), transform(e.right, fn))
    elif isinstance(e, Not):
        e = Not(transform(e.child, fn))
    elif isinstance(e, Negate):
        e = Negate(transform(e.child, fn))
    elif isinstance(e, IsNull):
        e = IsNull(transform(e.child, fn))
    elif isinstance(e, IsNotNull):
        e = IsNotNull(transform(e.child, fn))
    elif isinstance(e, InList):
        e = InList(
            transform(e.child, fn),
            tuple(transform(v, fn) for v in e.values),
            e.negated,
        )
    elif isinstance(e, If):
        e = If(
            transform(e.cond, fn),
            transform(e.then, fn),
            transform(e.otherwise, fn),
        )
    elif isinstance(e, CaseWhen):
        e = CaseWhen(
            tuple(
                (transform(c, fn), transform(r, fn)) for c, r in e.branches
            ),
            transform(e.otherwise, fn) if e.otherwise is not None else None,
        )
    elif isinstance(e, ScalarFn):
        e = ScalarFn(e.name, tuple(transform(a, fn) for a in e.args))
    elif isinstance(e, Coalesce):
        e = Coalesce(tuple(transform(a, fn) for a in e.args))
    elif isinstance(e, AggExpr):
        e = AggExpr(
            e.fn, transform(e.child, fn) if e.child is not None else None
        )
    return fn(e)


def bind(e: Expr, schema: Schema) -> Expr:
    """Resolve Col -> BoundCol against a schema."""

    def rule(x: Expr) -> Expr:
        if isinstance(x, Col):
            return x.bind(schema)
        return x

    return transform(e, rule)
