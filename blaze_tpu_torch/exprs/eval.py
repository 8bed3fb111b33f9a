"""Device columnar expression evaluator on torch tensors.

Evaluates the IR over padded device columns, eagerly, one torch op at a
time (no fusion in this slice). A column value is the pair (values,
validity) where validity is None for all-valid.

Null semantics follow Spark SQL (non-ANSI), as in the JAX package's
evaluator (blaze_tpu/exprs/eval.py):
- arithmetic/comparison: NULL if any input is NULL
- x / 0 and x % 0 are NULL (all numeric types)
- AND/OR are three-valued (FALSE AND NULL = FALSE, TRUE OR NULL = TRUE)
- NaN equals NaN and sorts greater than any other double
- IS NULL / IS NOT NULL never return NULL

Where the JAX package leans on XLA's defined behaviour, this module
spells the result out, because torch on CUDA leaves it undefined:
- integer division truncates and remainder takes the dividend's sign
  (lax.div / lax.rem); MIN / -1 wraps to MIN and MIN % -1 is 0;
- float -> int casts saturate at the target's range and map NaN to 0
  (XLA's convert on the CPU);
- shifts by >= the bit width give 0 (<<) or the sign fill (>>).

Every literal takes its dtype from the IR (`infer_dtype`), never from
torch's defaults. Strings, wide decimals and scalar functions raise
NotImplementedError naming the ROADMAP item that brings them.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from blaze_tpu_torch.batch import torch_dtype
from blaze_tpu_torch.types import DataType, Schema, TypeId
from blaze_tpu_torch.exprs import ir
from blaze_tpu_torch.exprs.ir import Op
from blaze_tpu_torch.exprs.typing import infer_dtype, promote

CV = Tuple[torch.Tensor, Optional[torch.Tensor]]  # (values, validity|None)

_ROADMAP_EXPRS = "ROADMAP 'Modules to port': expressions and types"


def and_validity(a: Optional[torch.Tensor],
                 b: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    if a is None:
        return b
    if b is None:
        return a
    return a & b


def valid_or_true(v: Optional[torch.Tensor], like: torch.Tensor
                  ) -> torch.Tensor:
    if v is None:
        return torch.ones(like.shape, dtype=torch.bool, device=like.device)
    return v


class DeviceEvaluator:
    """Evaluate bound expressions against a batch's device columns."""

    def __init__(self, schema: Schema, columns: Sequence[CV],
                 capacity: int, device: torch.device):
        self.schema = schema
        self.columns = list(columns)
        self.capacity = capacity
        self.device = torch.device(device)

    # ------------------------------------------------------------------
    def evaluate(self, e: ir.Expr) -> CV:
        return self._eval(e)

    def evaluate_predicate(self, e: ir.Expr) -> torch.Tensor:
        """Predicate result with SQL WHERE semantics: NULL -> False."""
        v, m = self._eval(e)
        v = v.to(torch.bool)
        if m is not None:
            v = v & m
        return v

    # ------------------------------------------------------------------
    def _eval(self, e: ir.Expr) -> CV:
        if isinstance(e, ir.BoundCol):
            return self.columns[e.index]
        if isinstance(e, ir.Col):
            return self.columns[self.schema.index_of(e.name)]
        if isinstance(e, ir.Literal):
            return self._literal(e)
        if isinstance(e, ir.Cast):
            return self._cast(e)
        if isinstance(e, ir.BinaryOp):
            return self._binary(e)
        if isinstance(e, ir.Not):
            v, m = self._eval(e.child)
            return ~v.to(torch.bool), m
        if isinstance(e, ir.Negate):
            v, m = self._eval(e.child)
            return -v, m
        if isinstance(e, ir.IsNull):
            _, m = self._eval(e.child)
            if m is None:
                return self._full(False, torch.bool), None
            return ~m, None
        if isinstance(e, ir.IsNotNull):
            _, m = self._eval(e.child)
            if m is None:
                return self._full(True, torch.bool), None
            return m, None
        if isinstance(e, ir.InList):
            return self._in_list(e)
        if isinstance(e, ir.If):
            return self._case(
                ir.CaseWhen(((e.cond, e.then),), e.otherwise)
            )
        if isinstance(e, ir.CaseWhen):
            return self._case(e)
        if isinstance(e, ir.Coalesce):
            return self._coalesce(e)
        if isinstance(e, ir.ScalarFn):
            raise NotImplementedError(
                f"scalar function {e.name!r} waits for {_ROADMAP_EXPRS}"
            )
        raise NotImplementedError(
            f"device evaluator: unsupported expr {type(e).__name__}"
        )

    def _full(self, value, dtype: torch.dtype) -> torch.Tensor:
        return torch.full((self.capacity,), value, dtype=dtype,
                          device=self.device)

    # ------------------------------------------------------------------
    def _literal(self, e: ir.Literal) -> CV:
        if e.dtype is not None and (
            e.dtype.is_string_like or e.dtype.is_wide_decimal
        ):
            raise NotImplementedError(
                f"{e.dtype} literals wait for {_ROADMAP_EXPRS}"
            )
        if e.value is None:
            # zeros carry the literal's PHYSICAL dtype (see the JAX
            # evaluator: a NULL int32 literal must not narrow to int8)
            phys = torch.int8 if e.dtype is None else torch_dtype(e.dtype)
            return self._full(0, phys), self._full(False, torch.bool)
        return self._full(e.value, torch_dtype(e.dtype)), None

    def _cast(self, e: ir.Cast) -> CV:
        v, m = self._eval(e.child)
        src = infer_dtype(e.child, self.schema)
        dst = e.to
        if src == dst:
            return v, m
        for t in (src, dst):
            if t.is_string_like or t.is_wide_decimal:
                raise NotImplementedError(
                    f"cast {src} -> {dst} waits for {_ROADMAP_EXPRS}"
                )
        if src.id is TypeId.DECIMAL and dst.id is TypeId.DECIMAL:
            # rescale unscaled i64 by 10^(dst.scale - src.scale)
            dscale = dst.scale - src.scale
            if dscale >= 0:
                return v * (10 ** dscale), m
            return _java_div(v, torch.full_like(v, 10 ** (-dscale))), m
        if src.id is TypeId.DECIMAL:
            scaled = v.to(torch.float64) / (10.0 ** src.scale)
            return _convert(scaled, dst), m
        if dst.id is TypeId.DECIMAL:
            out = v.to(torch.float64) * (10.0 ** dst.scale)
            return _float_to_int(torch.round(out), torch.int64), m
        if src.id is TypeId.DATE32 and dst.id is TypeId.TIMESTAMP_US:
            return v.to(torch.int64) * 86_400_000_000, m
        if src.id is TypeId.TIMESTAMP_US and dst.id is TypeId.DATE32:
            return torch.div(v, 86_400_000_000, rounding_mode="floor") \
                .to(torch.int32), m
        if dst.id is TypeId.BOOL:
            return v != 0, m
        # numeric <-> numeric: ints wrap, floats truncate toward zero
        return _convert(v, dst), m

    # ------------------------------------------------------------------
    def _binary(self, e: ir.BinaryOp) -> CV:
        op = e.op
        if op in ir.LOGIC_OPS:
            return self._logic(e)
        lv, lm = self._eval(e.left)
        rv, rm = self._eval(e.right)
        lt = infer_dtype(e.left, self.schema)
        rt = infer_dtype(e.right, self.schema)
        m = and_validity(lm, rm)
        if op in ir.COMPARISON_OPS:
            return self._compare(op, lv, rv, lt, rt, m)
        out_t = infer_dtype(e, self.schema)
        if lt.id is TypeId.DECIMAL or rt.id is TypeId.DECIMAL:
            return self._decimal_arith(op, lv, rv, lt, rt, out_t, m)
        phys = torch_dtype(out_t)
        lv = lv.to(phys)
        rv = rv.to(phys)
        if op is Op.ADD:
            return lv + rv, m
        if op is Op.SUB:
            return lv - rv, m
        if op is Op.MUL:
            return lv * rv, m
        if op is Op.DIV:
            return self._div(lv, rv, out_t, m)
        if op is Op.MOD:
            return self._mod(lv, rv, m)
        if op is Op.BITAND:
            return lv & rv, m
        if op is Op.BITOR:
            return lv | rv, m
        if op is Op.BITXOR:
            return lv ^ rv, m
        if op in (Op.SHL, Op.SHR):
            return _shift(op, lv, rv), m
        raise NotImplementedError(op)

    def _compare(self, op, lv, rv, lt, rt, m) -> CV:
        if lt.is_wide_decimal or rt.is_wide_decimal:
            raise NotImplementedError(
                f"decimal(>18) comparison waits for {_ROADMAP_EXPRS}"
            )
        ct = promote(lt, rt) if lt != rt else lt
        phys = torch_dtype(ct)
        lv = lv.to(phys)
        rv = rv.to(phys)
        if ct.is_floating:
            # Spark NaN semantics: NaN == NaN, NaN greater than everything
            ln = torch.isnan(lv)
            rn = torch.isnan(rv)
            if op is Op.EQ:
                return (lv == rv) | (ln & rn), m
            if op is Op.NEQ:
                return ~((lv == rv) | (ln & rn)), m
            if op is Op.LT:
                return ~ln & (rn | (lv < rv)), m
            if op is Op.LTE:
                return torch.where(ln, rn, rn | (lv <= rv)), m
            if op is Op.GT:
                return ~rn & (ln | (lv > rv)), m
            if op is Op.GTE:
                return torch.where(rn, ln, ln | (lv >= rv)), m
        table = {
            Op.EQ: lambda: lv == rv,
            Op.NEQ: lambda: lv != rv,
            Op.LT: lambda: lv < rv,
            Op.LTE: lambda: lv <= rv,
            Op.GT: lambda: lv > rv,
            Op.GTE: lambda: lv >= rv,
        }
        return table[op](), m

    def _div(self, lv, rv, out_t: DataType, m) -> CV:
        zero = rv == 0
        safe = torch.where(zero, torch.ones_like(rv), rv)
        if out_t.is_floating:
            return lv / safe, and_validity(m, ~zero)
        return _java_div(lv, safe), and_validity(m, ~zero)

    def _mod(self, lv, rv, m) -> CV:
        zero = rv == 0
        safe = torch.where(zero, torch.ones_like(rv), rv)
        return _java_rem(lv, safe), and_validity(m, ~zero)

    def _decimal_arith(self, op, lv, rv, lt, rt, out_t, m) -> CV:
        """decimal(<=18) arithmetic on unscaled int64; a float operand
        (or DIV) takes the float64 path, as in the JAX evaluator."""
        if lt.is_wide_decimal or rt.is_wide_decimal or \
                out_t.is_wide_decimal:
            raise NotImplementedError(
                f"decimal(>18) arithmetic waits for {_ROADMAP_EXPRS}"
            )

        def unscaled(v, t):
            if t.id is TypeId.DECIMAL:
                return v.to(torch.int64), t.scale
            if t.is_integer:
                return v.to(torch.int64), 0
            return v, None  # float operand -> float path

        lu, ls = unscaled(lv, lt)
        ru, rs = unscaled(rv, rt)
        if ls is None or rs is None or op is Op.DIV:
            def to_f(v, t):
                return v.to(torch.float64) / (
                    10.0 ** t.scale if t.id is TypeId.DECIMAL else 1.0
                )

            lf = to_f(lv, lt)
            rf = to_f(rv, rt)
            if op is Op.DIV:
                return self._div(lf, rf, DataType.float64(), m)
            if op is Op.ADD:
                return lf + rf, m
            if op is Op.SUB:
                return lf - rf, m
            if op is Op.MUL:
                return lf * rf, m
            raise NotImplementedError(f"decimal {op}")
        target = out_t.scale
        if op in (Op.ADD, Op.SUB):
            lu = lu * (10 ** (target - ls))
            ru = ru * (10 ** (target - rs))
        if op is Op.ADD:
            return lu + ru, m
        if op is Op.SUB:
            return lu - ru, m
        if op is Op.MUL:
            # scale(l)+scale(r) -> rescale down to out scale
            prod = lu * ru
            down = ls + rs - target
            if down > 0:
                prod = _java_div(prod, torch.full_like(prod, 10 ** down))
            return prod, m
        if op is Op.MOD:
            return self._mod(lu, ru, m)
        raise NotImplementedError(f"decimal {op}")

    def _logic(self, e: ir.BinaryOp) -> CV:
        lv, lm = self._eval(e.left)
        rv, rm = self._eval(e.right)
        lv = lv.to(torch.bool)
        rv = rv.to(torch.bool)
        if lm is None and rm is None:
            return (lv & rv if e.op is Op.AND else lv | rv), None
        lvalid = valid_or_true(lm, lv)
        rvalid = valid_or_true(rm, rv)
        if e.op is Op.AND:
            # known iff either side is known-FALSE or both sides are known
            known = (lvalid & ~lv) | (rvalid & ~rv) | (lvalid & rvalid)
            return lv & rv, known
        # OR: known iff either side is known-TRUE or both known
        known = (lvalid & lv) | (rvalid & rv) | (lvalid & rvalid)
        return lv | rv, known

    def _in_list(self, e: ir.InList) -> CV:
        v, m = self._eval(e.child)
        any_null_item = any(
            isinstance(x, ir.Literal) and x.value is None
            for x in e.values
        )
        non_null = [
            x for x in e.values
            if not (isinstance(x, ir.Literal) and x.value is None)
        ]
        ct = infer_dtype(e.child, self.schema)
        hit = self._full(False, torch.bool)
        for item in non_null:
            iv, _ = self._eval(item)
            phys = torch_dtype(promote(ct, infer_dtype(item, self.schema)))
            hit = hit | (v.to(phys) == iv.to(phys))
        # Spark: x IN (...) is NULL if no match and any element (or x)
        # is NULL
        validity = m
        if any_null_item:
            validity = and_validity(validity, hit)
        return (~hit if e.negated else hit), validity

    def _case(self, e: ir.CaseWhen) -> CV:
        phys = torch_dtype(infer_dtype(e, self.schema))
        if e.otherwise is not None:
            acc_v, acc_m = self._eval(e.otherwise)
            acc_v = acc_v.to(phys)
        else:
            acc_v = self._full(0, phys)
            acc_m = self._full(False, torch.bool)
        # fold branches right-to-left so the first matching wins
        for cond, result in reversed(e.branches):
            c = self.evaluate_predicate(cond)
            rv, rm = self._eval(result)
            rv = rv.to(phys)
            acc_v = torch.where(c, rv, acc_v)
            if rm is not None or acc_m is not None:
                acc_m = torch.where(c, valid_or_true(rm, rv),
                                    valid_or_true(acc_m, acc_v))
        return acc_v, acc_m

    def _coalesce(self, e: ir.Coalesce) -> CV:
        phys = torch_dtype(infer_dtype(e, self.schema))
        acc_v = self._full(0, phys)
        acc_m = self._full(False, torch.bool)
        for a in reversed(e.args):
            v, m = self._eval(a)
            v = v.to(phys)
            valid = valid_or_true(m, v)
            acc_v = torch.where(valid, v, acc_v)
            acc_m = valid | acc_m
        return acc_v, acc_m


# ---------------------------------------------------------------------------
# integer semantics spelled out (see the module docstring)
# ---------------------------------------------------------------------------

def _java_div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Integer division truncating toward zero (lax.div); MIN / -1
    wraps to MIN. `b` must hold no zeros."""
    neg1 = b == -1
    q = torch.div(a, torch.where(neg1, torch.ones_like(b), b),
                  rounding_mode="trunc")
    return torch.where(neg1, -a, q)


def _java_rem(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Remainder with the dividend's sign (lax.rem, C fmod); x % -1 is 0
    for integers. `b` must hold no zeros."""
    if a.is_floating_point():
        return torch.fmod(a, b)
    neg1 = b == -1
    r = torch.fmod(a, torch.where(neg1, torch.ones_like(b), b))
    return torch.where(neg1, torch.zeros_like(r), r)


def _shift(op: Op, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    bits = a.element_size() * 8
    out_of_range = (b < 0) | (b >= bits)
    amt = torch.where(out_of_range, torch.zeros_like(b), b)
    if op is Op.SHL:
        return torch.where(out_of_range, torch.zeros_like(a), a << amt)
    return torch.where(out_of_range, a >> (bits - 1), a >> amt)


def _float_to_int(v: torch.Tensor, dst: torch.dtype) -> torch.Tensor:
    """Saturating float -> int conversion, NaN -> 0 (XLA's convert)."""
    info = torch.iinfo(dst)
    hi = float(info.max) + 1.0  # 2^(bits-1): exact in f32 and f64
    lo = float(info.min)
    big = v >= hi
    small = v < lo
    bad = torch.isnan(v) | big | small
    out = torch.where(bad, torch.zeros_like(v), v).to(dst)
    out = torch.where(big, torch.full_like(out, info.max), out)
    return torch.where(small, torch.full_like(out, info.min), out)


def _convert(v: torch.Tensor, dst: DataType) -> torch.Tensor:
    phys = torch_dtype(dst)
    if v.is_floating_point() and not phys.is_floating_point \
            and phys is not torch.bool:
        return _float_to_int(v, phys)
    return v.to(phys)


__all__ = ["DeviceEvaluator", "CV", "and_validity", "valid_or_true"]
