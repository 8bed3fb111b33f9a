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
torch's defaults. Strings, wide decimals and the string, hash and
time-of-day scalar functions raise NotImplementedError naming the
ROADMAP item that brings them.

Every operation here is an eager torch op with no host sync, so a
batch's whole evaluation can be captured in a CUDA graph (ops/fused.py).
No two roundings are contracted into one: a product and a sum stay two
ops, as Spark's JVM computes them.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
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
            return self._scalar_fn(e)
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


    # ------------------------------------------------------------------
    def _scalar_fn(self, e: ir.ScalarFn) -> CV:
        """The JAX package's scalar-function arms (its `_scalar_fn`),
        each result in the physical dtype of the type `infer_dtype`
        gives the call. Where the JAX package departs from Spark, this
        follows Spark (ROADMAP section 3): a logarithm of x <= 0 is
        NULL; least skips NaN; round of a double rounds its shortest
        decimal form HALF_UP; isnan(NULL) is false; nanvl(x, y) takes y
        only where x is NaN; pmod by a negative divisor is
        ((a % n) + n) % n; null_if counts NaN equal to NaN."""
        n = e.name
        if n not in _SCALAR_FNS:
            raise NotImplementedError(
                f"scalar function {n!r} waits for {_ROADMAP_EXPRS}")
        if n in ("date_part", "trunc_date"):
            # the part or format is a literal; only the date evaluates
            lit, arg = (e.args[0], e.args[1]) if n == "date_part" \
                else (e.args[1], e.args[0])
            if not isinstance(lit, ir.Literal):
                raise NotImplementedError(f"{n} needs a literal part")
            v, m = self._eval(arg)
            fn = _date_part if n == "date_part" else _trunc_date
            return fn(str(lit.value).lower(), v), m
        args = [self._eval(a) for a in e.args]
        m = None
        for _, am in args:
            m = and_validity(m, am)
        vs = [v for v, _ in args]
        out_t = infer_dtype(e, self.schema)
        if n in _UNARY_F64:
            x = vs[0].to(torch.float64)
            if n in _LOGS:
                # Spark's logarithms are NULL at and below 0
                m = and_validity(m, ~(x <= 0))
            return _UNARY_F64[n](x), m
        if n in ("greatest", "least"):
            return self._extreme_of(n, args, out_t)
        if n == "isnan":
            v = vs[0]
            if not v.is_floating_point():
                return self._full(False, torch.bool), None
            # Spark: isnan(NULL) is false, never NULL
            return torch.isnan(v) & valid_or_true(m, v), None
        if n == "nanvl":
            a = vs[0].to(torch.float64)
            b = vs[1].to(torch.float64)
            nan = torch.isnan(a)
            (_, am), (_, bm) = args
            if bm is not None:
                # y's NULL shows only where x is NaN
                bm = bm | ~nan
            return _convert(torch.where(nan, b, a), out_t), \
                and_validity(am, bm)
        if n == "pmod":
            phys = torch_dtype(out_t)
            a, b = vs[0].to(phys), vs[1].to(phys)
            zero = b == 0
            safe = torch.where(zero, torch.ones_like(b), b)
            r = _java_rem(a, safe)
            r = torch.where(r < 0, _java_rem(r + safe, safe), r)
            return r, and_validity(m, ~zero)
        if n == "null_if":
            a, b = vs[0], vs[1].to(vs[0].dtype)
            eq = a == b
            if a.is_floating_point():
                eq = eq | (torch.isnan(a) & torch.isnan(b))
            if m is not None:
                eq = eq & m
            base = args[0][1]
            return a, (~eq if base is None else base & ~eq)
        if n == "round":
            return self._round(e, vs[0], m, out_t)
        src_t = infer_dtype(e.args[0], self.schema)
        if n in ("ceil", "floor") and src_t.is_integer:
            return vs[0], m
        return _convert(_SIMPLE_FNS[n](*vs), out_t), m

    def _extreme_of(self, n: str, args: List[CV], out_t: DataType) -> CV:
        """greatest/least: NULL operands are skipped, NULL only when all
        are. NaN is above every value (Spark's order): greatest lets it
        through, least skips it; -0.0 is below +0.0."""
        phys = torch_dtype(out_t)
        acc_v = acc_m = None
        for v, vm in args:
            v = v.to(phys)
            valid = valid_or_true(vm, v)
            if acc_v is None:
                acc_v, acc_m = v, valid
                continue
            if n == "greatest":
                pick = _fmax(acc_v, v)
            else:
                pick = _fmin_skip_nan(acc_v, v)
            acc_v = torch.where(acc_m & valid, pick,
                                torch.where(valid, v, acc_v))
            acc_m = acc_m | valid
        return acc_v, acc_m

    def _round(self, e: ir.ScalarFn, v: torch.Tensor, m,
               out_t: DataType) -> CV:
        src_t = infer_dtype(e.args[0], self.schema)
        if src_t.is_integer:
            # round(int, d >= 0) is the identity; d < 0 rounds HALF_UP to
            # a power of ten (Spark round(1250, -2) = 1300); the scale
            # must be a literal
            if len(e.args) > 1 and not isinstance(e.args[1], ir.Literal):
                raise NotImplementedError(
                    "round(int, scale) needs a literal scale")
            d = e.args[1].value if len(e.args) > 1 else 0
            if d is None or d >= 0:
                return v, m
            p = 10 ** (-d)
            w = v.to(torch.int64)
            q = torch.div(w, p, rounding_mode="floor")
            r = w - q * p
            half = torch.where(w >= 0, 2 * r >= p, 2 * r > p)
            return ((q + half.to(torch.int64)) * p).to(v.dtype), m
        if len(e.args) > 1:
            d, dm = self._eval(e.args[1])
            m = and_validity(m, dm)
        else:
            d = self._full(0, torch.int64)
        return _convert(_round_half_up(v.to(torch.float64), d), out_t), m

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


# ---------------------------------------------------------------------------
# scalar functions
# ---------------------------------------------------------------------------

def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root. torch's CPU kernel for float64 is
    only faithful (1 ulp off on about 0.7% of random inputs, torch 2.13),
    so CPU tensors take numpy's; CUDA's double sqrt is IEEE-rounded."""
    if x.device.type == "cpu":
        with np.errstate(invalid="ignore"):
            return torch.from_numpy(np.sqrt(x.numpy()))
    return torch.sqrt(x)


_UNARY_F64 = {
    "sqrt": _sqrt, "exp": torch.exp, "ln": torch.log,
    "log": torch.log, "log2": torch.log2, "log10": torch.log10,
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "asin": torch.asin, "acos": torch.acos, "atan": torch.atan,
    "sinh": torch.sinh, "cosh": torch.cosh, "tanh": torch.tanh,
}
_LOGS = ("ln", "log", "log2", "log10")
_DATE_FIELDS = ("year", "month", "day", "dayofmonth", "quarter",
                "dayofweek", "dayofyear")


def _f64(v: torch.Tensor) -> torch.Tensor:
    return v.to(torch.float64)


def _signum(v: torch.Tensor) -> torch.Tensor:
    # Math.signum: NaN and +/-0.0 are their own sign (torch.sign maps
    # NaN to 0 and -0.0 to +0.0)
    x = _f64(v)
    return torch.where(x > 0, 1.0, torch.where(x < 0, -1.0, x))


_SIMPLE_FNS = {
    "abs": torch.abs,
    "negative": torch.neg,
    "positive": lambda v: v,
    "signum": _signum,
    "pow": lambda a, b: torch.pow(_f64(a), _f64(b)),
    "atan2": lambda a, b: torch.atan2(_f64(a), _f64(b)),
    "ceil": lambda v: _float_to_int(torch.ceil(_f64(v)), torch.int64),
    "floor": lambda v: _float_to_int(torch.floor(_f64(v)), torch.int64),
    "trunc": lambda v: torch.trunc(_f64(v)),
    "spark_unscaled_value": lambda v: v.to(torch.int64),
    "spark_make_decimal": lambda v: v.to(torch.int64),
    **{f: (lambda v, f=f: _date_part(f, v)) for f in _DATE_FIELDS},
}
_SCALAR_FNS = frozenset(_UNARY_F64) | frozenset(_SIMPLE_FNS) | {
    "greatest", "least", "isnan", "nanvl", "pmod", "null_if", "round",
    "date_part", "trunc_date"}


def _zeros_ordered(pick, a, b, take_neg: bool):
    """Where a and b are both zeros, the signed one the order -0.0 <
    +0.0 picks (jnp.minimum/maximum); elsewhere `pick`."""
    both = (a == 0) & (b == 0)
    neg = torch.signbit(a) | torch.signbit(b) if take_neg \
        else torch.signbit(a) & torch.signbit(b)
    zero = torch.where(neg, -0.0, 0.0).to(a.dtype)
    return torch.where(both, zero, pick)


def _fmax(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """max with NaN above every value and -0.0 below +0.0."""
    if not a.is_floating_point():
        return torch.maximum(a, b)
    return _zeros_ordered(torch.maximum(a, b), a, b, take_neg=False)


def _fmin(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """min letting NaN through (jnp.minimum, K1) and -0.0 below +0.0."""
    if not a.is_floating_point():
        return torch.minimum(a, b)
    return _zeros_ordered(torch.minimum(a, b), a, b, take_neg=True)


def _fmin_skip_nan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """min in Spark's order: NaN is above every value, so it is the
    least only when both are NaN; -0.0 is below +0.0."""
    if not a.is_floating_point():
        return torch.minimum(a, b)
    pick = torch.where(torch.isnan(a) | (b < a), b, a)
    return _zeros_ordered(pick, a, b, take_neg=True)


def _pow10(e: torch.Tensor) -> torch.Tensor:
    """10.0 ** e for an int64 tensor e in [0, 511], the product of
    powers picked by e's bits: exact up to 10^22 (every factor and
    product there is an exact double), within a few ulp above, inf past
    10^308."""
    p = torch.ones(e.shape, dtype=torch.float64, device=e.device)
    for bit, f in enumerate((1e1, 1e2, 1e4, 1e8, 1e16, 1e32, 1e64, 1e128,
                             1e256)):
        p = torch.where((e >> bit) & 1 == 1, p * f, p)
    return p


_SPLIT = 134217729.0  # 2^27 + 1: Veltkamp's splitter for float64


def _two_product(a: torch.Tensor, b: torch.Tensor):
    """(hi, lo) with hi + lo = a * b exactly (Dekker's product, each op
    rounded on its own: no FMA)."""
    hi = a * b
    ca = _SPLIT * a
    ah = ca - (ca - a)
    al = a - ah
    cb = _SPLIT * b
    bh = cb - (cb - b)
    bl = b - bh
    lo = ((ah * bh - hi) + ah * bl + al * bh) + al * bl
    return hi, lo


def _nearest_scaled_up(a: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """The integer nearest a * m (m an exact power of ten), int64."""
    hi, lo = _two_product(a, m)
    hf = torch.floor(hi)
    return hf.to(torch.int64) + torch.floor((hi - hf) + lo + 0.5).to(
        torch.int64)


def _nearest_scaled_down(a: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """The integer nearest a / m (m an exact power of ten), int64: the
    rounded quotient corrected by its exact remainder (the quotient may
    lie past 2^53, so the correction is taken in int64)."""
    qf = torch.floor(a / m)
    hi, lo = _two_product(qf, m)
    rem = (a - hi) - lo
    adj = torch.floor(rem / m)
    rem = rem - adj * m
    return qf.to(torch.int64) + adj.to(torch.int64) \
        + (2.0 * rem >= m).to(torch.int64)


def _round_half_up(x: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Spark's round of a double at scale d: BigDecimal of the shortest
    decimal form of x, HALF_UP, back to the nearest double.

    With y = |x| * 10^d (or / 10^-d) and k = floor(y), the result is k
    or k + 1 over 10^d: k + 1 when the shortest form s of |x| is at
    least the tie t = (k + 1/2) * 10^-d. Where the doubles next to |x|
    lie more than 10^-(d+1) apart, at most one decimal of d + 1 places
    rounds to |x|, so s >= t exactly when the correctly rounded t is at
    most |x| (a tie, t = s, rounds up). Where they lie closer (the band
    up to y = 2^53), several such decimals can round to |x|: then |x| is
    its own result if a decimal of d places rounds to it, and otherwise
    s is the decimal of d + 1 places nearest |x|, whose last digit
    decides (|x| * 10^(d+1) taken exactly: Dekker's product, or for
    d < 0 a division with its exact remainder). For y >= 2^53 |x| has
    no digit past the scale. Left unchecked (ROADMAP section 3): |d| >
    21, where 10^(|d|+1) is not an exact double and the rule runs on
    rounded powers."""
    a = torch.abs(x)
    d = d.to(torch.int64)
    up = d >= 0
    e = d.abs().clamp(max=400)
    p = _pow10(e)
    y = torch.where(up, a * p, a / p)
    k = torch.floor(y)
    # (k + 1/2) is exact for k < 2^52, so t is correctly rounded
    t = torch.where(up, (k + 0.5) / p, (k + 0.5) * p)
    q = k + (t <= a).to(torch.float64)
    r = torch.where(up, q / p, q * p)
    # the band: decimals of d + 1 places closer together than doubles
    unit = torch.where(up, 1.0 / _pow10(e + 1), _pow10((e - 1).clamp(min=0)))
    ulp = torch.nextafter(a, torch.full_like(a, float("inf"))) - a
    band = ulp >= torch.where(up, 1.0 / _pow10(e + 1), unit)
    own = torch.zeros_like(up)
    for j in (-1.0, 0.0, 1.0):
        own = own | (torch.where(up, (k + j) / p, (k + j) * p) == a)
    n = torch.where(up, _nearest_scaled_up(a, _pow10(e + 1)),
                    _nearest_scaled_down(a, unit))
    qb = torch.div(n, 10, rounding_mode="floor") \
        + (torch.remainder(n, 10) >= 5).to(torch.int64)
    qb = qb.to(torch.float64)
    r = torch.where(band, torch.where(own, a, torch.where(
        up, qb / p, qb * p)), r)
    r = torch.where(y >= 2.0 ** 53, a, r)
    # BigDecimal has no -0: a result of zero is +0.0 (also where a
    # scale past 10^308 made 0 * inf)
    r = torch.where((r == 0) | (a == 0) | (y == 0), 0.0,
                    torch.copysign(r, x))
    return torch.where(torch.isfinite(x), r, x)


def _floordiv(a: torch.Tensor, b: int) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def _days_from_civil(y, mth, d) -> torch.Tensor:
    """Civil date -> days since the epoch (Hinnant), int32."""
    y = y - (mth <= 2).to(torch.int64)
    era = _floordiv(y, 400)
    yoe = y - era * 400
    mp = torch.where(mth > 2, mth - 3, mth + 9)
    doy = _floordiv(153 * mp + 2, 5) + d - 1
    doe = yoe * 365 + _floordiv(yoe, 4) - _floordiv(yoe, 100) + doy
    return (era * 146_097 + doe - 719_468).to(torch.int32)


def _trunc_date(fmt: str, days32: torch.Tensor) -> torch.Tensor:
    """TruncDate: a date32 down to its year, quarter, month or
    (Monday) week start."""
    y = _date_part("year", days32).to(torch.int64)
    mth = _date_part("month", days32).to(torch.int64)
    one = torch.ones_like(mth)
    if fmt in ("year", "yyyy", "yy"):
        return _days_from_civil(y, one, one)
    if fmt == "quarter":
        return _days_from_civil(y, _floordiv(mth - 1, 3) * 3 + 1, one)
    if fmt in ("month", "mon", "mm"):
        return _days_from_civil(y, mth, one)
    if fmt == "week":
        d = days32.to(torch.int64)
        # 1970-01-01 was a Thursday
        return (d - torch.remainder(d + 3, 7)).to(torch.int32)
    raise NotImplementedError(
        f"trunc_date {fmt!r} waits for {_ROADMAP_EXPRS}")


def _date_part(part: str, days32: torch.Tensor) -> torch.Tensor:
    """A field of a date32 (days since the epoch), int32, by Hinnant's
    civil-from-days in integer ops."""
    z = days32.to(torch.int64) + 719_468
    era = _floordiv(z, 146_097)
    doe = z - era * 146_097
    yoe = _floordiv(doe - _floordiv(doe, 1460) + _floordiv(doe, 36524)
                    - _floordiv(doe, 146096), 365)
    doy = doe - (365 * yoe + _floordiv(yoe, 4) - _floordiv(yoe, 100))
    mp = _floordiv(5 * doy + 2, 153)
    d = doy - _floordiv(153 * mp + 2, 5) + 1
    month = mp + torch.where(mp < 10, 3, -9)
    year = yoe + era * 400 + (month <= 2).to(torch.int64)
    if part == "year":
        return year.to(torch.int32)
    if part == "month":
        return month.to(torch.int32)
    if part in ("day", "dayofmonth"):
        return d.to(torch.int32)
    if part == "quarter":
        return (_floordiv(month - 1, 3) + 1).to(torch.int32)
    if part in ("dayofweek", "dow"):
        # Spark: 1 = Sunday ... 7 = Saturday
        return (torch.remainder(days32.to(torch.int64) + 4, 7) + 1) \
            .to(torch.int32)
    if part in ("dayofyear", "doy"):
        one = torch.ones_like(year)
        jan1 = _days_from_civil(year, one, one)
        return (days32.to(torch.int64) - jan1 + 1).to(torch.int32)
    raise NotImplementedError(
        f"date_part {part!r} waits for {_ROADMAP_EXPRS}")


__all__ = ["DeviceEvaluator", "CV", "and_validity", "valid_or_true"]
