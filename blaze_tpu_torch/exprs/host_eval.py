"""Host (pyarrow) expression evaluator for string-typed subtrees.

TPUs have no string compute, so the pipeline compiler splits each expression
tree at the type boundary (SURVEY 7 design stance): any node with a direct
string-typed input is evaluated here, over the batch's real utf8 data, and
re-enters the device pipeline as a precomputed column. Null propagation
comes from pyarrow compute kernels natively (matching Spark for the ops
used). Also serves as the engine-independent differential reference for
device results in tests.

A copy of the JAX package's exprs/host_eval.py. Beyond it, the port
evaluates `hash` / `murmur3_hash` with string arguments (Spark's murmur3
of the UTF-8 bytes, chained with the other arguments,
exprs/hashing.hash_arrays_host) and `to_date` of a string (ISO
yyyy-mm-dd, NULL where it does not parse, as Spark's cast gives), which
the JAX package's evaluators do not have.

`upper`, `lower`, `trim`, `ltrim` and `rtrim` follow Spark where the
JAX package follows pyarrow: Spark's UTF8String maps ASCII text itself
and other text through Java's String.toUpperCase / toLowerCase, whose
full case mapping gives upper('ß') = 'SS', upper('ﬁ') = 'FI' and a
final sigma in lower('ΑΣ') = 'ας' (Python's str.upper and str.lower
apply the same Unicode SpecialCasing rules); its trims strip U+0020
only, where pyarrow strips all whitespace.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from blaze_tpu_torch.types import DataType, Schema, TypeId, to_arrow_type
from blaze_tpu_torch.exprs import ir
from blaze_tpu_torch.exprs.ir import Op


class HostEvaluator:
    """Evaluates bound expressions against positional pyarrow arrays
    (full batch rows, no selection applied - alignment matters)."""

    def __init__(self, schema: Schema, arrays: List[pa.Array]):
        self.schema = schema
        self.arrays = arrays
        self.length = len(arrays[0]) if arrays else 0

    def evaluate(self, e: ir.Expr) -> pa.Array:
        if isinstance(e, ir.BoundCol):
            return self.arrays[e.index]
        if isinstance(e, ir.Literal):
            if e.value is None:
                # typed, so coalesce(s, NULL) and if_else find kernels
                # (the JAX package's untyped nulls do not)
                return pa.nulls(self.length, type=None if e.dtype is None
                                else to_arrow_type(e.dtype))
            return pa.array(
                [e.value] * self.length, type=to_arrow_type(e.dtype)
            )
        if isinstance(e, ir.Cast):
            child = self.evaluate(e.child)
            return pc.cast(child, to_arrow_type(e.to), safe=False)
        if isinstance(e, ir.BinaryOp):
            return self._binary(e)
        if isinstance(e, ir.Not):
            return pc.invert(self.evaluate(e.child))
        if isinstance(e, ir.IsNull):
            return pc.is_null(self.evaluate(e.child))
        if isinstance(e, ir.IsNotNull):
            return pc.is_valid(self.evaluate(e.child))
        if isinstance(e, ir.InList):
            v = self.evaluate(e.child)
            items = [
                x.value for x in e.values
                if isinstance(x, ir.Literal) and x.value is not None
            ]
            out = pc.is_in(v, value_set=pa.array(items))
            if e.negated:
                out = pc.invert(out)
            # propagate child nulls (pc.is_in treats null as not-found)
            return pc.if_else(pc.is_valid(v), out, pa.nulls(self.length))
        if isinstance(e, ir.If):
            return pc.if_else(
                self.evaluate(e.cond),
                self.evaluate(e.then),
                self.evaluate(e.otherwise),
            )
        if isinstance(e, ir.CaseWhen):
            acc = (
                self.evaluate(e.otherwise)
                if e.otherwise is not None
                else pa.nulls(self.length)
            )
            for cond, res in reversed(e.branches):
                c = self.evaluate(cond)
                c = pc.fill_null(c, False)
                acc = pc.if_else(c, self.evaluate(res), acc)
            return acc
        if isinstance(e, ir.Coalesce):
            return pc.coalesce(*[self.evaluate(a) for a in e.args])
        if isinstance(e, ir.ScalarFn):
            return self._scalar_fn(e)
        raise NotImplementedError(f"host eval: {type(e).__name__}")

    def _binary(self, e: ir.BinaryOp) -> pa.Array:
        l = self.evaluate(e.left)
        r = self.evaluate(e.right)
        cmp = {
            Op.EQ: pc.equal,
            Op.NEQ: pc.not_equal,
            Op.LT: pc.less,
            Op.LTE: pc.less_equal,
            Op.GT: pc.greater,
            Op.GTE: pc.greater_equal,
        }
        if e.op in cmp:
            return cmp[e.op](l, r)
        if e.op is Op.AND:
            return pc.and_kleene(l, r)
        if e.op is Op.OR:
            return pc.or_kleene(l, r)
        arith = {
            Op.ADD: pc.add,
            Op.SUB: pc.subtract,
            Op.MUL: pc.multiply,
        }
        if e.op in arith:
            return arith[e.op](l, r)
        if e.op is Op.DIV:
            # Spark: divide-by-zero -> NULL
            zero = pc.equal(r, pa.scalar(0, type=r.type))
            safe = pc.if_else(zero, pa.scalar(1, type=r.type), r)
            out = pc.divide(l, safe)
            return pc.if_else(zero, pa.nulls(self.length, out.type), out)
        if e.op is Op.MOD:
            # Spark %: truncated remainder, sign of the dividend
            # (device parity: lax.rem in exprs/eval.py _mod);
            # mod-by-zero -> NULL. pyarrow has no modulo kernel, so
            # build it from trunc-division: l - trunc(l/r)*r.
            zero = pc.equal(r, pa.scalar(0, type=r.type))
            safe = pc.if_else(zero, pa.scalar(1, type=r.type), r)
            quot = pc.divide(l, safe)  # integer divide truncates
            if pa.types.is_floating(quot.type):
                quot = pc.trunc(quot)
            rem = pc.subtract(l, pc.multiply(quot, safe))
            return pc.if_else(zero, pa.nulls(self.length, rem.type), rem)
        raise NotImplementedError(f"host binary {e.op}")

    def _scalar_fn(self, e: ir.ScalarFn) -> pa.Array:
        n = e.name
        args = [self.evaluate(a) for a in e.args]
        if n in ("lower", "upper"):
            return _spark_case(args[0], n == "upper")
        if n == "trim":
            return pc.utf8_trim(args[0], characters=" ")
        if n == "ltrim":
            return pc.utf8_ltrim(args[0], characters=" ")
        if n == "rtrim":
            return pc.utf8_rtrim(args[0], characters=" ")
        if n in ("length", "char_length"):
            return pc.cast(pc.utf8_length(args[0]), pa.int32())
        if n == "reverse":
            return pc.utf8_reverse(args[0])
        if n == "starts_with":
            return pc.starts_with(args[0], pattern=_pat(e.args[1]))
        if n == "ends_with":
            return pc.ends_with(args[0], pattern=_pat(e.args[1]))
        if n == "contains":
            return pc.match_substring(args[0], pattern=_pat(e.args[1]))
        if n == "like":
            return pc.match_like(args[0], pattern=_pat(e.args[1]))
        if n == "substring":
            # Spark 1-based start; 0 behaves like 1; negative counts from
            # the end
            start = _int_lit(e.args[1])
            length = _int_lit(e.args[2]) if len(e.args) > 2 else None
            if start > 0:
                start0 = start - 1
            elif start == 0:
                start0 = 0
            else:
                start0 = start  # arrow slice supports negative starts
            if length is None:
                stop = None
            else:
                stop = start0 + length
                if start0 < 0 and stop >= 0:
                    stop = None  # reaches the end of the string
            return pc.utf8_slice_codeunits(args[0], start0, stop)
        if n == "concat":
            return pc.binary_join_element_wise(
                *args, "", null_handling="emit_null"
            )
        if n == "replace":
            return pc.replace_substring(
                args[0], pattern=_pat(e.args[1]),
                replacement=_pat(e.args[2]),
            )
        if n == "null_if":
            eq = pc.fill_null(pc.equal(args[0], args[1]), False)
            return pc.if_else(eq, pa.nulls(self.length, args[0].type),
                              args[0])
        if n in ("hash", "murmur3_hash"):
            from blaze_tpu_torch.exprs.hashing import hash_arrays_host
            from blaze_tpu_torch.exprs.typing import infer_dtype

            dtypes = [infer_dtype(a, self.schema) for a in e.args]
            return pa.array(hash_arrays_host(args, dtypes), type=pa.int32())
        if n == "to_date":
            ts = pc.strptime(args[0], format="%Y-%m-%d", unit="s",
                             error_is_null=True)
            return pc.cast(ts, pa.date32())
        if n == "octet_length":
            return pc.cast(pc.binary_length(args[0]), pa.int32())
        if n in ("md5", "sha224", "sha256", "sha384", "sha512"):
            # digest fns (reference Md5/Sha2 cases): host-only, hashlib
            import hashlib

            fn = getattr(hashlib, n)
            vals = args[0].to_pylist()
            out = [
                None if v is None else fn(
                    v.encode("utf-8") if isinstance(v, str) else v
                ).hexdigest()
                for v in vals
            ]
            return pa.array(out, type=pa.utf8())
        raise NotImplementedError(f"host scalar fn {n}")


def _spark_case(arr: pa.Array, upper: bool) -> pa.Array:
    """Spark's UTF8String.toUpperCase / toLowerCase: ASCII text maps
    byte by byte; other text takes Java's full case mapping, which
    Python's str.upper / str.lower share (one result a string)."""
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    ascii_fn = pc.ascii_upper if upper else pc.ascii_lower
    if len(arr) == 0 or pc.all(pc.string_is_ascii(arr)).as_py() in (
            True, None):
        return ascii_fn(arr)
    conv = str.upper if upper else str.lower
    return pa.array([None if v is None else conv(v)
                     for v in arr.to_pylist()], type=arr.type)


def _pat(e: ir.Expr) -> str:
    assert isinstance(e, ir.Literal), "pattern must be a literal"
    return e.value


def _int_lit(e: ir.Expr) -> int:
    assert isinstance(e, ir.Literal), "argument must be a literal"
    return int(e.value)
