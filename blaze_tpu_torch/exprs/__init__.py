"""Expression engine: IR + columnar evaluators.

Covers the reference's physical expression surface (spark-extension
NativeConverters.scala:380-501 and plan-serde from_proto.rs expression arms):
literals, column refs, casts, binary arithmetic/comparison/logic, null
predicates, In/InSet, If/CaseWhen, ~40 scalar functions, and the Spark
aggregate set (MIN/MAX/SUM/AVG/COUNT/VAR/STDDEV).

Two evaluators share the IR:
- `eval.DeviceEvaluator`: jnp ops inside jit over padded device columns
  (values + validity). The TPU compute path.
- string-typed subtrees are evaluated host-side (pyarrow compute) by the
  pipeline compiler and enter the device pipeline as precomputed inputs;
  TPUs have no string compute so we split at the type boundary.
"""

from blaze_tpu_torch.exprs.ir import (
    Expr,
    Literal,
    Col,
    BoundCol,
    Cast,
    BinaryOp,
    Not,
    Negate,
    IsNull,
    IsNotNull,
    InList,
    If,
    CaseWhen,
    ScalarFn,
    Coalesce,
    AggExpr,
    AggFn,
)

__all__ = [
    "Expr",
    "Literal",
    "Col",
    "BoundCol",
    "Cast",
    "BinaryOp",
    "Not",
    "Negate",
    "IsNull",
    "IsNotNull",
    "InList",
    "If",
    "CaseWhen",
    "ScalarFn",
    "Coalesce",
    "AggExpr",
    "AggFn",
]
