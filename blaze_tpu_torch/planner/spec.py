"""PlanSpec: the embedder-facing physical-plan description.

The neutral tree an embedding system hands to the planner - playing the
role Spark's physical `SparkPlan` tree plays for the reference's converters
(BlazeConverters.scala per-op convertXxxExec surface). Node set mirrors the
operators the reference can offload plus the ones it deliberately leaves on
the host (Window - BlazeConverters inserts row barriers before those,
BlazeConverters.scala:93-107). A copy of the JAX package's
planner/spec.py over the port's IR."""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from blaze_tpu_torch.exprs import ir
from blaze_tpu_torch.exprs.ir import AggExpr


@dataclasses.dataclass
class PlanSpec:
    children: List["PlanSpec"] = dataclasses.field(default_factory=list)
    # filled by the strategy pass (reference tags blaze.convertible /
    # blaze.convert.strategy on every node, BlazeConvertStrategy.scala:84-86)
    convertible: Optional[bool] = None
    strategy: str = "default"  # default | always | never


@dataclasses.dataclass
class ScanSpec(PlanSpec):
    """Parquet file scan (FileSourceScanExec analog)."""

    file_groups: Sequence[Sequence] = ()
    projection: Optional[Sequence[str]] = None
    predicate: Optional[ir.Expr] = None  # data filter -> pruning + filter


@dataclasses.dataclass
class MemorySpec(PlanSpec):
    """In-memory table (tests / local embedders)."""

    dataframe: object = None  # pandas DataFrame
    partitions: int = 1


@dataclasses.dataclass
class ProjectSpec(PlanSpec):
    exprs: Sequence[Tuple[ir.Expr, str]] = ()


@dataclasses.dataclass
class FilterSpec(PlanSpec):
    predicate: Optional[ir.Expr] = None


@dataclasses.dataclass
class SortSpec(PlanSpec):
    keys: Sequence[Tuple[ir.Expr, bool, bool]] = ()  # expr, asc, nulls_first
    fetch: Optional[int] = None


@dataclasses.dataclass
class UnionSpec(PlanSpec):
    pass


@dataclasses.dataclass
class LimitSpec(PlanSpec):
    limit: int = 0


@dataclasses.dataclass
class AggSpec(PlanSpec):
    keys: Sequence[Tuple[ir.Expr, str]] = ()
    aggs: Sequence[Tuple[AggExpr, str]] = ()
    mode: str = "complete"  # partial | final | complete


@dataclasses.dataclass
class JoinSpec(PlanSpec):
    kind: str = "smj"  # smj | bhj
    left_keys: Sequence[str] = ()
    right_keys: Sequence[str] = ()
    join_type: str = "inner"
    condition: Optional[ir.Expr] = None  # post-join filter
    # AQE-detected skew joins stay host-side, like the reference's
    # strategy (BlazeConvertStrategy.scala:159 "never convert skew joins")
    skewed: bool = False


@dataclasses.dataclass
class ExchangeSpec(PlanSpec):
    keys: Sequence[ir.Expr] = ()
    num_partitions: int = 1
    mode: str = "hash"  # hash | single | round_robin | range | broadcast


@dataclasses.dataclass
class WindowSpec(PlanSpec):
    """Host-only in the reference too (row barrier inserted before it)."""

    partition_by: Sequence[str] = ()
    order_by: Sequence[str] = ()
    function: str = "row_number"
    source: Optional[str] = None  # input column for lag/lead/agg-over
    output: str = "w"
