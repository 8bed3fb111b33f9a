"""Planner tier: the engine-side analog of the reference's Spark session
extension (spark-extension L1/L2, SURVEY 2.2).

An embedder (a Spark extension, a SQL frontend, tests) describes its
already-optimized physical plan as a `PlanSpec` tree; the planner then does
what BlazeSparkSessionExtension + BlazeConvertStrategy + BlazeConverters do
(BlazeSparkSessionExtension.scala:41-62, BlazeConvertStrategy.scala:84-148,
BlazeConverters.scala:93-157):

1. tag every node convertible/not by DRY-RUNNING its conversion
2. apply strategy heuristics + per-op enable gates to pick native vs host
3. convert bottom-up with tryConvert per-node fallback - a conversion
   error falls back to the host engine for that node, never fails the query
4. splice conversion bridges where native and host subtrees meet

The host tier here is a pandas interpreter of PlanSpec (planner/host_engine)
standing in for the JVM row-based execution the reference falls back to.

The port's planner: this conversion (planner/{spec,convert,host_engine}),
the exchange pass (planner/distribute.insert_exchanges), the scan hints
(planner/colprune) and the fusion pass applied to every decoded task
(planner/fuse).
"""

from blaze_tpu_torch.planner.spec import (
    AggSpec,
    ExchangeSpec,
    FilterSpec,
    JoinSpec,
    LimitSpec,
    MemorySpec,
    PlanSpec,
    ProjectSpec,
    ScanSpec,
    SortSpec,
    UnionSpec,
    WindowSpec,
)
from blaze_tpu_torch.planner.convert import ConvertStrategy, convert_plan

__all__ = [
    "PlanSpec",
    "MemorySpec",
    "ScanSpec",
    "ProjectSpec",
    "FilterSpec",
    "SortSpec",
    "UnionSpec",
    "LimitSpec",
    "AggSpec",
    "JoinSpec",
    "ExchangeSpec",
    "WindowSpec",
    "ConvertStrategy",
    "convert_plan",
]
