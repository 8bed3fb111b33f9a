"""Operator base: execution context, metrics, the PhysicalOp protocol."""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Iterator, List, Optional, Union

import torch

from blaze_tpu_torch.config import EngineConfig, get_config
from blaze_tpu_torch.types import Schema
from blaze_tpu_torch.batch import ColumnBatch


class MetricNode:
    """Per-operator metric tree mirroring the plan, like the reference's
    MetricNode mirrored into Spark SQLMetrics (NativeSupports.scala:215-228,
    native side metrics.rs:32-56). Collected after a partition's stream is
    drained."""

    def __init__(self, name: str, children: Optional[List["MetricNode"]] = None):
        self.name = name
        self.children = children or []
        self.counters: Dict[str, int] = {}
        # tasks of one plan run in threads (runtime/scheduler.py) and
        # share their context's tree
        self._lock = threading.Lock()

    def add(self, key: str, value: int) -> None:
        with self._lock:
            self.counters[key] = self.counters.get(key, 0) + int(value)

    def flatten(self) -> Dict[str, Dict[str, int]]:
        out = {self.name: dict(self.counters)}
        for c in self.children:
            out.update(c.flatten())
        return out


@dataclasses.dataclass
class ExecContext:
    """Per-task execution context (the reference's TaskDefinition partition
    context + SessionContext config, exec.rs:137-165).

    `device` is the torch device every operator of the task computes on;
    left unset it is `config.device` ("cuda" by default)."""

    partition_id: int = 0
    task_id: str = "task-0"
    config: EngineConfig = dataclasses.field(default_factory=get_config)
    metrics: MetricNode = dataclasses.field(
        default_factory=lambda: MetricNode("root")
    )
    device: Optional[Union[str, torch.device]] = None
    # resource registry: IpcReader sources, IpcWriter sinks (the
    # reference's JniBridge.resourcesMap, JniBridge.java:31)
    resources: Dict[str, object] = dataclasses.field(default_factory=dict)
    # per-query TraceRecorder (obs/trace.py) when tracing is on; the
    # executor/scheduler seams check `trace.ACTIVE` before touching it
    tracer: Optional[object] = None

    def __post_init__(self):
        self.device = torch.device(
            self.device if self.device is not None else self.config.device
        )


class PhysicalOp:
    """A node in the physical plan.

    `execute(partition, ctx)` yields ColumnBatches for one partition -
    the host-side analog of DataFusion's ExecutionPlan::execute returning a
    RecordBatch stream (reference from_proto.rs:162-560 builds these).
    """

    children: List["PhysicalOp"] = []

    @property
    def schema(self) -> Schema:
        raise NotImplementedError

    @property
    def partition_count(self) -> int:
        if self.children:
            return self.children[0].partition_count
        return 1

    def execute(self, partition: int, ctx: ExecContext
                ) -> Iterator[ColumnBatch]:
        raise NotImplementedError

    # ------------------------------------------------------------------
    def describe(self) -> str:
        """One-line operator description for plan display."""
        return type(self).__name__

    def display(self, indent: int = 0) -> str:
        """Indented plan tree (the reference logs the same shape at task
        start: displayable(...).indent(), exec.rs:154-158)."""
        lines = ["  " * indent + self.describe()]
        for c in self.children:
            lines.append(c.display(indent + 1))
        return "\n".join(lines)

    # ------------------------------------------------------------------
    def fingerprint(self) -> str:
        """Content-addressed plan identity: operator name + parameter
        digest + children, recursively (the JAX package's). Two
        independently decoded plans that compute the same thing get the
        same fingerprint, which keys the serving tier's result cache
        (service/cache.py). Ops that cannot prove stable identity keep
        the default `@id` digest, and `fingerprint_is_stable` says so,
        so their results are never shared across submissions."""
        me = f"{type(self).__name__}({self._fingerprint_params()})"
        if not self.children:
            return me
        kids = ",".join(c.fingerprint() for c in self.children)
        return f"{me}[{kids}]"

    # set True by subclasses whose _fingerprint_params covers every
    # execution-relevant parameter (content identity, not object
    # identity)
    _FINGERPRINT_STABLE = False

    def _fingerprint_params(self) -> str:
        return f"@{id(self):x}"

    def fingerprint_is_stable(self) -> bool:
        """True iff every op in the tree declares content-complete
        parameter coverage; only stable fingerprints key results shared
        across submissions."""
        return self._FINGERPRINT_STABLE and all(
            c.fingerprint_is_stable() for c in self.children
        )
