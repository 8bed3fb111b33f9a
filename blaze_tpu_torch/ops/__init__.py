"""Physical operators of the port: scans, filter, project and the hash
aggregate, keyless and keyed. Operators stream ColumnBatches per
partition and compute eagerly on the task's device.
"""

from blaze_tpu_torch.ops.base import ExecContext, PhysicalOp
from blaze_tpu_torch.ops.memory_scan import MemoryScanExec
from blaze_tpu_torch.ops.project import ProjectExec
from blaze_tpu_torch.ops.filter import FilterExec
from blaze_tpu_torch.ops.hash_aggregate import AggMode, HashAggregateExec
from blaze_tpu_torch.ops.parquet_scan import FileRange, ParquetScanExec

__all__ = [
    "ExecContext",
    "PhysicalOp",
    "MemoryScanExec",
    "ProjectExec",
    "FilterExec",
    "AggMode",
    "HashAggregateExec",
    "FileRange",
    "ParquetScanExec",
]
