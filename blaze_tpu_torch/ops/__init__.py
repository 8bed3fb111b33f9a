"""Physical operators of the port: scans, filter, project, the hash
aggregate (keyless and keyed, with grace execution past its
materialization limit), and the exchange: the shuffle writer and the IPC
reader and writer. Operators stream ColumnBatches per partition and
compute eagerly on the task's device.
"""

from blaze_tpu_torch.ops.base import ExecContext, PhysicalOp
from blaze_tpu_torch.ops.memory_scan import MemoryScanExec
from blaze_tpu_torch.ops.project import ProjectExec
from blaze_tpu_torch.ops.filter import FilterExec
from blaze_tpu_torch.ops.hash_aggregate import AggMode, HashAggregateExec
from blaze_tpu_torch.ops.parquet_scan import FileRange, ParquetScanExec
from blaze_tpu_torch.ops.shuffle_writer import ShuffleWriterExec
from blaze_tpu_torch.ops.ipc_reader import (
    FileSegment,
    IpcReaderExec,
    IpcReadMode,
)
from blaze_tpu_torch.ops.ipc_writer import IpcWriterExec, collect_ipc

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
    "ShuffleWriterExec",
    "FileSegment",
    "IpcReaderExec",
    "IpcReadMode",
    "IpcWriterExec",
    "collect_ipc",
]
