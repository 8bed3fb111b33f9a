"""Host-tier shuffle writer: same files, no device.

Reference counterpart: the JVM fallback row-shuffle writers
(ArrowShuffleWriter301.java:74, ArrowBypassMergeSortShuffleWriter301.
java:81) - when a shuffle's input was never native, rows are serialized
host-side into the SAME segmented-IPC `.data`/`.index` format the native
writer produces, so the read side never knows which tier wrote a block.
This module is that second producer (the JAX package's
ops/host_shuffle.py): pyarrow batches in, Spark murmur3 (seed 42) / pmod
partition ids computed on the host with numpy and the C++ string chain
of runtime/native.py (exprs/hashing.hash_arrays_host: the ids K4 gives
on the card, Spark's float rules included), per-partition zstd IPC parts
assembled through the writer's PartitionBuffers spill ladder.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence

import numpy as np
import pyarrow as pa

from blaze_tpu_torch.exprs.hashing import hash_arrays_host
from blaze_tpu_torch.io.ipc import encode_ipc_segment
from blaze_tpu_torch.ops.shuffle_writer import PartitionBuffers, append_parts
from blaze_tpu_torch.types import from_arrow_schema


def host_partition_ids(rb: pa.RecordBatch,
                       key_names: Sequence[str],
                       num_partitions: int) -> np.ndarray:
    """Spark murmur3 (seed 42) chained over the key columns, then
    `pmod num_partitions`, for one host batch, as int32."""
    schema = from_arrow_schema(rb.schema)
    idx = [rb.schema.get_field_index(name) for name in key_names]
    h = hash_arrays_host([rb.column(i) for i in idx],
                         [schema.fields[i].dtype for i in idx])
    return np.mod(h.astype(np.int64), num_partitions).astype(np.int32)


def host_shuffle_write(batches: Iterable[pa.RecordBatch],
                       key_names: Sequence[str],
                       num_partitions: int,
                       data_file: str,
                       index_file: str,
                       spill_dir: Optional[str] = None,
                       compression_level: int = 1) -> List[int]:
    """Hash-partition host batches and write one map output in the
    shared shuffle format. Returns per-partition byte lengths (what the
    index file records; the reference's writeIndexFileAndCommit input,
    ArrowShuffleExchangeExec301.scala:572-585)."""
    import tempfile

    bufs = PartitionBuffers(num_partitions,
                            spill_dir or tempfile.gettempdir())
    try:
        for rb in batches:
            if rb.num_rows == 0:
                continue
            if num_partitions == 1:
                bufs.append(0, encode_ipc_segment(rb, compression_level))
                continue
            pids = host_partition_ids(rb, key_names, num_partitions)
            order = np.argsort(pids, kind="stable")
            offsets = np.searchsorted(
                pids[order], np.arange(num_partitions + 1))
            append_parts(bufs, rb.take(pa.array(order)), offsets,
                         compression_level)
    except BaseException:
        bufs.close()
        raise
    return bufs.finalize(data_file, index_file)
