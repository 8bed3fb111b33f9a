"""Kernel K4: Spark murmur3 partition ids.

Replaces the TPU kernel `blaze_tpu/ops/kernels/murmur3_pallas.py`
(`partition_ids_int32` / `_kernel_int32`, `partition_ids_int64` /
`_kernel_int64`). On this slice's paths it is the partition id of every
row a hash shuffle writes (`ops/shuffle_writer.spark_partition_ids`) and
of every row grace aggregation buckets (`ops/external.bucket_stream`,
`subdivide_pid_fn`).

What it computes is the function, not the Pallas blocks: Spark's
Murmur3Hash with seed 42 chained over 1 or more fixed-width key columns
(each with optional validity; a NULL leaves the hash unchanged), then
Spark's pmod(h, n) for an `n` given at run time, and `n` itself for the
rows from `num_rows` up to the capacity. The types and their Java
canonicalisation are those of `exprs/hashing.py`, whose torch chain is
the plain version (`murmur3_plain`).

A second entry, `hashes`, returns the chained hash itself (the
kernel's `emit_hash` mode): the sorted join core's bucketing hash
(ops/joins.py), which needs equal keys to hash equal and nothing else.

Bound on the card: bytes - each key column read once, one int32 id
written per row. The CUDA source (csrc/murmur3.cu) runs one thread per
row in a grid-stride loop on uint32 arithmetic. More than 8 key columns
chain launches through the running hashes, one launch per 8 columns.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from blaze_tpu_torch.exprs import hashing
from blaze_tpu_torch.runtime import dispatch
from blaze_tpu_torch.types import DataType

#: launches of the CUDA kernel by `partition_ids` and by `hashes` (the
#: plain versions never count)
LAUNCHES = 0
HASH_LAUNCHES = 0
#: what `hashes` gives the rows past `num_rows` (the sorted join core's
#: padding sentinel); also the kernel's `n` there
HASH_PAD = 0x7FFFFFFF

KeyCol = Tuple[torch.Tensor, Optional[torch.Tensor], DataType]

_THREADS = 256
# a grid-stride loop: 16 blocks for each of the H100's 132 SMs at most
_MAX_BLOCKS = 132 * 16
#: key columns one launch takes (csrc/murmur3.cu kMaxCols)
MAX_COLS = 8
# csrc/murmur3.cu `Kind`, by the column's storage dtype
_KIND = {torch.bool: 0, torch.int8: 1, torch.int16: 2, torch.int32: 3,
         torch.int64: 4, torch.float32: 5, torch.float64: 6}


def partition_ids(cols: Sequence[KeyCol], num_rows: int, n: int
                  ) -> torch.Tensor:
    """int32 (capacity,): pmod(murmur3(keys), n) for rows below
    `num_rows`, `n` past them. `cols` are (values, validity or None,
    DataType) of equal length (the capacity). CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    if not 1 <= n < 2 ** 31:
        raise ValueError(f"partition_ids: n={n} outside [1, 2^31)")
    dev = _check(cols, num_rows, "partition_ids")
    with dispatch.kernel_seams("murmur3"):
        if dev.type == "cpu":
            return murmur3_plain(cols, num_rows, n)
        return _chain(cols, num_rows, n, False)


def hashes(cols: Sequence[KeyCol], num_rows: int) -> torch.Tensor:
    """int32 (capacity,): Spark's murmur3 (seed 42) chained over the
    keys for rows below `num_rows`, HASH_PAD past them. CPU tensors
    take the plain version; CUDA tensors launch the kernel."""
    dev = _check(cols, num_rows, "hashes")
    with dispatch.kernel_seams("murmur3_hashes"):
        if dev.type == "cpu":
            return hashes_plain(cols, num_rows)
        return _chain(cols, num_rows, HASH_PAD, True)


def _check(cols: Sequence[KeyCol], num_rows: int, what: str
           ) -> torch.device:
    """Validate the key columns; their one device."""
    if not cols:
        raise ValueError(f"{what}: no key columns")
    cap = cols[0][0].shape[0]
    devs = set()
    for v, m, dt in cols:
        hashing.check_hashable(dt)
        if v.dim() != 1 or v.shape[0] != cap or v.dtype not in _KIND:
            raise ValueError(
                f"{what}: key of {v.dtype} {tuple(v.shape)}; want "
                f"1-D fixed-width of length {cap}")
        if m is not None and (m.dtype != torch.bool or m.shape != v.shape):
            raise ValueError(f"{what}: validity must be bool, "
                             "shaped as its values")
        devs.add(v.device)
        if m is not None:
            devs.add(m.device)
    if not 0 <= num_rows <= cap:
        raise ValueError(f"{what}: num_rows={num_rows} outside "
                         f"[0, {cap}]")
    if len(devs) != 1:
        raise ValueError(f"{what}: keys on several devices {devs}")
    (dev,) = devs
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {dev}")
    return dev


def _chain(cols: Sequence[KeyCol], num_rows: int, n: int, emit_hash: bool
           ) -> torch.Tensor:
    """Launches over the columns, MAX_COLS a launch, each starting from
    the running hashes of the one before; the last emits the hash or
    the partition id, and `n` past `num_rows`."""
    global LAUNCHES, HASH_LAUNCHES
    cap = cols[0][0].shape[0]
    out = None
    for start in range(0, len(cols), MAX_COLS):
        group = [(v.contiguous(), None if m is None else m.contiguous())
                 for v, m, _ in cols[start:start + MAX_COLS]]
        last = start + MAX_COLS >= len(cols)
        out = _launch(group, out, num_rows, cap, n, emit_hash or not last)
        if emit_hash:
            HASH_LAUNCHES += 1
            dispatch.record("launch.murmur3_hashes")
        else:
            LAUNCHES += 1
            dispatch.record("launch.murmur3")
    return out


def _launch(group, h_in: Optional[torch.Tensor], num_rows: int, cap: int,
            n: int, emit_hash: bool) -> torch.Tensor:
    """One launch over up to MAX_COLS (values, validity) columns,
    starting from the running hashes `h_in` (None: the seed)."""
    from blaze_tpu_torch.ops.kernels import _build

    lib = _build.load("murmur3")
    fn = lib.blaze_murmur3_partition_ids
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    k = len(group)
    values = (ctypes.c_longlong * k)(*[v.data_ptr() for v, _ in group])
    valid = (ctypes.c_longlong * k)(
        *[0 if m is None else m.data_ptr() for _, m in group])
    kinds = (ctypes.c_int * k)(*[_KIND[v.dtype] for v, _ in group])
    dev = group[0][0].device
    out = torch.empty(cap, dtype=torch.int32, device=dev)
    nblocks = max(1, min((cap + _THREADS - 1) // _THREADS, _MAX_BLOCKS))
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(values, valid, kinds, k,
             None if h_in is None else h_in.data_ptr(), num_rows, cap, n,
             int(emit_hash), out.data_ptr(), nblocks, stream)
    _build.check(err, "murmur3 partition_ids")
    return out


def murmur3_plain(cols: Sequence[KeyCol], num_rows: int, n: int
                  ) -> torch.Tensor:
    """Plain PyTorch version: the torch chain of exprs/hashing, pmod,
    and the sentinel `n` past `num_rows`."""
    cap = cols[0][0].shape[0]
    pid = hashing.pmod(hashing.hash_columns_device(cols, cap), n)
    pad = torch.arange(cap, device=pid.device) >= num_rows
    return torch.where(pad, torch.full_like(pid, n), pid)


def hashes_plain(cols: Sequence[KeyCol], num_rows: int) -> torch.Tensor:
    """Plain PyTorch version of `hashes`: the torch chain of
    exprs/hashing and HASH_PAD past `num_rows`."""
    cap = cols[0][0].shape[0]
    h = hashing.hash_columns_device(cols, cap)
    pad = torch.arange(cap, device=h.device) >= num_rows
    return torch.where(pad, torch.full_like(h, HASH_PAD), h)
