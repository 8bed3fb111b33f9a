"""Kernel K1: masked column statistics (sum, min, max, count).

Replaces the TPU kernel `blaze_tpu/ops/kernels/stats_pallas.py`
(`masked_stats`, body `_kernel`). On this slice's path it is the keyless
aggregate's core: one launch per aggregate column per batch gives the
SUM/AVG/MIN/MAX state and the non-null count that the JAX package
computes with two or three separate reductions (`_SegOps.scalar`,
hash_aggregate.py:211-242, fed by `_agg_state` at :1100-1152).

Bound on the card: bytes - one read of the values and of the mask; the
arithmetic per row is four compares/adds. The CUDA source
(csrc/stats.cu) keeps all four states in registers through one
grid-strided pass, folds each block with warp shuffles, and folds the
per-block partials in a second, single-block launch in a fixed order,
so results repeat bit for bit.

Results follow the JAX keyless-aggregate path, not the Pallas kernel's
f32 partials: the sum is float64 for float input and int64 (two's-
complement wrap) for integer input (`_sum_type`, hash_aggregate.py:362);
min and max keep the value dtype and let NaN through (jnp.min/max); the
count is int64. An empty selection gives (0, +max, -max, 0) with +/-inf
for floats. All four come back as device tensors of shape (1,), with no
host sync.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from blaze_tpu_torch.runtime import dispatch

#: launches of the CUDA kernel (the plain version never counts)
LAUNCHES = 0

_ENTRIES = {
    torch.float32: "blaze_masked_stats_f32",
    torch.float64: "blaze_masked_stats_f64",
    torch.int32: "blaze_masked_stats_i32",
    torch.int64: "blaze_masked_stats_i64",
}
_THREADS = 256
_ROWS_PER_BLOCK = 4 * _THREADS
_MAX_BLOCKS = 1024

Stats = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def sum_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype.is_floating_point else torch.int64


def masked_stats(values: torch.Tensor, mask: torch.Tensor) -> Stats:
    """(sum, min, max, count) over rows where mask != 0.

    `values`: 1-D float32/float64/int32/int64; `mask`: bool or uint8 of
    the same length. CPU tensors take the plain version; CUDA tensors
    launch the kernel."""
    if values.dtype not in _ENTRIES:
        raise TypeError(f"masked_stats: unsupported dtype {values.dtype}")
    if mask.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"masked_stats: mask must be bool/uint8, "
                        f"got {mask.dtype}")
    if values.dim() != 1 or mask.shape != values.shape:
        raise ValueError(
            f"masked_stats: shapes {tuple(values.shape)} / "
            f"{tuple(mask.shape)} must be equal and 1-D")
    if values.device.type == "cpu" and mask.device.type == "cpu":
        return masked_stats_plain(values, mask)
    if values.device.type != "cuda" or mask.device != values.device:
        raise ValueError(
            f"masked_stats: values on {values.device}, mask on "
            f"{mask.device}")
    return _launch(values.contiguous(), mask.contiguous())


def _launch(values: torch.Tensor, mask: torch.Tensor) -> Stats:
    from blaze_tpu_torch.ops.kernels import _build

    global LAUNCHES
    lib = _build.load("stats")
    fn = getattr(lib, _ENTRIES[values.dtype])
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_int] + [ctypes.c_void_p] * 9
        fn.restype = ctypes.c_int
    n = values.numel()
    nblocks = max(1, min(_MAX_BLOCKS,
                         (n + _ROWS_PER_BLOCK - 1) // _ROWS_PER_BLOCK))
    dev = values.device
    acc = sum_dtype(values.dtype)
    psum = torch.empty(nblocks, dtype=acc, device=dev)
    plo = torch.empty(nblocks, dtype=values.dtype, device=dev)
    phi = torch.empty(nblocks, dtype=values.dtype, device=dev)
    pcnt = torch.empty(nblocks, dtype=torch.int64, device=dev)
    osum = torch.empty(1, dtype=acc, device=dev)
    olo = torch.empty(1, dtype=values.dtype, device=dev)
    ohi = torch.empty(1, dtype=values.dtype, device=dev)
    ocnt = torch.empty(1, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(values.data_ptr(), mask.data_ptr(), n, nblocks,
             psum.data_ptr(), plo.data_ptr(), phi.data_ptr(),
             pcnt.data_ptr(), osum.data_ptr(), olo.data_ptr(),
             ohi.data_ptr(), ocnt.data_ptr(), stream)
    _build.check(err, "masked_stats")
    LAUNCHES += 1
    dispatch.record("launch.masked_stats")
    return osum, olo, ohi, ocnt


def masked_stats_plain(values: torch.Tensor, mask: torch.Tensor) -> Stats:
    """Plain PyTorch version of the same function (same neutral
    elements, same state dtypes)."""
    live = mask != 0
    acc = sum_dtype(values.dtype)
    if values.dtype.is_floating_point:
        hi_n, lo_n = float("inf"), float("-inf")
    else:
        info = torch.iinfo(values.dtype)
        hi_n, lo_n = info.max, info.min
    if values.numel() == 0:
        return (torch.zeros(1, dtype=acc, device=values.device),
                torch.full((1,), hi_n, dtype=values.dtype,
                           device=values.device),
                torch.full((1,), lo_n, dtype=values.dtype,
                           device=values.device),
                torch.zeros(1, dtype=torch.int64, device=values.device))
    s = torch.where(live, values.to(acc), torch.zeros((), dtype=acc,
                                                      device=values.device))
    lo = torch.where(live, values, torch.full((), hi_n, dtype=values.dtype,
                                              device=values.device))
    hi = torch.where(live, values, torch.full((), lo_n, dtype=values.dtype,
                                              device=values.device))
    lo, hi = lo.amin().reshape(1), hi.amax().reshape(1)
    if values.dtype.is_floating_point:
        # which of two equal zeros amin/amax keep depends on the order;
        # -0.0 orders below +0.0, as jnp.min / jnp.max
        zero = live & (values == 0)
        neg = (zero & torch.signbit(values)).any()
        pos = (zero & ~torch.signbit(values)).any()
        lo = torch.where(lo == 0, torch.where(neg, -0.0, 0.0).to(lo), lo)
        hi = torch.where(hi == 0, torch.where(pos, 0.0, -0.0).to(hi), hi)
    return (s.sum(dtype=acc).reshape(1), lo, hi,
            live.sum(dtype=torch.int64).reshape(1))
