"""Kernel K3: segmented reduction (sum, min, max per segment).

Replaces the TPU kernel `blaze_tpu/ops/kernels/segreduce_pallas.py`
(`segment_sum` and `segment_minmax`, bodies `_sum_kernel` and
`_minmax_kernel`). On this slice's path it is every keyed reduction of
the hash aggregate: `_SegOps.sum/extreme/count` (ops/hash_aggregate.py)
reduce rows into raw hash-table slots, as the JAX package's
`jax.ops.segment_sum/min/max` over its `jnp.where`'d, widened columns do
(hash_aggregate.py:211-242).

Semantics are those of `jax.ops.segment_*`, which the engine relies on,
not the Pallas kernel's (f32 only, k <= 8192): a gid outside [0, k)
contributes nowhere, and neither does a row whose `contrib` byte is 0;
an empty segment holds 0 for sum, +inf / iinfo.max for min and -inf /
iinfo.min for max; a NaN makes its own segment's sum, min and max NaN;
-0.0 orders below +0.0; int64 sums wrap. The column comes in its own
dtype (bool, int8-64, float32/64) and widens in registers: sums to
int64 or float64, min/max of bool, int8 and int16 to int32; the rest
keep theirs. With `at`, the result is taken at those slots only (the
grouped aggregate's occupied slots), in the same call.

Bound on the card: bytes - one read of the int32 gid, the column and
the mask byte per row, one write per segment. The CUDA source
(csrc/segreduce.cu) clears its accumulators with one cudaMemsetAsync
(every empty accumulator is all-zero bits: min is stored as the
complement of an ordered key, so both min and max fold with atomicMax),
folds the rows with one atomic each into a per-block shared-memory copy
("shared") or device memory ("global"), and decodes min/max keys, or
gathers at `at`, in one more launch. `variant` picks by the timings of
both on the card (PERF.md, K3). Float64 sums through atomics are not
bit-repeatable from run to run.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from blaze_tpu_torch.runtime import dispatch

#: launches of the CUDA kernel (the plain version never counts); a
#: launch inside a CUDA graph counts at each replay
#: (runtime/dispatch.launched), not at capture
LAUNCHES = 0

# column dtype codes of the C entry (csrc/segreduce.cu `Src`)
_SRC = {torch.bool: 0, torch.int8: 1, torch.int16: 2, torch.int32: 3,
        torch.int64: 4, torch.float32: 5, torch.float64: 6}
_OPS = {"sum": 0, "min": 1, "max": 2}
_VARIANTS = {"global": 0, "shared": 1}
_THREADS = 256  # global variant (csrc/segreduce.cu kThreads)
_UNROLL = 4  # rows per thread per step (csrc/segreduce.cu kUnroll)
# the largest shared-memory copy a block may take
# (csrc/segreduce.cu kMaxSharedBytes)
_SHARED_MAX_BYTES = 200 * 1024
# A private copy beat global atomics on the H100 from 48 rows a slot
# (the sums lost at 32 rows a slot; PERF.md, K3)
_COPY_MIN_ROWS = 48
# threads and blocks per SM of the shared variant: every block clears,
# and flushes to device memory, its own copy, so fewer, wider blocks won
_COPY_THREADS = 1024
_COPY_BLOCKS_PER_SM = 2
# H100 shared memory per SM (228 KiB) less a margin, for blocks per SM
_SM_SHARED_BYTES = 224 * 1024
_SM_THREADS = 2048

_fn = None


def segment_sum(gid: torch.Tensor, values: torch.Tensor, k: int,
                contrib: Optional[torch.Tensor] = None,
                at: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sum of `values` per segment `gid` in [0, k) over the rows where
    `contrib` holds; float64 for float columns, wrapping int64 for the
    rest. With `at`, the sums at those slots."""
    return _segment("sum", gid, values, k, contrib, at)


def segment_min(gid: torch.Tensor, values: torch.Tensor, k: int,
                contrib: Optional[torch.Tensor] = None,
                at: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Minimum of `values` per segment; empty segments hold +inf or
    iinfo.max. bool, int8 and int16 come back as int32."""
    return _segment("min", gid, values, k, contrib, at)


def segment_max(gid: torch.Tensor, values: torch.Tensor, k: int,
                contrib: Optional[torch.Tensor] = None,
                at: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Maximum of `values` per segment; empty segments hold -inf or
    iinfo.min. bool, int8 and int16 come back as int32."""
    return _segment("max", gid, values, k, contrib, at)


def result_dtype(op: str, dtype: torch.dtype) -> torch.dtype:
    """The dtype a reduction of a `dtype` column comes back in."""
    if op == "sum":
        return torch.float64 if dtype.is_floating_point else torch.int64
    if dtype in (torch.bool, torch.int8, torch.int16):
        return torch.int32
    return dtype


def _segment(op: str, gid, values, k: int, contrib, at) -> torch.Tensor:
    if values.dtype not in _SRC:
        raise TypeError(f"segment_{op}: unsupported dtype {values.dtype}")
    if gid.dtype != torch.int32:
        raise TypeError(f"segment_{op}: gid must be int32, got {gid.dtype}")
    if values.dim() != 1 or gid.shape != values.shape:
        raise ValueError(
            f"segment_{op}: shapes {tuple(gid.shape)} / "
            f"{tuple(values.shape)} must be equal and 1-D")
    if contrib is not None and (
            contrib.dtype not in (torch.bool, torch.uint8)
            or contrib.shape != values.shape):
        raise ValueError(f"segment_{op}: contrib must be a bool/uint8 "
                         f"mask of the rows, got {contrib.dtype} "
                         f"{tuple(contrib.shape)}")
    if at is not None and (at.dtype != torch.int32 or at.dim() != 1):
        raise ValueError(f"segment_{op}: at must be 1-D int32")
    if not 1 <= k < 2 ** 31:
        raise ValueError(f"segment_{op}: k={k} outside [1, 2^31)")
    dev = values.device
    others = [t.device for t in (gid, contrib, at) if t is not None]
    # the grouped aggregate's reductions: the JAX package's
    # group_dispatch span
    with dispatch.kernel_seams(f"segment_{op}", "group_dispatch"):
        if dev.type == "cpu" and all(d.type == "cpu" for d in others):
            return _PLAIN[op](gid, values, k, contrib, at)
        if dev.type != "cuda" or any(d != dev for d in others):
            raise ValueError(f"segment_{op}: tensors on {dev} and "
                             f"{[str(d) for d in others]}")
        return _launch(op, gid.contiguous(), values.contiguous(), k,
                       None if contrib is None else contrib.contiguous(),
                       None if at is None else at.contiguous())


def key_size(op: str, dtype: torch.dtype) -> int:
    """Bytes of one accumulator: the result's width."""
    return result_dtype(op, dtype).itemsize


def variant(n: int, k: int, op: str, dtype: torch.dtype) -> str:
    """The variant for n rows of a `dtype` column into k slots: a
    block-private shared-memory copy where one fits and enough rows hit
    each slot, otherwise one global atomic per row."""
    if n >= _COPY_MIN_ROWS * k and \
            k * key_size(op, dtype) <= _SHARED_MAX_BYTES:
        return "shared"
    return "global"


def _library():
    """The C entry, resolved once per process."""
    global _fn
    if _fn is None:
        from blaze_tpu_torch.ops.kernels import _build

        fn = _build.load("segreduce").blaze_segment_reduce
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _grid(kind: str, n: int, k: int, keysize: int, sms: int):
    """(blocks, threads a block) of one launch."""
    threads = _THREADS if kind == "global" else _COPY_THREADS
    row_blocks = max(1, -(-n // (threads * _UNROLL)))
    fit = _SM_THREADS // threads
    if kind == "global":
        return min(row_blocks, sms * fit), threads
    per_sm = max(1, min(fit, _COPY_BLOCKS_PER_SM,
                        _SM_SHARED_BYTES // (k * keysize)))
    return min(row_blocks, sms * per_sm), threads


def _count() -> None:
    global LAUNCHES
    LAUNCHES += 1
    dispatch.record("launch.segreduce")


def _launch(op: str, gid: torch.Tensor, values: torch.Tensor, k: int,
            contrib: Optional[torch.Tensor] = None,
            at: Optional[torch.Tensor] = None,
            kind: Optional[str] = None) -> torch.Tensor:
    """Launch the kernel; `kind` forces a variant (for timing them all)
    where None takes `variant`'s choice."""
    from blaze_tpu_torch.ops.kernels import _build

    fn = _library()
    n = values.numel()
    dev = values.device
    rdt = result_dtype(op, values.dtype)
    keysize = rdt.itemsize
    if kind is None:
        kind = variant(n, k, op, values.dtype)
    nblocks, threads = _grid(kind, n, k, keysize, _build.sm_count(dev))
    acc = torch.empty(k, dtype=rdt, device=dev)
    out = acc if at is None else torch.empty(at.numel(), dtype=rdt,
                                              device=dev)
    err = fn(_OPS[op], _SRC[values.dtype], gid.data_ptr(),
             values.data_ptr(),
             None if contrib is None else contrib.data_ptr(), n, k,
             acc.data_ptr(), None if at is None else at.data_ptr(),
             0 if at is None else at.numel(),
             None if at is None else out.data_ptr(), _VARIANTS[kind],
             nblocks, threads, _build.stream(dev))
    _build.check(err, f"segment_{op}")
    dispatch.launched(_count)
    return out


def neutral(op: str, dtype: torch.dtype):
    """The empty segment's value for `op` over a `dtype` result."""
    if op == "sum":
        return 0
    if dtype.is_floating_point:
        return float("inf") if op == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if op == "min" else info.min


def _target(gid: torch.Tensor, k: int,
            contrib: Optional[torch.Tensor]) -> torch.Tensor:
    """int64 row targets; out-of-range and masked-out rows go to the
    dump slot k."""
    g = gid.to(torch.int64)
    keep = (g >= 0) & (g < k)
    if contrib is not None:
        keep = keep & (contrib != 0)
    return torch.where(keep, g, torch.full_like(g, k))


def _widen(op: str, values: torch.Tensor) -> torch.Tensor:
    return values.to(result_dtype(op, values.dtype))


def _at(r: torch.Tensor, at: Optional[torch.Tensor]) -> torch.Tensor:
    return r if at is None else torch.index_select(r, 0, at)


def segment_sum_plain(gid: torch.Tensor, values: torch.Tensor, k: int,
                      contrib: Optional[torch.Tensor] = None,
                      at: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of segment_sum."""
    v = _widen("sum", values)
    out = torch.zeros(k + 1, dtype=v.dtype, device=v.device)
    out.index_add_(0, _target(gid, k, contrib), v)
    return _at(out[:k], at)


def _any(tgt: torch.Tensor, flag: torch.Tensor, k: int) -> torch.Tensor:
    """Per segment (and the dump slot k): whether any row's flag is set."""
    hits = torch.zeros(k + 1, dtype=torch.int32, device=flag.device)
    hits.index_add_(0, tgt, flag.to(torch.int32))
    return hits > 0


def _extreme_plain(op: str, gid: torch.Tensor, values: torch.Tensor,
                   k: int, contrib: Optional[torch.Tensor],
                   at: Optional[torch.Tensor]) -> torch.Tensor:
    v = _widen(op, values)
    tgt = _target(gid, k, contrib)
    out = torch.full((k + 1,), neutral(op, v.dtype), dtype=v.dtype,
                     device=v.device)
    out.scatter_reduce_(0, tgt, v, "amin" if op == "min" else "amax",
                        include_self=True)
    if v.dtype.is_floating_point:
        # which of two equal zeros scatter_reduce_ keeps depends on the
        # row order; -0.0 orders below +0.0, as XLA's min and max do
        want_neg = op == "min"
        has_pref = _any(tgt, (v == 0) & (torch.signbit(v) == want_neg), k)
        pref, other = (-0.0, 0.0) if want_neg else (0.0, -0.0)
        zero = torch.where(has_pref, torch.full_like(out, pref),
                           torch.full_like(out, other))
        out = torch.where(out == 0, zero, out)
        # NaN wins its segment on every device
        out = torch.where(_any(tgt, torch.isnan(v), k),
                          torch.full_like(out, float("nan")), out)
    return _at(out[:k], at)


def segment_min_plain(gid: torch.Tensor, values: torch.Tensor, k: int,
                      contrib: Optional[torch.Tensor] = None,
                      at: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of segment_min."""
    return _extreme_plain("min", gid, values, k, contrib, at)


def segment_max_plain(gid: torch.Tensor, values: torch.Tensor, k: int,
                      contrib: Optional[torch.Tensor] = None,
                      at: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of segment_max."""
    return _extreme_plain("max", gid, values, k, contrib, at)


_PLAIN = {"sum": segment_sum_plain, "min": segment_min_plain,
          "max": segment_max_plain}
