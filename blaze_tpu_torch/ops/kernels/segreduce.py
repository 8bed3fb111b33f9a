"""Kernel K3: segmented reduction (sum, min, max per segment).

Replaces the TPU kernel `blaze_tpu/ops/kernels/segreduce_pallas.py`
(`segment_sum` and `segment_minmax`, bodies `_sum_kernel` and
`_minmax_kernel`). On this slice's path it is every keyed reduction of
the hash aggregate: `_SegOps.sum/min/max` (ops/hash_aggregate.py) reduce
rows into raw hash-table slots, as the JAX package's
`jax.ops.segment_sum/min/max` do (hash_aggregate.py:211-242).

Semantics are those of `jax.ops.segment_*`, which the engine relies on,
not the Pallas kernel's (f32 only, k <= 8192): a gid outside [0, k)
contributes nowhere; an empty segment holds 0 for sum, +inf / iinfo.max
for min and -inf / iinfo.min for max; a NaN makes its own segment's
sum, min and max NaN; int64 sums wrap. Sums take float64 and int64
values, min and max float32, float64, int32 and int64; the result has
the values' dtype.

Bound on the card: bytes - one read of the int32 gid and of the value
per row, one write per segment. The CUDA source (csrc/segreduce.cu)
does one atomic per row, either into a per-block shared-memory copy of
the segments or straight into device memory; `uses_shared` picks by
the timings of both (PERF.md, K3). Float min/max run on ordered-integer
keys with NaN carried explicitly. Float64 sums through atomics are not
bit-repeatable from run to run.
"""

from __future__ import annotations

import ctypes

import torch

from blaze_tpu_torch.runtime import dispatch

#: launches of the CUDA kernel (the plain version never counts)
LAUNCHES = 0

_SUM_DTYPES = (torch.float64, torch.int64)
_MINMAX_DTYPES = (torch.float32, torch.float64, torch.int32, torch.int64)
_SUFFIX = {torch.float32: "f32", torch.float64: "f64", torch.int32: "i32",
           torch.int64: "i64"}
_THREADS = 256
# the largest private copy of the segments a block may take
# (csrc/segreduce.cu kMaxSharedBytes)
_SHARED_MAX_BYTES = 128 * 1024
# where the shared variant beat global atomics on the H100 (chip_smoke.py
# time_k3): a copy of at most 64 KiB, so three blocks share an SM, and
# at least 128 rows a segment to pay for clearing and flushing it
_SHARED_PICK_BYTES = 64 * 1024
_SHARED_MIN_ROWS = 128
# H100 shared memory per SM (228 KiB) less a margin, for blocks per SM
_SM_SHARED_BYTES = 224 * 1024
_MAX_GLOBAL_BLOCKS = 8192


def segment_sum(gid: torch.Tensor, values: torch.Tensor, k: int
                ) -> torch.Tensor:
    """Sum of `values` per segment `gid` in [0, k); float64 or int64."""
    return _segment("sum", gid, values, k)


def segment_min(gid: torch.Tensor, values: torch.Tensor, k: int
                ) -> torch.Tensor:
    """Minimum of `values` per segment; empty segments hold +inf or
    iinfo.max."""
    return _segment("min", gid, values, k)


def segment_max(gid: torch.Tensor, values: torch.Tensor, k: int
                ) -> torch.Tensor:
    """Maximum of `values` per segment; empty segments hold -inf or
    iinfo.min."""
    return _segment("max", gid, values, k)


def _segment(op: str, gid: torch.Tensor, values: torch.Tensor, k: int
             ) -> torch.Tensor:
    allowed = _SUM_DTYPES if op == "sum" else _MINMAX_DTYPES
    if values.dtype not in allowed:
        raise TypeError(f"segment_{op}: unsupported dtype {values.dtype}")
    if gid.dtype != torch.int32:
        raise TypeError(f"segment_{op}: gid must be int32, got {gid.dtype}")
    if values.dim() != 1 or gid.shape != values.shape:
        raise ValueError(
            f"segment_{op}: shapes {tuple(gid.shape)} / "
            f"{tuple(values.shape)} must be equal and 1-D")
    if not 1 <= k < 2 ** 31:
        raise ValueError(f"segment_{op}: k={k} outside [1, 2^31)")
    if gid.device.type == "cpu" and values.device.type == "cpu":
        return _PLAIN[op](gid, values, k)
    if values.device.type != "cuda" or gid.device != values.device:
        raise ValueError(
            f"segment_{op}: gid on {gid.device}, values on {values.device}")
    return _launch(op, gid.contiguous(), values.contiguous(), k)


def uses_shared(n: int, k: int, itemsize: int) -> bool:
    """The shared-memory variant for small domains that many rows hit;
    otherwise one global atomic per row."""
    return k * itemsize <= _SHARED_PICK_BYTES and n >= _SHARED_MIN_ROWS * k


def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _launch(op: str, gid: torch.Tensor, values: torch.Tensor, k: int,
            shared: bool | None = None) -> torch.Tensor:
    """Launch the kernel; `shared` forces a variant (for timing both)
    where None takes uses_shared's choice."""
    from blaze_tpu_torch.ops.kernels import _build

    global LAUNCHES
    lib = _build.load("segreduce")
    fn = getattr(lib, f"blaze_segment_{op}_{_SUFFIX[values.dtype]}")
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    n = values.numel()
    dev = values.device
    itemsize = values.element_size()
    if shared is None:
        shared = uses_shared(n, k, itemsize)
    row_blocks = max(1, (n + _THREADS - 1) // _THREADS)
    if shared:
        per_sm = max(1, _SM_SHARED_BYTES // (k * itemsize))
        nblocks = min(row_blocks, _sm_count(dev) * per_sm)
    else:
        nblocks = min(row_blocks, _MAX_GLOBAL_BLOCKS)
    out = torch.empty(k, dtype=values.dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(gid.data_ptr(), values.data_ptr(), n, k, out.data_ptr(),
             nblocks, int(shared), stream)
    _build.check(err, f"segment_{op}")
    LAUNCHES += 1
    dispatch.record("launch.segreduce")
    return out


def neutral(op: str, dtype: torch.dtype):
    """The empty segment's value for `op` over `dtype`."""
    if op == "sum":
        return 0
    if dtype.is_floating_point:
        return float("inf") if op == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if op == "min" else info.min


def _target(gid: torch.Tensor, k: int) -> torch.Tensor:
    """int64 row targets; out-of-range gids go to the dump slot k."""
    g = gid.to(torch.int64)
    return torch.where((g >= 0) & (g < k), g, torch.full_like(g, k))


def segment_sum_plain(gid: torch.Tensor, values: torch.Tensor, k: int
                      ) -> torch.Tensor:
    """Plain PyTorch version of segment_sum."""
    out = torch.zeros(k + 1, dtype=values.dtype, device=values.device)
    out.index_add_(0, _target(gid, k), values)
    return out[:k]


def _any(tgt: torch.Tensor, flag: torch.Tensor, k: int) -> torch.Tensor:
    """Per segment (and the dump slot k): whether any row's flag is set."""
    hits = torch.zeros(k + 1, dtype=torch.int32, device=flag.device)
    hits.index_add_(0, tgt, flag.to(torch.int32))
    return hits > 0


def _extreme_plain(op: str, gid: torch.Tensor, values: torch.Tensor,
                   k: int) -> torch.Tensor:
    tgt = _target(gid, k)
    out = torch.full((k + 1,), neutral(op, values.dtype),
                     dtype=values.dtype, device=values.device)
    out.scatter_reduce_(0, tgt, values, "amin" if op == "min" else "amax",
                        include_self=True)
    if values.dtype.is_floating_point:
        # which of two equal zeros scatter_reduce_ keeps depends on the
        # row order; -0.0 orders below +0.0, as XLA's min and max do
        want_neg = op == "min"
        has_pref = _any(tgt, (values == 0)
                        & (torch.signbit(values) == want_neg), k)
        pref, other = (-0.0, 0.0) if want_neg else (0.0, -0.0)
        zero = torch.where(has_pref, torch.full_like(out, pref),
                           torch.full_like(out, other))
        out = torch.where(out == 0, zero, out)
        # NaN wins its segment on every device
        out = torch.where(_any(tgt, torch.isnan(values), k),
                          torch.full_like(out, float("nan")), out)
    return out[:k]


def segment_min_plain(gid: torch.Tensor, values: torch.Tensor, k: int
                      ) -> torch.Tensor:
    """Plain PyTorch version of segment_min."""
    return _extreme_plain("min", gid, values, k)


def segment_max_plain(gid: torch.Tensor, values: torch.Tensor, k: int
                      ) -> torch.Tensor:
    """Plain PyTorch version of segment_max."""
    return _extreme_plain("max", gid, values, k)


_PLAIN = {"sum": segment_sum_plain, "min": segment_min_plain,
          "max": segment_max_plain}
