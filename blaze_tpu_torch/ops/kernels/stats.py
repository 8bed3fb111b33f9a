"""Kernel K1: masked column statistics (sum, min, max, count).

Replaces the TPU kernel `blaze_tpu/ops/kernels/stats_pallas.py`
(`masked_stats`, body `_kernel`). On this slice's path it is the keyless
aggregate's core: one launch per aggregate column per batch gives the
SUM/AVG/MIN/MAX state and the non-null count that the JAX package
computes with two or three separate reductions (`_SegOps.scalar`,
hash_aggregate.py:211-242, fed by `_agg_state` at :1100-1152).

Bound on the card: bytes - one read of the values and of the mask; the
arithmetic per row is a few selects and adds. The CUDA source
(csrc/stats.cu) takes the column in its own dtype (bool, int8-64,
float32/64) and widens in registers; each thread keeps two 16-byte
value vectors and their mask bytes in flight and applies the mask with
selects. Min and max compare integer keys that order -0.0 below +0.0
and put NaN past the infinities, so a NaN needs no test of its own. One
launch a call: the first warp of the block that takes the last ticket
folds the per-block partials in a fixed order (a grid of one block
writes its result directly), so results repeat bit for bit and no
memset or second launch is needed. The partials and the ticket live in
a scratch that is zeroed once and kept for each (device, stream): two
streams never share a ticket, and nothing but the 32-byte result is
allocated per call, as a CUDA graph needs. A failed launch may leave
the ticket set, so its stream's scratch is dropped and made anew. A
CUDA graph passes a scratch of its own (`new_scratch`): the graph
replays on whatever stream its caller is on, so it cannot rely on the
capturing stream's. A launch captured in a graph counts once at each
replay (runtime/dispatch.launched), not at capture.

Results follow the JAX keyless-aggregate path, not the Pallas kernel's
f32 partials: the sum is float64 for float input and int64 (two's-
complement wrap) for integer and bool input (`_sum_type`,
hash_aggregate.py:362); min and max keep the value dtype and let NaN
through (jnp.min/max), and a bool's min is its AND, its max its OR; the
count is int64. An empty selection gives (0, +max, -max, 0), with
+/-inf for floats and (True, False) for bool. All four come back as
(1,)-shaped views of one device buffer, with no host sync.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from blaze_tpu_torch.runtime import dispatch

#: launches of the CUDA kernel (the plain version never counts)
LAUNCHES = 0

_ENTRIES = {
    torch.bool: "blaze_masked_stats_b8",
    torch.int8: "blaze_masked_stats_i8",
    torch.int16: "blaze_masked_stats_i16",
    torch.int32: "blaze_masked_stats_i32",
    torch.int64: "blaze_masked_stats_i64",
    torch.float32: "blaze_masked_stats_f32",
    torch.float64: "blaze_masked_stats_f64",
}
# the most blocks the scratch holds (csrc/stats.cu kMaxBlocks)
_MAX_BLOCKS = 1024
# bytes of values a block's round reads: 1024 threads, two 16-byte
# vectors each (csrc/stats.cu kThreads, kUnroll)
_ROUND_BYTES = 16 * 1024 * 2
# up to this many bytes of values one block takes the whole column: a
# second block costs more (the ticket's fence and atomic, the last
# block's fold) than it saves (chip_smoke.py's k1_grid_sweep)
_ONE_BLOCK_BYTES = 65536
_BLOCKS_PER_SM = 2
# int64 words of a stream's scratch: four a partial, then the ticket
_SCRATCH_WORDS = 4 * _MAX_BLOCKS + 1

_fns: Dict[torch.dtype, object] = {}
_scratch: Dict[Tuple[int, int], torch.Tensor] = {}

Stats = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def sum_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype.is_floating_point else torch.int64


def masked_stats(values: torch.Tensor, mask: torch.Tensor,
                 scratch: Optional[torch.Tensor] = None) -> Stats:
    """(sum, min, max, count) over rows where mask != 0.

    `values`: 1-D bool/int8/int16/int32/int64/float32/float64; `mask`:
    bool or uint8 of the same length, any nonzero byte kept. CPU tensors
    take the plain version; CUDA tensors launch the kernel, with the
    caller's `scratch` (from `new_scratch`) or the current stream's."""
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
    return _launch(values.contiguous(), mask.contiguous(), None, scratch)


def new_scratch(device: torch.device) -> torch.Tensor:
    """A zeroed scratch that one caller (a CUDA graph) keeps for itself:
    no other launch shares its ticket."""
    return torch.zeros(_SCRATCH_WORDS, dtype=torch.int64, device=device)


def grid(n: int, itemsize: int, sms: int) -> int:
    """Blocks of a call: one up to _ONE_BLOCK_BYTES of values, else one
    a round of _ROUND_BYTES, at most _BLOCKS_PER_SM an SM."""
    nbytes = n * itemsize
    if nbytes <= _ONE_BLOCK_BYTES:
        return 1
    return min(-(-nbytes // _ROUND_BYTES), _BLOCKS_PER_SM * sms)


def result_views(buf: torch.Tensor, dtype: torch.dtype) -> Stats:
    """(sum, min, max, count) as (1,)-shaped views of one int64 buffer
    of 4 words: the sum in word 0 (float64 or int64), the count in word
    1, min and max side by side from word 2 in the column's dtype."""
    s = buf[0:1] if not dtype.is_floating_point else buf[0:1].view(
        torch.float64)
    ext = buf[2:4].view(dtype)
    return s, ext[0:1], ext[1:2], buf[1:2]


def _entry(dtype: torch.dtype):
    """The C entry for a column dtype, resolved once per process."""
    fn = _fns.get(dtype)
    if fn is None:
        from blaze_tpu_torch.ops.kernels import _build

        fn = getattr(_build.load("stats"), _ENTRIES[dtype])
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_int] + [ctypes.c_void_p] * 3
        fn.restype = ctypes.c_int
        _fns[dtype] = fn
    return fn


def _count() -> None:
    global LAUNCHES
    LAUNCHES += 1
    dispatch.record("launch.masked_stats")


def _launch(values: torch.Tensor, mask: torch.Tensor,
            nblocks: Optional[int] = None,
            scratch: Optional[torch.Tensor] = None) -> Stats:
    """Launch the kernel on the current stream; `nblocks` forces the
    grid (to check it at any grid), where None takes `grid`; `scratch`
    None takes the stream's."""
    from blaze_tpu_torch.ops.kernels import _build

    fn = _entry(values.dtype)
    dev = values.device
    stream = _build.stream(dev)
    key = (dev.index, stream) if scratch is None else None
    if key is not None:
        scratch = _scratch.get(key)
        if scratch is None:
            scratch = _scratch[key] = new_scratch(dev)
    n = values.numel()
    if nblocks is None:
        nblocks = grid(n, values.element_size(), _build.sm_count(dev))
    buf = torch.empty(4, dtype=torch.int64, device=dev)
    err = fn(values.data_ptr(), mask.data_ptr(), n, nblocks,
             scratch.data_ptr(), buf.data_ptr(), stream)
    if err != 0:
        if key is not None:
            del _scratch[key]
        _build.check(err, "masked_stats")
    dispatch.launched(_count)
    return result_views(buf, values.dtype)


def masked_stats_plain(values: torch.Tensor, mask: torch.Tensor) -> Stats:
    """Plain PyTorch version of the same function (same neutral
    elements, same state dtypes, the same one-buffer layout)."""
    dev = values.device
    live = mask != 0
    buf = torch.empty(4, dtype=torch.int64, device=dev)
    s, lo, hi, cnt = result_views(buf, values.dtype)
    acc = sum_dtype(values.dtype)
    s.copy_(torch.where(live, values.to(acc),
                        torch.zeros((), dtype=acc, device=dev))
            .sum(dtype=acc).reshape(1))
    cnt.copy_(live.sum(dtype=torch.int64).reshape(1))
    if values.dtype == torch.bool:
        # min is the AND of the kept rows, max their OR
        lo.copy_((values | ~live).all().reshape(1))
        hi.copy_((values & live).any().reshape(1))
        return s, lo, hi, cnt
    if values.dtype.is_floating_point:
        hi_n, lo_n = float("inf"), float("-inf")
    else:
        info = torch.iinfo(values.dtype)
        hi_n, lo_n = info.max, info.min
    if values.numel() == 0:
        lo.fill_(hi_n)
        hi.fill_(lo_n)
        return s, lo, hi, cnt
    lo.copy_(torch.where(live, values, torch.full(
        (), hi_n, dtype=values.dtype, device=dev)).amin().reshape(1))
    hi.copy_(torch.where(live, values, torch.full(
        (), lo_n, dtype=values.dtype, device=dev)).amax().reshape(1))
    if values.dtype.is_floating_point:
        # which of two equal zeros amin/amax keep depends on the order;
        # -0.0 orders below +0.0, as jnp.min / jnp.max
        zero = live & (values == 0)
        neg = (zero & torch.signbit(values)).any()
        pos = (zero & ~torch.signbit(values)).any()
        lo.copy_(torch.where(lo == 0, torch.where(neg, -0.0, 0.0).to(lo), lo))
        hi.copy_(torch.where(hi == 0, torch.where(pos, 0.0, -0.0).to(hi), hi))
    return s, lo, hi, cnt
