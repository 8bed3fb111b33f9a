"""Kernel K2: the compaction permutation of a keep-mask.

Replaces the TPU kernel `blaze_tpu/ops/kernels/compact_pallas.py`
(`compact_perm`, body `_compact_kernel`). On this slice's path it backs
`ops/util._compact_indices`, which every output batch with a pending
selection passes through (`ensure_compacted`, executor.py:176), and
`ops/util.occupied_slots`, the grouped aggregate's occupied hash-table
slots. The contract is `_compact_indices`': the stable list of kept
rows packed to the front, the tail [n_live, cap) filled with 0
(`jnp.nonzero(..., fill_value=0)`, util.py:47), and the live count; no
host sync. Any nonzero byte of a uint8 mask means kept. Columns then
move by `torch.index_select`, a bit-exact gather.

Bound on the card: bytes - one read of the mask and one write of the
int32 permutation. The CUDA source (csrc/compact.cu) is one kernel
launch a call, 16-byte mask loads, ranks by popcount and a block scan,
staged contiguous stores and the 0 tail written in the same kernel. Up
to 65,536 rows (the engine's batches and most hash tables) each block
of 4096 rows also counts every other block's rows, so no block waits on
another and the call needs no scratch. Past that, a chained scan with
decoupled look-back over tiles of 8192 rows claimed from an atomic
counter, whose status words one cudaMemsetAsync clears. One allocation
holds the permutation, the count and any scratch. The TPU kernel's
one-hot MXU contraction has no place here.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from blaze_tpu_torch.runtime import dispatch

#: launches of the CUDA kernel (the plain version never counts); a
#: launch inside a CUDA graph counts at each replay
#: (runtime/dispatch.launched), not at capture
LAUNCHES = 0

# rows per look-back tile, bytes per vector load, the most rows of the
# kernel without look-back (csrc/compact.cu kTile, kVec, kSmallRows)
_TILE = 8192
_VEC = 16
_SMALL_ROWS = 65536
# look-back blocks per SM, each with a 32 KiB staging tile (the fastest
# of 2, 4, 6 and 8 at 2^24 rows on the H100)
_BLOCKS_PER_SM = 6

_fn = None


def compact_perm(keep: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(src int32 (cap,), n_live int32 (1,)): src[:n_live] are the kept
    row indices in order, src[n_live:] are 0. `keep` is bool or uint8;
    any nonzero byte is kept. CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    if keep.dtype not in (torch.bool, torch.uint8) or keep.dim() != 1:
        raise TypeError(f"compact_perm: keep must be a 1-D bool/uint8 "
                        f"tensor, got {keep.dtype} {tuple(keep.shape)}")
    if keep.numel() >= 2 ** 31 - _TILE:
        raise ValueError("compact_perm: int32 row indices need fewer "
                         "than 2^31 - 8192 rows")
    with dispatch.kernel_seams("compact_perm"):
        if keep.device.type == "cpu":
            return compact_perm_plain(keep)
        if keep.device.type != "cuda":
            raise ValueError(
                f"compact_perm: unsupported device {keep.device}")
        return _launch(keep.contiguous())


def _library():
    """The C entry, resolved once per process."""
    global _fn
    if _fn is None:
        from blaze_tpu_torch.ops.kernels import _build

        fn = _build.load("compact").blaze_compact_perm
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_int] + [ctypes.c_void_p] * 4
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def layout(n: int, head: int) -> Tuple[int, int, int]:
    """(look-back tiles, int32 offset of the count, int32 words in all)
    of one call's allocation: the permutation at 0 (16-byte aligned),
    the count after it, then, past _SMALL_ROWS rows, the look-back
    scratch (tile counter, done word, pad, one 64-bit status word per
    tile: 16 + 8 tiles bytes) on a 16-byte boundary. Tiles lie on the
    16-byte grid below the first row, `head` bytes before it. Up to
    _SMALL_ROWS rows there are no tiles and no scratch."""
    live_at = -(-n // 4) * 4
    if n <= _SMALL_ROWS:
        return 0, live_at, live_at + 4
    tiles = -(-(head + n) // _TILE)
    return tiles, live_at, live_at + 4 + (16 + 8 * tiles) // 4


def _count() -> None:
    global LAUNCHES
    LAUNCHES += 1
    dispatch.record("launch.compact_perm")


def _launch(keep: torch.Tensor, nblocks: Optional[int] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel; `nblocks` forces the look-back kernel's grid
    (to check it at any grid), where None takes _BLOCKS_PER_SM an SM."""
    from blaze_tpu_torch.ops.kernels import _build

    fn = _library()
    dev = keep.device
    n = keep.numel()
    ptr = keep.data_ptr()
    tiles, live_at, words = layout(n, ptr % _VEC)
    if nblocks is None:
        nblocks = min(tiles, _build.sm_count(dev) * _BLOCKS_PER_SM)
    buf = torch.empty(words, dtype=torch.int32, device=dev)
    base = buf.data_ptr()
    err = fn(ptr, n, tiles, nblocks, base, base + 4 * live_at,
             base + 4 * (live_at + 4), _build.stream(dev))
    _build.check(err, "compact_perm")
    dispatch.launched(_count)
    return buf[:n], buf[live_at:live_at + 1]


def compact_perm_plain(keep: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: prefix sum of the mask gives each kept
    row its slot; a scatter writes the row indices there."""
    n = keep.numel()
    k = keep != 0
    pos = torch.cumsum(k.to(torch.int32), 0, dtype=torch.int32) - 1
    # dropped rows all land in a dump slot past the end
    slot = torch.where(k, pos, torch.full_like(pos, n)).to(torch.int64)
    src = torch.zeros(n + 1, dtype=torch.int32, device=keep.device)
    src.scatter_(0, slot, torch.arange(n, dtype=torch.int32,
                                       device=keep.device))
    src[n] = 0
    n_live = k.sum(dtype=torch.int32).reshape(1)
    return src[:n], n_live
