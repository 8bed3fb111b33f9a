"""Kernel K2: the compaction permutation of a keep-mask.

Replaces the TPU kernel `blaze_tpu/ops/kernels/compact_pallas.py`
(`compact_perm`, body `_compact_kernel`). On this slice's path it backs
`ops/util._compact_indices`, which every output batch with a pending
selection passes through (`ensure_compacted`, executor.py:176). The
contract is `_compact_indices`': the stable list of kept rows packed to
the front, the tail [n_live, cap) filled with 0
(`jnp.nonzero(..., fill_value=0)`, util.py:47), and the live count.
Columns then move by `torch.index_select`, a bit-exact gather.

Bound on the card: bytes - one read of the mask and one write of the
int32 permutation. The CUDA source (csrc/compact.cu) counts each
1024-row block, scans the block counts in one block, then ranks every
warp's kept rows with one ballot and a popcount and scatters the row
indices; the TPU kernel's one-hot MXU contraction has no place here.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from blaze_tpu_torch.runtime import dispatch

#: launches of the CUDA kernel (the plain version never counts)
LAUNCHES = 0

_ROWS = 1024


def compact_perm(keep: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(src int32 (cap,), n_live int32 (1,)): src[:n_live] are the kept
    row indices in order, src[n_live:] are 0. `keep` is bool or uint8.
    CPU tensors take the plain version; CUDA tensors launch the
    kernel."""
    if keep.dtype not in (torch.bool, torch.uint8) or keep.dim() != 1:
        raise TypeError(f"compact_perm: keep must be a 1-D bool/uint8 "
                        f"tensor, got {keep.dtype} {tuple(keep.shape)}")
    if keep.numel() >= 2 ** 31:
        raise ValueError("compact_perm: int32 row indices need < 2^31 rows")
    if keep.device.type == "cpu":
        return compact_perm_plain(keep)
    if keep.device.type != "cuda":
        raise ValueError(f"compact_perm: unsupported device {keep.device}")
    return _launch(keep.contiguous())


def _launch(keep: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    from blaze_tpu_torch.ops.kernels import _build

    global LAUNCHES
    lib = _build.load("compact")
    fn = lib.blaze_compact_perm
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int] \
            + [ctypes.c_void_p] * 5
        fn.restype = ctypes.c_int
    n = keep.numel()
    nblocks = max(1, (n + _ROWS - 1) // _ROWS)
    dev = keep.device
    counts = torch.empty(nblocks, dtype=torch.int32, device=dev)
    offsets = torch.empty(nblocks, dtype=torch.int32, device=dev)
    n_live = torch.empty(1, dtype=torch.int32, device=dev)
    src = torch.empty(n, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(keep.data_ptr(), n, nblocks, counts.data_ptr(),
             offsets.data_ptr(), n_live.data_ptr(), src.data_ptr(), stream)
    _build.check(err, "compact_perm")
    LAUNCHES += 1
    dispatch.record("launch.compact_perm")
    return src, n_live


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
