"""External execution helpers.

The JAX package's ops/external.py hash-buckets oversized inputs through
the shuffle format (grace execution). That needs the shuffle writer and
kernel K4 (ROADMAP 'Modules to port' item 6); this slice ports only the
stream cut that decides whether an aggregate's input fits.
"""

from __future__ import annotations

from typing import Iterator, List, Tuple

from blaze_tpu_torch.batch import ColumnBatch


def collect_until(
    it: Iterator[ColumnBatch], row_limit: int
) -> Tuple[List[ColumnBatch], bool]:
    """Pull batches until the stream ends or row_limit is crossed.
    Returns (collected, exceeded)."""
    out: List[ColumnBatch] = []
    total = 0
    for cb in it:
        out.append(cb)
        total += cb.num_rows
        if total > row_limit:
            return out, True
    return out, False
