"""State carried across from the JAX package: batches as plain numpy.

In a query engine the "weights" are the plan and the data. The plan
crosses as TaskDefinition bytes (plan/serde.py reads the JAX package's
wire format unchanged). The data crosses here: `batch_from_numpy` takes
the same padded buffers a JAX `ColumnBatch` holds - values, validity,
the deferred selection and the live row count - so an operator-level
test can feed both packages identical batches, padding included.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from blaze_tpu_torch.batch import (
    Column,
    ColumnBatch,
    torch_dtype,
    value_shape,
)
from blaze_tpu_torch.types import Schema


def batch_from_numpy(schema: Schema,
                     values: Sequence[np.ndarray],
                     validity: Sequence[Optional[np.ndarray]],
                     selection: Optional[np.ndarray],
                     num_rows: int,
                     device,
                     dictionaries: Optional[Sequence] = None
                     ) -> ColumnBatch:
    """Port ColumnBatch from padded host buffers: `values[i]` and
    `validity[i]` (bool or None) have the batch capacity as length; a
    string column's values are its int32 codes into `dictionaries[i]`
    (a pyarrow array); a decimal(>18) column's are (capacity, 2) int64
    [lo, hi] limbs, as the JAX package holds them."""
    device = torch.device(device)
    cols: List[Column] = []
    caps = set()
    if dictionaries is None:
        dictionaries = [None] * len(values)
    for field, v, m, d in zip(schema, values, validity, dictionaries):
        v = np.ascontiguousarray(v, dtype=field.dtype.physical_dtype())
        if v.shape[1:] != value_shape(field.dtype, len(v))[1:]:
            raise ValueError(f"{field.name}: values of shape {v.shape} "
                             f"for {field.dtype}")
        caps.add(len(v))
        t = torch.from_numpy(v.copy()).to(device)
        assert t.dtype == torch_dtype(field.dtype)
        mt = None
        if m is not None:
            mt = torch.from_numpy(
                np.ascontiguousarray(m, dtype=bool).copy()).to(device)
        cols.append(Column(field.dtype, t, mt, d))
    if len(caps) > 1:
        raise ValueError(f"columns disagree on capacity: {sorted(caps)}")
    sel = None
    if selection is not None:
        sel = torch.from_numpy(
            np.ascontiguousarray(selection, dtype=bool).copy()).to(device)
    return ColumnBatch(schema, cols, int(num_rows), sel)


def batch_to_numpy(cb: ColumnBatch) -> Tuple[
        List[np.ndarray], List[Optional[np.ndarray]],
        Optional[np.ndarray], int]:
    """(values, validity, selection, num_rows) as host numpy buffers,
    the inverse of batch_from_numpy."""
    values = [c.values.cpu().numpy() for c in cb.columns]
    validity = [
        c.validity.cpu().numpy() if c.validity is not None else None
        for c in cb.columns
    ]
    sel = cb.selection.cpu().numpy() if cb.selection is not None else None
    return values, validity, sel, cb.num_rows
