"""Shared helpers for the PyTorch port's differential tests
(tests/test_torch_*.py): Arrow equality with NaN equal to NaN, and
identical batches for both packages built from numpy buffers.

Importing it runs torch on one intra-op thread in this process: the
port's tests run in several xdist workers at once, each of which
imports every test file, and torch's default of a thread a core has
each worker's CPU kernels contend with the other workers' for the
same cores (and torch's CPU searchsorted wakes its pool for a few
hundred elements, tens of ms a call)."""

import numpy as np
import pyarrow as pa
import pyarrow.types as pat
import torch

torch.set_num_threads(1)


def assert_arrow_equal(a, b):
    """Same names, types, nulls and values; NaN equals NaN."""
    assert a.schema.names == b.schema.names, (a.schema, b.schema)
    assert a.num_rows == b.num_rows
    for name, ca, cb in zip(a.schema.names, a.columns, b.columns):
        if isinstance(ca, pa.ChunkedArray):
            ca = ca.combine_chunks()
        if isinstance(cb, pa.ChunkedArray):
            cb = cb.combine_chunks()
        assert ca.type == cb.type, (name, ca.type, cb.type)
        np.testing.assert_array_equal(
            np.asarray(ca.is_null()), np.asarray(cb.is_null()), err_msg=name)
        if pat.is_floating(ca.type):
            np.testing.assert_array_equal(
                ca.fill_null(0).to_numpy(), cb.fill_null(0).to_numpy(),
                err_msg=name)
        else:
            assert ca.equals(cb), name


def jax_schema(schema):
    """The blaze_tpu Schema of a blaze_tpu_torch Schema."""
    from blaze_tpu.types import DataType, Field, Schema, TypeId

    return Schema([
        Field(f.name, DataType(TypeId(f.dtype.id.value), f.dtype.precision,
                               f.dtype.scale), f.nullable)
        for f in schema
    ])


def jax_batch(schema, values, validity, selection, num_rows):
    """A blaze_tpu ColumnBatch over the same padded numpy buffers that
    blaze_tpu_torch.interop.batch_from_numpy takes. `schema` is a
    blaze_tpu_torch Schema."""
    import jax.numpy as jnp

    from blaze_tpu.batch import Column, ColumnBatch

    js = jax_schema(schema)
    cols = [
        Column(f.dtype, jnp.asarray(v),
               None if m is None else jnp.asarray(m))
        for f, v, m in zip(js, values, validity)
    ]
    sel = None if selection is None else jnp.asarray(selection)
    return ColumnBatch(js, cols, num_rows, sel)


def computed_once(tmp_path_factory, name, compute):
    """`compute()`, run once per test session and shared by the xdist
    workers: the first worker to ask computes it under an exclusive
    lock and pickles it under the session's shared temporary root; the
    others wait for the lock and read it. For JAX references whose
    compile costs seconds, which every worker would otherwise repeat.
    Without xdist it is simply computed."""
    import os

    if not os.environ.get("PYTEST_XDIST_WORKER"):
        return compute()
    return _shared(tmp_path_factory, name, compute, block=True)[1]


def _shared(tmp_path_factory, name, compute, block):
    """(True, value) of computed_once; (False, None) at once when
    `block` is false and another worker holds the lock."""
    import fcntl
    import pickle

    root = tmp_path_factory.getbasetemp().parent
    path = root / f"computed-once-{name}.pkl"
    with open(root / f"computed-once-{name}.lock", "w") as lock:
        try:
            fcntl.flock(lock, fcntl.LOCK_EX | (0 if block else
                                               fcntl.LOCK_NB))
        except BlockingIOError:
            return False, None
        if path.is_file():
            return True, pickle.loads(path.read_bytes())
        value = compute()
        tmp = path.with_suffix(".tmp")
        tmp.write_bytes(pickle.dumps(value))
        tmp.replace(path)
        return True, value


def computed_in_parts(tmp_path_factory, name, computes):
    """[compute() for compute in computes], each part computed once per
    test session like computed_once; a worker first takes every part no
    other worker is computing, then waits for the rest, so workers that
    ask at the same moment compute the parts side by side instead of
    waiting on one worker for all of them."""
    import os

    if not os.environ.get("PYTEST_XDIST_WORKER"):
        return [compute() for compute in computes]
    out = [_shared(tmp_path_factory, f"{name}-{i}", c, block=False)
           for i, c in enumerate(computes)]
    return [v if done else computed_once(tmp_path_factory, f"{name}-{i}",
                                         computes[i])
            for i, (done, v) in enumerate(out)]


def built_once(tmp_path_factory, name, build):
    """Path of a binary that `build(out_path)` compiles, built once per
    test session and shared by the xdist workers (under an exclusive
    lock in the session's shared temporary root)."""
    import fcntl
    import os

    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    out = root / f"built-once-{name}"
    with open(root / f"built-once-{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not out.exists():
            tmp = root / f"built-once-{name}.tmp"
            build(str(tmp))
            tmp.replace(out)
    return str(out)
