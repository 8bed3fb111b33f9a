"""Seeded random plans through both packages' planners, on the CPU: the
twin of tests/test_plan_differential_random.py. 22 cases, each held
against the JAX package on the same inputs: 12 random
filter/project/aggregate-or-top-k PlanSpecs, each built once with each
package's spec classes and converted by its `convert_plan`, where the
port's native result, the port's pandas host engine and the JAX
package's converted result agree (the JAX package's conversion of a
top-k SortSpec falls back to its host engine); 4 random sort-merge join
+ aggregate plans, one for each join type, run plain and through
`insert_exchanges` (real shuffle files) in the port, equal to each
other and to the JAX package's plain run; 6 random windows, plain and
through the exchange the distribution rule plants, equal to the JAX
package's. Integer and count columns are equal, float columns within
1e-9 relative (the reference test's tolerance)."""

import types

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest

from blaze_tpu_torch.ops.base import ExecContext
from blaze_tpu_torch.runtime.executor import run_plan


def package(jax: bool) -> types.SimpleNamespace:
    if jax:
        import blaze_tpu.ops as ops
        import blaze_tpu.planner as planner
        from blaze_tpu.batch import ColumnBatch
        from blaze_tpu.exprs import ir
        from blaze_tpu.ops.joins import JoinType
        from blaze_tpu.ops.sort import SortKey
        from blaze_tpu.ops.window import WindowExec, WindowFn
        from blaze_tpu.planner.distribute import insert_exchanges
        from blaze_tpu.planner.host_engine import execute_host
        from blaze_tpu.runtime.executor import run_plan as run

        def batch(rb):
            return ColumnBatch.from_arrow(rb)
    else:
        import blaze_tpu_torch.ops as ops
        import blaze_tpu_torch.planner as planner
        from blaze_tpu_torch.batch import ColumnBatch
        from blaze_tpu_torch.exprs import ir
        from blaze_tpu_torch.ops.joins import JoinType
        from blaze_tpu_torch.ops.sort import SortKey
        from blaze_tpu_torch.ops.window import WindowExec, WindowFn
        from blaze_tpu_torch.planner.distribute import insert_exchanges
        from blaze_tpu_torch.planner.host_engine import execute_host

        def run(op):
            return run_plan(op, ExecContext(device="cpu"))

        def batch(rb):
            return ColumnBatch.from_arrow(rb, device="cpu")
    return types.SimpleNamespace(
        ops=ops, planner=planner, ir=ir, JoinType=JoinType, SortKey=SortKey,
        WindowExec=WindowExec, WindowFn=WindowFn, run=run, batch=batch,
        insert_exchanges=insert_exchanges, execute_host=execute_host)


def _assert_frames(a, b, sort_cols, what):
    if sort_cols:
        a = a.sort_values(sort_cols).reset_index(drop=True)
        b = b.sort_values(sort_cols).reset_index(drop=True)
    assert list(a.columns) == list(b.columns), what
    assert len(a) == len(b), what
    for c in a.columns:
        x, y = a[c].to_numpy(), b[c].to_numpy()
        if x.dtype.kind == "f" or y.dtype.kind == "f":
            np.testing.assert_allclose(x.astype(float), y.astype(float),
                                       rtol=1e-9, err_msg=f"{what} {c}")
        else:
            np.testing.assert_array_equal(x, y, err_msg=f"{what} {c}")


# ---------------------------------------------------------------------------
# random filter / project / aggregate or top-k PlanSpecs
# ---------------------------------------------------------------------------

def rand_df(rng, n=400):
    return pd.DataFrame({
        "k": rng.integers(0, 8, n),
        "a": rng.integers(-30, 30, n),
        "b": np.round(rng.standard_normal(n) * 10, 3),
    })


def rand_plan(P, seed):
    """The same random spec in package P for one seed."""
    S, ir = P.planner, P.ir
    rng = np.random.default_rng(1000 + seed)
    df = rand_df(rng)
    node = S.MemorySpec(dataframe=df, partitions=1)
    node = S.FilterSpec(children=[node],
                        predicate=ir.Col("a") > int(rng.integers(-20, 20)))
    node = S.ProjectSpec(children=[node], exprs=[
        (ir.Col("k"), "k"),
        (ir.Col("a") * 2 + int(rng.integers(0, 5)), "a2"),
        (ir.Col("b"), "b")])
    if rng.integers(0, 2) == 0:
        return S.AggSpec(children=[node], keys=[(ir.Col("k"), "k")], aggs=[
            (ir.AggExpr(ir.AggFn.SUM, ir.Col("a2")), "s"),
            (ir.AggExpr(ir.AggFn.COUNT_STAR, None), "n"),
            (ir.AggExpr(ir.AggFn.MAX, ir.Col("b")), "mx")],
            mode="complete"), ["k"]
    return S.SortSpec(children=[node],
                      keys=[(ir.Col("a2"), True, True),
                            (ir.Col("b"), True, True)], fetch=50), None


@pytest.mark.parametrize("seed", range(12))
def test_random_plans_match_jax_and_host(seed):
    port, jax = package(False), package(True)
    spec, sort_cols = rand_plan(port, seed)
    native = port.run(port.planner.convert_plan(spec)).to_pandas()
    host = port.execute_host(spec)
    jspec, _ = rand_plan(jax, seed)
    jnative = jax.run(jax.planner.convert_plan(jspec)).to_pandas()
    _assert_frames(native, host, sort_cols, f"seed={seed} host")
    _assert_frames(native, jnative, sort_cols, f"seed={seed} jax")


# ---------------------------------------------------------------------------
# random joins and windows through exchanges
# ---------------------------------------------------------------------------

def _scan(P, frames):
    parts = [[P.batch(pa.RecordBatch.from_pandas(
        f.reset_index(drop=True), preserve_index=False))] for f in frames]
    return P.ops.MemoryScanExec(parts, parts[0][0].schema)


def _join_agg(P, seed):
    rng = np.random.default_rng(2000 + seed)
    n_l, n_r = int(rng.integers(200, 800)), int(rng.integers(300, 1200))
    left = pd.DataFrame({"lk": rng.integers(0, 40, n_l),
                         "lv": np.round(rng.standard_normal(n_l) * 5, 3)})
    right = pd.DataFrame({"rk": rng.integers(0, 40, n_r),
                          "rv": rng.integers(-100, 100, n_r)})
    jt = [P.JoinType.INNER, P.JoinType.LEFT, P.JoinType.LEFT_SEMI,
          P.JoinType.LEFT_ANTI][seed % 4]
    ir = P.ir
    aggs = [(ir.AggExpr(ir.AggFn.SUM, ir.Col("lv")), "s"),
            (ir.AggExpr(ir.AggFn.COUNT_STAR, None), "n")]
    if jt not in (P.JoinType.LEFT_SEMI, P.JoinType.LEFT_ANTI):
        aggs.append((ir.AggExpr(ir.AggFn.MIN, ir.Col("rv")), "mn"))
    join = P.ops.SortMergeJoinExec(_scan(P, [left]), _scan(P, [right]),
                                   ["lk"], ["rk"], jt)
    return P.ops.HashAggregateExec(join, keys=[(ir.Col("lk"), "lk")],
                                   aggs=aggs, mode=P.ops.AggMode.COMPLETE), \
        int(rng.integers(2, 6))


@pytest.mark.parametrize("seed", range(4))
def test_random_join_agg_through_exchanges(seed, tmp_path):
    port, jax = package(False), package(True)
    plan, n_parts = _join_agg(port, seed)
    plain = port.run(plan).to_pandas()
    exchanged_plan = port.insert_exchanges(_join_agg(port, seed)[0], n_parts,
                                           shuffle_dir=str(tmp_path))
    exchanged = port.run(exchanged_plan).to_pandas()
    jplain = jax.run(_join_agg(jax, seed)[0]).to_pandas()
    _assert_frames(plain, exchanged, ["lk"], f"seed={seed} exchanged")
    _assert_frames(plain, jplain, ["lk"], f"seed={seed} jax")


def _window(P, seed, parts):
    rng = np.random.default_rng(3000 + seed)
    n = int(rng.integers(300, 1200))
    df = pd.DataFrame({
        "p": rng.integers(0, 12, n).astype(np.int64),
        # a unique order key: rank and row_number are deterministic
        "o": rng.permutation(n).astype(np.int64),
        "v": rng.integers(-50, 50, n).astype(np.int64)})
    bounds = np.linspace(0, n, parts + 1, dtype=int)
    scan = _scan(P, [df.iloc[bounds[i]:bounds[i + 1]]
                     for i in range(parts)])
    ir = P.ir
    return P.WindowExec(
        scan, partition_by=[ir.Col("p")],
        order_by=[P.SortKey(ir.Col("o"), seed % 2 == 0, True)],
        functions=[P.WindowFn("row_number", None, "rn"),
                   P.WindowFn("sum", ir.Col("v"), "run",
                              frame=("rows", None, 0))]), n


@pytest.mark.parametrize("seed", range(6))
def test_random_window_through_exchanges(seed, tmp_path):
    port, jax = package(False), package(True)
    plan, n = _window(port, seed, 1)
    plain = port.run(plan).to_pandas()
    ex_plan = port.insert_exchanges(_window(port, seed, 3)[0], 4,
                                    shuffle_dir=str(tmp_path))
    exchanged = port.run(ex_plan).to_pandas()
    jplain = jax.run(_window(jax, seed, 1)[0]).to_pandas()
    assert len(plain) == n
    _assert_frames(plain, exchanged, ["p", "o"], f"seed={seed} exchanged")
    _assert_frames(plain, jplain, ["p", "o"], f"seed={seed} jax")
