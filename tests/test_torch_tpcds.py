"""The repo's 99 TPC-DS queries through the PyTorch port, on the CPU.

Every query of tests/tpcds_support.py runs in both flavours (broadcast
hash joins and forced sort-merge joins) through the port's `run_plan`
and is compared with the pandas oracle of tests/test_tpcds_queries.py by
that file's `assert_frames_match` (floats within rtol = atol = 1e-6,
everything else equal after canonical row order). Both files are loaded
as port-side copies (tests/torch_tpcds_support.py); no JAX query runs.

Scale: 200,000 store_sales rows, the JAX suite's default; the other
tables scale from it as tests/tpcds_support.py sets them. 13 of the 23
tables hold string columns, on which the queries filter, group, join,
sort and partition windows.
"""

import pytest
import torch

import torch_tpcds_support

SUPPORT, QUERIES_MOD = torch_tpcds_support.load()

#: (query, flavour) -> ROADMAP item that a failing query waits for;
#: each runs as a strict xfail. Empty: every query passes.
XFAIL = {}


def _cases():
    out = []
    for q in torch_tpcds_support.query_order(SUPPORT.QUERIES):
        for flavor in ("bhj", "smj"):
            reason = XFAIL.get((q, flavor))
            marks = () if reason is None else (
                pytest.mark.xfail(strict=True, reason=reason),)
            out.append(pytest.param(q, flavor, marks=marks,
                                    id=f"{q}-{flavor}"))
    return out


@pytest.fixture(scope="module")
def env():
    from blaze_tpu_torch.config import EngineConfig, get_config, set_config

    old, threads = get_config(), torch.get_num_threads()
    n = SUPPORT.N_SALES
    # one batch a table, as the JAX suite's fixture sets it; finer
    # buckets keep the padding small
    set_config(EngineConfig(
        device="cpu", batch_size=max(n, 1 << 20),
        shape_buckets=(256, 1024, 4096, 16384, 65536, 262144, 1 << 20,
                       max(n, 1 << 20))))
    torch.set_num_threads(1)
    try:
        tables = SUPPORT.gen_tables()
        # one pandas oracle a query serves both flavours
        yield tables, SUPPORT.scans_of(tables), {}
    finally:
        set_config(old)
        torch.set_num_threads(threads)


@pytest.mark.parametrize("q,flavor", _cases())
def test_tpcds_query_on_port(env, q, flavor):
    from blaze_tpu_torch.runtime.executor import run_plan

    tables, scans, oracles = env
    got = run_plan(SUPPORT.QUERIES[q](scans, flavor)).to_pandas()
    if q not in oracles:
        oracles[q] = QUERIES_MOD.ORACLES[q](tables)
    exp = oracles[q].copy()
    exp.columns = list(got.columns)  # positional contract
    QUERIES_MOD.assert_frames_match(got, exp, f"{q}/{flavor}")


def test_matrix_covers_the_99_queries():
    assert len(SUPPORT.QUERIES) == 99
    assert set(QUERIES_MOD.ORACLES) == set(SUPPORT.QUERIES)


def test_rank_tolerant_checks_load_without_jax(env):
    """chip_smoke's tpcds99 holds q67 and q86 on the card to the
    reference's rank-tolerant comparisons, loaded from
    tests/test_tpcds_exchange.py by source (no JAX module): each
    accepts its oracle's own frame, and q67's rejects a rank moved
    past what any tie allows."""
    tables, _, _ = env
    tol = torch_tpcds_support.rank_tolerant(QUERIES_MOD)
    rolled = QUERIES_MOD.q67_rolled_frame(tables)
    q67 = QUERIES_MOD.ORACLES["q67"](tables)
    # the check walks the rows it is given: 20 of them suffice here
    tol._assert_rank_tolerant_q67(q67.head(20), rolled)
    q86 = QUERIES_MOD.ORACLES["q86"](tables)
    tol._assert_rank_tolerant_q86(q86.head(20),
                                  QUERIES_MOD.q86_rolled_frame(tables))
    bad = q67.head(3).copy()
    bad.loc[bad.index[0], "rk"] = 100
    with pytest.raises(AssertionError):
        tol._assert_rank_tolerant_q67(bad, rolled)
