"""TPC-DS queries through the port's exchange tier on the CPU: a sample
of tests/test_tpcds_exchange.py's EXCHANGE_QUERIES, each plan lowered by
the port's `insert_exchanges` (co-partitioned hash exchanges under
sort-merge joins, broadcast exchanges under hash joins, PARTIAL ->
exchange -> FINAL aggregates, hash exchanges on window partitions,
single partitions under global sorts), run through the port's
`run_plan` and held against the pandas oracles of
tests/test_tpcds_queries.py (`assert_frames_match`); q67 and q86 by
the reference's rank-tolerant comparisons where their float sums rank
differently. Both files are loaded as port copies
(tests/torch_tpcds_support.py); no JAX query runs. One parquet query
runs with the scan hints installed with filters (pruning and pushdown).
The sample holds a broadcast hash join (q42, bhj flavour), sort-merge
joins, shared CTE subtrees (q44, q92, q86, q67), windows (q12, q44, q86,
q67), global sorts (q73, q44) and a keyless aggregate over a single
exchange (q96). All 99 and the six parquet queries run on the card
(chip_smoke.py, tpcds_exchange).

Scale: 20,000 store_sales rows, test_tpcds_exchange.py's default.
"""

import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import torch_tpcds_support

ROWS = 20_000
SAMPLE = [("q3", "smj"), ("q12", "smj"), ("q42", "bhj"), ("q44", "smj"),
          ("q67", "smj"), ("q73", "smj"), ("q86", "smj"), ("q90", "smj"),
          ("q92", "smj"), ("q96", "smj")]
PARQUET_SAMPLE = ["q6"]


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    from blaze_tpu_torch.config import EngineConfig, get_config, set_config
    from blaze_tpu_torch.ops import FileRange, ParquetScanExec

    support, queries = torch_tpcds_support.load(ROWS)
    lists = torch_tpcds_support.exchange_queries()
    old, threads = get_config(), torch.get_num_threads()
    set_config(EngineConfig(
        device="cpu", batch_size=max(ROWS, 1 << 20),
        shape_buckets=(256, 1024, 4096, 16384, 65536, 262144, 1 << 20)))
    torch.set_num_threads(1)
    try:
        tables = support.gen_tables()
        d = tmp_path_factory.mktemp("tpcds_pq")
        pq_scans = {}
        for name, df in tables.items():
            path = str(d / f"{name}.parquet")
            pq.write_table(pa.Table.from_pandas(df, preserve_index=False),
                           path, row_group_size=1 << 16)
            pq_scans[name] = (lambda path=path: ParquetScanExec(
                [[FileRange(path)]]))
        yield (support, queries, lists, tables, support.scans_of(tables),
               pq_scans)
    finally:
        set_config(old)
        torch.set_num_threads(threads)


def _run(env, q, flavor, scans, tmp_path, hints=False):
    from blaze_tpu_torch.planner.colprune import install
    from blaze_tpu_torch.planner.distribute import insert_exchanges
    from blaze_tpu_torch.runtime.executor import run_plan

    support, _, lists = env[:3]
    plan = insert_exchanges(support.QUERIES[q](scans, flavor),
                            lists.N_EXCHANGE_PARTITIONS,
                            shuffle_dir=str(tmp_path))
    if hints:
        install(plan, with_filters=True)
    return plan, run_plan(plan).to_pandas()


def test_sample_is_in_the_exchange_suite(env):
    lists = env[2]
    assert {q for q, _ in SAMPLE} <= set(lists.EXCHANGE_QUERIES)
    assert set(PARQUET_SAMPLE) <= set(lists.PARQUET_QUERIES)
    assert lists.RANK_TOLERANT == {"q67", "q86"}


@pytest.mark.parametrize("q,flavor", SAMPLE,
                         ids=[f"{q}-{f}" for q, f in SAMPLE])
def test_query_through_exchanges(env, q, flavor, tmp_path):
    _, queries, lists, tables, scans, _ = env
    plan, got = _run(env, q, flavor, scans, tmp_path)
    names = set()
    stack = [plan]
    while stack:
        o = stack.pop()
        names.add(type(o).__name__)
        stack.extend(o.children)
    if flavor == "bhj":
        assert "BroadcastExchangeExec" in names
    else:
        assert "ShuffleExchangeExec" in names
    exp = queries.ORACLES[q](tables)
    exp.columns = list(got.columns)
    if q not in lists.RANK_TOLERANT:
        queries.assert_frames_match(got, exp, f"{q}/shuffle")
        return
    tolerant = torch_tpcds_support.rank_tolerant(queries)
    assert len(got) == len(exp)
    if q == "q67":
        tolerant._assert_rank_tolerant_q67(got,
                                           queries.q67_rolled_frame(tables))
    else:
        tolerant._assert_rank_tolerant_q86(got,
                                           queries.q86_rolled_frame(tables))


@pytest.mark.parametrize("q", PARQUET_SAMPLE)
def test_query_through_parquet_hints_and_exchanges(env, q, tmp_path):
    import chip_smoke

    _, queries, _, tables, _, pq_scans = env
    plan, got = _run(env, q, "smj", pq_scans, tmp_path, hints=True)
    reads = chip_smoke.scan_reads(plan)
    assert sum(len(s["decoded"]) for s in reads) < \
        sum(len(s["schema"]) for s in reads)
    assert any(s["pushed"] for s in reads)
    exp = queries.ORACLES[q](tables)
    exp.columns = list(got.columns)
    queries.assert_frames_match(got, exp, f"{q}/parquet-shuffle")
