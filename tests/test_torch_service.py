"""The port's serving tier (blaze_tpu_torch/service), on the CPU.

Three parts:
- the JAX package's own service tests (tests/test_service.py and
  tests/test_service_failures.py), run against the
  port as source-rewritten twins (tests/torch_service_support.twin),
  with the port's config on the CPU;
- the differential: the same TaskDefinition bytes (q6, grouped, an
  INNER join under a keyed aggregate) through both packages'
  QueryService (the JAX side `mesh_mode="off"`, the port's
  `device="cpu"`): equal results, admission order, terminal states
  and error classes;
- the port's own rules: a cache hit does no device work, the host
  degrade happens on the CPU and is reported, stays off on a cuda
  context unless asked, and the mesh and fleet tiers raise naming
  ROADMAP item 7.
"""

import pytest

import torch_service_support as S

_SERVICE = S.twin("test_service")
_FAILURES = S.twin("test_service_failures")

S.pick(globals(), _SERVICE, [
    "parquet_task",
    "test_fingerprint_stable_across_rebuilds",
    "test_fingerprint_distinguishes_plans",
    "test_fingerprint_memory_scan_unstable",
    "test_submit_plan_matches_run_plan",
    "test_priority_then_fifo_admission_order",
    "test_headroom_queueing_not_oom",
    "test_larger_than_budget_query_runs_alone",
    "test_queue_overflow_rejected",
    "test_cancel_queued_and_running",
    "test_deadline_queued_and_running",
    "test_decode_failure_reports_failed",
    "test_illegal_transition_raises",
    "test_repeated_task_hits_cache_zero_dispatches",
    "test_cache_bypass_when_disabled",
    "test_cache_ttl_expiry",
    "test_cache_lru_eviction",
    "test_cache_spill_restore_through_memory_pool",
    "test_cache_invalidate",
    "test_unstable_fingerprint_never_cached",
    "test_estimate_plan_device_bytes",
    "test_coalescing_second_identical_inflight_submit_waits",
])
S.pick(globals(), _FAILURES, [
    "parquet_blob",
    "test_cancel_during_admitted_to_running_window",
    "test_double_cancel_idempotent",
    "test_retry_then_cancel_interleaving",
    "test_cancel_vs_completion_race_clean",
    "test_sweep_propagates_cancel_to_running_query",
    "test_user_cancel_wins_over_concurrent_deadline",
    "test_edf_ordering_within_priority_class",
    "test_unmeetable_deadline_shed_at_admission",
    "test_degraded_query_releases_bytes_unblocks_waiter",
    "test_orphan_sweep_reaps_terminal_never_fetched_queries",
    "test_poll_activity_defers_orphan_sweep",
    "test_fetch_guard_counter_survives_concurrent_fetches",
    "test_result_cache_refuses_partial_entries",
    "test_cache_probe_mid_stream_misses_then_hits",
    # the wire half
    "test_client_disconnect_during_fetch_of_cached_result",
    "test_server_drop_midstream_reconnect_refetch",
    "test_poll_survives_connection_drop",
    "test_error_class_and_attempts_on_the_wire",
    "test_fetch_of_reaped_query_is_classified_not_found",
    "test_tenant_budget_rejection_classified_on_wire",
    "test_tenant_budget_retry_honors_backoff_budget",
])


@pytest.fixture(autouse=True)
def _port_env():
    yield from S.port_env()


# ---------------------------------------------------------------------------
# the differential
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def both(tmp_path_factory):
    return S.scenarios(tmp_path_factory)


@pytest.mark.parametrize("task", ["q6", "grouped", "join_agg",
                                  "grouped_edf"])
def test_results_equal_jax(both, task):
    port, jax = both
    S.assert_results_equal(port["results"][task], jax["results"][task])


def test_admission_order_equals_jax(both):
    port, jax = both
    # priority first, then earliest deadline, then FIFO
    assert port["order"] == ["blocker", "grouped", "grouped_edf",
                             "join_agg", "q6"]
    assert port["order"] == jax["order"]


def test_terminal_states_and_classes_equal_jax(both):
    port, jax = both
    assert port["outcomes"] == jax["outcomes"]
    assert port["outcomes"]["invalid_plan"] == ("FAILED", "PLAN_INVALID")
    assert port["outcomes"]["overload"][0] == "REJECTED_OVERLOADED"


# ---------------------------------------------------------------------------
# the port's own rules
# ---------------------------------------------------------------------------

def test_cache_hit_does_no_device_work(parquet_task):
    from blaze_tpu_torch.service import QueryService

    _, blob = parquet_task()
    with QueryService(max_concurrency=1, device="cpu") as svc:
        q1 = svc.submit_task(blob)
        svc.result(q1.query_id, timeout=60)
        assert q1.status()["dispatches"] > 0
        q2 = svc.submit_task(blob)
        svc.result(q2.query_id, timeout=60)
        st = q2.status()
    assert st["cache_hits"] == 1
    for k in ("dispatches", "graph_replays", "launches", "h2d_copies",
              "d2h_syncs"):
        assert st[k] == 0, (k, st)


def _q6_blob(tmp_path):
    return S.tasks(S.write_sales(tmp_path / "s.parquet", rows=3000),
                   S.write_items(tmp_path / "i.parquet", n=64))["q6"]


def test_degrade_on_cpu_is_reported(tmp_path):
    """RESOURCE_EXHAUSTED on the CPU re-runs the partition on the host
    engine and says so: q.degraded, degraded_queries and
    blaze_degraded_queries_total."""
    from blaze_tpu_torch.obs.metrics import REGISTRY
    from blaze_tpu_torch.service import QueryService
    from blaze_tpu_torch.testing import chaos

    blob = _q6_blob(tmp_path)
    with QueryService(max_concurrency=1, enable_cache=False,
                      device="cpu") as svc:
        ref = S.canonical(svc.result(svc.submit_task(blob).query_id, 60))
        before = REGISTRY.get("blaze_degraded_queries_total")
        with chaos.active([chaos.Fault(site="task.execute",
                                       klass="RESOURCE_EXHAUSTED")]):
            q = svc.submit_task(blob)
            got = S.canonical(svc.result(q.query_id, 60))
        assert q.degraded and q.status()["degraded"]
        assert svc.stats()["queries"]["degraded_queries"] == 1
        assert REGISTRY.get("blaze_degraded_queries_total") == before + 1
    # the host engine (pandas, planner/host_engine.py as in the JAX
    # package) sums the float32 products in its own order and width
    assert got.column("n").equals(ref.column("n"))
    assert got.column("t").to_numpy() == pytest.approx(
        ref.column("t").to_numpy(), rel=1e-6)


@pytest.mark.parametrize("asked", [None, True])
def test_no_degrade_on_cuda_unless_asked(tmp_path, monkeypatch, asked):
    """On a cuda context the degrade is off by default: the query fails
    with its class. degrade_to_host=True turns it on. (require_device
    is stubbed: the injected fault fires before any device work.)"""
    from blaze_tpu_torch.runtime import executor
    from blaze_tpu_torch.service import QueryService, QueryState
    from blaze_tpu_torch.testing import chaos

    monkeypatch.setattr(executor, "require_device", lambda device: None)
    blob = _q6_blob(tmp_path)
    with QueryService(max_concurrency=1, enable_cache=False,
                      device="cuda", degrade_to_host=asked) as svc:
        assert svc.degrade_to_host is bool(asked)
        with chaos.active([chaos.Fault(site="task.execute",
                                       klass="RESOURCE_EXHAUSTED")]):
            q = svc.submit_task(blob)
            assert q.wait(60)
        degraded = svc.stats()["queries"]["degraded_queries"]
    if asked:
        assert q.state is QueryState.DONE and q.degraded and degraded == 1
    else:
        assert q.state is QueryState.FAILED
        assert q.error_class == "RESOURCE_EXHAUSTED"
        assert not q.degraded and degraded == 0


@pytest.mark.parametrize("kw", [{"mesh_mode": "on"},
                                {"fleet_peers": ["127.0.0.1:1"]}])
def test_mesh_and_fleet_name_item_7(kw):
    from blaze_tpu_torch.service import QueryService

    with pytest.raises(NotImplementedError, match="item 7"):
        QueryService(device="cpu", **kw)


@pytest.mark.parametrize("mode", ["auto", "off"])
def test_mesh_auto_and_off_run_on_one_device(tmp_path, mode):
    from blaze_tpu_torch.service import QueryService

    blob = _q6_blob(tmp_path)
    with QueryService(device="cpu", mesh_mode=mode) as svc:
        out = svc.result(svc.submit_task(blob).query_id, 60)
        assert svc.stats()["meshprof"] == {}
    assert out[0].num_rows == 1


def test_graph_cache_counts_lent_graphs():
    """Every acquire is given back by its borrower's `finally`; a
    graph built for a key is lent too."""
    from blaze_tpu_torch.runtime.dispatch import Graph, GraphCache

    cache = GraphCache(max_keys=2)
    g1 = cache.acquire(("fagg", 1), lambda: Graph(None, []))
    assert g1.kind == "fagg" and cache.lent() == 1
    g2 = cache.acquire(("carry", 2), lambda: Graph(None, []))
    assert cache.lent() == 2
    cache.release(("fagg", 1), g1)
    assert cache.acquire(("fagg", 1), lambda: None) is g1
    cache.release(("fagg", 1), g1)
    cache.release(("carry", 2), g2)
    assert cache.lent() == 0


def test_cancelled_queries_leave_no_graph_lent(tmp_path):
    from blaze_tpu_torch.runtime import dispatch
    from blaze_tpu_torch.service import QueryService

    blob = _q6_blob(tmp_path)
    start = dispatch.GRAPHS.lent()
    with QueryService(max_concurrency=1, enable_cache=False,
                      device="cpu") as svc:
        qs = [svc.submit_task(blob) for _ in range(4)]
        for q in qs[1:]:
            svc.cancel(q.query_id)
        for q in qs:
            assert q.wait(60)
    assert dispatch.GRAPHS.lent() == start
