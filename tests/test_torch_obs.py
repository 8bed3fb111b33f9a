"""The port's observability tier (blaze_tpu_torch/obs and
runtime/instrument.py), on the CPU.

The JAX package's tests of it (tests/test_obs.py, tests/test_phases.py,
tests/test_contention.py) run against the port as source-rewritten
twins (tests/torch_service_support.twin), without the cluster's worker
spans, the router and the `regress` and `profile` CLIs, which come with
the second half of ROADMAP item 8. Then the differential against the
JAX package on the same TaskDefinition bytes: the metric families of
the exposition (less the mesh's) and the phase keys of a traced q6's
rollup. And the port's own: the exposition carries its dispatch kinds,
a tracing-on run makes no more device work or readbacks than a
tracing-off one, and the metric tree leaves the fused operators' types
alone.
"""

import pytest

import torch_service_support as S

_OBS = S.twin("test_obs", extra=[
    # the port's dispatch kind of a fused batch on the CPU
    ('dispatch.record("dispatches", 0)',
     'dispatch.record("graph_eager_batches", 0)'),
    ('kind="dispatches"', 'kind="graph_eager_batches"'),
])
_PHASES = S.twin("test_phases")
_CONTENTION = S.twin("test_contention")

S.pick(globals(), _OBS, [
    "two_part_plan",
    "test_span_tree_nests_and_exports_valid_chrome_trace",
    "test_span_exit_tags_error_class",
    "test_chrome_validator_rejects_malformed",
    "test_span_cap_degrades_to_null_spans",
    "test_attach_subtree_stitches_remote_spans",
    "test_metrics_registry_prometheus_exposition",
    "test_two_live_services_render_distinct_series",
    "test_global_registry_folds_dispatch_counters",
    "test_runtime_history_estimates_and_bounds",
    "test_trace_chaos_retried_query_exports_valid_perfetto_json",
    "test_trace_parquet_decode_fault_lands_on_its_span",
    "test_trace_off_records_nothing",
    "test_predicted_unmeetable_shed",
    "test_predicted_shed_skipped_when_cache_covers",
    "test_queued_deadline_timeout_snapshots_error",
    "test_runtime_history_records_service_executions",
    "test_stats_structured_payload",
    "test_slow_query_log_emits_one_json_line",
    "test_slow_query_log_flags_retries_and_threshold_off",
    "test_wire_metrics_verb_and_trace_report",
    "test_wire_report_raw_span_dicts_flag",
])
S.pick(globals(), _PHASES, [
    "agg_blob",
    "test_rollup_percentiles_and_aggregate_class",
    "test_rollup_bounded_rings_and_class_lru",
    "test_rollup_negative_and_unknown_phase_dropped",
    "test_class_key_digests_not_prefixes",
    "test_fold_span_dicts_sums_per_phase",
    "test_compare_flags_creep_beyond_band_only",
    "test_compare_min_samples_and_missing_cells",
    "test_compare_per_phase_band_overrides",
    "test_terminal_hook_folds_phases_into_global_rollup",
    "test_obs_off_service_still_folds_lifecycle_phases",
    "test_regress_detects_stalled_decode_under_flat_e2e",
    "test_probe_service_stays_out_of_global_rollup",
    "test_stream_phase_folds_on_wire_fetch",
    "test_compare_router_stream_phases_get_widened_default_bands",
    "test_phase_totals_matches_fold_span_dicts",
])
S.pick(globals(), _CONTENTION, [
    "test_timedlock_records_wait_and_hold_under_contention",
    "test_timedrlock_reentrant_is_one_boundary",
    "test_off_mode_records_nothing",
    "test_condition_over_timedlock_accounts_cv_waits",
    "test_enable_is_refcounted",
    "test_lock_name_overflow_folds_bounded",
    "test_top_locks_orders_by_wait",
    "test_lock_histograms_reach_metrics_exposition",
    "test_sampler_start_stop_hygiene",
    "test_sampler_bounds_distinct_stacks",
    "test_collapsed_export_is_flamegraph_valid",
    "test_role_tagging",
    "test_profile_verb_roundtrip_service_tier",
    "test_profile_verb_repeated_start_balances",
])
# the contention file's fixture shares a name with the zerocopy twin's
dataset = _CONTENTION.dataset


@pytest.fixture(autouse=True)
def _port_env():
    yield from S.port_env()


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    return S.scenarios(tmp_path_factory)


def test_metric_families_equal_jax(both):
    port, jax = both
    assert port["families"] == jax["families"]
    assert "blaze_dispatch_total" in port["families"]


def test_phase_keys_equal_jax(both):
    port, jax = both
    assert port["phases"] == jax["phases"]
    assert {"queue_wait", "plan_decode", "arrow_decode", "dispatch",
            "execute", "e2e"} <= set(port["phases"])


def _q6(tmp_path):
    return S.tasks(S.write_sales(tmp_path / "s.parquet", rows=3000),
                   S.write_items(tmp_path / "i.parquet", n=64))["q6"]


def test_exposition_carries_the_port_dispatch_kinds(tmp_path):
    from blaze_tpu_torch.obs.metrics import REGISTRY
    from blaze_tpu_torch.runtime import dispatch
    from blaze_tpu_torch.service import QueryService

    dispatch.record("graph_replays", 0)
    dispatch.record("h2d_copies", 0)
    with QueryService(device="cpu") as svc:
        svc.result(svc.submit_task(_q6(tmp_path)).query_id, 60)
        text = REGISTRY.render_prometheus()
    for kind in ("graph_replays", "h2d_copies", "graph_eager_batches"):
        assert f'blaze_dispatch_total{{kind="{kind}"}}' in text, kind
    assert "blaze_result_cache_events_total" in text


def test_tracing_adds_no_device_work(tmp_path):
    """The same task with tracing on and off: equal dispatch counters,
    readbacks included (no span syncs or reads a tensor back)."""
    from blaze_tpu_torch.service import QueryService

    blob = _q6(tmp_path)
    counts = []
    for trace in (False, True):
        with QueryService(device="cpu", enable_cache=False,
                          enable_trace=trace) as svc:
            q = svc.submit_task(blob)
            svc.result(q.query_id, 60)
            counts.append({k: v for k, v in q.ctx.metrics.counters.items()
                           if k.startswith("dispatch.")})
            assert (q.tracer is not None) is trace
    assert counts[0] == counts[1]


def test_instrument_keeps_operator_types(tmp_path):
    """The metric tree wraps each node's stream in place: the fused
    aggregate still sees its HashJoinExec child (the folded join)."""
    from blaze_tpu_torch.ops import ExecContext
    from blaze_tpu_torch.ops.base import MetricNode
    from blaze_tpu_torch.ops.joins import HashJoinExec
    from blaze_tpu_torch.plan.serde import task_from_proto
    from blaze_tpu_torch.runtime.executor import (
        execute_partition,
        prepare_decoded_task,
    )
    from blaze_tpu_torch.runtime.instrument import (
        instrument,
        render_metrics,
    )

    blob = S.tasks(S.write_sales(tmp_path / "s.parquet", rows=3000),
                   S.write_items(tmp_path / "i.parquet", n=4096))[
        "join_agg"]
    ctx = ExecContext(device="cpu")
    op, part = prepare_decoded_task(task_from_proto(blob), ctx)
    root = MetricNode("root")
    assert instrument(op, root) is op
    assert instrument(op, root) is op  # once only
    fused = op.children[0]
    assert isinstance(fused.children[0], HashJoinExec)
    rows = sum(rb.num_rows for rb in execute_partition(op, part, ctx))
    assert rows == 16
    text = render_metrics(root)
    assert "HashJoinExec" in text and "rows=16" in text
