"""The port's fault injection (blaze_tpu_torch/testing/chaos.py) and its
seams in the executor, scheduler, scan, pack, memory tracker, kernel
wrappers and graph replays, on the CPU.

The JAX package's chaos tests (tests/test_chaos.py) run against the
port as source-rewritten twins (tests/torch_service_support.twin),
without the cluster heartbeat's (the cluster's hooks come with the
second half of ROADMAP item 8) and the scheduler's per-attempt hook.
Then the differential: the chaos seams one traced q6 passes in the
port equal the JAX package's on the same bytes; and the port's H2D
seam, which sits on the copy to the card.
"""

import numpy as np
import pytest

import torch_service_support as S

_CHAOS = S.twin("test_chaos")

S.pick(globals(), _CHAOS, [
    "test_chaos_off_by_default",
    "test_fault_plan_determinism",
    "test_fault_matching_and_times",
    "test_env_plan_round_trip",
    "test_injected_faults_are_classified",
    "test_transient_fault_one_retry_exact_result",
    "test_plan_invalid_fails_first_attempt_zero_retries",
    "test_resource_exhausted_degrades_to_host_engine",
    "test_internal_error_not_retried",
    "test_scheduler_plan_invalid_fails_fast",
    "test_scheduler_resource_exhausted_degrades",
    "test_scheduler_degradation_unavailable_surfaces_original",
    "test_degradation_translates_union_partitions",
    "test_wire_task_degradation_survives_inplace_fusion",
    "test_failed_attempt_output_not_double_counted",
    "test_degradation_refuses_misaligned_partition_index",
    "test_parquet_decode_fault_retried",
    "test_kernel_dispatch_fault_retried",
    "test_device_memory_seam",
    "test_cache_spill_fault_degrades_gracefully",
    "test_battery_shapes_identical_under_transient_chaos",
    "test_fused_relational_byte_equal_and_chaos_parity",
])


@pytest.fixture(autouse=True)
def _port_env():
    yield from S.port_env()


def test_seams_of_a_traced_q6_equal_jax(tmp_path_factory):
    port, jax = S.scenarios(tmp_path_factory)
    assert port["seams"] == jax["seams"]
    assert {"task.execute", "parquet.decode", "kernel.dispatch",
            "service.admit"} <= set(port["seams"])


def test_h2d_transfer_seam():
    """The seam fires on a copy to the card, before any device work (so
    a CPU-only host can inject it); a CPU batch has no transfer and
    passes no seam."""
    import torch

    from blaze_tpu_torch.runtime.pack import put_packed
    from blaze_tpu_torch.testing import chaos

    seg = [(np.arange(8, dtype=np.int64), 0)]
    with chaos.active([chaos.Fault("h2d.transfer", klass="TRANSIENT",
                                   times=0)], seed=7) as plan:
        with pytest.raises(chaos.InjectedTransient):
            put_packed(seg, 8, 16, torch.device("cuda"))
        buf, views = put_packed(seg, 8, 16, torch.device("cpu"))
    assert plan.fired("h2d.transfer") == 1
    assert views[0][:8].tolist() == list(range(8))
