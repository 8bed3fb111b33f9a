"""The port's zero-copy serve path (blaze_tpu_torch/zerocopy: the
decoded-plan cache and the shared-memory Arrow arena, with
runtime/transport.sendmsg_all), on the CPU.

The JAX package's tests (tests/test_zerocopy.py, less the router's)
run against the port as source-rewritten twins
(tests/torch_service_support.twin); its scatter-gather byte-identity
test runs on the threaded wire, the port's one plane. Then the plan
digest against the JAX package's, and `sendmsg_all` itself.
"""

import socket

import pytest

import torch_service_support as S

_ZC = S.twin("test_zerocopy")

S.pick(globals(), _ZC, [
    "dataset",
    "test_plan_cache_lru_eviction_and_counters",
    "test_plan_entry_tree_loan_is_exclusive",
    "test_plan_cache_put_first_writer_wins",
    "test_arena_publish_buffers_roundtrip",
    "test_arena_lru_eviction_spares_leased_segments",
    "test_arena_orphaned_lease_is_ttl_reaped",
    "test_map_handle_frames_roundtrip_and_stale_lease",
    "test_arena_close_removes_segment_files",
    "test_plan_cache_hit_zero_plan_decode_spans",
    "test_plan_cache_repeat_executes_correctly_without_result_cache",
    "test_handle_fetch_batches_identical_to_socket",
    "test_handle_fetch_resumes_mid_stream",
    "test_client_map_failure_falls_back_to_byte_refetch",
    "test_queued_fleet_still_serves_cached_repeat",
    "test_fast_path_skipped_when_cache_cannot_cover",
    "test_chaos_map_fault_degrades_publish_to_byte_path",
    "test_chaos_lease_fault_degrades_handle_to_sg_bytes",
    "test_parquet_mmap_falls_back_under_chaos",
    "test_stats_and_metrics_carry_zerocopy_counters",
    "test_plan_decode_phase_rolls_up_split_from_arrow_decode",
])


@pytest.fixture(autouse=True)
def _port_env():
    yield from S.port_env()


def test_sg_fetch_byte_identical_to_socket_fetch(dataset):
    """The JAX package's test on the threaded wire (its async plane
    waits for the event-loop wire)."""
    _ZC.test_sg_fetch_byte_identical_to_socket_fetch(dataset, "threaded")


def test_plan_digest_equals_jax():
    """One digest for one blob in both packages: the JAX package's
    router places by it, and the port's plan cache keys on it."""
    from blaze_tpu.zerocopy.plan_cache import plan_digest as jax_digest
    from blaze_tpu_torch.zerocopy import plan_digest

    for blob in (b"", b"\x01\x02task", bytes(range(256)) * 9):
        for is_ref in (False, True):
            assert plan_digest(blob, is_ref) == jax_digest(blob, is_ref)
    assert plan_digest(b"t", False) != plan_digest(b"t", True)


@pytest.mark.parametrize("sizes", [[0, 5, 0, 7], [3] * 600, [1 << 20, 9]])
def test_sendmsg_all_writes_every_buffer(sizes):
    """Partial sends, more buffers than one sendmsg takes, empty
    buffers and memoryviews: the peer reads the concatenation."""
    import threading

    from blaze_tpu_torch.runtime.transport import sendmsg_all

    bufs = [bytes([i % 251]) * n for i, n in enumerate(sizes)]
    bufs = [memoryview(b) if i % 2 else b for i, b in enumerate(bufs)]
    a, b = socket.socketpair()
    got = bytearray()

    def read():
        while True:
            chunk = b.recv(1 << 16)
            if not chunk:
                return
            got.extend(chunk)

    t = threading.Thread(target=read)
    t.start()
    try:
        assert sendmsg_all(a, bufs) == sum(sizes)
    finally:
        a.close()
        t.join()
        b.close()
    assert bytes(got) == b"".join(bytes(x) for x in bufs)
