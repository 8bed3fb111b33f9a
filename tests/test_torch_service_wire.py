"""The port's service wire (blaze_tpu_torch/service/wire.py) behind the
gateway's header bit 61, on the CPU.

The JAX package's wire tests (tests/test_service_gateway.py and
tests/test_stream.py without the router; the wire half of
tests/test_service_failures.py runs in test_torch_service.py, beside
its fixture) run against the port as source-rewritten twins
(tests/torch_service_support.twin) with the port's config on the CPU;
the `serve` CLI twin is given `--device cpu`. Then the port's own: every
verb over one connection, the three refused paths (MEMBER answers that
the endpoint is not a router, MESH_EXCHANGE names ROADMAP item 7, the
event-loop wire names the second half of item 8), legacy one-shot tasks
on a listener with a service, and the CLI commands that wait for later
items.
"""

import json
import struct
import time

import pytest

import torch_service_support as S

_GATEWAY = S.twin("test_service_gateway", extra=[
    ('"serve", "--port", "0",', '"serve", "--device", "cpu", "--port", "0",'),
])
_STREAM = S.twin("test_stream")

S.pick(globals(), _GATEWAY, [
    "dataset",
    "test_wire_roundtrip_matches_inprocess",
    "test_wire_repeat_hits_cache_zero_dispatches",
    "test_concurrent_mixed_priority_load",
    "test_wire_cancel_and_fetch_error_frame",
    "test_wire_deadline_times_out_queued",
    "test_wire_session_disconnect_cancels_pending",
    "test_serve_cli_repeat_query_hits_cache",
])
S.pick(globals(), _STREAM, [
    "parquet_blob",
    "test_ring_fills_while_running_without_consumer",
    "test_backpressure_pins_high_water_at_cap",
    "test_stalled_consumer_aborts_stream_stalled",
    "test_rollback_preserves_delivered_prefix_and_replay_verifies",
    "test_fetch_delivers_first_part_while_running",
    "test_double_fetch_of_live_stream_byte_identical",
    "test_attached_disconnect_mid_stream_cancels_and_frees",
    "test_orphan_reap_with_partially_delivered_stream",
    "test_drain_waits_for_open_stream",
    "test_stream_consume_drop_resumes_byte_identical",
    "test_stream_consume_stall_slows_but_completes",
])


@pytest.fixture(autouse=True)
def _port_env():
    yield from S.port_env()


@pytest.fixture
def served(tmp_path):
    """(service, gateway, q6 blob): a CPU service, with the serve CLI's
    plan cache and an arena, behind a threaded gateway listener."""
    from blaze_tpu_torch.runtime.gateway import TaskGatewayServer
    from blaze_tpu_torch.service import QueryService

    blob = S.tasks(S.write_sales(tmp_path / "s.parquet", rows=3000),
                   S.write_items(tmp_path / "i.parquet", n=64))["q6"]
    with QueryService(max_concurrency=2, device="cpu",
                      arena_bytes=1 << 24) as svc:
        with TaskGatewayServer(service=svc, device="cpu") as srv:
            yield svc, srv, blob


def _await_published(svc, n=1):
    """The arena publishes at a query's terminal hook, which may run
    after its stream has handed the client the last part: wait for it."""
    deadline = time.monotonic() + 30
    while svc.stats()["arena"]["published"] < n:
        assert time.monotonic() < deadline, svc.stats()["arena"]
        time.sleep(0.005)


def _await_done(client, query_id):
    deadline = time.monotonic() + 30
    while client.poll(query_id)["state"] != "DONE":
        assert time.monotonic() < deadline, client.poll(query_id)
        time.sleep(0.005)


def test_every_verb_over_one_connection(served):
    from blaze_tpu_torch.obs.trace import validate_chrome
    from blaze_tpu_torch.service import ServiceClient

    svc, srv, blob = served
    with ServiceClient(*srv.address) as c:
        st = c.submit(blob, priority=3)
        first = c.fetch(st["query_id"])
        poll = c.poll(st["query_id"])
        assert poll["state"] == "DONE" and poll["priority"] == 3
        rep = c.report_full(st["query_id"])
        assert st["query_id"] in rep["report"]
        assert validate_chrome(rep["trace"]) == []
        again = c.run(blob)
        assert [rb.to_pydict() for rb in again] == \
            [rb.to_pydict() for rb in first]
        _await_published(svc)
        stats = c.stats()
        assert stats["cache"]["hits"] == 1
        assert stats["plan_cache"]["hits"] == 1
        assert stats["arena"]["segments"] == 1
        assert stats["meshprof"] == {}
        text = c.metrics()
        assert 'blaze_dispatch_total{kind="graph_eager_batches"}' in text
        assert "blaze_queries_total" in text
        assert c.profile({"op": "snapshot"})["tier"] == "service"
        # CANCEL of a finished query leaves it DONE
        assert c.cancel(st["query_id"])["state"] == "DONE"


def test_arena_fetch_equals_socket_fetch(served):
    from blaze_tpu_torch.service import ServiceClient

    svc, srv, blob = served
    with ServiceClient(*srv.address) as c:
        plain = c.run(blob)
    _await_published(svc)
    with ServiceClient(*srv.address, use_arena=True) as c:
        # the arena serves a finished query: a FETCH that comes while
        # the repeat is still running streams its parts instead
        qid = c.submit(blob)["query_id"]
        _await_done(c, qid)
        mapped = c.fetch(qid)
    arena = svc.stats()["arena"]
    assert arena["handle_hits"] == 1 and arena["active_leases"] == 0
    assert [rb.to_pydict() for rb in mapped] == \
        [rb.to_pydict() for rb in plain]


def test_member_and_mesh_exchange_are_refused_in_band(served):
    from blaze_tpu_torch.service import ServiceClient

    _, srv, _ = served
    with ServiceClient(*srv.address) as c:
        assert "not a router" in c.member({"op": "join"})["error"]
        resp, parts = c.mesh_exchange({"op": "stage"})
    assert "item 7" in resp["error"]
    assert resp["error_class"] == "PLAN_INVALID" and list(parts) == []


def test_fetch_async_names_the_event_loop_slice(served):
    import asyncio

    from blaze_tpu_torch.service.wire import ServiceVerbBackend

    svc, _, _ = served
    with pytest.raises(NotImplementedError, match="wire_async.*item 8"):
        asyncio.run(ServiceVerbBackend(svc).fetch_async(None, "q", 0))


@pytest.mark.parametrize("how", ["arg", "env"])
def test_async_wire_raises(monkeypatch, how):
    from blaze_tpu_torch.runtime.gateway import TaskGatewayServer

    kw = {}
    if how == "arg":
        kw["wire"] = "async"
    else:
        monkeypatch.setenv("BLAZE_WIRE", "async")
    with pytest.raises(NotImplementedError, match="item 8"):
        TaskGatewayServer(device="cpu", **kw)


def test_threaded_is_the_default_wire(monkeypatch):
    from blaze_tpu_torch.runtime.gateway import TaskGatewayServer

    monkeypatch.delenv("BLAZE_WIRE", raising=False)
    srv = TaskGatewayServer(device="cpu")
    try:
        assert srv.wire == "threaded"
    finally:
        srv.stop()


def test_legacy_task_beside_the_service(served):
    """A one-shot task on a listener with a service attached still gets
    its batch stream (header without bit 61)."""
    import socket

    from blaze_tpu_torch.io.ipc import decode_ipc_parts

    svc, srv, blob = served
    with socket.create_connection(srv.address, timeout=30) as s:
        s.sendall(struct.pack("<Q", len(blob)) + blob)
        data = b""
        while True:
            chunk = s.recv(1 << 16)
            if not chunk:
                break
            data += chunk
            if data.endswith(struct.pack("<Q", 0)):
                break
    rows = list(decode_ipc_parts(data))
    assert len(rows) == 1 and rows[0].column("n")[0].as_py() > 0
    assert svc.stats()["queries"]["live"] == 0


def test_cli_commands_of_later_items_exit_2(capsys):
    from blaze_tpu_torch.__main__ import main

    for cmd, item in (("route", "item 8"), ("profile", "item 8"),
                      ("regress", "item 8"), ("mesh-dryrun", "item 7"),
                      ("mesh-attr", "item 7")):
        assert main([cmd, "--port", "1"]) == 2
        assert item in capsys.readouterr().err
    for argv, item in ((["serve", "--device", "cpu", "--mesh"], "item 7"),
                       (["serve", "--device", "cpu", "--port", "0",
                         "--wire", "async"], "item 8"),
                       (["serve", "--device", "cpu",
                         "--router", "h:1"], "item 8")):
        assert main(argv) == 2
        assert item in capsys.readouterr().err


@pytest.mark.parametrize("flag", ["--fleet-peer", "--fleet-router",
                                  "--fleet-devices", "--advertise"])
def test_serve_fleet_flags_exit_2(flag, capsys):
    """A fleet peer names item 7; the flags that only act with a fleet
    or a router are not taken at all."""
    from blaze_tpu_torch.__main__ import main

    argv = ["serve", "--device", "cpu", "--port", "0", flag, "2"]
    if flag == "--fleet-peer":
        assert main(argv) == 2
        assert "item 7" in capsys.readouterr().err
    else:
        with pytest.raises(SystemExit) as e:
            main(argv)
        assert e.value.code == 2
        assert "unrecognized arguments" in capsys.readouterr().err


def test_cli_info_trace_and_metrics(served, tmp_path, capsys):
    from blaze_tpu_torch.__main__ import main
    from blaze_tpu_torch.service import ServiceClient

    _, srv, blob = served
    assert main(["info"]) == 0
    info = json.loads(capsys.readouterr().out)
    assert set(info["kernels_built"]) == {"stats", "compact", "segreduce",
                                          "murmur3"}
    assert "backend" not in info
    with ServiceClient(*srv.address) as c:
        qid = c.submit(blob)["query_id"]
        c.fetch(qid)
    host, port = srv.address
    out = tmp_path / "t.json"
    assert main(["trace", qid, "--host", host, "--port", str(port),
                 "-o", str(out)]) == 0
    names = {e["name"] for e in json.loads(out.read_text())["traceEvents"]}
    assert {"query", "queue_wait", "attempt", "execute_partition",
            "parquet_decode", "kernel_dispatch"} <= names
    capsys.readouterr()
    assert main(["metrics", "--host", host, "--port", str(port)]) == 0
    assert "blaze_dispatch_total" in capsys.readouterr().out
