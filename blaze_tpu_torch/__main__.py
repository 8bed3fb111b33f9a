"""CLI entry points: `python -m blaze_tpu_torch <command>`.

The JAX package's CLI (blaze_tpu/__main__.py) for the tiers the port
has. Every command that runs a task runs it on `cuda` unless it is
given `--device cpu`; without CUDA it fails rather than run on the CPU
unasked.

  info            the card (name, count), torch and CUDA versions, and
                  whether the hand-written kernels are built
  run-task FILE   execute a serialized TaskDefinition protobuf and print
                  the resulting Arrow batches
  scan FILE       scan a parquet file (projection, limit) and print it
  gateway         the one-shot task gateway (one task per connection)
  serve           the multi-query serving tier: the gateway listener
                  with a QueryService attached (admission, priorities,
                  deadlines, cancellation, the result and decoded-plan
                  caches, the Arrow arena, query tracing)
  trace QUERY_ID  export one query's span tree from a running server as
                  Chrome-trace-event JSON (ui.perfetto.dev)
  metrics         print the server's Prometheus text exposition

`route`, `profile` and `regress` come with the second half of ROADMAP
'Modules to port' item 8, `mesh-dryrun` and `mesh-attr` with item 7:
each exits 2 with a message that says so.
"""

from __future__ import annotations

import argparse
import json
import sys

#: commands of the JAX package's CLI that the port does not have yet,
#: and the ROADMAP item each waits for
WAITING = {
    "route": "the replica router, the second half of ROADMAP 'Modules "
             "to port' item 8",
    "profile": "the contention profile driver, the second half of "
               "ROADMAP 'Modules to port' item 8",
    "regress": "the phase regression check, the second half of ROADMAP "
               "'Modules to port' item 8",
    "mesh-dryrun": "multi-GPU, ROADMAP 'Modules to port' item 7",
    "mesh-attr": "multi-GPU, ROADMAP 'Modules to port' item 7",
}


def cmd_info(args) -> int:
    import torch

    from blaze_tpu_torch.ops.kernels import _build

    cuda = torch.cuda.is_available()
    info = {
        "version": __import__("blaze_tpu_torch").__version__,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "cuda_available": cuda,
        "device_count": torch.cuda.device_count() if cuda else 0,
        "devices": ([torch.cuda.get_device_name(i)
                     for i in range(torch.cuda.device_count())]
                    if cuda else []),
        "kernels_built": {n: _build.library_path(n).exists()
                          for n in _build.SOURCES},
    }
    print(json.dumps(info, indent=2))
    return 0


def cmd_run_task(args) -> int:
    from blaze_tpu_torch.ops.base import ExecContext, MetricNode
    from blaze_tpu_torch.runtime.executor import (
        decode_task,
        execute_partition,
    )
    from blaze_tpu_torch.runtime.instrument import (
        instrument,
        render_metrics,
    )

    with open(args.file, "rb") as f:
        blob = f.read()
    ctx = ExecContext(device=args.device)
    total = 0
    # one production decode path; --metrics only adds the mirrored
    # metric tree
    op, partition = decode_task(blob, ctx)
    root = MetricNode("root")
    if args.metrics:
        op = instrument(op, root)
    for rb in execute_partition(op, partition, ctx):
        total += rb.num_rows
        if not args.quiet:
            print(rb.to_pandas().to_string(max_rows=20))
    if args.metrics:
        print(render_metrics(root), file=sys.stderr)
    print(f"-- {total} rows", file=sys.stderr)
    print(json.dumps(ctx.metrics.flatten()), file=sys.stderr)
    return 0


def cmd_scan(args) -> int:
    from blaze_tpu_torch.ops.base import ExecContext
    from blaze_tpu_torch.ops.limit import LimitExec
    from blaze_tpu_torch.ops.parquet_scan import FileRange, ParquetScanExec
    from blaze_tpu_torch.runtime.executor import run_plan

    plan = ParquetScanExec(
        [[FileRange(args.file)]],
        projection=args.columns.split(",") if args.columns else None,
    )
    op = LimitExec(plan, args.limit) if args.limit else plan
    tbl = run_plan(op, ExecContext(device=args.device))
    print(tbl.to_pandas().to_string(max_rows=args.limit or 50))
    return 0


def cmd_gateway(args) -> int:
    from blaze_tpu_torch.runtime.gateway import serve_forever

    serve_forever(args.host, args.port, device=args.device)
    return 0


def cmd_serve(args) -> int:
    import signal
    import threading
    import time

    from blaze_tpu_torch.runtime.gateway import TaskGatewayServer
    from blaze_tpu_torch.service import QueryService, ResultCache

    if args.router:
        print("serve --router: elastic membership waits for "
              f"{WAITING['route']}", file=sys.stderr)
        return 2
    cache = None
    if not args.no_cache:
        cache = ResultCache(
            max_bytes=args.cache_bytes, ttl_s=args.cache_ttl
        )
    try:
        service = QueryService(
            max_concurrency=args.max_concurrency,
            max_queue_depth=args.max_queue_depth,
            cache=cache,
            enable_cache=not args.no_cache,
            default_deadline_s=args.deadline or None,
            enable_trace=not args.no_trace,
            slow_query_s=args.slow_query_s,
            mesh_mode=("on" if args.mesh else args.mesh_mode),
            orphan_ttl_s=args.orphan_ttl,
            stream_buffer_bytes=args.stream_buffer_bytes,
            stream_stall_s=args.stream_stall_s,
            plan_cache_entries=args.plan_cache_entries,
            arena_bytes=(0 if args.no_arena else args.arena_bytes),
            arena_dir=args.arena_dir,
            tenant_config=(
                json.loads(args.tenant_config)
                if args.tenant_config else None
            ),
            fleet_peers=(args.fleet_peer or None),
            device=args.device,
        )
    except NotImplementedError as e:
        print(f"serve: {e}", file=sys.stderr)
        return 2
    try:
        srv = TaskGatewayServer(args.host, args.port, device=args.device,
                                service=service, wire=args.wire)
    except NotImplementedError as e:
        service.close()
        print(f"serve: {e}", file=sys.stderr)
        return 2
    if service.device.type == "cuda":
        # ready means the card is ready: the CUDA context and the
        # kernels' libraries load before the listening line, not in the
        # first query (the kernels build here if the checkout has none)
        import torch

        from blaze_tpu_torch.ops.kernels import _build

        torch.zeros(1, device=service.device)
        for name in _build.SOURCES:
            _build.load(name)
    if args.profile_hz > 0:
        # whole-lifetime profiling: contention accounting + the stack
        # sampler (the PROFILE verb can also arm a running server)
        from blaze_tpu_torch.obs import contention, sampler

        contention.enable()
        sampler.start(hz=args.profile_hz)
    print(f"blaze_tpu_torch gateway listening on {srv.address}",
          flush=True)
    draining = threading.Event()

    def _drain_and_exit() -> None:
        # the listener stays up through the drain: in-flight queries
        # finish and their results stay FETCHable; only new SUBMITs
        # are refused (classified DRAINING rejection)
        print("SIGTERM: draining (refusing new submits)", flush=True)
        service.drain(timeout_s=args.drain_grace or None)
        time.sleep(0.25)
        print("drained; leaving", flush=True)
        srv.shutdown()

    def _on_sigterm(signum, frame) -> None:
        if not draining.is_set():
            draining.set()
            threading.Thread(
                target=_drain_and_exit, daemon=True,
                name="blaze-serve-drain",
            ).start()

    signal.signal(signal.SIGTERM, _on_sigterm)
    try:
        srv.serve_blocking()
    except KeyboardInterrupt:
        pass
    finally:
        try:
            srv.stop()
        except OSError:
            pass
        service.close()
    return 0


def cmd_trace(args) -> int:
    """Fetch one query's trace over the REPORT verb and write the
    Perfetto-loadable Chrome-trace-event JSON."""
    from blaze_tpu_torch.obs.trace import validate_chrome
    from blaze_tpu_torch.service.wire import ServiceClient

    with ServiceClient(args.host, args.port) as c:
        data = c.report_full(args.query_id)
    if data.get("error"):
        print(data["error"], file=sys.stderr)
        return 1
    doc = data.get("trace")
    if not doc:
        print(
            f"no trace recorded for {args.query_id} "
            "(server tracing disabled, or query evicted)",
            file=sys.stderr,
        )
        return 1
    problems = validate_chrome(doc)
    if args.out == "-":
        json.dump(doc, sys.stdout)
        print()
    else:
        out = args.out or f"{args.query_id}.trace.json"
        with open(out, "w") as f:
            json.dump(doc, f)
        print(
            f"{out}: {len(doc['traceEvents'])} events"
            + (f" ({len(problems)} schema problems)" if problems
               else " (valid)")
            + " - load in ui.perfetto.dev or chrome://tracing",
            file=sys.stderr,
        )
    return 0 if not problems else 2


def cmd_metrics(args) -> int:
    from blaze_tpu_torch.service.wire import ServiceClient

    with ServiceClient(args.host, args.port) as c:
        sys.stdout.write(c.metrics())
    return 0


def _device_arg(p) -> None:
    p.add_argument("--device", default=None, choices=("cuda", "cpu"),
                   help="device the tasks run on (default: cuda; "
                        "without CUDA the task fails)")


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in WAITING:
        print(f"{argv[0]}: not in the port yet; it waits for "
              f"{WAITING[argv[0]]}", file=sys.stderr)
        return 2
    p = argparse.ArgumentParser(prog="blaze_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    sub.add_parser("info")
    rt = sub.add_parser("run-task")
    rt.add_argument("file")
    rt.add_argument("--quiet", action="store_true")
    rt.add_argument("--metrics", action="store_true",
                    help="print the per-operator metric tree")
    _device_arg(rt)
    sc = sub.add_parser("scan")
    sc.add_argument("file")
    sc.add_argument("--columns", default=None)
    sc.add_argument("--limit", type=int, default=20)
    _device_arg(sc)
    gw = sub.add_parser("gateway")
    gw.add_argument("--host", default="127.0.0.1")
    gw.add_argument("--port", type=int, default=8484)
    _device_arg(gw)
    sv = sub.add_parser("serve")
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument("--port", type=int, default=8484)
    _device_arg(sv)
    sv.add_argument("--max-concurrency", type=int, default=2)
    sv.add_argument("--max-queue-depth", type=int, default=64)
    sv.add_argument("--deadline", type=float, default=0.0,
                    help="default per-query deadline seconds (0 = none)")
    sv.add_argument("--no-cache", action="store_true",
                    help="disable the plan-fingerprint result cache")
    sv.add_argument("--cache-bytes", type=int, default=256 << 20)
    sv.add_argument("--cache-ttl", type=float, default=300.0)
    sv.add_argument("--no-trace", action="store_true",
                    help="disable query-lifecycle tracing (obs/)")
    sv.add_argument("--slow-query-s", type=float, default=None,
                    help="structured slow-query log threshold "
                         "(default 5s or BLAZE_SLOW_QUERY_S; "
                         "<= 0 disables)")
    sv.add_argument("--mesh", action="store_true",
                    help="force the mesh tier (waits for item 7: "
                         "exits 2)")
    sv.add_argument("--mesh-mode", default=None,
                    choices=("auto", "on", "off"),
                    help="mesh execution mode (auto and off run on the "
                         "one card; on waits for item 7)")
    sv.add_argument("--router", default=None, metavar="HOST:PORT",
                    help="router to JOIN (waits for the router: "
                         "exits 2)")
    sv.add_argument("--orphan-ttl", type=float, default=900.0,
                    help="reap terminal, never-fetched queries with "
                         "no POLL activity for this many seconds "
                         "(0 disables)")
    sv.add_argument("--drain-grace", type=float, default=30.0,
                    help="SIGTERM drain: max seconds to wait for "
                         "in-flight queries before leaving anyway "
                         "(0 = wait forever)")
    sv.add_argument("--stream-buffer-bytes", type=int,
                    default=32 << 20,
                    help="per-query bounded ring for FETCH-while-"
                         "RUNNING delivery (0 = materialize then "
                         "stream)")
    sv.add_argument("--stream-stall-s", type=float, default=30.0,
                    help="slow-consumer budget before the query is "
                         "aborted STREAM_STALLED (0 disables)")
    sv.add_argument("--profile-hz", type=float, default=0.0,
                    help="arm lock-wait accounting and the thread-"
                         "stack sampler at this Hz (0 = off)")
    sv.add_argument("--wire", default=None,
                    choices=("async", "threaded"),
                    help="wire data plane: threaded (the port's "
                         "default and only plane; async waits for "
                         "the event-loop wire); default honors "
                         "BLAZE_WIRE")
    sv.add_argument("--plan-cache-entries", type=int, default=256,
                    help="decoded-plan cache: repeat SUBMITs of a "
                         "byte-identical blob skip the decode "
                         "(0 disables)")
    sv.add_argument("--arena-bytes", type=int, default=256 << 20,
                    help="shared-memory Arrow arena budget: finalized "
                         "results are published once as mmap'd wire "
                         "frames and FETCHes are served from them")
    sv.add_argument("--no-arena", action="store_true",
                    help="disable the arena: every FETCH re-encodes")
    sv.add_argument("--arena-dir", default=None,
                    help="arena segment directory (default: a "
                         "private temp dir, removed at close)")
    sv.add_argument("--fleet-peer", action="append", default=[],
                    metavar="HOST:PORT",
                    help="peer for the fleet mesh tier (waits for "
                         "item 7: exits 2)")
    sv.add_argument("--tenant-config", default=None, metavar="JSON",
                    help="per-tenant admission budgets, e.g. "
                         '\'{"acme": {"max_queued": 8, '
                         '"max_running": 1, "weight": 2.0}}\'')
    tr = sub.add_parser("trace")
    tr.add_argument("query_id")
    tr.add_argument("--host", default="127.0.0.1")
    tr.add_argument("--port", type=int, default=8484)
    tr.add_argument("-o", "--out", default=None,
                    help="output path ('-' = stdout; default "
                         "<query_id>.trace.json)")
    mt = sub.add_parser("metrics")
    mt.add_argument("--host", default="127.0.0.1")
    mt.add_argument("--port", type=int, default=8484)
    args = p.parse_args(argv)
    return {
        "info": cmd_info,
        "run-task": cmd_run_task,
        "scan": cmd_scan,
        "gateway": cmd_gateway,
        "serve": cmd_serve,
        "trace": cmd_trace,
        "metrics": cmd_metrics,
    }[args.cmd](args)


if __name__ == "__main__":
    raise SystemExit(main())
