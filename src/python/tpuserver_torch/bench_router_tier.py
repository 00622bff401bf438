"""Horizontal router tier bench: >=10k concurrent SSE streams through a
3-active partitioned tier of the port's routers on one box.

    python -m tpuserver_torch.bench_router_tier [--out FILE]
    python -m tpuserver_torch.bench_router_tier --streams 600 \\
        --control-streams 120 --takeover-streams 60   # quick smoke

The port's copy of the JAX package's ``tools/bench_router_tier.py``, on
the port's own tier: ``python -m tpuserver_torch.router_cli`` routers,
the port's distributed perf analyzer coordinator
(``tpuserver_torch.perfanalyzer.coordinator``) and ``FleetSupervisor``.
Three measurements:

1. **Stream capacity** — the coordinator drives N hold-workers
   (asyncio, raw sockets) that dial and HOLD the streams as concurrent
   ``/generate_stream`` relays through 3 partitioned actives (selector
   relay).  Every worker pins each stream's ``generation_id`` to the
   partition of the router it dials, so the tier serves with ZERO
   peer-forward hops; the parent reads each router's resident thread
   count from ``/proc/<pid>/status`` while the streams are held.
2. **Thread-per-conn control** — the same hold load (scaled down)
   against one ``--relay thread`` router, where resident threads grow
   about 1:1 with held streams.  The ratio of streams per router thread
   is the selector relay's win.
3. **Takeover window** — a supervised 3-active+standby tier over
   ``tests/fleet_stub.py`` replicas; SIGKILL the partition-0 active
   mid-traffic and measure each victim stream's reconnect gap (the
   largest time between two of its events on the client's
   ``time.monotonic()``) through the resumable SSE reader's rotation to
   the other routers; p99 is the takeover window.  Sibling partitions
   must ride through with ZERO reconnects (the
   ``partition_blast_radius`` invariant).

The upstream for phases 1-2 is an in-file asyncio SSE stub (emit one
token, hold the stream open), because the thread-per-connection stub
cannot hold 10k streams on one box.  The streams need about three
descriptors each over the routers, workers and upstream: the tool
raises its own soft ``RLIMIT_NOFILE`` to the hard limit (its children
inherit it) and exits 2, naming the limit and the count, where even the
hard limit cannot hold them.  No model runs and no device is touched.
"""

import argparse
import asyncio
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import zlib

from tpuserver_torch import chaos_campaign
from tpuserver_torch.chaos_campaign import REPO, SRC_PYTHON

PROMPT = [5, 7, 9]
STREAM_PATH = "/v2/models/stub/generate_stream"
#: descriptors a process keeps beyond its streams (its own files,
#: listeners, probes, pipes)
FD_SLACK = 512


def partition_of(gid, count):
    return zlib.crc32(gid.encode("utf-8")) % count


def pin_gid(part, count, tag):
    n = 0
    while True:
        gid = "bench-{}-{}".format(tag, n)
        if partition_of(gid, count) == part:
            return gid
        n += 1


def proc_status(pid):
    """(threads, vm_rss_kib) for a live pid, from /proc."""
    threads = rss = 0
    with open("/proc/{}/status".format(pid)) as fh:
        for line in fh:
            if line.startswith("Threads:"):
                threads = int(line.split()[1])
            elif line.startswith("VmRSS:"):
                rss = int(line.split()[1])
    return threads, rss


def descriptors_needed(streams, control_streams, workers):
    """The most descriptors one process of the run holds at once: the
    upstream one a held stream, a router two (client and upstream) for
    its partition's share or for the whole control load, a worker its
    share; plus :data:`FD_SLACK`."""
    return FD_SLACK + max(streams, 2 * -(-streams // 3),
                          -(-streams // max(1, workers)),
                          2 * control_streams)


def raise_nofile(needed):
    """Raise this process's soft ``RLIMIT_NOFILE`` to its hard limit (the
    children inherit it); returns ``(soft, hard)`` after, or None where
    the hard limit is below ``needed``."""
    import resource

    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    if hard != resource.RLIM_INFINITY and hard < needed:
        return None
    if soft != resource.RLIM_INFINITY and (
            hard == resource.RLIM_INFINITY or soft < hard):
        resource.setrlimit(resource.RLIMIT_NOFILE, (hard, hard))
    return resource.getrlimit(resource.RLIMIT_NOFILE)


# -- the asyncio SSE upstream (phases 1-2) -----------------------------------


def serve_upstream(port, hold_s):
    """One-process asyncio upstream: health probes + a generate_stream
    that emits one token immediately and then holds the stream open
    for ``hold_s`` — the idle-stream shape the capacity phases hold
    through the routers."""
    snapshot = json.dumps({
        "state": "ready", "ready": True, "inflight": 0,
        "max_inflight": None, "pid": os.getpid(), "role": None,
        "models": {"stub": {
            "live_streams": 0, "pending": 0, "max_slots": 1 << 20,
            "max_pending": 1 << 20, "tripped": False, "draining": False,
            "closed": False, "healthy": True, "restarts": 0,
            "quarantined": 0, "replay_entries": 0}},
    }).encode("utf-8")

    async def handle(reader, writer):
        try:
            request = await reader.readline()
            parts = request.split()
            if len(parts) < 2:
                return
            method, path = parts[0], parts[1].decode("ascii")
            length = 0
            while True:
                line = await reader.readline()
                if line in (b"\r\n", b"\n", b""):
                    break
                if line.lower().startswith(b"content-length:"):
                    length = int(line.split(b":", 1)[1])
            body = await reader.readexactly(length) if length else b""
            if method == b"GET":
                writer.write(
                    b"HTTP/1.1 200 OK\r\n"
                    b"Content-Type: application/json\r\n"
                    b"Content-Length: " + str(len(snapshot)).encode()
                    + b"\r\n\r\n" + snapshot)
                await writer.drain()
                return
            if not path.endswith("/generate_stream"):
                writer.write(b"HTTP/1.1 404 Not Found\r\n"
                             b"Content-Length: 0\r\n\r\n")
                await writer.drain()
                return
            try:
                gid = str((json.loads(body or b"{}").get("parameters")
                           or {}).get("generation_id") or "anon")
            except ValueError:
                gid = "anon"
            event = json.dumps({
                "model_name": "stub",
                "outputs": [{"name": "TOKEN", "datatype": "INT32",
                             "shape": [1], "data": [7]}],
                "parameters": {"generation_id": gid, "seq": 0},
            }).encode("ascii")
            writer.write(
                b"HTTP/1.1 200 OK\r\n"
                b"Content-Type: text/event-stream\r\n\r\n"
                + "id: {}/0\n".format(gid).encode("ascii")
                + b"data: " + event + b"\n\n")
            await writer.drain()
            await asyncio.sleep(hold_s)
            writer.write(b'data: {"final": true}\n\n')
            await writer.drain()
        except (OSError, asyncio.IncompleteReadError,
                ConnectionError):
            pass
        finally:
            try:
                writer.close()
            except OSError:
                pass

    async def main():
        server = await asyncio.start_server(
            handle, "127.0.0.1", port, backlog=512)
        async with server:
            await server.serve_forever()

    asyncio.run(main())


# -- the hold-worker (coordinator-driven, phases 1-2) ------------------------


def run_hold_worker(args):
    """Dial ``--streams`` generate_stream relays against the router
    tier in ``--targets`` (each stream's gid pinned to its target's
    partition), hold them open, and report dial latencies through the
    coordinator's window protocol."""
    from tpuserver_torch.perfanalyzer.coordinator import WorkerChannel

    targets = [t.rsplit(":", 1) for t in args.targets.split(",")]
    targets = [(host, int(port)) for host, port in targets]
    count = len(targets)
    held = []

    async def dial(sem, index, latencies, errors):
        part = index % count
        gid = pin_gid(part, count,
                      "w{}-{}".format(args.worker_id, index))
        body = json.dumps({
            "inputs": [
                {"name": "PROMPT_IDS", "datatype": "INT32",
                 "shape": [len(PROMPT)], "data": PROMPT},
                {"name": "MAX_TOKENS", "datatype": "INT32",
                 "shape": [1], "data": [2]},
            ],
            "parameters": {"generation_id": gid},
        }).encode("utf-8")
        host, port = targets[part]
        async with sem:
            t0 = time.monotonic()
            try:
                reader, writer = await asyncio.open_connection(host, port)
                writer.write(
                    "POST {} HTTP/1.1\r\nHost: {}\r\n"
                    "Content-Type: application/json\r\n"
                    "Content-Length: {}\r\n\r\n".format(
                        STREAM_PATH, host, len(body)).encode("ascii")
                    + body)
                await writer.drain()
                status = await reader.readline()
                if b" 200 " not in status:
                    raise ConnectionError(
                        "dial answered {!r}".format(status))
                while True:
                    line = await reader.readline()
                    if not line:
                        raise ConnectionError("EOF before first event")
                    if line.startswith(b"data: "):
                        break
                latencies.append(time.monotonic() - t0)
                held.append((reader, writer))
            except (OSError, ConnectionError, ValueError) as e:
                errors.append(str(e))

    def run_window(duration_s, index):
        if index > 0:
            # hold window: just confirm the streams are still up
            time.sleep(duration_s)
            alive = sum(1 for r, _w in held if not r.at_eof())
            return {"completed": alive, "errors": 0,
                    "duration_s": duration_s, "latencies_s": []}
        latencies, errors = [], []

        async def dial_all():
            sem = asyncio.Semaphore(args.dial_concurrency)
            await asyncio.gather(*[
                dial(sem, i, latencies, errors)
                for i in range(args.streams)])

        t0 = time.monotonic()
        loop.run_until_complete(dial_all())
        if errors:
            sys.stderr.write("worker {}: {} dial errors, first: {}\n"
                             .format(args.worker_id, len(errors),
                                     errors[0]))
        return {"completed": len(held), "errors": len(errors),
                "duration_s": time.monotonic() - t0,
                "latencies_s": latencies}

    loop = asyncio.new_event_loop()
    channel = WorkerChannel(args.worker_connect, args.worker_id)
    try:
        channel.serve(run_window, idle_timeout_s=1800.0)
    finally:
        channel.close()
        for _reader, writer in held:
            try:
                writer.close()
            except OSError:
                pass
        loop.close()
    return 0


# -- phase 1/2 driver --------------------------------------------------------


def _child_env():
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (SRC_PYTHON, os.environ.get("PYTHONPATH")) if p))


def spawn_router(argv_extra, port, backends, journal):
    return subprocess.Popen(
        [sys.executable, "-m", "tpuserver_torch.router_cli",
         "--backends", backends, "--port", str(port),
         "--journal", journal, "--gen-capacity", "32768",
         "--probe-interval", "2.0"] + argv_extra,
        env=_child_env())


def run_capacity_phase(streams, routers, workers, dial_concurrency,
                       tmp, tag, relay=None):
    """Hold ``streams`` relayed SSE streams through ``routers``
    partitioned actives; return (held, dial stats, per-router
    (threads, rss_kib, stats)) measured WHILE the streams are held."""
    from tpuserver_torch.perfanalyzer.coordinator import (
        Coordinator,
        reap_workers,
    )

    free_port, wait_ready = chaos_campaign.free_port, \
        chaos_campaign.wait_ready
    upstream_port = free_port()
    upstream = subprocess.Popen(
        [sys.executable, "-m", "tpuserver_torch.bench_router_tier",
         "--upstream-serve", "--port", str(upstream_port),
         "--hold-s", "3600"], env=_child_env())
    procs = [upstream]
    worker_procs = []
    coord = None
    try:
        if not wait_ready(upstream_port, 30):
            raise RuntimeError("upstream never ready")
        ports = [free_port() for _ in range(routers)]
        peers = ",".join("127.0.0.1:{}".format(p) for p in ports)
        backends = "127.0.0.1:{}".format(upstream_port)
        for k, port in enumerate(ports):
            extra = []
            if routers > 1:
                extra = ["--partition-count", str(routers),
                         "--partition-index", str(k),
                         "--peers", peers, "--epoch", "1"]
            if relay:
                extra += ["--relay", relay]
            procs.append(spawn_router(
                extra, port, backends,
                os.path.join(tmp, "journal-{}-{}".format(tag, k))))
        for port in ports:
            if not wait_ready(port, 60):
                raise RuntimeError("router never ready")

        coord = Coordinator(workers=workers, result_timeout_s=1800.0)
        coord.listen()
        per_worker = (streams + workers - 1) // workers
        for i in range(workers):
            worker_procs.append(subprocess.Popen(
                [sys.executable, "-m", "tpuserver_torch.bench_router_tier",
                 "--hold-worker", "--worker-connect", coord.address,
                 "--worker-id", str(i), "--targets", peers,
                 "--streams", str(per_worker),
                 "--dial-concurrency", str(dial_concurrency)],
                env=_child_env()))
        coord.wait_for_workers(timeout_s=60)
        dialed = coord.run_window(0, 1.0)
        # the streams are held right now: measure each router process
        router_rows = []
        for proc, port in zip(procs[1:], ports):
            threads, rss = proc_status(proc.pid)
            stats = router_stats(port)
            router_rows.append((threads, rss, stats))
        held = coord.run_window(1, 2.0)  # still-alive confirmation
        coord.shutdown()
        coord = None
        reap_workers(worker_procs, timeout_s=30)
        worker_procs = []
        return dialed, held, router_rows
    finally:
        if coord is not None:
            try:
                coord.shutdown()
            except OSError:
                pass
        for proc in worker_procs + procs:
            try:
                proc.kill()
            except OSError:
                pass
        for proc in worker_procs + procs:
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pass


def router_stats(port):
    return chaos_campaign.get_json(
        "127.0.0.1:{}".format(port), "/router/stats") or {}


# -- phase 3: takeover window through the supervised tier --------------------


def expected_tokens(tokens):
    """The stub replicas' greedy tokens for :data:`PROMPT`."""
    expected = []
    fed = list(PROMPT)
    for _ in range(tokens):
        tok = (sum(fed) * 31 + len(fed) * len(fed) * 7 + 13) % 101
        fed.append(tok)
        expected.append(tok)
    return expected


def run_takeover_phase(streams_per_partition, tokens, token_delay_ms,
                       tmp):
    """SIGKILL the partition-0 active of a supervised 3-active+standby
    tier mid-traffic; victims resume by the resumable SSE reader's
    rotation through the other routers.  Returns (victim
    reconnect-window gaps, survivor gaps, victim reconnects, survivor
    reconnects, takeover wall seconds)."""
    from tpuserver_torch.fleet import FleetSupervisor

    actives = 3
    command = [sys.executable,
               os.path.join(REPO, "tests", "fleet_stub.py"),
               "--port", "{port}", "--scope", "{scope}"]
    router_command = [
        sys.executable, "-m", "tpuserver_torch.router_cli",
        "--backends", "{backends}", "--port", "{port}",
        "--journal", "{journal}", "--probe-interval", "0.1",
    ]
    supervisor = FleetSupervisor(
        command, replicas=2, min_replicas=2, max_replicas=2,
        probe_interval_s=0.1, probe_timeout_s=2.0,
        start_timeout_s=60.0, restart_backoff_s=0.05,
        max_restarts=8, scope_prefix="bench-mr-",
        router_command=router_command, router_standby=True,
        active_routers=actives,
        router_journal=os.path.join(tmp, "journal-takeover"),
        env={"PYTHONPATH": SRC_PYTHON},
    ).start()
    try:
        if not supervisor.wait_ready(timeout_s=60):
            raise RuntimeError("the stub replicas never came up")
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            rows = supervisor.stats().get("routers", [])
            if len(rows) == actives + 1 and all(
                    r["state"] == "up" for r in rows):
                break
            time.sleep(0.1)
        else:
            raise RuntimeError("router tier never came up")
        pmap = supervisor.stats()["partition_map"]
        urls = supervisor.router_urls()
        expected = expected_tokens(tokens)
        lock = threading.Lock()
        victim_gaps, survivor_gaps = [], []
        victim_recs, survivor_recs = [], []
        failures = []

        def one_stream(part, gid, owner_urls):
            recs = victim_recs if part == 0 else survivor_recs
            got, stamps = [], []

            def on_reconnect(attempt, exc):
                with lock:
                    recs.append(attempt)

            try:
                for event in chaos_campaign.generate_stream(
                        owner_urls, "stub", PROMPT, tokens,
                        {"generation_id": gid,
                         "token_delay_ms": token_delay_ms},
                        max_reconnects=20, backoff_s=0.05,
                        on_reconnect=on_reconnect):
                    stamps.append(time.monotonic())
                    for out in event.get("outputs", []):
                        if out["name"] == "TOKEN":
                            got.append(int(out["data"][0]))
            except Exception as e:  # noqa: BLE001 — reported below
                with lock:
                    failures.append("stream {}: {}: {}".format(
                        gid, type(e).__name__, e))
                return
            if got != expected:
                with lock:
                    failures.append("stream {} diverged: {} vs {}".format(
                        gid, got[:5], expected[:5]))
                return
            gap = max((b - a for a, b in zip(stamps, stamps[1:])),
                      default=0.0)
            with lock:
                (victim_gaps if part == 0 else survivor_gaps).append(gap)

        threads = []
        for part in range(actives):
            owner = pmap[part]
            fallbacks = [u for u in urls if u != owner]
            for n in range(streams_per_partition):
                gid = pin_gid(part, actives, "tk-p{}-{}".format(part, n))
                threads.append(threading.Thread(
                    target=one_stream, args=(part, gid, [owner] + fallbacks),
                    name="takeover-stream", daemon=True))
        for thread in threads:
            thread.start()
        time.sleep(max(0.5, tokens * token_delay_ms / 4000.0))
        victim = [r for r in supervisor.stats()["routers"]
                  if r.get("partition") == 0 and r["state"] == "up"][0]
        t_kill = time.monotonic()
        os.kill(victim["pid"], signal.SIGKILL)
        stream_deadline = t_kill + 120.0 + tokens * token_delay_ms / 1000.0
        for thread in threads:
            thread.join(timeout=max(0.0, stream_deadline - time.monotonic()))
        takeover_wall = time.monotonic() - t_kill
        if any(thread.is_alive() for thread in threads):
            raise RuntimeError("takeover streams still open after {:.0f} s"
                               .format(takeover_wall))
        if failures:
            raise RuntimeError("{} takeover stream(s) failed, first: {}"
                               .format(len(failures), failures[0]))
        stats = supervisor.stats()
        if stats.get("router_takeovers", 0) < 1:
            raise RuntimeError("no takeover recorded")
        return (victim_gaps, survivor_gaps, len(victim_recs),
                len(survivor_recs), takeover_wall)
    finally:
        supervisor.stop()


# -- report ------------------------------------------------------------------


def percentile(values, q):
    if not values:
        return 0.0
    ordered = sorted(values)
    idx = min(len(ordered) - 1, int(round(q * (len(ordered) - 1))))
    return ordered[idx]


def build_parser():
    ap = argparse.ArgumentParser(
        prog="python -m tpuserver_torch.bench_router_tier",
        description=__doc__.split("\n")[0])
    ap.add_argument("--streams", type=int, default=10200,
                    help="held streams through the 3-active tier")
    ap.add_argument("--control-streams", type=int, default=1000,
                    help="held streams through the threaded control")
    ap.add_argument("--takeover-streams", type=int, default=80,
                    help="streams PER PARTITION in the takeover phase")
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--dial-concurrency", type=int, default=64,
                    help="concurrent dials per worker")
    ap.add_argument("--tokens", type=int, default=40)
    ap.add_argument("--token-delay-ms", type=int, default=250)
    ap.add_argument("--out", default=None, metavar="FILE",
                    help="write the BENCH-schema JSON here")
    ap.add_argument("--skip-capacity", action="store_true")
    ap.add_argument("--skip-takeover", action="store_true")
    # internal modes
    ap.add_argument("--upstream-serve", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0,
                    help=argparse.SUPPRESS)
    ap.add_argument("--hold-s", type=float, default=3600.0,
                    help=argparse.SUPPRESS)
    ap.add_argument("--hold-worker", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--worker-connect", default="",
                    help=argparse.SUPPRESS)
    ap.add_argument("--worker-id", type=int, default=0,
                    help=argparse.SUPPRESS)
    ap.add_argument("--targets", default="", help=argparse.SUPPRESS)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)

    if args.upstream_serve:
        serve_upstream(args.port, args.hold_s)
        return 0
    if args.hold_worker:
        return run_hold_worker(args)

    if not args.skip_capacity:
        needed = descriptors_needed(args.streams, args.control_streams,
                                    args.workers)
        limits = raise_nofile(needed)
        if limits is None:
            import resource

            print("bench_router_tier: {} streams need about {} open files "
                  "in one process; RLIMIT_NOFILE's hard limit is {}".format(
                      args.streams, needed,
                      resource.getrlimit(resource.RLIMIT_NOFILE)[1]),
                  file=sys.stderr, flush=True)
            return 2
        print("open files: soft {} hard {} (a process needs about {})"
              .format(limits[0], limits[1], needed), flush=True)

    tmp = tempfile.mkdtemp(prefix="bench-router-tier-")
    try:
        rows = run_phases(args, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if args.out:
        report = {
            "cmd": "python -m tpuserver_torch.bench_router_tier",
            "rc": 0,
            "note": "horizontal front tier on the port's routers: 3 "
                    "partitioned actives hold the streams via the "
                    "selector relay loop (the thread-per-conn control "
                    "holds about 1 thread per stream); killing one "
                    "active costs only its own partition a reconnect "
                    "window (siblings: zero reconnects)",
            "rows": rows,
        }
        with open(args.out, "w") as fh:
            json.dump(report, fh, indent=1)
        print("wrote {}".format(args.out), flush=True)
    return 0


def run_phases(args, tmp):
    """The three measurements of ``main``, their journals under ``tmp``;
    returns the report's rows."""
    rows = []
    if not args.skip_capacity:
        print("phase 1: {} streams through 3 partitioned actives "
              "(selector relay)...".format(args.streams), flush=True)
        dialed, held, router_rows = run_capacity_phase(
            args.streams, 3, args.workers, args.dial_concurrency,
            tmp, "sel")
        sel_threads = max(t for t, _r, _s in router_rows)
        sel_rss = max(r for _t, r, _s in router_rows)
        forwarded = sum(
            (s.get("partition") or {}).get("forwarded", 0)
            for _t, _r, s in router_rows)
        dial_p99_s = (dialed.get("p99_usec") or 0.0) / 1e6
        print("  held {}/{} (alive {}), dial p99 {:.3f}s, max "
              "threads/router {}, forwarded {}".format(
                  dialed["completed"], args.streams,
                  held["completed"], dial_p99_s,
                  sel_threads, forwarded), flush=True)

        print("phase 2: {} streams through 1 threaded-relay control "
              "router...".format(args.control_streams), flush=True)
        c_dialed, c_held, c_rows = run_capacity_phase(
            args.control_streams, 1, 1, args.dial_concurrency,
            tmp, "thr", relay="thread")
        thr_threads = max(t for t, _r, _s in c_rows)
        thr_rss = max(r for _t, r, _s in c_rows)
        print("  held {}/{} (alive {}), threads/router {}".format(
            c_dialed["completed"], args.control_streams,
            c_held["completed"], thr_threads), flush=True)

        sel_per_router = dialed["completed"] / 3.0
        sel_ratio = sel_per_router / max(1, sel_threads)
        thr_ratio = c_dialed["completed"] / max(1, thr_threads)
        rows += [
            {"config": "3-active selector tier",
             "metric": "concurrent_streams_held",
             "value": dialed["completed"], "unit": "streams",
             "vs_baseline": c_dialed["completed"],
             "routers": 3, "workers": args.workers,
             "dial_errors": dialed["errors"],
             "peer_forwarded": forwarded,
             "dial_p99_s": round(dial_p99_s, 4)},
            {"config": "3-active selector tier",
             "metric": "resident_threads_per_router",
             "value": sel_threads, "unit": "threads",
             "vs_baseline": thr_threads,
             "streams_per_router": round(sel_per_router, 1),
             "rss_kib": sel_rss},
            {"config": "3-active selector tier",
             "metric": "streams_per_router_thread",
             "value": round(sel_ratio, 1), "unit": "streams/thread",
             "vs_baseline": round(thr_ratio, 2),
             "speedup": round(sel_ratio / max(thr_ratio, 1e-9), 1)},
            {"config": "threaded-relay control",
             "metric": "resident_threads_per_router",
             "value": thr_threads, "unit": "threads",
             "vs_baseline": thr_threads,
             "streams": c_dialed["completed"], "rss_kib": thr_rss},
        ]

    if not args.skip_takeover:
        print("phase 3: SIGKILL partition 0 of 3 under {} streams/"
              "partition...".format(args.takeover_streams), flush=True)
        (victim_gaps, survivor_gaps, victim_recs, survivor_recs,
         takeover_wall) = run_takeover_phase(
            args.takeover_streams, args.tokens, args.token_delay_ms,
            tmp)
        p99 = percentile(victim_gaps, 0.99)
        print("  victim reconnect-window p50 {:.2f}s p99 {:.2f}s "
              "({} streams, {} reconnects); survivors: {} streams, "
              "{} reconnects, max gap {:.2f}s".format(
                  percentile(victim_gaps, 0.5), p99,
                  len(victim_gaps), victim_recs,
                  len(survivor_gaps), survivor_recs,
                  max(survivor_gaps or [0.0])), flush=True)
        if survivor_recs:
            raise SystemExit(
                "partition_blast_radius violated: {} survivor "
                "reconnects".format(survivor_recs))
        rows.append(
            {"config": "takeover (SIGKILL 1 of 3 actives)",
             "metric": "takeover_window_p99_s",
             "value": round(p99, 3), "unit": "s",
             "vs_baseline": round(
                 percentile(victim_gaps, 0.5), 3),
             "victim_streams": len(victim_gaps),
             "victim_reconnects": victim_recs,
             "survivor_streams": len(survivor_gaps),
             "survivor_reconnects": survivor_recs,
             "takeover_wall_s": round(takeover_wall, 3),
             "token_identical": True})
    return rows


if __name__ == "__main__":
    sys.exit(main())
