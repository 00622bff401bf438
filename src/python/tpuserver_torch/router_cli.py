"""Fleet router CLI: one resilient front-tier over N replica servers.

    PYTHONPATH=src/python python -m tpuserver_torch.router_cli \
        --backends 10.0.0.1:8000,10.0.0.2:8000 \
        --port 9000 --probe-interval 0.5 --max-inflight 256

The port's router process (``tpuserver_torch.fleet_router``), with the
JAX package's router CLI's flags.  The router speaks the same KServe v2
+ /generate_stream surface as a replica, so any plain HTTP client
points at it unchanged and gets health-aware routing, typed shedding,
sticky stream resume, and cross-replica resume handoff for free
(docs/resilience.md "Fleet router").  Membership is live: GET/POST
/router/replicas lists, adds, and removes replicas at runtime (the
surface ``python -m tpuserver_torch.fleet_cli``'s supervisor drives
scaling through).

Router HA (docs/resilience.md "Router HA & state durability"):
``--journal DIR`` makes the sticky registry crash-durable — the
router replays the journal on boot, so marked (``gen~offset/seq``)
resumes survive a restart — and ``--standby`` (same ``--journal``)
runs a warm standby that tails the journal and sheds typed 503 until
promoted (``POST /router/promote``, or SIGUSR1 to this process).

SIGTERM drains first — stop admitting, let in-flight streams finish
or hand off, flush + fsync the journal — exactly like the replica
entrypoint's ``install_sigterm_drain``; SIGINT stops immediately.
"""

import argparse
import signal
import sys
import threading


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--backends", required=True,
                    help="comma-separated replica host:port list")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=9000,
                    help="router listen port (0 = pick free)")
    ap.add_argument("--probe-interval", type=float, default=1.0,
                    help="health-prober cadence in seconds (default 1.0)")
    ap.add_argument("--probe-timeout", type=float, default=2.0)
    ap.add_argument("--max-inflight", type=int, default=None,
                    help="router-level in-flight cap; excess sheds with "
                         "typed 429 + Retry-After (default: uncapped)")
    ap.add_argument("--gen-ttl", type=float, default=60.0,
                    help="generation registry TTL seconds — match the "
                         "replicas' replay_ttl_s (default 60)")
    ap.add_argument("--gen-capacity", type=int, default=1024)
    ap.add_argument("--affinity-bonus", type=float, default=2.0,
                    help="prefix-affinity load-score bonus for the "
                         "replica whose radix cache is warm for a "
                         "prompt prefix (0 disables: hash-blind "
                         "routing; default 2)")
    ap.add_argument("--affinity-prefix-tokens", type=int, default=16,
                    help="prompt tokens hashed into the affinity key; "
                         "must not exceed the workload's SHARED prefix "
                         "length (default 16 = one KV page, the "
                         "smallest radix-shareable prefix)")
    ap.add_argument("--outlier-factor", type=float, default=3.0,
                    help="gray-failure ejection: soft-eject a replica "
                         "whose recent p90 exceeds this multiple of "
                         "the fleet median (default 3.0; <=0 keeps "
                         "the default)")
    ap.add_argument("--outlier-min-samples", type=int, default=16,
                    help="digest samples required before a replica "
                         "can be judged an outlier (default 16)")
    ap.add_argument("--min-eligible", type=int, default=1,
                    help="ejection never leaves fewer than this many "
                         "healthy un-ejected replicas: degrade to "
                         "slow, never to unavailable (default 1)")
    ap.add_argument("--probe-fraction", type=float, default=1.0 / 16,
                    help="share of traffic routed to a soft-ejected "
                         "replica as its real-traffic re-admission "
                         "probe (default 1/16)")
    ap.add_argument("--hedge-delay", type=float, default=None,
                    help="hedged unary requests (seconds; default "
                         "off): an idempotent attempt still pending "
                         "after the primary's rolling p95 — floored "
                         "at this value, which alone applies while "
                         "the digest is cold — races a duplicate on "
                         "a different replica")
    ap.add_argument("--journal", default=None, metavar="DIR",
                    help="crash-durable generation journal directory: "
                         "replayed on boot (marked resumes survive a "
                         "router restart), appended off the hot relay "
                         "path while serving")
    ap.add_argument("--standby", action="store_true",
                    help="run as a warm standby: tail --journal "
                         "(required), keep membership/probing live, "
                         "shed /v2 traffic typed-503 until promoted "
                         "(POST /router/promote or SIGUSR1)")
    ap.add_argument("--partition-count", type=int, default=1,
                    help="horizontal front tier: total active-router "
                         "partitions over the generation-id space "
                         "(default 1 = the single-active tier)")
    ap.add_argument("--partition-index", type=int, default=None,
                    help="the partition THIS active owns (0-based; "
                         "required for an active when "
                         "--partition-count > 1, omitted for the "
                         "standby which tails every partition)")
    ap.add_argument("--peers", default=None,
                    help="comma list of router host:port by partition "
                         "index (empty slot = no live owner yet); "
                         "wrong-partition requests peer-forward here")
    ap.add_argument("--epoch", type=int, default=0,
                    help="partition-map epoch the --peers map carries "
                         "(broadcasts with a newer epoch supersede)")
    ap.add_argument("--relay", choices=("thread", "selector"),
                    default=None,
                    help="SSE relay mode (default: selector when "
                         "partitioned, thread otherwise)")
    ap.add_argument("--spawn-nonce", default=None,
                    help="spawn identity nonce echoed in "
                         "/v2/health/stats (fleet supervisor "
                         "adoption after a supervisor restart)")
    ap.add_argument("--drain-timeout", type=float, default=10.0,
                    help="SIGTERM drain budget in seconds (in-flight "
                         "streams finish, journal flushes, then exit)")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)

    if args.standby and not args.journal:
        ap.error("--standby requires --journal (the standby tails it)")

    from tpuserver_torch.fleet_router import FleetRouter

    backends = [u.strip() for u in args.backends.split(",") if u.strip()]
    router = FleetRouter(
        backends,
        host=args.host,
        port=args.port,
        probe_interval_s=args.probe_interval,
        probe_timeout_s=args.probe_timeout,
        max_inflight=args.max_inflight,
        gen_ttl_s=args.gen_ttl,
        gen_capacity=args.gen_capacity,
        affinity_bonus=args.affinity_bonus,
        affinity_prefix_tokens=args.affinity_prefix_tokens,
        outlier_factor=(args.outlier_factor if args.outlier_factor > 0
                        else 3.0),
        outlier_min_samples=args.outlier_min_samples,
        min_eligible=args.min_eligible,
        probe_fraction=args.probe_fraction,
        hedge_delay_s=args.hedge_delay,
        journal=args.journal,
        standby=args.standby,
        partition_index=args.partition_index,
        partition_count=args.partition_count,
        peers=(args.peers.split(",") if args.peers else None),
        partition_epoch=args.epoch,
        relay_mode=args.relay,
        spawn_nonce=args.spawn_nonce,
        verbose=args.verbose,
    ).start()

    stop = threading.Event()
    drain_first = threading.Event()

    def _stop(signum, frame):
        stop.set()

    def _sigterm(signum, frame):
        # the router's own install_sigterm_drain twin: stop admitting,
        # let in-flight streams finish or hand off, flush + fsync the
        # journal, then exit.  The admission latch flips HERE, not in
        # the main thread's drain() — otherwise a request landing
        # between signal delivery and the main thread waking out of
        # stop.wait() is still admitted after SIGTERM.  Safe: the main
        # thread (where handlers run) is parked in stop.wait() and
        # never holds the router lock; the drain_first guard keeps a
        # repeated SIGTERM from re-entering begin_drain mid-drain().
        if not drain_first.is_set():
            drain_first.set()
            router.begin_drain()
        stop.set()

    def _promote(signum, frame):
        # takeover signal for supervisor-less deployments; the HTTP
        # twin is POST /router/promote
        threading.Thread(target=router.promote,
                         name="router-promote", daemon=True).start()

    signal.signal(signal.SIGTERM, _sigterm)
    signal.signal(signal.SIGINT, _stop)
    if hasattr(signal, "SIGUSR1"):
        signal.signal(signal.SIGUSR1, _promote)
    print("fleet router {} on {} over {} replica(s): {}{}{}".format(
        "STANDBY" if args.standby else "listening",
        router.url, len(backends), ", ".join(backends),
        " (journal: {})".format(args.journal) if args.journal else "",
        " (partition {}/{})".format(args.partition_index,
                                    args.partition_count)
        if args.partition_count > 1 else "",
    ), flush=True)
    try:
        stop.wait()
        if drain_first.is_set():
            print("router draining...", flush=True)
            router.drain(timeout_s=args.drain_timeout)
    finally:
        router.stop()
    print("router stopped", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
