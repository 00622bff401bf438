"""Fleet CLI: a supervised, elastically-scaled replica fleet behind one
router address.

    PYTHONPATH=src/python python -m tpuserver_torch.fleet_cli \\
        --prefill-replicas 1 --decode-replicas 1 --router-processes \\
        --manifest /var/lib/fleet --config llama3_8b --max-seq 4096 \\
        --max-slots 8

The port's counterpart of the JAX package's fleet CLI, on the port's
own tier: a :class:`~tpuserver_torch.fleet.FleetSupervisor` spawns N
replica processes, each the port's server (``python -m
tpuserver_torch.serve ... --port {port} --fault-scope {scope}``, with
``--role`` and ``--spawn-nonce`` appended by the supervisor), fronts
them with a router (in-process, or ``python -m
tpuserver_torch.router_cli`` processes with ``--router-processes``)
whose membership it keeps live, heals replica death (SIGKILL/crash) and
wedges (SIGTERM-drain first) under a bounded restart budget, and scales
the replica count with the fleet's queue pressure (docs/resilience.md
"Fleet supervisor & elastic scaling").  A replica runs on the card
unless ``--device cpu`` is passed through to it.

``--manifest DIR`` makes the SUPERVISOR itself crash-durable
(docs/resilience.md "Supervisor crash durability"): fleet state is
journaled to an append-only manifest, and a restarted supervisor
ADOPTS the still-running children instead of respawning a healthy
fleet.  Signal dispositions split with it:

- SIGTERM (manifest mode) = graceful HANDOVER — checkpoint the
  manifest, release the single-writer lock, exit WITHOUT touching the
  children; they keep serving until a successor adopts them.  Pass
  ``--stop-fleet`` to keep SIGTERM as full fleet teardown.
- SIGINT (and SIGTERM without a manifest) = stop the whole fleet,
  drain-first.

``--stub`` runs ``tests/fleet_stub.py`` replicas instead (a checkout's
model-free stub server, for supervisor and chaos tests).
"""

import argparse
import os
import signal
import sys
import threading

#: the directory that holds the package (what a child's PYTHONPATH needs)
SRC_PYTHON = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(os.path.dirname(SRC_PYTHON))


def replica_command(args):
    """The argv template of one replica process."""
    if args.stub:
        command = [
            sys.executable, os.path.join(REPO, "tests", "fleet_stub.py"),
            "--port", "{port}", "--scope", "{scope}",
        ]
        if args.spec_tokens > 0:
            command += ["--spec-tokens", str(args.spec_tokens)]
        return command
    command = [
        sys.executable, "-m", "tpuserver_torch.serve",
        "--config", args.config, "--max-seq", str(args.max_seq),
        "--max-slots", str(args.max_slots), "--seed", str(args.seed),
        "--models", args.models,
        "--spec-tokens", str(args.spec_tokens),
        "--drain-timeout", str(args.drain_timeout),
        "--port", "{port}", "--fault-scope", "{scope}",
    ]
    if args.device:
        command += ["--device", args.device]
    return command


def router_command(args):
    """The argv template of a router process (``--router-processes``),
    or None for the in-process router."""
    if not (args.router_processes or args.router_standby
            or args.active_routers > 1):
        return None
    return [
        sys.executable, "-m", "tpuserver_torch.router_cli",
        "--backends", "{backends}", "--host", args.router_host,
        "--port", "{port}", "--journal", "{journal}",
    ]


def signal_disposition(signum, manifest, stop_fleet):
    """What one shutdown signal means for THIS supervisor process:
    ``"handover"`` (checkpoint + release the manifest lock + leave the
    children serving) or ``"stop"`` (full drain-first fleet teardown).
    SIGTERM in manifest mode defaults to handover — the whole point of
    the manifest is that restarting the supervisor must not restart
    the fleet — unless ``--stop-fleet`` pins the teardown behaviour;
    SIGINT (and any signal without a manifest) always stops."""
    if (signum == signal.SIGTERM and manifest is not None
            and not stop_fleet):
        return "handover"
    return "stop"


def build_parser():
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    # -- the replicas (passed through to tpuserver_torch.serve) ----------
    ap.add_argument("--config", default="llama3_8b",
                    help="replica model config (serve.py --config)")
    ap.add_argument("--max-seq", type=int, default=4096)
    ap.add_argument("--max-slots", "--slots", dest="max_slots", type=int,
                    default=4,
                    help="llama scheduler slots per replica (default 4)")
    ap.add_argument("--seed", type=int, default=0,
                    help="the replicas' weight seed (every replica "
                         "serves the same weights)")
    ap.add_argument("--device", default=None,
                    help="replica device (default: the card; 'cpu' "
                         "for a CPU fleet)")
    ap.add_argument("--models", default="llama",
                    help="serve.py --models groups per replica "
                         "(default llama)")
    ap.add_argument("--spec-tokens", type=int, default=0,
                    help="speculative decoding draft budget per replica "
                         "scheduler step (0 = off; token streams are "
                         "identical either way)")
    ap.add_argument("--drain-timeout", type=float, default=10.0,
                    help="replica SIGTERM drain budget in seconds")
    # -- the supervisor ----------------------------------------------------
    ap.add_argument("--replicas", type=int, default=2,
                    help="initial replica process count (default 2)")
    ap.add_argument("--prefill-replicas", type=int, default=0,
                    help="disaggregated serving: dedicated prefill "
                         "replicas (requires --decode-replicas too; "
                         "--replicas then only adds fused capacity)")
    ap.add_argument("--decode-replicas", type=int, default=0,
                    help="disaggregated serving: dedicated decode "
                         "replicas the router attaches exported KV "
                         "onto")
    ap.add_argument("--min-replicas", type=int, default=1)
    ap.add_argument("--max-replicas", type=int, default=4)
    ap.add_argument("--router-host", default="127.0.0.1")
    ap.add_argument("--router-port", type=int, default=9000,
                    help="router listen port (0 = pick free)")
    ap.add_argument("--probe-interval", type=float, default=0.5,
                    help="supervisor monitor cadence (default 0.5s)")
    ap.add_argument("--max-restarts", type=int, default=5,
                    help="per-replica restart budget inside the window")
    ap.add_argument("--restart-window", type=float, default=60.0)
    ap.add_argument("--scale-high", type=float, default=0.85,
                    help="sustained fleet utilization that scales UP")
    ap.add_argument("--scale-low", type=float, default=0.10,
                    help="sustained fleet utilization that scales DOWN")
    ap.add_argument("--router-processes", action="store_true",
                    help="supervise the router as its own PROCESS "
                         "(python -m tpuserver_torch.router_cli with a "
                         "crash journal) under the same drain-first "
                         "restart budget the replicas get, instead of "
                         "the in-process router")
    ap.add_argument("--router-standby", action="store_true",
                    help="with --router-processes: run a warm-standby "
                         "router tailing the same journal; the "
                         "supervisor promotes it on active-router "
                         "death")
    ap.add_argument("--router-journal", default=None, metavar="DIR",
                    help="journal directory the router processes "
                         "share (default: a supervisor-owned temp "
                         "directory)")
    ap.add_argument("--standby-port", type=int, default=0,
                    help="standby router listen port (0 = pick free)")
    ap.add_argument("--active-routers", type=int, default=1,
                    help="with --router-processes: N simultaneously-"
                         "active routers partitioning the generation-"
                         "id space (default 1 = single active)")
    ap.add_argument("--manifest", default=None, metavar="DIR",
                    help="supervisor crash durability: journal fleet "
                         "state to this manifest directory; a "
                         "restarted supervisor ADOPTS the running "
                         "children instead of respawning them")
    ap.add_argument("--takeover", action="store_true",
                    help="with --manifest: wait (bounded) for the "
                         "incumbent supervisor's lock instead of "
                         "refusing when one is alive")
    ap.add_argument("--heartbeat-file", default=None, metavar="FILE",
                    help="stamp supervisor liveness + adoption "
                         "counters to this file every monitor tick "
                         "(atomic replace)")
    ap.add_argument("--stop-fleet", action="store_true",
                    help="with --manifest: keep SIGTERM as full fleet "
                         "teardown instead of the default graceful "
                         "handover that leaves children serving")
    ap.add_argument("--stub", action="store_true",
                    help="tests/fleet_stub.py replicas (model-free)")
    ap.add_argument("-v", "--verbose", action="store_true")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)

    from tpuserver_torch.fleet import FleetSupervisor

    path = os.environ.get("PYTHONPATH")
    supervisor = FleetSupervisor(
        replica_command(args),
        replicas=args.replicas,
        prefill_replicas=args.prefill_replicas,
        decode_replicas=args.decode_replicas,
        min_replicas=args.min_replicas,
        max_replicas=args.max_replicas,
        probe_interval_s=args.probe_interval,
        # a planned stop SIGKILLs only past the replica's own drain
        drain_grace_s=args.drain_timeout + 10.0,
        max_restarts=args.max_restarts,
        restart_window_s=args.restart_window,
        scale_high=args.scale_high,
        scale_low=args.scale_low,
        router_kwargs={"host": args.router_host, "port": args.router_port},
        router_command=router_command(args),
        router_standby=args.router_standby,
        router_journal=args.router_journal,
        router_port=args.router_port,
        standby_port=args.standby_port,
        active_routers=args.active_routers,
        env={"PYTHONPATH": SRC_PYTHON + (os.pathsep + path if path
                                         else "")},
        verbose=args.verbose,
        manifest_dir=args.manifest,
        takeover=args.takeover,
        heartbeat_file=args.heartbeat_file,
    ).start()

    stop = threading.Event()
    disposition = {"action": "stop"}

    def _signal(signum, frame):
        disposition["action"] = signal_disposition(
            signum, args.manifest, args.stop_fleet)
        stop.set()

    signal.signal(signal.SIGTERM, _signal)
    signal.signal(signal.SIGINT, _signal)
    print("fleet supervisor: router(s) on {} over {} replica(s) "
          "(min {}, max {}{})".format(
              ", ".join(supervisor.router_urls()),
              len(supervisor.stats()["replicas"]),
              args.min_replicas, args.max_replicas,
              ", manifest {}".format(args.manifest)
              if args.manifest else ""), flush=True)
    supervisor.wait_ready(timeout_s=120.0)
    for rep in supervisor.stats()["replicas"]:
        print("  replica {url} [{scope}] pid={pid} state={state}".format(
            **rep), flush=True)
    try:
        stop.wait()
    finally:
        if disposition["action"] == "handover":
            supervisor.handover()
        else:
            supervisor.stop()
    print("fleet {}".format(
        "handed over (children still serving)"
        if disposition["action"] == "handover" else "stopped"),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
