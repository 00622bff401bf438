#!/usr/bin/env python3
"""Fleet-supervisor demo on the PyTorch port: a plain
``tritonclient.http`` client pointed at a supervised fleet's router
keeps working while a replica server PROCESS is SIGKILLed — the
supervisor respawns it, the router's live membership follows, and the
client never sees an error.

The demo (1) spawns two real replica processes under a
``tpuserver_torch.fleet.FleetSupervisor`` (each ``python -m
tpuserver_torch.serve --models fixtures`` with its own port and fault
scope), (2) runs unary traffic through the router, (3) SIGKILLs one
replica — no drain, no warning — and keeps the traffic flowing off the
surviving replica, and (4) waits for the supervisor to heal the fleet
back to two members before a final round of traffic.

Self-contained: the fleet is spun up by the demo itself (a healing demo
needs a replica it is allowed to kill).  ``-u`` is accepted for harness
compatibility and ignored.  The replicas run on ``--device`` (the card
unless ``cpu``).  In production run the fleet as its own process tree:
``python -m tpuserver_torch.fleet_cli --models fixtures ...``.

    PYTHONPATH=src/python python src/python/examples/simple_fleet_torch.py \\
        [--device cpu]
"""

import argparse
import os
import signal
import sys
import time

import numpy as np

import tritonclient.http as httpclient
from tpuserver_torch.fleet import FleetSupervisor

SRC_PYTHON = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-v", "--verbose", action="store_true")
    parser.add_argument("-u", "--url", default=None,
                        help="ignored: this demo kills its own "
                             "supervised replica processes")
    parser.add_argument("-n", "--requests", type=int, default=8)
    parser.add_argument("--device", default=None,
                        help="the replicas' device: the card unless 'cpu'")
    return parser.parse_args(argv)


def replica_command(device):
    """The argv template of one replica process."""
    command = [sys.executable, "-m", "tpuserver_torch.serve",
               "--models", "fixtures", "--port", "{port}",
               "--fault-scope", "{scope}"]
    if device is not None:
        command += ["--device", device]
    return command


def main(argv=None):
    args = parse_args(argv)
    pythonpath = os.pathsep.join(
        p for p in (SRC_PYTHON, os.environ.get("PYTHONPATH")) if p)
    supervisor = FleetSupervisor(
        replica_command(args.device), replicas=2, min_replicas=2,
        max_replicas=2, probe_interval_s=0.15, probe_timeout_s=5.0,
        unhealthy_after=20, start_timeout_s=120.0, drain_grace_s=5.0,
        restart_backoff_s=0.05, scope_prefix="demo-fleet-r",
        router_kwargs={"probe_interval_s": 0.1},
        env={"PYTHONPATH": pythonpath}, verbose=args.verbose,
    ).start()
    failures = []
    try:
        if not supervisor.wait_ready(timeout_s=120):
            raise SystemExit("fleet never became ready")
        print("router:   {}".format(supervisor.router.url))
        for rep in supervisor.stats()["replicas"]:
            print("replica:  {url} [{scope}] pid={pid}".format(**rep))

        client = httpclient.InferenceServerClient(supervisor.router.url)
        data = np.arange(16, dtype=np.int32)
        inputs = [httpclient.InferInput("INPUT0", [16], "INT32"),
                  httpclient.InferInput("INPUT1", [16], "INT32")]
        inputs[0].set_data_from_numpy(data)
        inputs[1].set_data_from_numpy(np.ones(16, dtype=np.int32))

        def traffic(label):
            ok = 0
            for i in range(args.requests):
                try:
                    result = client.infer("simple", inputs)
                    if np.array_equal(result.as_numpy("OUTPUT0"),
                                      data + 1):
                        ok += 1
                    else:
                        failures.append(
                            "{}: wrong result at {}".format(label, i))
                except Exception as e:  # noqa: BLE001 — counted
                    failures.append("{}: request {} failed: {}".format(
                        label, i, e))
            print("{}: {}/{} requests ok".format(
                label, ok, args.requests))

        traffic("healthy fleet")

        victim = supervisor.stats()["replicas"][0]
        print("--- SIGKILL replica {} (pid {}) ---".format(
            victim["url"], victim["pid"]))
        os.kill(victim["pid"], signal.SIGKILL)
        time.sleep(0.3)  # let routing notice; the survivor carries on
        traffic("one replica dead")

        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            stats = supervisor.stats()
            if stats["replica_restarts"] >= 1 and stats["up"] == 2:
                break
            time.sleep(0.1)
        stats = supervisor.stats()
        print("healed: restarts={} up={} retired={}".format(
            stats["replica_restarts"], stats["up"],
            stats["retired_replicas"]))
        if stats["replica_restarts"] < 1 or stats["up"] != 2:
            failures.append("supervisor never healed the fleet: "
                            "{}".format(stats))
        replaced = next(r for r in stats["replicas"]
                        if r["index"] == victim["index"])
        if replaced["pid"] == victim["pid"]:
            failures.append("replica was not actually respawned")

        traffic("healed fleet")
        client.close()
    finally:
        supervisor.stop()

    if failures:
        for failure in failures:
            print("FAIL: {}".format(failure))
        return 1
    print("PASS: a SIGKILL'd replica process was respawned and the "
          "fleet healed with zero client-visible errors")
    return 0


if __name__ == "__main__":
    sys.exit(main())
