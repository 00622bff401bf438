"""The port's chaos soak over ``tests/fleet_stub.py`` replicas on the CPU:
``--gray``, ``--router-kill``, ``--disagg``, ``--supervisor`` and
``--multi-router`` (the port's partitioned front tier: two active
``router_cli`` processes and a standby, partition 0's active SIGKILLed)
exit 0 with their OK lines; a partition-1 stream that reconnects during
the sibling's kill exits 1 with an ``INVARIANT VIOLATED`` line; and a
stream pinned to partition 1 but dialed at partition 0's owner relays the
same bytes through each package's partitioned routers over the same stub
replicas."""

import http.client
import json
import subprocess
import sys
import time

import pytest

from torch_port_helpers import chaos_cli as run_cli
from tpuserver.router import FleetRouter as JaxRouter
from tpuserver_torch import chaos_campaign, chaos_smoke
from tpuserver_torch.chaos_smoke import STUB
from tpuserver_torch.fleet import _free_port
from tpuserver_torch.fleet_router import FleetRouter

pytestmark = pytest.mark.torch_port


@pytest.mark.parametrize("args, ok", [
    (["--gray", "--cycles", "1"], "gray chaos smoke OK: 1 gray cycles"),
    (["--router-kill", "--cycles", "2", "--soak", "2"],
     "router-kill chaos smoke OK: 2 active-router SIGKILL cycles"),
    (["--disagg", "--cycles", "2", "--soak", "2"],
     "disagg chaos smoke OK: 2 prefill-SIGKILL cycles"),
    (["--supervisor", "--cycles", "1", "--soak", "2"],
     "supervisor chaos smoke OK: 1 supervisor-SIGKILL cycles"),
    (["--multi-router", "--cycles", "2"],
     "multi-router chaos smoke OK: 2 partitioned-tier SIGKILL cycles"),
], ids=["gray", "router-kill", "disagg", "supervisor", "multi-router"])
def test_stub_mode_exits_zero(args, ok):
    rc, out = run_cli(args)
    assert rc == 0, out
    assert ok in out
    assert "INVARIANT VIOLATED" not in out


def test_a_reconnecting_partition_1_stream_exits_one(monkeypatch, capsys):
    """Every partition-1 stream (dialed at its owner with no reconnect
    allowed) reports one reconnect: the blast-radius check fails the
    run."""
    stream = chaos_smoke.stream_generation

    def reconnecting(urls, model, prompt, budget, parameters=None,
                     max_reconnects=10, on_reconnect=None):
        if max_reconnects == 0 and on_reconnect is not None:
            on_reconnect(1, ConnectionError("planted drop"))
        return stream(urls, model, prompt, budget, parameters,
                      max_reconnects, on_reconnect)

    monkeypatch.setattr(chaos_smoke, "stream_generation", reconnecting)
    assert chaos_smoke.main(["--multi-router", "--cycles", "1"]) == 1
    err = capsys.readouterr().err
    assert "INVARIANT VIOLATED: " in err
    assert "on surviving partition 1 reconnected 1 time(s)" in err
    assert "multi-router chaos smoke FAILED" in err


def _body_bytes(url, gid):
    host, _, port = url.rpartition(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=30)
    try:
        conn.request("POST", "/v2/models/stub/generate_stream", json.dumps({
            "inputs": [
                {"name": "PROMPT_IDS", "datatype": "INT32", "shape": [3],
                 "data": [5, 7, 9]},
                {"name": "MAX_TOKENS", "datatype": "INT32", "shape": [1],
                 "data": [8]}],
            "parameters": {"generation_id": gid}}),
            {"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200
        return resp.read()
    finally:
        conn.close()


def test_peer_relay_bytes_equal_across_packages():
    """Two stub replicas; for each package, two partitioned routers
    (partition 0 and 1 of 2, each other's peers).  A generation pinned to
    partition 1 and dialed at partition 0's router is forwarded to its
    owner, and the client reads the same bytes from either package."""
    ports = [_free_port("127.0.0.1") for _ in range(2)]
    procs = [subprocess.Popen([sys.executable, STUB, "--port", str(p)])
             for p in ports]
    backends = ["127.0.0.1:{}".format(p) for p in ports]
    gid = chaos_smoke.pin_gid(1, "relay")
    bodies = {}
    try:
        for p in ports:
            assert chaos_campaign.wait_ready(p)
        for name, cls in (("jax", JaxRouter), ("port", FleetRouter)):
            rports = [_free_port("127.0.0.1") for _ in range(2)]
            peers = ["127.0.0.1:{}".format(p) for p in rports]
            routers = [cls(backends, port=rports[k], probe_interval_s=0.1,
                           partition_index=k, partition_count=2,
                           peers=peers).start() for k in range(2)]
            try:
                deadline = time.monotonic() + 20
                while not all(any(r["eligible"] for r in router.stats()[
                        "replicas"]) for router in routers):
                    assert time.monotonic() < deadline
                    time.sleep(0.05)
                before = routers[0].stats()["partition"]["forwarded"]
                bodies[name] = _body_bytes(peers[0], gid)
                assert routers[0].stats()["partition"]["forwarded"] == \
                    before + 1
                assert routers[1].stats()["partition"]["owned"] >= 1
            finally:
                for router in routers:
                    router.stop()
    finally:
        for proc in procs:
            proc.kill()
            proc.wait(timeout=10)
    assert bodies["port"] == bodies["jax"]
    assert bodies["port"].count(b"data: ") == 9  # 8 tokens and the final
