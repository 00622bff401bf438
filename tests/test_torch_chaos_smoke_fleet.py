"""The port's chaos soak over a router and a fleet on the CPU:
``--router`` (two in-process float32 ``tiny`` replicas behind the port's
``FleetRouter``, one SIGTERM-drained and revived and live streams severed
each cycle; also with ``--spec-tokens 2``) and ``--fleet`` (two
``python -m tpuserver_torch.serve`` processes under a ``FleetSupervisor``,
one SIGKILLed each cycle) exit 0 with their OK lines.

Two faults of the fleet tier that ``--fleet`` found, shared with the
JAX package's router, repaired in the port and pinned here: the fleet
``/metrics`` view missed a respawned replica whose counter had caught up
to its predecessor's (the counter never dropped), and a replica's load
read by a probe while a stream was live outweighed the prefix-affinity
bonus once the stream had ended, so the prompt's next sibling landed on
a cold replica."""

import subprocess
import sys
import time

import pytest

from torch_port_helpers import chaos_cli as run_cli
from tpuserver_torch import fleet_router
from tpuserver_torch.chaos_campaign import generate_stream
from tpuserver_torch.chaos_smoke import STUB
from tpuserver_torch.fleet import _free_port

pytestmark = pytest.mark.torch_port


@pytest.mark.parametrize("args, ok", [
    (["--router", "--cycles", "1", "--soak", "2"],
     "router chaos smoke OK: 1 drain/sever cycles"),
    (["--router", "--cycles", "1", "--soak", "2", "--spec-tokens", "2"],
     "router chaos smoke OK: 1 drain/sever cycles"),
    (["--fleet", "--cycles", "2", "--soak", "2"],
     "fleet chaos smoke OK: 2 SIGKILL cycles"),
], ids=["router", "router-spec", "fleet"])
def test_router_and_fleet_modes_exit_zero(args, ok):
    rc, out = run_cli(["--device", "cpu"] + args)
    assert rc == 0, out
    assert ok in out
    assert "INVARIANT VIOLATED" not in out


def _counter(value):
    return {"tpu_prefix_cache_hits_total": {
        "type": "counter", "help": "hits",
        "samples": [("tpu_prefix_cache_hits_total", {}, value)]}}


def _total(text):
    return next(float(line.split()[-1]) for line in text.splitlines()
                if line.startswith("tpu_prefix_cache_hits_total"))


def test_metrics_view_folds_a_respawn_that_caught_up():
    """A replica with 16 hits is replaced by a new process (another
    identity) at the same url that reaches 16 again: the fleet view
    reads 32.  The same process scraped twice at 16 stays 16, and a
    scrape with no identity falls back to the drop rule."""
    agg = fleet_router._FleetMetricsAggregator()
    url = "127.0.0.1:1"
    assert _total(agg.render([url], {url: _counter(16)},
                             identities={url: (10, None)})) == 16
    assert _total(agg.render([url], {url: _counter(16)},
                             identities={url: (10, None)})) == 16
    assert _total(agg.render([url], {url: _counter(16)},
                             identities={url: (11, "n2")})) == 32
    assert _total(agg.render([url], {url: _counter(20)})) == 36
    assert _total(agg.render([url], {url: _counter(4)})) == 40


def test_a_finished_stream_refreshes_its_replicas_load():
    """A stub replica behind the port's router with its prober off: its
    cached load is set stale-busy, one stream runs through the router,
    and by the time the client has read the final marker the router has
    probed the replica again and reads it idle."""
    port = _free_port("127.0.0.1")
    proc = subprocess.Popen([sys.executable, STUB, "--port", str(port)])
    url = "127.0.0.1:{}".format(port)
    router = fleet_router.FleetRouter([url])
    router._probe_loop_one = lambda rep: None  # only the relay probes
    rep = router.replica_by_url(url)
    try:
        deadline = time.monotonic() + 20
        while router._fetch_snapshot(rep) is None:
            assert time.monotonic() < deadline, "the stub never answered"
            time.sleep(0.05)
        router.start()
        rep.update_snapshot({"ready": True, "state": "ready",
                             "inflight": 1, "models": {
                                 "stub": {"live_streams": 1}}})
        assert rep.routable()[1] == 2
        events = list(generate_stream([router.url], "stub", [5, 7, 9], 4))
        assert len(events) == 4
        assert rep.routable() == (True, 0.0, False)
    finally:
        router.stop()
        proc.kill()
        proc.wait(timeout=10)
