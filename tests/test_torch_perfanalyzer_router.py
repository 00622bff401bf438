"""The port's perf analyzer pointed at a fleet router, held against the
JAX package's (``perfanalyzer``, ``tools/perf_analyzer.py``):

- ``attach_router_delta`` on the same synthetic before/after snapshots
  gives the same dict as JAX's, for each counter family the router may
  carry (the bare four, ejections/hedges, takeovers/recovered, the
  supervisor's, a nested ``disagg`` with ``fallbacks``) and with one
  snapshot missing, which leaves the result as it was;
- the table's router/supervisor footer of the same rows is JAX's, line
  for line;
- ``HttpBackend.router_snapshot`` returns the counters of the port's
  ``FleetRouter``, sends one request to a plain port replica and then
  none, and sends none for a url with no port;
- ``python -m tpuserver_torch.perf_analyzer`` through the port's
  ``FleetRouter`` over two float32 ``tiny`` replicas whose streams are
  severed (the ``http.generate_stream`` fault point in each replica's
  scope) exits 0 with zero errors, its row carries the ``router_*``
  deltas and its table the footer (the twin of JAX's
  ``test_cli_generation_through_router_reports_handoffs``);
- through a supervised fleet of two ``tpuserver_torch.serve`` replicas
  with one SIGKILL in the window, the row carries the ``supervisor_*``
  deltas and the table ``supervisor restarts=`` (the twin of JAX's
  ``test_cli_through_supervised_fleet_surfaces_restart_counters``)."""

import copy
import dataclasses
import io
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from perfanalyzer import metrics as jax_metrics
from perfanalyzer.report import ReportWriter as JaxWriter
from tpuserver_torch import fault_points
from tpuserver_torch.core import InferenceServer, InferRequest
from tpuserver_torch.fleet import FleetSupervisor
from tpuserver_torch.fleet_router import FleetRouter
from tpuserver_torch.http_server import HttpServer
from tpuserver_torch.models import default_models
from tpuserver_torch.models import llama as tl
from tpuserver_torch.models.llama_serving import LlamaGenerateModel
from tpuserver_torch.perfanalyzer import client_backend
from tpuserver_torch.perfanalyzer import metrics
from tpuserver_torch.perfanalyzer.report import ReportWriter

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
SRC_PY = os.path.join(REPO, "src", "python")
sys.path.insert(0, HERE)
from torch_port_helpers import one_torch_thread, wait_for  # noqa: E402,F401

pytestmark = pytest.mark.torch_port

ROUTER_KEYS = ("router_failovers", "router_handoffs",
               "router_resumed_streams", "router_shed")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC_PY
    env["CUDA_VISIBLE_DEVICES"] = ""
    env["OMP_NUM_THREADS"] = "1"
    return env


def _run_cli(args, timeout=240):
    proc = subprocess.run(
        [sys.executable, "-m", "tpuserver_torch.perf_analyzer"] + args,
        capture_output=True, text=True, timeout=timeout, env=_env(),
        cwd=REPO)
    rows = [json.loads(line) for line in proc.stdout.splitlines()
            if line.startswith('{"')]
    return proc, rows


# -- attach_router_delta against JAX's ---------------------------------------


_BARE = ({"failovers": 1, "handoffs": 2, "resumed_streams": 3, "shed": 4},
         {"failovers": 3, "handoffs": 7, "resumed_streams": 4, "shed": 4})


def _snapshots(shape):
    before, after = (dict(s) for s in _BARE)
    if shape == "ejections_hedges":
        before.update(ejections=1, hedges=5)
        after.update(ejections=4, hedges=9)
        # a family on one side only must not make up a delta
        after["takeovers"] = 2
    elif shape == "takeovers_recovered":
        before.update(takeovers=0, recovered_generations=3)
        after.update(takeovers=1, recovered_generations=8)
        before["ejections"] = 6
    elif shape == "supervisor":
        for i, key in enumerate(metrics.SUPERVISOR_COUNTERS[:-1]):
            before[key] = i
            after[key] = 2 * i + 1
        after[metrics.SUPERVISOR_COUNTERS[-1]] = 5
    elif shape == "disagg":
        before["disagg"] = {
            "splits": 2, "transfers": 1, "transfer_bytes": 4096,
            "transfer_ms_total": 1.5, "prefill_queue_ms_total": 3.0,
            "fallbacks": {"no_decode": 1}}
        after["disagg"] = {
            "splits": 6, "transfers": 4, "transfer_bytes": 16384,
            "transfer_ms_total": 7.5, "prefill_queue_ms_total": 11.0,
            "fallbacks": {"no_decode": 2, "export_missing": 3}}
    elif shape == "disagg_idle":
        # no split in the window: deltas of 0 and no per-phase columns
        before["disagg"] = {"splits": 2, "transfers": 1,
                            "transfer_ms_total": 1.5, "fallbacks": {}}
        after["disagg"] = dict(before["disagg"], transfer_bytes=0)
    elif shape == "before_none":
        before = None
    elif shape == "after_none":
        after = None
    return before, after


@pytest.mark.parametrize("shape", [
    "bare", "ejections_hedges", "takeovers_recovered", "supervisor",
    "disagg", "disagg_idle", "before_none", "after_none"])
def test_attach_router_delta_matches_jax(shape):
    before, after = _snapshots(shape)
    results = []
    for attach in (metrics.attach_router_delta,
                   jax_metrics.attach_router_delta):
        result = {"level": 4, "errors": 0}
        attach(result, copy.deepcopy(before), copy.deepcopy(after))
        results.append(result)
    assert results[0] == results[1]
    assert metrics.SUPERVISOR_COUNTERS == jax_metrics.SUPERVISOR_COUNTERS
    port = results[0]
    if shape.endswith("_none"):
        assert port == {"level": 4, "errors": 0}
        return
    assert port["router_handoffs"] == 5 and port["router_shed"] == 0
    if shape == "ejections_hedges":
        assert (port["router_ejections"], port["router_hedges"]) == (3, 4)
        assert "router_takeovers" not in port
    if shape == "takeovers_recovered":
        assert port["router_recovered_generations"] == 5
        assert "router_ejections" not in port
    if shape == "supervisor":
        assert metrics.SUPERVISOR_COUNTERS[-1] not in port
        assert port["supervisor_scale_up_events"] == 2
    if shape == "disagg":
        assert port["disagg_fallbacks"] == 4
        assert port["prefill_queue_ms"] == pytest.approx(2.0)
        assert port["kv_transfer_ms"] == pytest.approx(2.0)
    if shape == "disagg_idle":
        assert port["disagg_splits"] == 0
        assert "disagg_transfer_bytes" not in port
        assert "prefill_queue_ms" not in port


# -- the table's footer against JAX's ----------------------------------------


def _footer_rows(mode):
    common = {"mode": mode, "throughput": 10.0, "errors": 0,
              "stable": True, "tokens": 40, "generations": 5}
    return [
        dict(common, level=1, router_failovers=0, router_handoffs=2,
             router_resumed_streams=1, router_shed=0),
        # this level's snapshot failed for a moment: no line
        dict(common, level=2),
        dict(common, level=3, router_failovers=1, router_handoffs=0,
             router_resumed_streams=0, router_shed=3, router_ejections=2,
             router_hedges=1, router_takeovers=1,
             router_recovered_generations=4,
             supervisor_replica_restarts=1, supervisor_scale_up_events=0,
             supervisor_scale_down_events=0, supervisor_retired_replicas=0,
             supervisor_adoptions=2, disagg_splits=3,
             prefill_queue_ms=1.25, kv_transfer_ms=0.5),
    ]


@pytest.mark.parametrize("mode", ["concurrency", "generation_concurrency"])
def test_footer_matches_jax(mode):
    rows = _footer_rows(mode)
    out = {}
    for side, cls in (("port", ReportWriter), ("jax", JaxWriter)):
        buf = io.StringIO()
        cls("llama_generate", "http").print_table(
            [dict(r) for r in rows], file=buf)
        out[side] = buf.getvalue().splitlines()
    footer = [line for line in out["port"] if line.startswith("  level ")]
    assert footer == [line for line in out["jax"]
                      if line.startswith("  level ")]
    assert footer == [
        "  level 1: router failovers=0 handoffs=2 resumed_streams=1 "
        "shed=0",
        "  level 3: router failovers=1 handoffs=0 resumed_streams=0 "
        "shed=3 ejections=2 hedges=1 takeovers=1 recovered=4 | "
        "supervisor restarts=1 scale_up=0 scale_down=0 retired=0 "
        "adoptions=2"]
    assert out["port"] == out["jax"]
    if mode.startswith("generation"):
        # the per-phase columns fill from the disagg deltas
        assert "1.25" in out["port"][-3] and "0.50" in out["port"][-3]
    # no router counters: no footer
    buf = io.StringIO()
    ReportWriter("m", "http").print_table(
        [{"mode": mode, "level": 1, "throughput": 1.0}], file=buf)
    assert "router failovers=" not in buf.getvalue()


# -- router_snapshot ---------------------------------------------------------


class _Counted(client_backend.HttpBackend):
    """The port's HTTP backend counting the requests it sends by path."""

    def __init__(self, url):
        super().__init__(url)
        self.sent = []

    def _call(self, method, path, body=None, headers=None):
        self.sent.append(path)
        return super()._call(method, path, body, headers)


@pytest.fixture(scope="module")
def replicas():
    """Two port servers on the CPU (the fixture models and a float32
    ``tiny`` llama behind four slots, in scopes ``pa-router-a`` and
    ``-b``), each warmed and behind its own HTTP server.  Yields their
    urls."""
    cfg = dataclasses.replace(tl.tiny(vocab=512), dtype=torch.float32)
    cores, https = [], []
    for scope in ("pa-router-a", "pa-router-b"):
        model = LlamaGenerateModel(cfg=cfg, max_seq=64, max_slots=4,
                                   device="cpu", fault_scope=scope,
                                   restart_backoff_s=0.01)
        core = InferenceServer(default_models() + [model],
                               fault_scope=scope)
        model.warmup()
        req = InferRequest("llama_generate", inputs={
            "PROMPT_IDS": np.array([3, 1, 4, 1], np.int32),
            "MAX_TOKENS": np.array([4], np.int32)})
        for _ in core.infer_stream(req):
            pass
        cores.append(core)
        https.append(HttpServer(core, port=0).start())
    try:
        yield ["127.0.0.1:{}".format(h.port) for h in https]
    finally:
        for h in https:
            h.stop()
        for core in cores:
            core.close()


@pytest.fixture
def router(replicas):
    router = FleetRouter(replicas, probe_interval_s=0.1).start()
    try:
        wait_for(lambda: sum(r["eligible"] for r in
                             router.stats()["replicas"]) == 2,
                 "both replicas eligible")
        yield router
    finally:
        router.stop()


def test_router_snapshot_reads_the_port_router(router):
    backend = _Counted(router.url)
    try:
        snap = backend.router_snapshot()
        stats = router.stats()
        for key in ("failovers", "handoffs", "resumed_streams", "shed",
                    "ejections", "hedges", "takeovers",
                    "recovered_generations"):
            assert snap[key] == stats[key], key
        assert snap["disagg"]["splits"] == stats["disagg"]["splits"]
        assert snap["disagg"]["fallbacks"] == stats["disagg"]["fallbacks"]
        # no supervisor behind this router: no supervisor family
        assert not any(k.startswith("supervisor_") for k in snap)
        assert backend.router_snapshot() is not None
        assert backend.sent == ["/router/stats"] * 2
    finally:
        backend.close()


def test_router_snapshot_of_a_plain_replica_costs_one_request(replicas):
    backend = _Counted(replicas[0])
    try:
        for _ in range(3):
            assert backend.router_snapshot() is None
        assert backend.sent == ["/router/stats"]
    finally:
        backend.close()


def test_router_snapshot_of_a_portless_url_sends_nothing():
    backend = _Counted("localhost")
    try:
        assert backend.router_snapshot() is None
        assert backend.router_snapshot() is None
        assert backend.sent == []
    finally:
        backend.close()
    for cls in (client_backend.ClientBackend,
                client_backend.GrpcBackend,
                client_backend.InProcessBackend):
        # the base class's None: only HTTP reaches /router/stats
        assert cls.router_snapshot is \
            client_backend.ClientBackend.router_snapshot


# -- the CLI through the port's router ---------------------------------------


def test_cli_generation_through_router_reports_handoffs(router):
    """Live replica streams are severed mid-generation: the router
    absorbs every sever (a handoff once tokens flowed, a failover
    before), the run exits 0 with zero errors, and the row and the
    table carry the router's deltas."""
    for scope in ("pa-router-a", "pa-router-b"):
        fault_points.install("http.generate_stream", mode="raise",
                             times=3, skip=8, scope=scope)
    try:
        proc, rows = _run_cli([
            "-m", "llama_generate", "--backend", "http",
            "-u", router.url, "--generation",
            "--concurrency-range", "2", "--max-tokens", "8",
            "--measurement-interval", "400", "--max-trials", "5",
            "--warmup", "0.1"])
        absorbed = router.stats()
    finally:
        fault_points.clear("http.generate_stream")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert len(rows) == 1
    row = rows[0]
    assert row["value"] > 0 and row["tokens"] > 0
    assert row["errors"] == 0
    # cumulative over the whole run: warm-up severs count here only
    assert absorbed["handoffs"] + absorbed["failovers"] > 0, absorbed
    for key in ROUTER_KEYS + ("router_ejections", "router_hedges",
                              "router_takeovers",
                              "router_recovered_generations",
                              "disagg_splits", "disagg_fallbacks"):
        assert key in row and row[key] >= 0, (key, row)
    assert "router failovers=" in proc.stdout


def test_cli_through_supervised_fleet_surfaces_restart_counters():
    """One replica PROCESS of a supervised fleet is SIGKILLed inside the
    level's windows: the run exits 0, and the row and the table carry
    the supervisor's healing deltas beside the router's."""
    command = [sys.executable, "-m", "tpuserver_torch.serve", "--device",
               "cpu", "--models", "fixtures", "--port", "{port}",
               "--fault-scope", "{scope}"]
    supervisor = FleetSupervisor(
        command, replicas=2, min_replicas=2, max_replicas=2,
        probe_interval_s=0.15, probe_timeout_s=5.0, unhealthy_after=20,
        start_timeout_s=120.0, drain_grace_s=5.0, max_restarts=6,
        restart_window_s=3600.0, restart_backoff_s=0.05,
        scope_prefix="pa-fleet-r", router_kwargs={"probe_interval_s": 0.1},
        env={"PYTHONPATH": SRC_PY, "OMP_NUM_THREADS": "1",
             "CUDA_VISIBLE_DEVICES": ""}).start()
    try:
        assert supervisor.wait_ready(timeout_s=120)

        def kill_one():
            time.sleep(1.6)  # lands inside the level's windows
            ups = [r for r in supervisor.stats()["replicas"]
                   if r["state"] == "up" and r["pid"]]
            if ups:
                os.kill(ups[-1]["pid"], signal.SIGKILL)

        killer = threading.Thread(target=kill_one, daemon=True)
        killer.start()
        proc, rows = _run_cli([
            "-m", "simple", "--backend", "http",
            "-u", supervisor.router.url, "--concurrency-range", "2",
            "--measurement-interval", "600", "--max-trials", "8",
            "--warmup", "0.5"])
        killer.join(timeout=30)
        wait_for(lambda: supervisor.stats()["replica_restarts"] >= 1,
                 "the restart")
        stats = supervisor.stats()
    finally:
        supervisor.stop()
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert len(rows) == 1
    row = rows[0]
    # a mid-request SIGKILL may surface one typed 502 by design: the
    # counters are checked here, not zero-error unary semantics
    for key in ROUTER_KEYS[:2] + metrics.SUPERVISOR_COUNTERS[:4]:
        assert key in row and row[key] is not None, (key, row)
    assert stats["replica_restarts"] >= 1
    assert stats["retired_replicas"] == 0
    assert "supervisor restarts=" in proc.stdout
