"""The port's fleet supervisor (``tpuserver_torch.fleet`` and
``python -m tpuserver_torch.fleet_cli``) over ``tests/fleet_stub.py``
replicas, and over the port's own server:

- it spawns replicas behind the port's router, heals a SIGKILL on the
  same port with a new pid, and scales up under queue pressure and
  back down when it clears;
- a supervisor restarted on the same manifest adopts the fleet (same
  pids, no respawn), and so does the port's supervisor on a manifest
  the JAX package's wrote, and the JAX package's on the port's;
- ``fleet_cli`` from a path that holds the port alone runs a
  phase-split fleet of ``tpuserver_torch.serve`` replicas (float32 is
  not needed: ``--config tiny --device cpu``) behind ``router_cli``
  processes, hands it over on SIGTERM, is adopted by a second
  supervisor, and stops every child on SIGINT; the tokens equal the
  same weights' in-process generation.

Every wait polls under a deadline; every supervisor is stopped and
every child reaped in a ``finally``."""

import http.client
import json
import os
import shutil
import signal
import subprocess
import sys
import threading

import numpy as np
import pytest

from tpuserver.fleet import FleetSupervisor as JaxSupervisor
from tpuserver_torch import fleetmanifest
from tpuserver_torch.fleet import FleetSupervisor

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
SRC_PY = os.path.join(REPO, "src", "python")
STUB = os.path.join(HERE, "fleet_stub.py")
sys.path.insert(0, HERE)
from torch_port_helpers import one_torch_thread, wait_for  # noqa: E402,F401

pytestmark = pytest.mark.torch_port

SUPERVISORS = {"jax": JaxSupervisor, "port": FleetSupervisor}


def _stub_command():
    return [sys.executable, STUB, "--port", "{port}", "--scope", "{scope}"]


def _supervisor(cls, replicas=2, **kw):
    kw.setdefault("min_replicas", replicas)
    kw.setdefault("max_replicas", replicas)
    kw.setdefault("probe_interval_s", 0.1)
    kw.setdefault("probe_timeout_s", 0.5)
    kw.setdefault("start_timeout_s", 20.0)
    kw.setdefault("drain_grace_s", 3.0)
    kw.setdefault("restart_backoff_s", 0.05)
    kw.setdefault("scale_cooldown_s", 0.3)
    kw.setdefault("scope_prefix", "stub-r")
    kw.setdefault("router_kwargs", {"probe_interval_s": 0.1})
    return cls(_stub_command(), replicas=replicas, **kw)


def _http(url, method, path, body=None):
    host, _, port = url.rpartition(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=10)
    try:
        conn.request(method, path, body=None if body is None
                     else json.dumps(body).encode("utf-8"),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read() or b"null")
    finally:
        conn.close()


def _members(sup):
    status, body = _http(sup.router.url, "GET", "/router/replicas")
    assert status == 200
    return {r["url"] for r in body["replicas"]}


def _stub_stream(router_url, gid, n=6):
    """One stub generation through the router: its tokens."""
    host, _, port = router_url.rpartition(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=30)
    body = json.dumps({"inputs": [
        {"name": "PROMPT_IDS", "datatype": "INT32", "shape": [3],
         "data": [5, 7, 9]},
        {"name": "MAX_TOKENS", "datatype": "INT32", "shape": [1],
         "data": [n]}], "parameters": {"generation_id": gid}})
    tokens = []
    try:
        conn.request("POST", "/v2/models/stub/generate_stream", body,
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200, (resp.status, resp.read())
        for raw in resp:
            if raw.startswith(b"data: "):
                event = json.loads(raw[len(b"data: "):])
                if event.get("final"):
                    return tokens
                tokens.append(event["outputs"][0]["data"][0])
    finally:
        conn.close()
    raise AssertionError("no final event: {}".format(tokens))


def _alive(pid):
    return fleetmanifest.process_start_token(pid) is not None


# -- healing and scaling ------------------------------------------------------


def test_supervisor_heals_a_sigkilled_replica():
    """A SIGKILL is an unplanned death: the replica respawns on its
    port with a new pid, rejoins the router's membership, and the
    fleet serves; no replica is retired."""
    sup = _supervisor(FleetSupervisor).start()
    try:
        assert sup.wait_ready(timeout_s=30)
        assert _members(sup) == {r["url"] for r in sup.stats()["replicas"]}
        victim = sup.stats()["replicas"][0]
        os.kill(victim["pid"], signal.SIGKILL)
        wait_for(lambda: sup.stats()["replica_restarts"] >= 1, "a restart")
        wait_for(lambda: sup.stats()["up"] == 2, "both replicas up again")
        healed = next(r for r in sup.stats()["replicas"]
                      if r["index"] == victim["index"])
        assert healed["pid"] != victim["pid"]
        assert healed["url"] == victim["url"]
        wait_for(lambda: _members(sup) == {
            r["url"] for r in sup.stats()["replicas"]}, "the membership")
        assert _stub_stream(sup.router.url, "healed") == \
            _stub_stream(sup.router.url, "again")
        assert sup.stats()["retired_replicas"] == 0
    finally:
        sup.stop()


def test_wait_ready_returns_only_after_the_replica_joined_the_router():
    """A healed replica joins the router before it reads ``up``: with
    ``_join_router`` held on an event, ``wait_ready()`` does not return
    and the router does not list the replica; once the join runs, both
    hold.  (The JAX package's supervisor sets ``up`` first and joins
    after, a window in which a caller that trusts ``wait_ready()`` meets
    a router without the replica.)"""
    sup = _supervisor(FleetSupervisor).start()
    release = threading.Event()
    entered = threading.Event()
    joined = []
    try:
        assert sup.wait_ready(timeout_s=30)
        join = sup._join_router

        def held_join(handle):
            entered.set()
            release.wait(60)
            join(handle)
            joined.append(handle.url)

        sup._join_router = held_join
        victim = sup.stats()["replicas"][0]
        os.kill(victim["pid"], signal.SIGKILL)
        wait_for(lambda: sup.stats()["replica_restarts"] >= 1, "a restart")
        wait_for(entered.is_set, "the respawned replica's join")
        assert victim["url"] not in _members(sup)
        assert not sup.wait_ready(timeout_s=1.0)
        release.set()
        assert sup.wait_ready(timeout_s=30)
        assert joined == [victim["url"]]
        assert victim["url"] in _members(sup)
    finally:
        release.set()
        sup.stop()


def test_supervisor_scales_up_under_load_and_back_down():
    """Queue pressure alone (a stub's ``pending`` 16) scales 1 -> 2 and
    the router's membership follows; once it clears, the fleet drains
    back to ``min_replicas``."""
    sup = _supervisor(FleetSupervisor, replicas=1, min_replicas=1,
                      max_replicas=3, scale_high=0.8, scale_low=0.1,
                      scale_up_windows=3, scale_down_windows=4).start()
    try:
        assert sup.wait_ready(timeout_s=30)
        url0 = sup.stats()["replicas"][0]["url"]
        _http(url0, "POST", "/stub/state", {"pending": 16})
        wait_for(lambda: sup.stats()["scale_up_events"] == 1, "a scale-up")
        wait_for(lambda: sup.stats()["up"] == 2, "two replicas up")
        urls = {r["url"] for r in sup.stats()["replicas"]}
        wait_for(lambda: _members(sup) == urls, "the grown membership")
        _http(url0, "POST", "/stub/state", {"pending": 0})
        wait_for(lambda: sup.stats()["scale_down_events"] == 1,
                 "a scale-down")
        wait_for(lambda: len(sup.stats()["replicas"]) == 1
                 and sup.stats()["up"] == 1, "one replica left")
        wait_for(lambda: _members(sup) == {url0}, "the shrunk membership")
    finally:
        sup.stop()


# -- adoption from a manifest --------------------------------------------------


@pytest.mark.parametrize("first,second", [
    ("port", "port"), ("jax", "port"), ("port", "jax")],
    ids=["port-adopts-port", "port-adopts-jax", "jax-adopts-port"])
def test_restarted_supervisor_adopts_the_fleet(tmp_path, first, second):
    """A phase-split stub fleet under a manifest; the first supervisor
    hands over (children keep serving), and a second one on the same
    manifest adopts both replicas: the same pids, the restart counters
    carried, the adoptions counter 2, no respawn; the fleet then heals
    a SIGKILL under its new supervisor."""
    manifest = str(tmp_path / "manifest")
    sup = _supervisor(SUPERVISORS[first], prefill_replicas=1,
                      decode_replicas=1, min_replicas=1, max_replicas=1,
                      manifest_dir=manifest).start()
    succ = None
    pids = []
    try:
        assert sup.wait_ready(timeout_s=30)
        before = {r["index"]: r for r in sup.stats()["replicas"]}
        pids = [r["pid"] for r in before.values()]
        sup.handover()
        assert all(_alive(pid) for pid in pids)
        succ = _supervisor(SUPERVISORS[second], prefill_replicas=1,
                           decode_replicas=1, min_replicas=1,
                           max_replicas=1, manifest_dir=manifest).start()
        assert succ.wait_ready(timeout_s=30)
        stats = succ.stats()
        assert stats["adoptions"] == 2 and stats["clean_handovers"] == 1
        assert {r["index"]: (r["pid"], r["role"], r["restarts"])
                for r in stats["replicas"]} == {
            i: (r["pid"], r["role"], r["restarts"])
            for i, r in before.items()}
        wait_for(lambda: succ.stats()["phase_replicas_up"] == {
            "prefill": 1, "decode": 1}, "both pools routed")
        victim = stats["replicas"][0]
        os.kill(victim["pid"], signal.SIGKILL)
        wait_for(lambda: succ.stats()["replica_restarts"] == 1
                 and succ.stats()["up"] == 2, "the adopted fleet healed")
    finally:
        if succ is not None:
            succ.stop()
        else:
            sup.stop()
        for pid in pids:
            if _alive(pid):
                os.kill(pid, signal.SIGKILL)


# -- the CLI over the port's server -------------------------------------------


def _isolated_path(tmp_path):
    root = tmp_path / "isolated"
    shutil.copytree(os.path.join(SRC_PY, "tpuserver_torch"),
                    str(root / "tpuserver_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    return str(root)


def _heartbeat(path):
    try:
        with open(path) as fh:
            return json.load(fh)
    except (OSError, ValueError):
        return None


def _fleet_up(path):
    beat = _heartbeat(path)
    return bool(beat and beat["routers"] and all(
        r["state"] == "up" for r in beat["replicas"] + beat["routers"]))


def _pools(router_url):
    stats = _http(router_url, "GET", "/router/stats")[1]
    if not all(r["eligible"] for r in stats["replicas"]):
        return None
    return (stats["disagg"]["prefill_replicas"],
            stats["disagg"]["decode_replicas"])


def _llama_tokens(router_url, prompt, n):
    host, _, port = router_url.rpartition(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=120)
    body = json.dumps({"inputs": [
        {"name": "PROMPT_IDS", "datatype": "INT32", "shape": [len(prompt)],
         "data": prompt},
        {"name": "MAX_TOKENS", "datatype": "INT32", "shape": [1],
         "data": [n]}]})
    tokens, seqs = [], []
    try:
        conn.request("POST", "/v2/models/llama_generate/generate_stream",
                     body, {"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200, (resp.status, resp.read())
        for raw in resp:
            line = raw.strip()
            if line.startswith(b"id: "):
                seqs.append(int(line.rsplit(b"/", 1)[1]))
            elif line.startswith(b"data: "):
                event = json.loads(line[len(b"data: "):])
                if event.get("final"):
                    assert seqs == list(range(n))
                    return tokens
                assert "error" not in event, event
                tokens.append(event["outputs"][0]["data"][0])
    finally:
        conn.close()
    raise AssertionError("no final event")


def _reference_tokens(prompts, n):
    """The same weights (``serve.py``'s: ``tiny`` from seed 0) generating
    in this process."""
    from tpuserver_torch.core import InferenceServer, InferRequest
    from tpuserver_torch.models import llama
    from tpuserver_torch.models.llama_serving import LlamaGenerateModel

    core = InferenceServer([LlamaGenerateModel(
        cfg=llama.PRESETS["tiny"](), max_seq=64, seed=0, device="cpu",
        max_slots=2)])
    try:
        out = []
        for prompt in prompts:
            req = InferRequest("llama_generate", inputs={
                "PROMPT_IDS": np.asarray(prompt, dtype=np.int32),
                "MAX_TOKENS": np.asarray([n], dtype=np.int32)})
            out.append([int(o[1][0]) for resp in core.infer_stream(req)
                        for o in resp.outputs if o[0]["name"] == "TOKEN"])
        return out
    finally:
        core.close()


def test_fleet_cli_runs_hands_over_and_stops_a_serve_fleet(tmp_path):
    """``python -m tpuserver_torch.fleet_cli`` from a path holding the
    port alone, with one prefill and one decode ``serve`` replica
    (``--config tiny --device cpu``, one torch thread) and a
    ``router_cli`` process under a manifest: 3 prompts stream the
    reference tokens (phase-split; on the CPU the decode leg's attach
    of another process's export falls back to a re-prefill); SIGTERM
    hands over with every child serving; a second CLI on the manifest
    adopts both replicas and the router (same pids, 3 adoptions, no
    spawn) and serves the same tokens; SIGINT drains every replica
    ("stopped" printed by each) and leaves no child."""
    path = _isolated_path(tmp_path)
    manifest = str(tmp_path / "manifest")
    beat = str(tmp_path / "heartbeat.json")
    env = dict(os.environ, PYTHONPATH=path, OMP_NUM_THREADS="1")
    argv = [sys.executable, "-m", "tpuserver_torch.fleet_cli",
            "--config", "tiny", "--device", "cpu", "--max-seq", "64",
            "--max-slots", "2", "--seed", "0", "--prefill-replicas", "1",
            "--decode-replicas", "1", "--router-processes",
            "--router-port", "0", "--manifest", manifest,
            "--heartbeat-file", beat, "--probe-interval", "0.1",
            "--drain-timeout", "5", "-v"]
    rng = np.random.RandomState(3)
    prompts = [list(map(int, rng.randint(1, 256, k))) for k in (9, 20, 4)]
    reference = _reference_tokens(prompts, 6)
    logs, procs, pids = [], [], []
    try:
        for _ in range(2):
            logs.append(open(str(tmp_path / "cli{}.log".format(len(logs))),
                             "w"))
            procs.append(subprocess.Popen(argv, env=env, cwd=path,
                                          stdout=logs[-1],
                                          stderr=subprocess.STDOUT))
            wait_for(lambda: _fleet_up(beat)
                     and _heartbeat(beat)["pid"] == procs[-1].pid,
                     "the fleet up under the CLI", timeout=120)
            first = _heartbeat(beat)
            router = first["routers"][0]["url"]
            wait_for(lambda: _pools(router) == (1, 1), "both role pools")
            splits = _http(router, "GET", "/router/stats")[1]["disagg"][
                "splits"]
            assert [_llama_tokens(router, p, 6) for p in prompts] == \
                reference
            disagg = _http(router, "GET", "/router/stats")[1]["disagg"]
            assert disagg["splits"] - splits == len(prompts), disagg
            if not pids:
                pids = [r["pid"] for r in first["replicas"]
                        + first["routers"]]
                procs[-1].send_signal(signal.SIGTERM)
                assert procs[-1].wait(timeout=30) == 0
                assert all(_alive(pid) for pid in pids)
        after = _heartbeat(beat)
        assert after["adoptions"] == 3 and after["clean_handovers"] == 1
        assert [r["pid"] for r in after["replicas"] + after["routers"]] \
            == pids
        procs[-1].send_signal(signal.SIGINT)
        assert procs[-1].wait(timeout=60) == 0
        wait_for(lambda: not any(_alive(pid) for pid in pids),
                 "every child gone")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
        for pid in pids:
            if _alive(pid):
                os.kill(pid, signal.SIGKILL)
        for log in logs:
            log.close()
    out = [open(log.name).read() for log in logs]
    assert "fleet handed over (children still serving)" in out[0]
    assert "adopted replica" in out[1] and "fleet stopped" in out[1]
    assert "spawned replica" not in out[1]
    # the replicas inherited the first CLI's output: each drained
    assert out[0].splitlines().count("stopped") == 2, out[0][-2000:]
