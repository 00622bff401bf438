"""The port as a fleet replica (tpuserver_torch.core's lifecycle and
health snapshot, http_server's ``/v2/health/*``, grpc_server's readiness
and ``serve.py`` as a process), held against the JAX package's core and
its replica entry point (``tools/fleet.py --serve-replica``) on the same
inputs, and driven by the JAX package's ``FleetSupervisor``.

Float32 ``tiny``, weights bridged from ``llama.init_params(PRNGKey(0))``
(``params_from_jax``) for the in-process cores.  Tokens must be
identical; snapshots, readiness codes, typed codes, messages and
``Retry-After`` must be equal.  Every wait polls its condition under a
deadline of its own (``wait_for``), never a fixed sleep."""

import http.client
import json
import os
import signal
import subprocess
import sys
import threading

import numpy as np
import pytest
import tritonclient.grpc as grpcclient
from tritonclient.utils import InferenceServerException

from tpuserver.core import InferenceServer as JaxServer
from tpuserver.core import InferRequest as JaxRequest
from tpuserver.core import install_sigterm_drain as jax_sigterm_drain
from tpuserver.fleet import FleetSupervisor
from tpuserver.grpc_frontend import GrpcFrontend
from tpuserver.http_frontend import HttpFrontend
from tpuserver.models.llama_serving import LlamaGenerateModel as JaxLlama
from tpuserver_torch.core import InferenceServer, InferRequest
from tpuserver_torch.core import install_sigterm_drain
from tpuserver_torch.grpc_server import GrpcServer
from tpuserver_torch.http_server import HttpServer
from tpuserver_torch.models.llama_serving import LlamaGenerateModel

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from fleet_stub import free_port  # noqa: E402
from torch_port_helpers import (  # noqa: E402,F401 (fixtures)
    WAIT_S, one_torch_thread, sse_events, tiny_cfgs, tparams, wait_for)

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_PY = os.path.join(REPO, "src", "python")
MAX_SEQ = 64
PROMPT = [3, 1, 4, 1, 5]
N_TOK = 12
STREAM_PATH = "/v2/models/llama_generate/generate_stream"
# the replica processes' decode steps each sleep this long (a fault
# point armed from the environment), so a stream outlives a SIGTERM
STEP_SLEEP_S = 0.1
REPLICA_BUDGET = 40


class _Side:
    """One package's llama core (``max_slots=2``) and, on demand, its
    HTTP front end: the verbs the tests drive on both."""

    def __init__(self, jax_side, tparams, **core_kwargs):
        jcfg, tcfg = tiny_cfgs()
        self.jax = jax_side
        if jax_side:
            self.model = JaxLlama(cfg=jcfg, max_seq=MAX_SEQ, max_slots=2)
            self.core = JaxServer([self.model], **core_kwargs)
        else:
            self.model = LlamaGenerateModel(cfg=tcfg, max_seq=MAX_SEQ,
                                            max_slots=2, params=tparams,
                                            device="cpu")
            self.core = InferenceServer([self.model], **core_kwargs)
        self.frontend = None

    def http(self):
        if self.frontend is None:
            cls = HttpFrontend if self.jax else HttpServer
            self.frontend = cls(self.core, port=0).start()
        return self.frontend.port

    def stream(self, n=N_TOK):
        cls = JaxRequest if self.jax else InferRequest
        return self.core.infer_stream(cls("llama_generate", inputs={
            "PROMPT_IDS": np.asarray(PROMPT, np.int32),
            "MAX_TOKENS": np.array([n], np.int32)}))

    @staticmethod
    def token(resp):
        arrays = {o[0]["name"]: o[1] for o in resp.outputs}
        return int(np.asarray(arrays["TOKEN"])[0])

    def tokens(self, n=N_TOK):
        return [self.token(r) for r in self.stream(n)]

    def refused(self):
        """(code, message) of a request the core refuses."""
        with pytest.raises(Exception) as err:
            self.tokens()
        return err.value.code, str(err.value)

    def close(self):
        if self.frontend is not None:
            self.frontend.stop()
        self.core.close()


@pytest.fixture
def sides(tparams):
    """``make(**core_kwargs)`` -> (JAX side, port side), closed at
    teardown."""
    made = []

    def make(**core_kwargs):
        pair = (_Side(True, tparams, **core_kwargs),
                _Side(False, tparams, **core_kwargs))
        made.extend(pair)
        return pair

    yield make
    for side in made:
        side.close()


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _body(prompt, n):
    return json.dumps({"inputs": [
        {"name": "PROMPT_IDS", "datatype": "INT32", "shape": [len(prompt)],
         "data": list(prompt)},
        {"name": "MAX_TOKENS", "datatype": "INT32", "shape": [1],
         "data": [n]}]})


def _post_stream(port, prompt=PROMPT, n=N_TOK):
    """(status, Retry-After header, parsed body or the events' tokens)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("POST", STREAM_PATH, _body(prompt, n),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        if resp.status != 200:
            return (resp.status, resp.getheader("Retry-After"),
                    json.loads(resp.read()))
        return 200, None, [event["outputs"][0]["data"][0]
                           for _, event in sse_events(resp)
                           if not event.get("final")]
    finally:
        conn.close()


# -- the health snapshot -----------------------------------------------------


def _drain_begun(side):
    side.core.begin_drain()


def _closed(side):
    side.core.close()


@pytest.mark.parametrize("core_kwargs,after", [
    ({}, None),
    ({"role": "decode", "spawn_nonce": "n-7", "max_inflight": 4}, None),
    ({"ready": False, "role": "prefill"}, None),
    ({"role": "prefill"}, _drain_begun),
    ({"spawn_nonce": "n-9"}, _closed),
], ids=["fused", "decode_nonce_cap", "starting", "draining", "stopped"])
def test_health_snapshot_matches_jax(sides, core_kwargs, after):
    """The snapshot's top-level keys and values equal JAX's in every
    lifecycle state (pid too: both cores live in this process); each
    model's JAX scheduler-stats keys are a subset of the port's, and the
    counts both keep agree after the same generation."""
    jside, tside = sides(**core_kwargs)
    port = tside.http()  # before close(): a front end's start reopens
    if core_kwargs.get("ready", True):
        assert jside.tokens() == tside.tokens()
    if after is not None:
        after(jside)
        after(tside)
    jsnap, tsnap = jside.core.health_snapshot(), tside.core.health_snapshot()
    jmodels, tmodels = jsnap.pop("models"), tsnap.pop("models")
    assert tsnap == jsnap
    assert tsnap["pid"] == os.getpid()
    assert set(tmodels) == set(jmodels) == {"llama_generate"}
    jstats, tstats = jmodels["llama_generate"], tmodels["llama_generate"]
    assert (jstats is None) == (tstats is None)
    if jstats is not None:
        assert set(jstats) <= set(tstats)
        for key in ("live_streams", "pending", "max_slots", "draining",
                    "closed", "healthy", "tripped", "restarts",
                    "quarantined", "admitted", "tokens"):
            assert tstats[key] == jstats[key], key
    assert tside.core.server_state() == jside.core.server_state()
    assert tside.core.server_ready() == jside.core.server_ready()
    # the HTTP route serves the snapshot as JSON
    status, body = _get(port, "/v2/health/stats")
    assert status == 200
    assert {k: v for k, v in json.loads(body).items() if k != "models"} \
        == tsnap


# -- drain and undrain -------------------------------------------------------


def _drain_round(side):
    """A generation in flight when the drain begins: readiness over HTTP
    and the typed refusal while it drains, then its tokens and the state
    once ``drain()`` returned."""
    port = side.http()
    reference = side.tokens()
    stream = side.stream()
    first = [side.token(next(stream))]
    side.core.begin_drain()
    ready_status = _get(port, "/v2/health/ready")[0]
    stats_state = json.loads(_get(port, "/v2/health/stats")[1])["state"]
    refused = side.refused()
    drainer = threading.Thread(target=side.core.drain, args=(WAIT_S,),
                               daemon=True)
    drainer.start()
    tokens = first + [side.token(r) for r in stream]
    drainer.join(timeout=WAIT_S)
    assert not drainer.is_alive()
    return {"reference": reference, "tokens": tokens,
            "ready": ready_status, "state_draining": stats_state,
            "refused": refused, "state": side.core.server_state(),
            "ready_after": _get(port, "/v2/health/ready")[0],
            "refused_after": side.refused()[0]}


def test_drain_finishes_inflight_generation_like_jax(sides):
    """Mirrors JAX's drain tests: while draining, ``/v2/health/ready``
    is 503 and a new request a typed 503 with JAX's message; the
    generation in flight finishes with the undisturbed tokens; drain()
    ends ``stopped``."""
    jside, tside = sides()
    j, t = _drain_round(jside), _drain_round(tside)
    assert t == j
    assert t["tokens"] == t["reference"]
    assert (t["ready"], t["state_draining"], t["state"]) == (
        503, "draining", "stopped")
    assert t["refused"] == (
        503, "server is draining; not accepting new requests")
    assert (t["ready_after"], t["refused_after"]) == (503, 503)


def _undrain_round(side):
    port = side.http()
    seen = []
    side.core.begin_drain()
    seen.append((side.core.server_state(), side.core.server_ready(),
                 _get(port, "/v2/health/ready")[0]))
    side.core.mark_ready()
    seen.append((side.core.server_state(), side.core.server_ready(),
                 _get(port, "/v2/health/ready")[0]))
    tokens = side.tokens()
    side.core.close()
    side.core.mark_ready()  # stopped stays stopped
    seen.append((side.core.server_state(), side.core.server_ready()))
    return seen, tokens


def test_mark_ready_cancels_drain_like_jax(sides):
    jside, tside = sides()
    (jseen, jtokens), (tseen, ttokens) = (_undrain_round(jside),
                                          _undrain_round(tside))
    assert tseen == jseen == [("draining", False, 503),
                              ("ready", True, 200), ("stopped", False)]
    assert ttokens == jtokens


def test_starting_server_refuses_until_mark_ready(sides):
    """``ready=False`` (the warm-up): not ready over HTTP and a typed 503
    with JAX's message, until ``mark_ready()``."""
    jside, tside = sides(ready=False)
    for side in (jside, tside):
        assert _get(side.http(), "/v2/health/ready")[0] == 503
    assert tside.refused() == jside.refused() == (
        503, "server is starting and not yet ready; not accepting new "
             "requests")
    for side in (jside, tside):
        side.core.mark_ready()
    assert tside.tokens() == jside.tokens()


@pytest.mark.parametrize("package", ["jax", "port"])
def test_sigterm_handler_drains(sides, package):
    """``install_sigterm_drain``: a SIGTERM to this process drains the
    core on a daemon thread to ``stopped``."""
    if threading.current_thread() is not threading.main_thread():
        pytest.skip("signal installation requires the main thread")
    jside, tside = sides()
    side, install = ((jside, jax_sigterm_drain) if package == "jax"
                     else (tside, install_sigterm_drain))
    previous = install(side.core, drain_timeout=5.0)
    try:
        os.kill(os.getpid(), signal.SIGTERM)
        wait_for(lambda: side.core.server_state() == "stopped", "the drain")
    finally:
        signal.signal(signal.SIGTERM, previous)


# -- the in-flight cap -------------------------------------------------------


def _capped_round(side):
    """A stream held in flight (suspended after its first event) at
    ``max_inflight=1``: a POST is shed 429 with ``Retry-After``; after
    ``set_max_inflight(None)`` it is served."""
    port = side.http()
    stream = side.stream()
    next(stream)
    shed = _post_stream(port)
    snap = side.core.health_snapshot()
    side.core.set_max_inflight(None)
    served = _post_stream(port)
    stream.close()
    return shed, (snap["inflight"], snap["max_inflight"]), served


def test_max_inflight_sheds_429_with_retry_after_like_jax(sides):
    jside, tside = sides(max_inflight=1)
    j, t = _capped_round(jside), _capped_round(tside)
    assert t == j
    status, retry_after, body = t[0]
    assert (status, retry_after) == (429, "1")
    assert body["error"] == ("server is at its in-flight request cap (1); "
                             "retry later")
    assert t[1] == (1, 1) and t[2][0] == 200 and len(t[2][2]) == N_TOK


# -- gRPC readiness and refusals ---------------------------------------------


def _grpc_round(side, case):
    cls = GrpcFrontend if side.jax else GrpcServer
    server = cls(side.core, port=0).start()
    client = grpcclient.InferenceServerClient(server.url)
    held = None
    try:
        if case == "draining":
            side.core.begin_drain()
        else:
            held = side.stream()
            next(held)
        inputs = [grpcclient.InferInput("PROMPT_IDS", [len(PROMPT)],
                                        "INT32"),
                  grpcclient.InferInput("MAX_TOKENS", [1], "INT32")]
        inputs[0].set_data_from_numpy(np.asarray(PROMPT, np.int32))
        inputs[1].set_data_from_numpy(np.array([2], np.int32))
        with pytest.raises(InferenceServerException) as err:
            client.infer("llama_generate", inputs)
        return (client.is_server_ready(), err.value.status(),
                err.value.message())
    finally:
        if held is not None:
            held.close()
        client.close()
        server.stop()


@pytest.mark.parametrize("case,core_kwargs,status", [
    ("draining", {}, "StatusCode.UNAVAILABLE"),
    ("capped", {"max_inflight": 1}, "StatusCode.RESOURCE_EXHAUSTED"),
])
def test_grpc_readiness_and_refusals_match_jax(sides, case, core_kwargs,
                                               status):
    """``ServerReady`` follows the lifecycle, and a unary request refused
    by it maps through the code map: UNAVAILABLE while draining,
    RESOURCE_EXHAUSTED at the cap, with JAX's messages."""
    jside, tside = sides(**core_kwargs)
    j, t = _grpc_round(jside, case), _grpc_round(tside, case)
    assert t == j
    assert t[0] == (case != "draining") and t[1] == status


# -- serve.py as a replica process -------------------------------------------


def _replica(package, port, scope, log_path):
    """A replica process with ``--role decode --spawn-nonce``: the port's
    ``serve.py`` or the JAX package's ``tools/fleet.py --serve-replica``,
    each with every decode step slowed by ``STEP_SLEEP_S``.  Its output
    goes to ``log_path`` (a pipe nobody reads would block it once
    full)."""
    if package == "port":
        argv = [sys.executable, "-m", "tpuserver_torch.serve", "--device",
                "cpu", "--config", "tiny", "--max-seq", str(MAX_SEQ),
                "--max-slots", "2", "--fault-scope", scope]
    else:
        argv = [sys.executable, os.path.join(REPO, "tools", "fleet.py"),
                "--serve-replica", "--models", "llama", "--slots", "2",
                "--scope", scope]
    argv += ["--port", str(port), "--role", "decode", "--spawn-nonce",
             "nonce-" + package, "--drain-timeout", str(WAIT_S)]
    env = dict(os.environ, PYTHONPATH=SRC_PY, OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu",
               # unscoped: the JAX replica's scheduler fires with no
               # scope (its --scope reaches only the core), and each
               # replica is a process of its own
               TPUSERVER_FAULTS="scheduler.step:sleep:-1:{}".format(
                   STEP_SLEEP_S))
    with open(log_path, "wb") as log:
        return subprocess.Popen(argv, env=env, stdout=log,
                                stderr=subprocess.STDOUT)


def _stats(port):
    try:
        status, body = _get(port, "/v2/health/stats")
    except OSError:
        return None
    return json.loads(body) if status == 200 else None


def _replica_round(package, proc, port, log_path):
    """Readiness, then an undisturbed stream, then one that a SIGTERM
    meets after its first event: the snapshot while draining, a POST
    refused, the stream's tokens and the exit code."""
    wait_for(lambda: (_stats(port) or {}).get("state") == "ready"
             or proc.poll() is not None, package + " replica ready")
    snap = _stats(port)
    assert snap is not None, log_path.read_text()[-4000:]
    reference = _post_stream(port, n=REPLICA_BUDGET)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=WAIT_S)
    conn.request("POST", STREAM_PATH, _body(PROMPT, REPLICA_BUDGET),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    tokens, seqs, final = [], [], False
    draining = refused = None
    for seq, event in sse_events(resp):
        if event.get("final"):
            final = True
            break
        seqs.append(seq)
        tokens.append(event["outputs"][0]["data"][0])
        if len(tokens) == 1:
            proc.send_signal(signal.SIGTERM)
            wait_for(lambda: (_stats(port) or {}).get("state") == "draining"
                     or proc.poll() is not None,
                     package + " replica draining")
            draining = _stats(port)
            assert draining is not None, log_path.read_text()[-4000:]
            refused = _post_stream(port)[0]
    conn.close()
    code = proc.wait(timeout=WAIT_S)
    return {"role": snap["role"], "nonce": snap["spawn_nonce"],
            "keys": sorted(snap), "reference": reference,
            "tokens": tokens, "seqs": seqs, "final": final,
            "draining": (draining["state"], draining["ready"],
                         draining["models"]["llama_generate"]["live_streams"]),
            "refused": refused, "exit": code,
            "max_inflight": snap["max_inflight"]}


def test_serve_replica_drains_on_sigterm_like_jax_replica(tmp_path):
    """``serve.py --role decode --spawn-nonce N`` as a process, beside the
    JAX package's replica process with the same flags: both echo role
    and nonce in the same snapshot keys, with no in-flight cap (neither
    entry point takes one); a stream begun before SIGTERM completes
    gap-free with the undisturbed tokens while the snapshot
    reads ``draining``, the next POST is a 503, and the process exits
    0."""
    ports = {p: free_port() for p in ("port", "jax")}
    logs = {p: tmp_path / (p + ".log") for p in ports}
    procs = {p: _replica(p, ports[p], "replica-" + p, logs[p])
             for p in ports}
    results, errors = {}, {}

    def run(p):
        try:
            results[p] = _replica_round(p, procs[p], ports[p], logs[p])
        except BaseException as e:  # re-raised on the test's thread
            errors[p] = e

    try:
        rounds = [threading.Thread(target=run, args=(p,), daemon=True)
                  for p in ports]
        for t in rounds:
            t.start()
        for t in rounds:
            t.join(timeout=4 * WAIT_S)
        for e in errors.values():
            raise e
        assert set(results) == set(ports), "a replica round hung"
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
            proc.wait(timeout=WAIT_S)
    t, j = results["port"], results["jax"]
    assert (t["role"], t["nonce"]) == ("decode", "nonce-port")
    assert (j["role"], j["nonce"]) == ("decode", "nonce-jax")
    assert t["keys"] == j["keys"]
    assert (t["max_inflight"], j["max_inflight"]) == (None, None)
    for r in (t, j):
        assert r["reference"][0] == 200
        assert r["tokens"] == r["reference"][2]
        assert r["seqs"] == list(range(REPLICA_BUDGET)) and r["final"]
        assert r["draining"] == ("draining", False, 1)
        assert (r["refused"], r["exit"]) == (503, 0)


# the port's serve.py with its warm-up held until a line on stdin
_HELD_WARMUP = """
import sys
from tpuserver_torch import serve
from tpuserver_torch.models.llama_serving import LlamaGenerateModel
warmup = LlamaGenerateModel.warmup
def held(self):
    print("WARMING", flush=True)
    sys.stdin.readline()
    warmup(self)
LlamaGenerateModel.warmup = held
serve.main(sys.argv[1:])
"""


def test_serve_replica_sigterm_while_starting_drains_after_warmup():
    """A SIGTERM reaches ``serve.py`` during its warm-up (held open until
    the test releases it): the server reads ``starting``, not ready,
    and refuses a POST with the typed 503; once the warm-up ends it
    drains and stops without ever turning ready, and the process exits
    0."""
    port = free_port()
    proc = subprocess.Popen(
        [sys.executable, "-c", _HELD_WARMUP, "--device", "cpu", "--config",
         "tiny", "--max-seq", str(MAX_SEQ), "--max-slots", "2", "--port",
         str(port), "--role", "decode"],
        env=dict(os.environ, PYTHONPATH=SRC_PY, OMP_NUM_THREADS="1"),
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        head = []
        for line in proc.stdout:
            head.append(line)
            if line.strip() == "WARMING":
                break
        assert head and head[-1].strip() == "WARMING", "".join(head)
        wait_for(lambda: _stats(port) is not None, "the front end")
        starting = _stats(port)
        ready = _get(port, "/v2/health/ready")[0]
        refused = _post_stream(port)
        proc.send_signal(signal.SIGTERM)
        out = proc.communicate("\n", timeout=WAIT_S)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait(timeout=WAIT_S)
    assert (starting["state"], starting["ready"], ready) == (
        "starting", False, 503)
    assert refused == (503, None, {"error": "server is starting and not "
                                            "yet ready; not accepting new "
                                            "requests"})
    assert proc.returncode == 0, out
    assert "SIGTERM during the warm-up" in out and "serving " not in out
    assert out.rstrip().endswith("stopped"), out


def test_warmup_end_never_cancels_a_drain(tparams):
    """``mark_ready(undrain=False)``, the switch ``serve.py`` makes when
    its warm-up ends: ``starting`` turns ready, but a drain a SIGTERM
    began stays a drain and reaches ``stopped``."""
    _, tcfg = tiny_cfgs()
    for begin_drain, after in ((False, "ready"), (True, "draining")):
        core = InferenceServer([LlamaGenerateModel(
            cfg=tcfg, max_seq=MAX_SEQ, max_slots=2, params=tparams,
            device="cpu")], ready=False)
        try:
            if begin_drain:
                core.begin_drain()
            core.mark_ready(undrain=False)
            assert core.server_state() == after
            if begin_drain:
                core.drain(WAIT_S)
                assert core.server_state() == "stopped"
        finally:
            core.close()


# -- the JAX supervisor over port replicas -----------------------------------


def test_fleet_supervisor_spawns_and_heals_port_replicas(tmp_path):
    """JAX's ``FleetSupervisor`` runs the port's ``serve.py`` from its
    command template, one replica per role (it appends ``--role``, and
    with a manifest ``--spawn-nonce``): both come up and route, each
    snapshot echoes its role and nonce, and a SIGKILL'd replica is
    respawned on its address with a new pid, the restart counted."""
    command = [sys.executable, "-m", "tpuserver_torch.serve", "--device",
               "cpu", "--config", "tiny", "--max-seq", str(MAX_SEQ),
               "--max-slots", "2", "--port", "{port}", "--fault-scope",
               "{scope}"]
    sup = FleetSupervisor(
        command, prefill_replicas=1, decode_replicas=1, min_replicas=1,
        max_replicas=1, probe_interval_s=0.1, probe_timeout_s=2.0,
        start_timeout_s=WAIT_S, drain_grace_s=5.0, restart_backoff_s=0.05,
        scale_cooldown_s=0.3, scope_prefix="port-r",
        router_kwargs={"probe_interval_s": 0.1},
        env={"PYTHONPATH": SRC_PY, "OMP_NUM_THREADS": "1"},
        manifest_dir=str(tmp_path / "manifest")).start()
    try:
        assert sup.wait_ready(2, timeout_s=WAIT_S)
        replicas = sup.stats()["replicas"]
        snaps = {}
        for rep in replicas:
            snaps[rep["url"]] = _stats(int(rep["url"].rsplit(":", 1)[1]))
        assert sorted(s["role"] for s in snaps.values()) == [
            "decode", "prefill"]
        assert all(s["spawn_nonce"] and s["state"] == "ready"
                   and s["max_inflight"] is None for s in snaps.values())
        assert {r["pid"] for r in replicas} == {
            s["pid"] for s in snaps.values()}
        victim = replicas[0]
        os.kill(victim["pid"], signal.SIGKILL)
        wait_for(lambda: sup.stats()["replica_restarts"] >= 1, "a restart")
        assert sup.wait_ready(2, timeout_s=WAIT_S)
        port = int(victim["url"].rsplit(":", 1)[1])
        wait_for(lambda: (_stats(port) or {}).get("pid") not in (
            None, victim["pid"]), "the respawned replica's snapshot")
        healed = _stats(port)
        assert healed["role"] == snaps[victim["url"]]["role"]
        assert healed["spawn_nonce"] != snaps[victim["url"]]["spawn_nonce"]
        assert healed["pid"] == next(
            r["pid"] for r in sup.stats()["replicas"]
            if r["url"] == victim["url"])
        assert sup.stats()["replica_restarts"] >= 1
    finally:
        sup.stop()
