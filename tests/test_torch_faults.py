"""The port's fault points (``tpuserver_torch.fault_points``) on the CPU,
against the JAX package's ``tpuserver.faults``: the registry's rules
(scopes, ``skip=``, ``times=``, the actions, the ``TPUSERVER_FAULTS``
form) on the same sequence of arm and trigger calls, and each point's
one trigger site, which must trip as often as JAX's for the same traffic
and fail it the same way (float32 ``tiny``, ``max_slots=2``, the same
weights on both sides)."""

import dataclasses
import http.client
import json
import time
from multiprocessing import shared_memory

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tritonclient.grpc as grpcclient
from tpuserver import faults as jax_faults
from tpuserver.core import InferenceServer as JaxServer
from tpuserver.core import InferRequest as JaxRequest
from tpuserver.grpc_frontend import GrpcFrontend
from tpuserver.http_frontend import HttpFrontend
from tpuserver.models import llama as jl
from tpuserver.models.llama_serving import LlamaGenerateModel as JaxLlama
from tpuserver_torch import fault_points
from tpuserver_torch.core import InferenceServer, InferRequest
from tpuserver_torch.grpc_server import GrpcServer
from tpuserver_torch.http_server import HttpServer
from tpuserver_torch.models import llama as tl
from tpuserver_torch.models.llama_serving import LlamaGenerateModel

pytestmark = pytest.mark.torch_port

VOCAB = 512
MAX_SEQ = 64
PROMPT = np.array([3, 1, 4, 1, 5], np.int32)
BUDGET = 6
SCOPE = "faulted"


def _trip(module):
    return getattr(module, "trip", None) or module.fire


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread per process: tiny steps stay short when
    several test processes share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _clean():
    for m in (fault_points, jax_faults):
        m.clear()
    yield
    for m in (fault_points, jax_faults):
        m.clear()


# -- the registry's rules -------------------------------------------------------


def _outcome(module, name, scope=None):
    try:
        return ("ok", _trip(module)(name, scope))
    except module.FaultInjected as e:
        return ("raised", e.point)


def _scopes(m):
    m.install("scheduler.step", scope="a")
    out = [_outcome(m, "scheduler.step", "b"),
           _outcome(m, "scheduler.step", None),
           _outcome(m, "scheduler.step", "a"),
           _outcome(m, "scheduler.step", "a")]
    m.install("scheduler.step", times=2)  # the global arming
    out += [_outcome(m, "scheduler.step", "b"),
            _outcome(m, "scheduler.step", None),
            _outcome(m, "scheduler.step", "c")]
    return out + [m.fired("scheduler.step", "a"), m.fired("scheduler.step"),
                  m.active("scheduler.step", "b")]


def _skip(m):
    m.install("grpc.stream_infer", skip=3, times=2, scope="s")
    out = [_outcome(m, "grpc.stream_infer", "s") for _ in range(7)]
    return out + [m.fired("grpc.stream_infer", "s"),
                  m.active("grpc.stream_infer", "s")]


def _actions(m):
    m.install("scheduler.step", mode="nan", delay=3)
    m.install("scheduler.fetch", mode="hang", delay=0.25)
    m.install("core.shm_read", mode="sleep", delay=0.0, times=-1)
    out = [_outcome(m, "scheduler.step"), _outcome(m, "scheduler.step"),
           _outcome(m, "scheduler.fetch")]
    out += [_outcome(m, "core.shm_read") for _ in range(3)]
    with pytest.raises(ValueError):
        m.install("scheduler.admit", mode="explode")
    return out + [m.fired("core.shm_read")]


def _injected(m):
    with m.injected("http.generate_stream", scope="x") as fault:
        out = [_outcome(m, "http.generate_stream", "x"), fault.fired]
    return out + [_outcome(m, "http.generate_stream", "x"),
                  m.active("http.generate_stream", "x")]


def _env(m):
    m.load_env({"TPUSERVER_FAULTS": (
        "scheduler.step@b:raise:2, core.shm_read:nan:1:5,"
        "scheduler.fetch:raise:-1")})
    out = [_outcome(m, "scheduler.step", "a"),
           _outcome(m, "scheduler.step", "b"),
           _outcome(m, "scheduler.step", "b"),
           _outcome(m, "scheduler.step", "b"),
           _outcome(m, "core.shm_read", "z")]
    out += [_outcome(m, "scheduler.fetch") for _ in range(3)]
    with pytest.raises(ValueError):
        m.load_env({"TPUSERVER_FAULTS": "scheduler.step"})
    return out


@pytest.mark.parametrize("scenario", [_scopes, _skip, _actions, _injected,
                                      _env],
                         ids=lambda f: f.__name__.strip("_"))
def test_registry_rules_match_jax(scenario):
    """The same arm and trigger calls give the same outcomes in both
    registries: scope isolation (a scoped arming trips only its scope, a
    global one every firer), ``skip=``, ``times=``, the ``nan`` and
    ``hang`` actions, the context manager and the environment form."""
    assert set(fault_points.POINTS) == set(jax_faults.POINTS)
    ours = scenario(fault_points)
    theirs = scenario(jax_faults)
    assert ours == theirs


# -- each trigger site, held against JAX's ---------------------------------------


def _cfgs():
    return (dataclasses.replace(jl.tiny(vocab=VOCAB), dtype=jnp.float32),
            dataclasses.replace(tl.tiny(vocab=VOCAB), dtype=torch.float32))


class _Stack:
    """One package's model (``max_slots=2``, scope ``SCOPE``), core and
    HTTP and gRPC front ends, and the verbs the site tests drive."""

    def __init__(self, jax_side, tparams=None):
        jcfg, tcfg = _cfgs()
        self.faults = jax_faults if jax_side else fault_points
        if jax_side:
            self.model = JaxLlama(cfg=jcfg, max_seq=MAX_SEQ, max_slots=2,
                                  spec_tokens=0, fault_scope=SCOPE,
                                  restart_backoff_s=0.01)
            self.core = JaxServer([self.model], fault_scope=SCOPE)
            self.request = JaxRequest
            self.frontends = [HttpFrontend(self.core, port=0).start(),
                              GrpcFrontend(self.core, port=0).start()]
        else:
            self.model = LlamaGenerateModel(
                cfg=tcfg, max_seq=MAX_SEQ, max_slots=2, params=tparams,
                device="cpu", fault_scope=SCOPE)
            self.core = InferenceServer([self.model], fault_scope=SCOPE)
            self.request = InferRequest
            self.frontends = [HttpServer(self.core, port=0).start(),
                              GrpcServer(self.core, port=0).start()]

    def stats(self):
        return self.model.scheduler_stats() or {}

    def generate(self):
        """One generation through the core: its tokens, or the error's
        code."""
        req = self.request("llama_generate", inputs={
            "PROMPT_IDS": PROMPT, "MAX_TOKENS": np.array([BUDGET], np.int32)})
        try:
            return [int(r.outputs[0][1][0]) for r in
                    self.core.infer_stream(req)]
        except Exception as e:  # noqa: BLE001 — the outcome compared
            return getattr(e, "code", type(e).__name__)

    def shm_read(self):
        region = shared_memory.SharedMemory(create=True, size=64)
        try:
            np.ndarray((len(PROMPT),), np.int32, region.buf)[:] = PROMPT
            self.core.register_system_shm("prompt", "/" + region.name, 0, 64)
            try:
                return [int(x) for x in self.core.read_shm_input(
                    "prompt", PROMPT.nbytes, 0, "INT32", [len(PROMPT)])]
            except Exception as e:  # noqa: BLE001 — the outcome compared
                return type(e).__name__
            finally:
                self.core.unregister_system_shm("prompt")
        finally:
            region.close()
            region.unlink()

    def http_stream(self):
        """The SSE events' tokens, and whether the final marker came."""
        body = json.dumps({"inputs": [
            {"name": "PROMPT_IDS", "datatype": "INT32",
             "shape": [len(PROMPT)], "data": PROMPT.tolist()},
            {"name": "MAX_TOKENS", "datatype": "INT32", "shape": [1],
             "data": [BUDGET]}]})
        conn = http.client.HTTPConnection("127.0.0.1",
                                          self.frontends[0].port, timeout=60)
        try:
            conn.request("POST", "/v2/models/llama_generate/generate_stream",
                         body, {"Content-Type": "application/json"})
            try:
                text = conn.getresponse().read().decode("utf-8")
            except http.client.IncompleteRead as e:
                text = e.partial.decode("utf-8")
        finally:
            conn.close()
        events = [json.loads(line[6:]) for line in text.splitlines()
                  if line.startswith("data: ")]
        return (len([e for e in events if "outputs" in e]),
                {"final": True} in events)

    def grpc_stream(self):
        client = grpcclient.InferenceServerClient(self.frontends[1].url)
        p = grpcclient.InferInput("PROMPT_IDS", [len(PROMPT)], "INT32")
        p.set_data_from_numpy(PROMPT)
        m = grpcclient.InferInput("MAX_TOKENS", [1], "INT32")
        m.set_data_from_numpy(np.array([BUDGET], np.int32))
        try:
            return len(list(client.generate_stream(
                "llama_generate", [p, m], resume=False)))
        except Exception as e:  # noqa: BLE001 — the outcome compared
            return type(e).__name__
        finally:
            client.close()

    def close(self):
        self.frontends[1].stop()
        self.frontends[0].stop()
        self.core.close()


@pytest.fixture(scope="module")
def stacks():
    jcfg, _ = _cfgs()
    tparams = tl.params_from_jax(jax.tree_util.tree_map(
        np.asarray, jl.init_params(jax.random.PRNGKey(0), jcfg)), "cpu")
    sides = [_Stack(False, tparams), _Stack(True)]
    try:
        reference = [s.generate() for s in sides]
        assert reference[0] == reference[1]
        yield sides, reference[0]
    finally:
        for s in sides:
            s.close()


#: point -> (the traffic through its site, what a raise there does)
SITES = {
    "scheduler.step": ("generate", "restart"),
    "scheduler.fetch": ("generate", "restart"),
    "scheduler.admit": ("generate", "fails"),
    "core.shm_read": ("shm_read", "fails"),
    "http.generate_stream": ("http_stream", "fails"),
    "grpc.stream_infer": ("grpc_stream", "fails"),
}


@pytest.mark.parametrize("point", sorted(SITES))
def test_each_site_trips_where_jax_does(stacks, point):
    """Armed to pass through (``sleep`` 0, unlimited), a point's site
    trips as often in the port as in JAX for the same traffic, which
    runs undisturbed; armed to raise once, it trips once on each side,
    and the traffic fails alike: a loop restart that the stream never
    sees (the scheduler's step and fetch), or a failed request (the
    admission's 500, the shm read, the HTTP stream cut before its final
    marker, the gRPC stream dropped)."""
    sides, reference = stacks
    verb, effect = SITES[point]
    counts, undisturbed = [], []
    for side in sides:
        side.faults.install(point, mode="sleep", times=-1, scope=SCOPE)
        side.faults.install("scheduler.step", mode="sleep", times=-1,
                            scope=SCOPE)
        undisturbed.append(getattr(side, verb)())
        if point == "scheduler.fetch":
            # the last step's fetch may come after the stream ended: in
            # the end every dispatched step is fetched once
            deadline = time.monotonic() + 30
            while side.faults.fired(point, SCOPE) < side.faults.fired(
                    "scheduler.step", SCOPE) < 10 ** 6:
                assert time.monotonic() < deadline
                time.sleep(0.01)
        counts.append(side.faults.fired(point, SCOPE))
        side.faults.clear()
    assert counts[0] == counts[1] > 0, counts
    assert undisturbed[0] == undisturbed[1]
    outcomes = []
    for side in sides:
        restarts = side.stats().get("restarts", 0)
        side.faults.install(point, scope=SCOPE)
        outcome = getattr(side, verb)()
        assert side.faults.fired(point, SCOPE) == 1
        side.faults.clear()
        outcomes.append((outcome, side.stats().get("restarts", 0) - restarts))
    if effect == "restart":
        assert outcomes == [(reference, 1)] * 2
    else:
        assert outcomes[0][0] != undisturbed[0]
        assert outcomes[1][0] != undisturbed[1]
        assert [o[1] for o in outcomes] == [0, 0]
    assert point in fault_points.POINTS


def test_a_nan_step_quarantines_one_generation_as_jax_does(stacks):
    """``scheduler.step`` in ``nan`` mode poisons one slot's logits row:
    the generation in it fails with the typed 422 on both sides, and the
    next runs clean."""
    sides, reference = stacks
    got = []
    for side in sides:
        side.faults.install("scheduler.step", mode="nan", delay=0,
                            scope=SCOPE)
        got.append((side.generate(), side.generate()))
    assert got == [(422, reference)] * 2
