"""The port's self-healing decode scheduler on the CPU: the supervisor
and its restart budget, the hung-step watchdog, and replay and resume of
generations (``DecodeScheduler.resume``, the ``resume_generation_id``
request parameter and the HTTP ``Last-Event-ID`` reconnect), held to the
contracts of ``tests/test_self_healing.py`` and against the JAX
scheduler's tokens on the same weights (float32 ``tiny``,
``init_params(PRNGKey(0))`` bridged by ``params_from_jax``).

Faults go in through a wrapped ``fns`` bundle: the step raises, or
sleeps on the host inside the watchdog's heartbeat window.  A restarted
or resumed stream must stream exactly the undisturbed tokens."""

import dataclasses
import functools
import http.client
import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuserver.models import llama as jl
from tpuserver.scheduler import DecodeScheduler as JaxScheduler
from tpuserver_torch import scheduler as scheduler_module
from tpuserver_torch.core import InferenceServer, InferRequest
from tpuserver_torch.errors import GenerationNotFound, ServerUnavailable
from tpuserver_torch.http_server import HttpServer
from tpuserver_torch.models import llama as tl
from tpuserver_torch.models import llama_serving
from tpuserver_torch.models.llama_serving import LlamaGenerateModel
from tpuserver_torch.scheduler import DecodeScheduler

pytestmark = pytest.mark.torch_port

CPU = torch.device("cpu")
VOCAB = 512
MAX_SEQ = 64
PROMPTS = [np.array(p, np.int32) for p in (
    [3, 1, 4, 1, 5], [9, 8, 7], [2, 7, 1, 8, 2, 8])]
BUDGETS = [8, 6, 7]
STREAM_PROMPT = np.arange(1, 21, dtype=np.int32)
STREAM_BUDGET = 40


def _cfgs():
    return (dataclasses.replace(jl.tiny(vocab=VOCAB), dtype=jnp.float32),
            dataclasses.replace(tl.tiny(vocab=VOCAB), dtype=torch.float32,
                                decode_impl="dense"))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The watchdog's tests time steps against ``step_timeout_s``: one
    intra-op thread per process keeps a tiny step short when several
    test processes share the cores (torch otherwise starts one thread
    per core in each)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def bridged():
    jcfg, _ = _cfgs()
    params = jl.init_params(jax.random.PRNGKey(0), jcfg)
    return params, tl.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), CPU)


@pytest.fixture(scope="module")
def fns():
    return tl.make_scheduler_fns(_cfgs()[1], MAX_SEQ, 2, device="cpu")


@pytest.fixture(scope="module")
def reference(bridged):
    """The JAX scheduler's tokens for PROMPTS, then STREAM_PROMPT."""
    params, _ = bridged
    sched = JaxScheduler(jl.make_scheduler_fns(_cfgs()[0], MAX_SEQ, 2),
                         params, 2, MAX_SEQ, spec_tokens=0)
    try:
        return [_collect(sched, p, n) for p, n in zip(
            PROMPTS + [STREAM_PROMPT], BUDGETS + [STREAM_BUDGET])]
    finally:
        sched.close()


def _collect(sched, prompt, n, **kwargs):
    return [t for t, _ in sched.submit(prompt, n, **kwargs)]


def _faulty(fns, action):
    """A copy of ``fns`` whose step (plain or speculative) runs
    ``action`` once, before the real call, on the call numbered
    ``state["at"]`` (None: never)."""
    fns = dict(fns)
    state = {"calls": 0, "at": None}

    def wrap(real):
        def wrapped(*args):
            state["calls"] += 1
            if state["calls"] == state["at"]:
                action()
            return real(*args)
        return wrapped

    for key in ("step", "spec_step"):
        fns[key] = wrap(fns[key])
    return fns, state


def _all_streams(sched):
    results = [None] * len(PROMPTS)
    errors = []

    def worker(i):
        try:
            results[i] = _collect(sched, PROMPTS[i], BUDGETS[i])
        except Exception as e:  # noqa: BLE001 — surfaced by the assert
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(PROMPTS))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    return results


def _raise():
    raise RuntimeError("injected device fault")


@pytest.mark.parametrize("spec_tokens", [0, 4])
def test_a_failed_step_restarts_the_loop_and_streams_stay_identical(
        bridged, fns, reference, spec_tokens):
    """A step that raises ends the loop; the supervisor starts a new one
    and the three concurrent streams, admitted again with ``prompt +
    history``, stream JAX's undisturbed tokens.  One restart, healthy."""
    _, tparams = bridged
    faulty, state = _faulty(fns, _raise)
    state["at"] = 4
    sched = DecodeScheduler(faulty, tparams, 2, MAX_SEQ,
                            spec_tokens=spec_tokens, restart_backoff_s=0.01)
    try:
        assert _all_streams(sched) == reference[:3]
        stats = sched.stats()
        assert stats["restarts"] == 1 and stats["healthy"]
        assert stats["live_streams"] == 0 and stats["admitted"] > 3
    finally:
        sched.close()


def test_the_watchdog_cuts_a_hung_step_and_drops_its_late_deliveries(
        bridged, fns, reference):
    """A step stalled on the host past ``step_timeout_s`` is demoted and
    the stream completes before the stall ends, token-identical; when
    the demoted thread wakes it delivers nothing, and a later run is
    untouched."""
    _, tparams = bridged
    hang_s = 1.5
    faulty, state = _faulty(fns, lambda: time.sleep(hang_s))
    sched = DecodeScheduler(faulty, tparams, 2, MAX_SEQ, step_timeout_s=0.3,
                            restart_backoff_s=0.01)
    try:
        assert _collect(sched, PROMPTS[0], BUDGETS[0]) == reference[0]
        state["at"] = state["calls"] + 3
        t0 = time.monotonic()
        assert _collect(sched, PROMPTS[0], BUDGETS[0]) == reference[0]
        elapsed = time.monotonic() - t0
        assert elapsed < hang_s, elapsed
        stats = sched.stats()
        assert stats["restarts"] == 1 and stats["healthy"]
        tokens = stats["tokens"]
        time.sleep(hang_s - elapsed + 0.3)  # the demoted thread wakes
        assert sched.stats()["tokens"] == tokens
        assert _collect(sched, PROMPTS[0], BUDGETS[0]) == reference[0]
    finally:
        sched.close()


@pytest.mark.parametrize("spec_tokens", [0, 4])
def test_the_watchdog_spares_the_first_call_of_each_kind(
        bridged, fns, reference, spec_tokens):
    """The first step of a cold scheduler may outlast ``step_timeout_s``
    (on the card it loads the kernel library and sets up cuBLAS): it runs
    unwatched and nothing restarts.  A later stall of the same length is
    cut."""
    _, tparams = bridged
    stall_s = 0.6
    faulty, state = _faulty(fns, lambda: time.sleep(stall_s))
    state["at"] = 1
    sched = DecodeScheduler(faulty, tparams, 2, MAX_SEQ, step_timeout_s=0.2,
                            restart_backoff_s=0.01, spec_tokens=spec_tokens)
    try:
        assert _collect(sched, PROMPTS[0], BUDGETS[0]) == reference[0]
        assert sched.stats()["restarts"] == 0
        state["at"] = state["calls"] + 2
        assert _collect(sched, PROMPTS[0], BUDGETS[0]) == reference[0]
        assert sched.stats()["restarts"] == 1 and sched.stats()["healthy"]
    finally:
        sched.close()


def _generate(core, prompt, n, parameters=None):
    req = InferRequest("llama_generate", inputs={
        "PROMPT_IDS": np.asarray(prompt, np.int32),
        "MAX_TOKENS": np.array([n], np.int32)}, parameters=parameters or {})
    return [int(dict((s["name"], a) for s, a in r.outputs)["TOKEN"][0])
            for r in core.infer_stream(req)]


def _scheduler_settings(monkeypatch, **kwargs):
    """Build the model's scheduler with ``kwargs`` (a short budget,
    backoff or TTL), which the model itself does not expose."""
    monkeypatch.setattr(llama_serving, "DecodeScheduler",
                        functools.partial(DecodeScheduler, **kwargs))


def test_a_spent_restart_budget_trips_to_503_and_drain_still_works(
        bridged, monkeypatch):
    """Repeated failures spend the budget: the stream fails with a 503,
    the model reports unhealthy, submits are refused, and drain ends in
    a closed scheduler."""
    _, tparams = bridged
    _scheduler_settings(monkeypatch, max_restarts=2, restart_backoff_s=0.01)
    model = LlamaGenerateModel(cfg=_cfgs()[1], max_seq=MAX_SEQ, max_slots=2,
                               params=tparams, device="cpu")
    core = InferenceServer([model])
    try:
        sched = model._ensure_scheduler()
        sched._fns = dict(sched._fns, step=lambda *args: _raise())
        with pytest.raises(ServerUnavailable,
                           match="restart budget exhausted") as info:
            _generate(core, PROMPTS[0], BUDGETS[0])
        assert info.value.code == 503
        stats = sched.stats()
        assert stats["tripped"] and not stats["healthy"]
        assert stats["restarts"] == 2
        assert not model.healthy() and not core.server_ready()
        with pytest.raises(ServerUnavailable, match="tripped"):
            _generate(core, PROMPTS[1], 2)
        model.drain(timeout=5.0)
        assert sched.stats()["closed"]
    finally:
        core.close()


def _parked(sched, gen_id):
    deadline = time.monotonic() + 5
    while gen_id not in sched._replay and time.monotonic() < deadline:
        time.sleep(0.01)  # the cancel reap parks it between steps
    return gen_id in sched._replay


def test_an_abandoned_stream_parks_and_resume_splices(bridged, fns,
                                                      reference):
    """A consumer that walks away after 3 tokens parks its generation;
    a resume from seq 2 replays the missed token and splices the live
    continuation (admitted again with ``prompt + history``): JAX's
    tokens, no duplicate, no gap.  The finished continuation parks as
    completed, and its tail replays twice; an interrupted entry is
    consumed by its first resume."""
    _, tparams = bridged
    sched = DecodeScheduler(fns, tparams, 2, MAX_SEQ)
    try:
        stream = sched.submit(STREAM_PROMPT, STREAM_BUDGET,
                              generation_id="g-splice")
        got = [next(stream) for _ in range(3)]
        stream.close()
        assert _parked(sched, "g-splice")
        resumed = list(sched.resume("g-splice", from_seq=2))
        assert resumed[0] == got[2]
        tokens = [t for t, _ in got[:2] + resumed]
        assert tokens == reference[3]
        for _ in range(2):
            assert [t for t, _ in sched.resume("g-splice", 30)] == \
                reference[3][30:]
        stats = sched.stats()
        assert stats["replay_hits"] == 3 and stats["replay_entries"] == 1
        assert stats["admitted"] == 2  # the resume admitted it again
        with pytest.raises(GenerationNotFound, match="beyond"):
            sched.resume("g-splice", STREAM_BUDGET + 1)
        with pytest.raises(GenerationNotFound, match="never-issued") as info:
            sched.resume("never-issued", 0, wait_s=0.1)
        assert info.value.code == 404
    finally:
        sched.close()


class _ShiftedClock:
    """The scheduler module's ``time``, with ``monotonic()`` moved on by
    ``shift`` seconds (0 until a test sets it)."""

    def __init__(self):
        self.shift = 0.0

    def monotonic(self):
        return time.monotonic() + self.shift

    def __getattr__(self, name):
        return getattr(time, name)


def test_a_resume_takes_the_reconnects_fresh_deadline(bridged, fns,
                                                      reference,
                                                      monkeypatch):
    """The original request's deadline died with its connection: a
    resume with no deadline runs to the end after it passed.  The
    deadline is generous while the two tokens are read, however loaded
    the machine; then the clock the scheduler reads moves past it (the
    replay entry's TTL is longer still, so the park stays)."""
    _, tparams = bridged
    clock = _ShiftedClock()
    monkeypatch.setattr(scheduler_module, "time", clock)
    sched = DecodeScheduler(fns, tparams, 2, MAX_SEQ, replay_ttl_s=3600.0)
    try:
        stream = sched.submit(STREAM_PROMPT, STREAM_BUDGET,
                              deadline=clock.monotonic() + 60.0,
                              generation_id="g-deadline")
        got = [next(stream) for _ in range(2)]
        stream.close()
        assert _parked(sched, "g-deadline")
        clock.shift = 61.0  # the ORIGINAL deadline is now past
        resumed = list(sched.resume("g-deadline", 2, deadline=None))
        assert [t for t, _ in got + resumed] == reference[3]
    finally:
        sched.close()


def test_completed_tails_replay_and_the_ttl_expires_them(bridged,
                                                         reference,
                                                         monkeypatch):
    """Through the core: a completed generation's tail replays twice
    (``resume_generation_id``/``resume_from_seq``, ``seq`` continuing
    from the resume point); after the TTL the id is a typed 404, as is
    an id never issued, and any resume on the single-stream path."""
    _, tparams = bridged
    _scheduler_settings(monkeypatch, replay_ttl_s=0.5)
    model = LlamaGenerateModel(cfg=_cfgs()[1], max_seq=MAX_SEQ, max_slots=2,
                               params=tparams, device="cpu")
    core = InferenceServer([model])
    try:
        assert _generate(core, PROMPTS[1], BUDGETS[1],
                         {"generation_id": "g-tail"}) == reference[1]
        for _ in range(2):
            req = InferRequest("llama_generate", inputs={
                "PROMPT_IDS": PROMPTS[1], "MAX_TOKENS": np.array(
                    [BUDGETS[1]], np.int32)}, parameters={
                "resume_generation_id": "g-tail", "resume_from_seq": 4})
            tail = list(core.infer_stream(req))
            assert [r.parameters["seq"] for r in tail] == [4, 5]
            assert [int(r.outputs[0][1][0]) for r in tail] == \
                reference[1][4:]
        time.sleep(0.6)
        for gen_id in ("g-tail", "never-issued"):
            with pytest.raises(GenerationNotFound) as info:
                _generate(core, PROMPTS[1], 2,
                          {"resume_generation_id": gen_id})
            assert info.value.code == 404
    finally:
        core.close()
    # the single-stream path keeps no replay state: nothing to resume
    single = InferenceServer([LlamaGenerateModel(
        cfg=_cfgs()[1], max_seq=MAX_SEQ, params=tparams, device="cpu")])
    with pytest.raises(GenerationNotFound, match="max_slots=1"):
        _generate(single, PROMPTS[1], 2, {"resume_generation_id": "g-tail"})


def _body(prompt, max_tokens):
    return json.dumps({"inputs": [
        {"name": "PROMPT_IDS", "datatype": "INT32", "shape": [len(prompt)],
         "data": [int(t) for t in prompt]},
        {"name": "MAX_TOKENS", "datatype": "INT32", "shape": [1],
         "data": [max_tokens]}]})


def _events(port, last_event_id=None, stop_after=None):
    """(status, [(id, token)]) of one /generate_stream request; closes
    the connection after ``stop_after`` events."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    headers = {"Last-Event-ID": last_event_id} if last_event_id else {}
    try:
        conn.request("POST", "/v2/models/llama_generate/generate_stream",
                     _body(STREAM_PROMPT, STREAM_BUDGET), headers)
        resp = conn.getresponse()
        if resp.status != 200:
            return resp.status, json.loads(resp.read())
        events, last = [], None
        for raw in resp:
            line = raw.decode("utf-8").strip()
            if line.startswith("id: "):
                last = line[len("id: "):]
            elif line.startswith("data: "):
                event = json.loads(line[len("data: "):])
                if event.get("final"):
                    break
                events.append((last, event["outputs"][0]["data"][0]))
                if len(events) == stop_after:
                    break
        return resp.status, events
    finally:
        conn.close()


def test_http_last_event_id_reconnect_is_gap_free(bridged, reference):
    """An SSE client drops after 5 events and reconnects with
    ``Last-Event-ID``: the two connections' ``id:`` seqs run 0..n-1 with
    no gap or duplicate and the tokens are JAX's.  A malformed id is a
    fresh request; an unknown one is a 404 before any event."""
    _, tparams = bridged
    core = InferenceServer([LlamaGenerateModel(
        cfg=_cfgs()[1], max_seq=MAX_SEQ, max_slots=2, params=tparams,
        device="cpu")])
    server = HttpServer(core, port=0).start()
    try:
        status, first = _events(server.port, stop_after=5)
        assert status == 200 and len(first) == 5
        status, rest = _events(server.port, last_event_id=first[-1][0])
        assert status == 200
        ids = [i for i, _ in first + rest]
        gen_ids = {i.rsplit("/", 1)[0] for i in ids}
        assert len(gen_ids) == 1
        assert [int(i.rsplit("/", 1)[1]) for i in ids] == list(
            range(STREAM_BUDGET))
        assert [t for _, t in first + rest] == reference[3]
        status, fresh = _events(server.port, last_event_id="no-slash")
        assert status == 200 and [t for _, t in fresh] == reference[3]
        assert fresh[0][0].endswith("/0") and fresh[0][0] not in ids
        status, body = _events(server.port, last_event_id="gone/3")
        assert status == 404 and "gone" in body["error"]
    finally:
        server.stop()
        core.close()
