"""The port's adaptive admission shedding on the CPU: its
``_CodelShedController`` against the JAX package's on the sojourn
sequences of ``tests/test_tail_defense.py`` (the same shed decisions and
``Retry-After``s), and the scheduler's shed through the core: the typed
429 with the computed ``Retry-After`` over the core, HTTP and the
metrics, and a real scheduler shedding under a slow-step fault, then
relaxing."""

import dataclasses
import http.client
import json
import threading
import time

import numpy as np
import pytest
import torch

from tpuserver.scheduler import _CodelShedController as JaxController
from tpuserver_torch import fault_points
from tpuserver_torch.core import InferenceServer, InferRequest
from tpuserver_torch.errors import TooManyRequests
from tpuserver_torch.http_server import HttpServer
from tpuserver_torch.models import llama as tl
from tpuserver_torch.models.llama_serving import LlamaGenerateModel
from tpuserver_torch.scheduler import _CodelShedController

pytestmark = pytest.mark.torch_port

# (target_s, interval_s, events): ("note", sojourn_s, now) feeds the
# sojourn signal, ("arrive", now, queue_len) asks for a verdict
SEQUENCES = {
    "below_target_or_empty": (0.02, 0.1, [
        ("note", 0.01, 0.0), ("arrive", 5.0, 8), ("note", 0.05, 10.0),
        ("arrive", 10.05, 8), ("arrive", 99.0, 0)]),
    "sustained_overload_tightens": (0.02, 0.1, [
        ("note", 0.05, 0.0), ("arrive", 0.11, 4), ("arrive", 0.12, 4),
        ("arrive", 0.21, 4), ("arrive", 0.2808, 4), ("arrive", 0.29, 4),
        ("arrive", 0.3, 4), ("arrive", 0.5, 4)]),
    "relaxes_when_sojourn_drops": (0.02, 0.1, [
        ("note", 0.05, 0.0), ("arrive", 0.2, 4), ("note", 0.001, 0.3),
        ("arrive", 0.31, 4), ("note", 0.05, 1.0), ("arrive", 1.05, 4),
        ("arrive", 1.11, 4)]),
    "retry_after_tracks_the_interval": (0.5, 7.0, [
        ("note", 1.0, 0.0), ("arrive", 8.0, 4), ("arrive", 12.0, 4),
        ("arrive", 13.0, 4), ("arrive", 30.0, 4)]),
    "retry_after_floors_at_one": (0.01, 0.05, [
        ("note", 1.0, 0.0), ("arrive", 1.0, 4), ("arrive", 1.02, 4),
        ("arrive", 1.2, 4)]),
}


def _run(cls, target_s, interval_s, events):
    ctl = cls(target_s, interval_s)
    out = []
    for kind, a, b in events:
        if kind == "note":
            ctl.note_sojourn(a, b)
        else:
            out.append(ctl.on_arrival(a, b))
        out.append((ctl.shedding, ctl.shed_count, ctl.above_since,
                    ctl.current_interval()))
    return out


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_controller_makes_jax_shed_decisions(name):
    """On the same sojourn sequence the port's controller sheds the same
    arrivals with the same ``Retry-After`` as JAX's, state for state."""
    target_s, interval_s, events = SEQUENCES[name]
    ours = _run(_CodelShedController, target_s, interval_s, events)
    assert ours == _run(JaxController, target_s, interval_s, events)
    verdicts = [v for v in ours if not isinstance(v, tuple)]
    if name == "below_target_or_empty":
        assert verdicts == [None] * 3
    else:
        assert any(v is not None for v in verdicts)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _model(**kwargs):
    cfg = dataclasses.replace(tl.tiny(vocab=128), dtype=torch.float32)
    return LlamaGenerateModel(cfg=cfg, max_seq=32, max_slots=2, device="cpu",
                              **kwargs)


def _request(prompt, n):
    return InferRequest("llama_generate", inputs={
        "PROMPT_IDS": np.asarray(prompt, np.int32),
        "MAX_TOKENS": np.array([n], np.int32)})


def test_a_shed_passes_through_the_core_and_http():
    """With the controller in its shedding state (an arrival queued, the
    sojourn above target for a minute) a submit through the core is the
    typed 429 with ``Retry-After`` = ceil(7 s interval); over HTTP, one
    interval later, the header carries the tightened ceil(7 / sqrt(2));
    the scheduler's stats and ``/metrics`` count the sheds and the typed
    errors."""
    model = _model(target_queue_ms=10, shed_interval_ms=7000.0)
    core = InferenceServer([model])
    sched = model._ensure_scheduler()
    with sched._cond:
        sched._pending.append(object())  # no loop runs: nothing admits it
        sched._shed_ctl.above_since = time.monotonic() - 60.0
    server = HttpServer(core, port=0).start()
    try:
        with pytest.raises(TooManyRequests) as info:
            list(core.infer_stream(_request([3, 1], 2)))
        assert info.value.retry_after == 7 and "sojourn" in str(info.value)
        # the next control interval has come: the second shed's interval
        # tightens to 7 / sqrt(2) s
        with sched._cond:
            sched._shed_ctl.shed_next = 0.0
        conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                          timeout=30)
        conn.request("POST", "/v2/models/llama_generate/generate_stream",
                     json.dumps({"inputs": [
                         {"name": "PROMPT_IDS", "datatype": "INT32",
                          "shape": [2], "data": [3, 1]},
                         {"name": "MAX_TOKENS", "datatype": "INT32",
                          "shape": [1], "data": [2]}]}),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 429 and resp.getheader("Retry-After") == "5"
        assert "sojourn" in json.loads(resp.read())["error"]
        conn.close()
        stats = model.scheduler_stats()
        assert stats["codel_sheds"] == 2 and stats["codel_shedding"]
        text = core.metrics_text()
        assert 'tpu_scheduler_codel_sheds_total{model="llama_generate"} 2' \
            in text
        assert 'tpu_scheduler_codel_shedding{model="llama_generate"} 1' \
            in text
        assert ('tpu_request_errors_total{verb="stream_infer",code="429"} 2'
                in text)
    finally:
        server.stop()
        with sched._cond:
            sched._pending.clear()
        core.close()


def test_the_scheduler_sheds_under_a_slow_step_then_relaxes():
    """A real scheduler behind the core: a long generation holds one of
    two slots while ``scheduler.step`` (this server's scope) slows every
    step; submits back the queue up past the target until one is shed
    with the typed 429; with the fault cleared the queue drains and a
    later generation is admitted with no new shed."""
    model = _model(target_queue_ms=20, shed_interval_ms=60.0,
                   fault_scope="codel")
    core = InferenceServer([model], fault_scope="codel")
    streams, sheds, threads = [], [], []

    def spare():
        try:
            list(core.infer_stream(_request([5, 2], 2)))
        except TooManyRequests as e:
            sheds.append(e)

    try:
        fault_points.install("scheduler.step", mode="slow", delay=0.03,
                             scope="codel")
        for _ in range(2):
            streams.append(core.infer_stream(_request([3, 1, 4], 20)))
            assert next(streams[-1]) is not None  # admitted, decoding
        # both slots are busy: each spare waits in the queue, which
        # only sojourn-time shedding bounds
        deadline = time.monotonic() + 30.0
        while not sheds and time.monotonic() < deadline:
            threads.append(threading.Thread(target=spare, daemon=True))
            threads[-1].start()
            time.sleep(0.02)
        assert sheds, "the controller never shed"
        assert sheds[0].retry_after >= 1 and "sojourn" in str(sheds[0])
    finally:
        fault_points.clear()
        for s in streams:
            s.close()
        for t in threads:
            t.join(timeout=60)
    assert model.scheduler_stats()["codel_sheds"] == len(sheds)
    try:
        before = model.scheduler_stats()["codel_sheds"]
        deadline = time.monotonic() + 30.0
        while model.scheduler_stats()["live_streams"] and \
                time.monotonic() < deadline:
            time.sleep(0.02)
        assert len(list(core.infer_stream(_request([9, 9], 2)))) == 2
        stats = model.scheduler_stats()
        assert stats["codel_sheds"] == before
        assert not stats["codel_shedding"]
    finally:
        core.close()
