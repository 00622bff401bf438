"""Chaos smoke soak: injected failures against the port's servers and
fleets, a nonzero exit on any resilience-invariant violation.

    PYTHONPATH=src/python python -m tpuserver_torch.chaos_smoke \\
        --device cpu [--rounds N] [--slots K] [--budget T]
    ... --kill-loop [--rounds N]          ... --shm [--rounds N]
    ... --router [--cycles N] [--soak M] [--spec-tokens K]
    ... --fleet | --gray | --router-kill | --multi-router | --disagg |
        --supervisor [--cycles N] [--soak M]

The port's counterpart of the JAX package's chaos soak, on the port's
own core, front ends, router, supervisor and fleet CLI: the same modes,
flags, defaults, ``... chaos smoke OK`` / ``FAILED`` lines and exit
codes.  Every assertion goes through ``tpuserver_torch.chaoslib``, whose
recorder's sink is :func:`fail` (an ``INVARIANT VIOLATED:`` stderr
line).  The default run cycles fault injections (decode-step raise,
host-transfer raise, admit raise, slow step with a mid-generation
deadline) over rounds of concurrent generations on the
continuous-batching scheduler, then rides out a transient overload
through the HTTP front end, and after every round asserts:

  1. every request reaches a terminal outcome (tokens or a typed error
     — never a hang);
  2. zero leaked slots/streams (the scheduler's live registry empties);
  3. the decode loop stays healthy (recovery, not watchdog trip);
  4. a clean request after the chaos produces greedy tokens IDENTICAL
     to the pre-chaos reference (the cache was rebuilt right).

``--kill-loop`` kills the decode loop mid-traffic every round: the
restart counter rises, no stream is lost, every request's tokens equal
the fault-free reference.  ``--shm`` does the same to token-ring
generations in a CUDA shared-memory region (a host region on the CPU),
plus a disconnect -> park-export -> attach-resume cycle: rings
token-identical after healing, ``cuda_shm_status`` exactly the ring
(no stale ``kvexport/*``), no region left after teardown.

``--router``: plain clients stream through a ``FleetRouter`` over two
in-process replicas while each cycle SIGTERM-drains and revives one
and severs live upstream streams (a scoped fault): zero user-visible
errors, token-identical gap-free streams, the drained replica rotated
out and back in, fleet metrics monotonic, the prefix cache re-warmed.
``--fleet``: real replica processes (``python -m tpuserver_torch.serve``
as ``tpuserver_torch.fleet_cli`` builds them, with ``--dtype``) under a
``FleetSupervisor``, a random one SIGKILLed each cycle; the fleet heals
to its target count with full router membership.

The stub modes run ``tests/fleet_stub.py`` replicas (no model):
``--gray`` (one replica turned slow-but-alive: soft ejection, p99 back
within 2x of healthy, re-admission), ``--router-kill`` (the active
``router_cli`` process SIGKILLed: standby takeover, journal recovery),
``--multi-router`` (the partitioned front tier, two actives and a
standby; partition 0's active SIGKILLed: partition 1's streams see zero
reconnects, the standby promotes into partition 0 under a newer epoch,
one journal writer per partition, a stream pinned to partition 1 but
dialed at partition 0's owner relays token-identically), ``--disagg``
(the prefill replica of a role fleet SIGKILLed mid-handoff) and
``--supervisor`` (a real ``python -m tpuserver_torch.fleet_cli --stub
--manifest DIR --heartbeat-file FILE`` process SIGKILLed; its successor
adopts every survivor).  ``--pool`` soaks the client library's endpoint
pool, which the port does not carry: it says so and exits 2.

The model modes serve ``--config`` (``tiny`` at vocab 512 by default)
in ``--dtype`` (float32 by default: a restart re-prefills ``prompt +
history`` in one pass, and only float32 keeps that token-identical to
the uninterrupted decode) on ``--device`` (the card unless ``cpu``),
with ``--max-seq`` 64 as the JAX tool's (a batched decode step reaches
the decode kernel only from 128, the least cache length its blocks
tile: below it the model attends densely, as JAX's does); :func:`main`
also takes the weights from its caller.  Exit 0 only if every invariant held.
"""

import argparse
import dataclasses
import http.client
import json
import os
import random
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

from tpuserver_torch import chaos_campaign, chaoslib, fault_points
from tpuserver_torch.chaos_campaign import get_json, post_stub_state
from tpuserver_torch.core import InferenceServer, InferRequest
from tpuserver_torch.errors import RequestTimedOut, TorchServeError

PROMPTS = [
    np.array([3, 1, 4, 1, 5], dtype=np.int32),
    np.array([9, 8, 7], dtype=np.int32),
    np.array([2, 7, 1, 8, 2, 8], dtype=np.int32),
    np.array([1, 2, 3, 4], dtype=np.int32),
]

# long enough to span a full KV page (page_size 16): repeated streams
# of this prompt exercise the radix prefix cache, whose fleet-view
# counters the router/fleet soaks assert stay monotonic and keep
# MOVING (cold caches re-warm) across healing
SHARED_PROMPT = np.array(
    [7, 3, 11, 4, 9, 2, 6, 13, 5, 1, 8, 12, 10, 14, 15, 7,
     9, 4, 2, 11, 6, 3, 13, 5], dtype=np.int32)

FAULT_CYCLE = [
    ("scheduler.step", "raise", 1, 0.0),
    ("scheduler.fetch", "raise", 1, 0.0),
    ("scheduler.admit", "raise", 1, 0.0),
    ("scheduler.step", "sleep", -1, 0.02),  # + deadline pressure
]

#: the model modes' default context length (the JAX tool's)
MAX_SEQ = 64

STUB = os.path.join(chaos_campaign.REPO, "tests", "fleet_stub.py")

_failures = []

#: what the last :func:`main` measured: its mode, seconds, the rounds it
#: ran, the fault-free reference tokens, the decode loop's restarts, the
#: ring lanes read back and the data plane's counts (``--shm``)
STATS = {}


def fail(msg):
    _failures.append(msg)
    print("INVARIANT VIOLATED: {}".format(msg), file=sys.stderr)


#: every mode's assertions run on the shared invariant library; its sink
#: is :func:`fail`, so each violation is one ``INVARIANT VIOLATED:`` line
#: and counts toward the exit code
RECORDER = chaoslib.InvariantRecorder(sink=lambda v: fail(v.message))


class RouterMetricsCheck(chaoslib.MetricsMonotonicityCheck):
    """Per-cycle telemetry invariant of the router and fleet soaks:
    ``GET /metrics`` on the router stays scrapeable under chaos and its
    cumulative families never decrease or vanish across cycles;
    ``prefix_hits`` holds the last scraped fleet-wide hit total."""

    def __init__(self, router_url, context, require_prefix=False):
        super().__init__(router_url, context, RECORDER,
                         require_prefix=require_prefix)


class Serving:
    """What the model modes serve: one config in one type on one device,
    and one set of weights every model of a mode shares (the caller's,
    or drawn from seed 0)."""

    def __init__(self, config, dtype, device, params=None,
                 max_seq=MAX_SEQ):
        import torch

        from tpuserver_torch import resolve_device
        from tpuserver_torch.models import llama

        cfg = (llama.tiny(vocab=512) if config == "tiny"
               else llama.PRESETS[config]())
        self.cfg = dataclasses.replace(cfg, dtype=getattr(torch, dtype))
        self.max_seq = max_seq
        self.device = resolve_device(device)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(0)
            params = llama.init_params(self.cfg, gen, self.device)
        self.params = params

    def model(self, max_slots, max_restarts, spec_tokens=0):
        from tpuserver_torch.models.llama_serving import LlamaGenerateModel

        return LlamaGenerateModel(
            cfg=self.cfg, max_seq=self.max_seq, max_slots=max_slots,
            params=self.params, device=self.device,
            max_restarts=max_restarts, restart_backoff_s=0.01,
            spec_tokens=spec_tokens)


def stream_generation(urls, model, prompt, budget, parameters=None,
                      max_reconnects=10, on_reconnect=None):
    """``(tokens, seqs)`` of one ``generate_stream`` generation dialed
    at ``urls[0]`` and resumed over the rest; raises on a user-visible
    error."""
    tokens, seqs = [], []
    for event in chaos_campaign.generate_stream(
            urls, model, [int(t) for t in prompt], budget, parameters,
            max_reconnects=max_reconnects, on_reconnect=on_reconnect):
        for out in event.get("outputs", []):
            if out["name"] == "TOKEN":
                tokens.append(int(out["data"][0]))
        params = event.get("parameters") or {}
        if "seq" in params:
            seqs.append(params["seq"])
    return tokens, seqs


def drive_shared_streams(url, context, cycle, shared_ref, budget, n=2):
    """A burst of the page-spanning ``SHARED_PROMPT`` through a router
    at ``url``: back-to-back siblings exercise the radix prefix cache,
    and a replica rebuilt this cycle re-warms its cold cache here, with
    zero user-visible errors and token-identical output."""
    for _ in range(n):
        try:
            tokens, _ = stream_generation([url], "llama_generate",
                                          SHARED_PROMPT, budget)
        except Exception as e:  # noqa: BLE001 — the invariant
            fail("{} cycle {}: shared-prefix stream error ({}: {})".format(
                context, cycle, type(e).__name__, e))
            continue
        chaoslib.check_token_identity(
            RECORDER, shared_ref, tokens,
            context="{} cycle {}".format(context, cycle),
            message="{} cycle {}: shared-prefix tokens diverged: "
                    "{} != {}".format(context, cycle, tokens, shared_ref))


def assert_prefix_rewarmed(metrics_check, hits_before, cycle):
    """The fleet-aggregated hit counter must have MOVED since the last
    cycle's scrape: a healed replica's cold radix cache re-warmed."""
    if (hits_before is not None
            and metrics_check.prefix_hits is not None
            and metrics_check.prefix_hits <= hits_before):
        fail("{} cycle {}: prefix cache did not re-warm (fleet hits "
             "stuck at {})".format(
                 metrics_check.context, cycle, hits_before))


def generate(core, prompt, n_tokens, parameters=None):
    req = InferRequest(
        "llama_generate",
        inputs={
            "PROMPT_IDS": np.asarray(prompt, np.int32),
            "MAX_TOKENS": np.array([n_tokens], dtype=np.int32),
        },
        parameters=parameters or {},
    )
    return [
        int(arr[0])
        for resp in core.infer_stream(req)
        for spec, arr in resp.outputs
        if spec["name"] == "TOKEN"
    ]


def wait_no_leaks(model, where, timeout=10.0):
    drained, stats = chaoslib.wait_stream_drain(
        model._scheduler.stats, timeout_s=timeout)
    if drained:
        return True
    fail("{}: leaked streams {}".format(where, stats))
    return False


def _run_workers(target, n):
    threads = [threading.Thread(target=target, args=(i,), daemon=True)
               for i in range(n)]
    for t in threads:
        t.start()
    return threads


def _join(threads, timeout):
    for t in threads:
        t.join(timeout=timeout)


def chaos_round(core, model, reference, budget, rnd):
    name, mode, times, delay = FAULT_CYCLE[rnd % len(FAULT_CYCLE)]
    fault_points.install(name, mode=mode, times=times, delay=delay)
    outcomes = [None] * len(PROMPTS)

    def worker(i):
        params = None
        if mode == "sleep":
            # slow-step round doubles as the deadline probe: this
            # request must expire mid-generation with a typed 504
            params = {"timeout": 300_000} if i == 0 else None
        try:
            outcomes[i] = ("ok", generate(
                core, PROMPTS[i], budget, params))
        except RequestTimedOut:
            outcomes[i] = ("deadline", None)
        except TorchServeError as e:
            outcomes[i] = ("err", e)

    _join(_run_workers(worker, len(PROMPTS)), 120)
    fault_points.clear(name)

    for i, outcome in enumerate(outcomes):
        if outcome is None:
            fail("round {} ({}:{}): request {} never terminated".format(
                rnd, name, mode, i))
        elif outcome[0] == "ok":
            # a request that claims success must be token-exact
            chaoslib.check_token_identity(
                RECORDER, reference[i], outcome[1],
                context="round {}".format(rnd),
                message="round {} ({}:{}): request {} tokens diverged: "
                        "{} != {}".format(
                            rnd, name, mode, i, outcome[1],
                            reference[i]))
    if mode == "sleep" and outcomes[0] is not None:
        if outcomes[0][0] not in ("deadline", "ok"):
            fail("round {} deadline probe got {} instead of a typed "
                 "RequestTimedOut".format(rnd, outcomes[0][0]))

    wait_no_leaks(model, "round {}".format(rnd))
    if not model.healthy():
        fail("round {} ({}:{}): scheduler watchdog tripped".format(
            rnd, name, mode))
    # recovery bar: a clean run right after the chaos is token-identical
    clean = generate(core, PROMPTS[0], budget)
    chaoslib.check_token_identity(
        RECORDER, reference[0], clean,
        context="round {}".format(rnd),
        message="round {} ({}:{}): post-chaos tokens diverged: "
                "{} != {}".format(rnd, name, mode, clean, reference[0]))
    kinds = [o[0] if o else "hang" for o in outcomes]
    print("round {:2d} fault={}:{} outcomes={} live={}".format(
        rnd, name, mode, kinds, model._scheduler.stats()["live_streams"]),
        flush=True)


def _post_infer(port, body):
    """POST ``body`` to the ``simple`` model's ``/infer`` on localhost:
    ``(status, Retry-After header or None, parsed body)``."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("POST", "/v2/models/simple/infer", body,
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return (resp.status, resp.getheader("Retry-After"),
                json.loads(resp.read() or b"{}"))
    finally:
        conn.close()


def overload_phase():
    """Transient overload through the HTTP front end: a plain request
    sees a typed 429 with ``Retry-After``; a retrying client (up to 8
    attempts, backoff 0.1 s doubling to 0.5 s, the server's
    ``Retry-After`` winning) rides the shed out and gets ``a+b``."""
    from tpuserver_torch.http_server import HttpServer
    from tpuserver_torch.models.simple import SimpleModel

    core = InferenceServer([SimpleModel()])
    frontend = HttpServer(core, port=0).start()
    try:
        data = np.arange(16, dtype=np.int32).reshape(1, 16)
        body = json.dumps({"inputs": [
            {"name": name, "datatype": "INT32", "shape": [1, 16],
             "data": data.ravel().tolist()}
            for name in ("INPUT0", "INPUT1")]})
        core.set_max_inflight(0)
        status, retry_after, _ = _post_infer(frontend.port, body)
        if status != 429:
            fail("overload: expected 429, got {}".format(status))
        elif retry_after is None:
            fail("overload: the 429 carries no Retry-After")
        timer = threading.Timer(0.3, core.set_max_inflight, args=(None,))
        timer.start()
        try:
            for attempt in range(8):
                status, retry_after, answer = _post_infer(frontend.port,
                                                          body)
                if status not in (429, 503) or attempt == 7:
                    break
                time.sleep(float(retry_after) if retry_after is not None
                           else min(0.5, 0.1 * 2 ** attempt))
            if status != 200:
                fail("overload: retry client failed: {} {}".format(
                    status, answer))
            else:
                out = {o["name"]: o["data"] for o in answer["outputs"]}
                if out.get("OUTPUT0") != (data + data).ravel().tolist():
                    fail("overload: retried result wrong")
                else:
                    print("overload phase: shed typed 429, retry client "
                          "rode it out", flush=True)
        finally:
            timer.cancel()
    finally:
        frontend.stop()
        core.close()


def default_phase(serving, rounds, slots, budget):
    """The default soak: ``rounds`` chaos rounds over ``FAULT_CYCLE``,
    the overload phase, and a graceful drain."""
    model = serving.model(
        slots,
        # every step/fetch round of the cycle costs one supervised
        # restart on purpose; the budget must outlast the soak
        rounds + 4)
    core = InferenceServer([model])
    print("warming up (builds the scheduler)...", flush=True)
    reference = [generate(core, p, budget) for p in PROMPTS]
    STATS["reference"] = reference
    print("reference tokens captured: {}; starting {} chaos "
          "rounds".format(reference, rounds), flush=True)
    for rnd in range(rounds):
        chaos_round(core, model, reference, budget, rnd)
    STATS["restarts"] = model._scheduler.stats()["restarts"]
    overload_phase()
    # graceful drain at the end: accepted work finishes, then stop
    core.drain(timeout=10.0)
    if core.server_state() != "stopped":
        fail("drain did not stop the server (state={})".format(
            core.server_state()))


def _killed_round(model, run, what, rnd):
    """One round of ``run(i)`` per prompt, the decode loop killed
    mid-traffic: the fault is armed before the streams start and lets
    the round's first decode step pass, so it lands while they are in
    flight.  Returns the outcomes; asserts the restart counter rose by
    the fires, the scheduler stayed untripped and healthy."""
    restarts_before = model._scheduler.stats()["restarts"]
    outcomes = [None] * len(PROMPTS)

    def worker(i):
        try:
            outcomes[i] = ("ok", run(i))
        except TorchServeError as e:
            outcomes[i] = ("err", e)

    # one unattributable step failure = loop death
    fault_points.install("scheduler.step", mode="raise", times=1, skip=1)
    try:
        _join(_run_workers(worker, len(PROMPTS)), 120)
        fired = fault_points.fired("scheduler.step")
    finally:
        fault_points.clear("scheduler.step")
    stats = model._scheduler.stats()
    for i, outcome in enumerate(outcomes):
        if outcome is None:
            fail("{} round {}: request {} never terminated".format(
                what, rnd, i))
        elif outcome[0] != "ok":
            fail("{} round {}: request {} failed instead of healing: "
                 "{}".format(what, rnd, i, outcome[1]))
    if not fired or stats["restarts"] - restarts_before != fired:
        fail("{} round {}: {} loop kill(s) fired, restarts {} -> "
             "{}".format(what, rnd, fired, restarts_before,
                         stats["restarts"]))
    if stats["tripped"]:
        fail("{} round {}: scheduler tripped inside the budget".format(
            what, rnd))
    if not model.healthy():
        fail("{} round {}: unhealthy after restart".format(what, rnd))
    return outcomes, restarts_before, stats["restarts"]


def kill_loop_phase(serving, rounds, slots, budget):
    """Repeatedly kill the decode loop mid-traffic; assert supervised
    auto-restart with zero lost or corrupted streams."""
    model = serving.model(slots, rounds + 4)
    core = InferenceServer([model])
    print("warming up (builds the scheduler)...", flush=True)
    reference = [generate(core, p, budget) for p in PROMPTS]
    STATS["reference"] = reference
    print("reference captured; killing the loop {} times "
          "mid-traffic".format(rounds), flush=True)

    for rnd in range(rounds):
        outcomes, before, after = _killed_round(
            model, lambda i: generate(core, PROMPTS[i], budget),
            "kill-loop", rnd)
        for i, outcome in enumerate(outcomes):
            if outcome is not None and outcome[0] == "ok":
                chaoslib.check_token_identity(
                    RECORDER, reference[i], outcome[1],
                    context="kill-loop round {}".format(rnd),
                    message="kill-loop round {}: request {} tokens "
                            "corrupted: {} != {}".format(
                                rnd, i, outcome[1], reference[i]))
        wait_no_leaks(model, "kill-loop round {}".format(rnd))
        print("round {:2d} restarts {} -> {} outcomes={}".format(
            rnd, before, after,
            [o[0] if o else "hang" for o in outcomes]), flush=True)
    STATS["restarts"] = model._scheduler.stats()["restarts"]

    core.drain(timeout=10.0)
    if core.server_state() != "stopped":
        fail("kill-loop drain did not stop the server (state={})".format(
            core.server_state()))


def shm_phase(serving, rounds, slots, budget):
    """Soak the shm data plane: concurrent token-ring generations with
    the decode loop killed mid-traffic every round, plus a disconnect ->
    park-export -> attach-resume cycle.  Invariants: every stream heals
    with ring content token-identical to the fault-free reference,
    ``cuda_shm_status`` stays consistent after healing (exactly the
    client's ring region — no stale ``kvexport/*``), and teardown leaves
    ZERO leaked regions."""
    from tpuserver_torch import cuda_shared_memory as csm

    model = serving.model(slots, rounds + 4)
    core = InferenceServer([model])
    baseline = {id(h) for h in csm.allocated_shared_memory_regions()}
    lane_bytes = budget * 8
    ring_size = lane_bytes * (len(PROMPTS) + 1)
    ring = csm.create_shared_memory_region("chaos_ring", ring_size,
                                           device=serving.device)
    core.register_cuda_shm(
        "chaos_ring", csm.get_raw_handle(ring), 0, ring_size)
    reads = [0]

    def ring_tokens(lane, n):
        # a lane's (TOKEN, LOGPROB) slots, read from the region's memory
        reads[0] += 1
        slots_ = csm.get_contents_as_numpy(
            ring, "INT32", [budget, 2], lane * lane_bytes)
        return [int(slots_[s % budget, 0]) for s in range(n)]

    def ring_params(lane):
        return {"shm_ring_region": "chaos_ring", "shm_ring_slots": budget,
                "shm_ring_offset": lane * lane_bytes}

    print("warming up (builds the scheduler)...", flush=True)
    reference = [generate(core, p, budget) for p in PROMPTS]
    STATS["reference"] = reference
    print("reference captured; {} shm-ring chaos rounds".format(rounds),
          flush=True)

    for rnd in range(rounds):
        # loop death mid-traffic: the supervised restart must heal the
        # rings too (replayed slots rewrite, seq numbering preserved)
        outcomes, _, _ = _killed_round(
            model, lambda i, rnd=rnd: generate(
                core, PROMPTS[i], budget,
                parameters=dict(ring_params(i),
                                generation_id="shm-{}-{}".format(rnd, i))),
            "shm", rnd)
        for i, outcome in enumerate(outcomes):
            if outcome is not None and outcome[0] == "ok":
                got = ring_tokens(i, budget)
                chaoslib.check_token_identity(
                    RECORDER, reference[i], got,
                    context="shm round {}".format(rnd),
                    message="shm round {}: ring {} tokens corrupted "
                            "after healing: {} != {}".format(
                                rnd, i, got, reference[i]))
        # disconnect -> park-export -> attach-resume, on the spare lane
        lane = len(PROMPTS)
        gid = "shm-park-{}".format(rnd)
        inputs = {"PROMPT_IDS": PROMPTS[0],
                  "MAX_TOKENS": np.array([budget], np.int32)}
        stream = core.infer_stream(InferRequest(
            "llama_generate", inputs=inputs,
            parameters=dict(ring_params(lane), generation_id=gid,
                            kv_park=True)))
        for _ in range(max(1, budget // 2)):
            next(stream)
        stream.close()
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            if "kvexport/" + gid in core.cuda_shm_status():
                break
            time.sleep(0.02)
        resume_req = InferRequest(
            "llama_generate", inputs=inputs,
            parameters=dict(ring_params(lane), resume_generation_id=gid,
                            resume_from_seq=0))
        # ring-mode events carry only descriptors: token identity is
        # judged on the ring lane; here pin gap-free seq numbering
        seqs = [resp.parameters.get("seq")
                for resp in core.infer_stream(resume_req)]
        chaoslib.check_seq_continuity(
            RECORDER, seqs, expected_len=budget,
            context="shm round {}".format(rnd),
            message="shm round {}: attach-resume seqs not gap-free: "
                    "{}".format(rnd, seqs))
        chaoslib.check_token_identity(
            RECORDER, reference[0], ring_tokens(lane, budget),
            context="shm round {}".format(rnd),
            message="shm round {}: attach-resume ring lane not "
                    "rewritten".format(rnd))
        wait_no_leaks(model, "shm round {}".format(rnd))
        status = set(core.cuda_shm_status())
        chaoslib.check_shm_consistency(
            RECORDER, status, {"chaos_ring"},
            context="shm round {}".format(rnd),
            message="shm round {}: cuda_shm_status inconsistent after "
                    "healing: {}".format(rnd, sorted(status)))
        stats = model._scheduler.stats()
        print("round {:2d} restarts={} status ok".format(
            rnd, stats["restarts"]), flush=True)
    STATS["restarts"] = model._scheduler.stats()["restarts"]
    STATS["ring_reads"] = reads[0]
    STATS["shm"] = core.shm_stats()

    core.drain(timeout=10.0)
    if core.server_state() != "stopped":
        fail("shm drain did not stop the server (state={})".format(
            core.server_state()))
    # drain dropped every server-owned export; only the client ring
    # remains, and its unregister must now succeed (no lingering pins)
    leftovers = set(core.cuda_shm_status())
    chaoslib.check_shm_consistency(
        RECORDER, leftovers, {"chaos_ring"}, context="shm teardown",
        message="shm teardown: leaked regions {}".format(
            sorted(leftovers)))
    try:
        core.unregister_cuda_shm("chaos_ring")
    except TorchServeError as e:
        fail("shm teardown: ring still pinned after drain: {}".format(e))
    if core.cuda_shm_status() != {}:
        fail("shm teardown: regions leaked past unregister")
    csm.destroy_shared_memory_region(ring)
    left = [h.name for h in csm.allocated_shared_memory_regions()
            if id(h) not in baseline]
    if left:
        fail("shm teardown: regions still allocated: {}".format(left))


def router_phase(serving, cycles, soak, budget, spec_tokens=0):
    """Fleet-router soak: plain clients stream through a FleetRouter
    over two replicas while one replica SIGTERM-drains/revives and live
    upstream streams are severed mid-generation every cycle.  With
    ``spec_tokens > 0`` both replicas run the speculative decoding
    engine — the reference capture, severs, drains and handoffs must
    all land on the identical token streams."""
    from tpuserver_torch.core import install_sigterm_drain
    from tpuserver_torch.fleet_router import FleetRouter
    from tpuserver_torch.http_server import HttpServer
    from tpuserver_torch.models.simple import SimpleModel

    scopes = ("router-a", "router-b")
    models = [serving.model(4, 64, spec_tokens=spec_tokens)
              for _ in scopes]
    cores = [
        InferenceServer([model, SimpleModel()], fault_scope=scope)
        for model, scope in zip(models, scopes)
    ]
    frontends = [HttpServer(core, port=0).start() for core in cores]
    urls = [f.url for f in frontends]
    router = FleetRouter(urls, probe_interval_s=0.05,
                         probe_timeout_s=1.0).start()
    previous = install_sigterm_drain(cores[1], drain_timeout=10.0)

    try:
        print("warming up both replicas (builds each scheduler)...",
              flush=True)
        reference = [generate(cores[0], p, budget) for p in PROMPTS]
        twin = [generate(cores[1], p, budget) for p in PROMPTS]
        if reference != twin:
            fail("router: replicas disagree on greedy reference tokens — "
                 "cross-replica handoff cannot be token-identical")
        shared_ref = generate(cores[0], SHARED_PROMPT, budget)
        if shared_ref != generate(cores[1], SHARED_PROMPT, budget):
            fail("router: replicas disagree on the shared-prefix prompt's "
                 "greedy tokens")
        print("reference captured; {} cycles of SIGTERM-drain + "
              "mid-stream severs through the router".format(cycles),
              flush=True)

        metrics_check = RouterMetricsCheck(
            router.url, "router", require_prefix=True)
        metrics_check.check(-1)  # seed the baseline pre-chaos
        resumes = [0]

        def replica_stats(url):
            return [r for r in router.stats()["replicas"]
                    if r["url"] == url][0]

        def worker(wid, n, cycle):
            for i in range(n):
                which = (wid + i) % len(PROMPTS)
                try:
                    tokens, seqs = stream_generation(
                        [router.url], "llama_generate", PROMPTS[which],
                        budget, on_reconnect=lambda a, e: resumes.__setitem__(
                            0, resumes[0] + 1))
                except Exception as e:  # noqa: BLE001 — the invariant
                    fail("router cycle {}: user-visible stream error "
                         "({}: {})".format(cycle, type(e).__name__, e))
                    continue
                chaoslib.check_token_identity(
                    RECORDER, reference[which], tokens,
                    context="router cycle {}".format(cycle),
                    message="router cycle {}: stream tokens diverged: "
                            "{} != {}".format(cycle, tokens,
                                              reference[which]))
                chaoslib.check_seq_continuity(
                    RECORDER, seqs, expected_len=budget,
                    context="router cycle {}".format(cycle),
                    message="router cycle {}: seq gap/duplicate: "
                            "{}".format(cycle, seqs))

        for cycle in range(cycles):
            stats_before = router.stats()
            # sever the serving connection of up to 2 live streams per
            # replica this cycle: a mid-generation replica-connection
            # death the router must absorb via handoff
            for scope in scopes:
                fault_points.install("http.generate_stream", mode="raise",
                                     times=2, skip=3, scope=scope)
            threads = [
                threading.Thread(target=worker, args=(w, soak, cycle),
                                 daemon=True)
                for w in range(4)
            ]
            for t in threads:
                t.start()
            time.sleep(0.05)  # streams in flight through the router
            # SIGTERM-drain replica b mid-traffic: in-flight work
            # finishes, new work sheds typed 503 the router routes
            # around, and the prober rotates b out
            os.kill(os.getpid(), signal.SIGTERM)
            _join(threads, 300)
            fault_points.clear("http.generate_stream")

            deadline = time.monotonic() + 15.0
            while (cores[1].server_state() != "stopped"
                   and time.monotonic() < deadline):
                time.sleep(0.02)
            if cores[1].server_state() != "stopped":
                fail("router cycle {}: SIGTERM drain never completed "
                     "(state={})".format(cycle, cores[1].server_state()))
            if replica_stats(urls[1])["eligible"]:
                # the prober had a whole drain to notice
                fail("router cycle {}: drained replica still "
                     "eligible".format(cycle))
            # revive: re-attach flips stopped -> ready, the prober
            # rotates b back in
            cores[1].attach_frontend()
            cores[1].detach_frontend()
            deadline = time.monotonic() + 10.0
            while (not replica_stats(urls[1])["eligible"]
                   and time.monotonic() < deadline):
                time.sleep(0.02)
            if not replica_stats(urls[1])["eligible"]:
                fail("router cycle {}: revived replica never rotated "
                     "back in".format(cycle))
            for model, scope in zip(models, scopes):
                if model._scheduler is not None:
                    wait_no_leaks(model, "router cycle {} ({})".format(
                        cycle, scope))
            # telemetry invariant: scrapeable + monotonic across the
            # drain/revive, and the prefix cache keeps WARMING: the
            # drained replica's scheduler (and radix cache) was rebuilt
            hits_before = metrics_check.prefix_hits
            drive_shared_streams(router.url, "router", cycle,
                                 shared_ref, budget)
            metrics_check.check(cycle)
            assert_prefix_rewarmed(metrics_check, hits_before, cycle)
            stats = router.stats()
            print("cycle {:2d} handoffs={} failovers={} shed={} "
                  "client_resumes={}".format(
                      cycle,
                      stats["handoffs"] - stats_before["handoffs"],
                      stats["failovers"] - stats_before["failovers"],
                      stats["shed"] - stats_before["shed"],
                      resumes[0]), flush=True)
        if router.stats()["handoffs"] == 0:
            fail("router: the soak never exercised a cross-replica "
                 "handoff (severs did not land mid-stream?)")
    finally:
        signal.signal(signal.SIGTERM, previous)
        router.stop()
        for f in frontends:
            f.stop()
        for c in cores:
            c.close()


def fleet_phase(serving_args, cycles, soak, budget):
    """Supervised-fleet soak: SIGKILL a random replica PROCESS
    mid-traffic every cycle; the router's handoff keeps every stream
    token-identical and the supervisor restores the replica count."""
    from tpuserver_torch import fleet_cli
    from tpuserver_torch.fleet import FleetSupervisor

    config, dtype, device, max_seq = serving_args
    command = fleet_cli.replica_command(argparse.Namespace(
        stub=False, config=config, max_seq=max_seq, max_slots=4, seed=0,
        models="llama,fixtures", spec_tokens=0, drain_timeout=10,
        device=device)) + ["--dtype", dtype]
    env = {"PYTHONPATH": chaos_campaign.SRC_PYTHON}
    if device == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    # min == max pins the target count: this soak is about HEALING
    # back to target, not elastic scaling
    supervisor = FleetSupervisor(
        command, replicas=2, min_replicas=2, max_replicas=2,
        probe_interval_s=0.2, probe_timeout_s=5.0,
        start_timeout_s=180.0, drain_grace_s=10.0,
        # a just-respawned replica warming up under full load can stall
        # health answers for seconds; that is warmup, not a wedge
        unhealthy_after=20,
        max_restarts=cycles + 4, restart_window_s=3600.0,
        restart_backoff_s=0.05, scope_prefix="chaos-fleet-r",
        router_kwargs={"probe_interval_s": 0.05}, env=env,
    ).start()
    rng = random.Random(1234)

    def fleet_recovered(restarts_before, timeout_s=180.0):
        """Recovered = the kill was actually NOTICED (restart counter
        moved past the cycle's baseline) AND the fleet is back at target
        count with full router membership."""
        return chaoslib.wait_fleet_converged(
            supervisor.stats, membership_fn=supervisor.router.membership,
            restarts_above=restarts_before, up=2, members=2,
            timeout_s=timeout_s)

    def stream_prompt(prompt):
        return stream_generation([supervisor.router.url], "llama_generate",
                                 prompt, budget)

    try:
        if not supervisor.wait_ready(timeout_s=180.0):
            fail("fleet: replicas never became ready")
            return
        print("warming up both replica processes...", flush=True)
        reference = []
        for prompt in PROMPTS:
            # one pass per replica; greedy decode must agree across
            # processes
            tokens, _ = stream_prompt(prompt)
            twin, _ = stream_prompt(prompt)
            if tokens != twin:
                fail("fleet: replicas disagree on greedy reference "
                     "tokens for prompt {}".format(prompt.tolist()))
            reference.append(tokens)
        shared_ref, _ = stream_prompt(SHARED_PROMPT)
        shared_twin, _ = stream_prompt(SHARED_PROMPT)
        if shared_ref != shared_twin:
            fail("fleet: shared-prefix greedy tokens disagree across "
                 "streams")
        print("reference captured; {} cycles of SIGKILL "
              "mid-traffic".format(cycles), flush=True)

        metrics_check = RouterMetricsCheck(
            supervisor.router.url, "fleet", require_prefix=True)
        metrics_check.check(-1)  # seed the baseline pre-chaos

        for cycle in range(cycles):
            restarts_before = supervisor.stats()["replica_restarts"]

            def worker(wid, n=soak, cycle=cycle):
                for i in range(n):
                    which = (wid + i) % len(PROMPTS)
                    try:
                        tokens, seqs = stream_prompt(PROMPTS[which])
                    except Exception as e:  # noqa: BLE001
                        fail("fleet cycle {}: user-visible stream "
                             "error ({}: {})".format(
                                 cycle, type(e).__name__, e))
                        continue
                    chaoslib.check_token_identity(
                        RECORDER, reference[which], tokens,
                        context="fleet cycle {}".format(cycle),
                        message="fleet cycle {}: stream tokens "
                                "diverged: {} != {}".format(
                                    cycle, tokens, reference[which]))
                    chaoslib.check_seq_continuity(
                        RECORDER, seqs, expected_len=budget,
                        context="fleet cycle {}".format(cycle),
                        message="fleet cycle {}: seq gap/"
                                "duplicate: {}".format(cycle, seqs))

            threads = _run_workers(worker, 4)
            time.sleep(0.2)  # streams in flight through the router
            ups = [r for r in supervisor.stats()["replicas"]
                   if r["state"] == "up" and r["pid"]]
            if not ups:
                fail("fleet cycle {}: no live replica to kill".format(
                    cycle))
            else:
                victim = rng.choice(ups)
                os.kill(victim["pid"], signal.SIGKILL)
            _join(threads, 600)
            if not fleet_recovered(restarts_before):
                fail("fleet cycle {}: replica count never recovered "
                     "to target (stats={})".format(
                         cycle, supervisor.stats()))
            # telemetry invariant: the SIGKILLed replica's counters
            # reset in ITS exposition, but the router's aggregated view
            # stays monotonic and scrapeable mid-heal, and the respawned
            # replica's cold radix cache RE-WARMS
            hits_before = metrics_check.prefix_hits
            drive_shared_streams(supervisor.router.url, "fleet", cycle,
                                 shared_ref, budget)
            metrics_check.check(cycle)
            assert_prefix_rewarmed(metrics_check, hits_before, cycle)
            stats = supervisor.stats()
            print("cycle {:2d} restarts {} -> {} up={} handoffs={}"
                  .format(cycle, restarts_before,
                          stats["replica_restarts"], stats["up"],
                          supervisor.router.stats()["handoffs"]),
                  flush=True)
        stats = supervisor.stats()
        if stats["replica_restarts"] < cycles:
            fail("fleet: expected >= {} supervised restarts, saw {}"
                 .format(cycles, stats["replica_restarts"]))
        if stats["retired_replicas"]:
            fail("fleet: {} replica(s) retired inside the budget"
                 .format(stats["retired_replicas"]))
    finally:
        supervisor.stop()


def _metric(url, family):
    """The value of ``family``'s first sample on ``url``'s ``/metrics``,
    or None."""
    host, _, port = url.rpartition(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=5)
    try:
        conn.request("GET", "/metrics")
        resp = conn.getresponse()
        if resp.status != 200:
            return None
        for line in resp.read().decode().splitlines():
            if line.startswith(family):
                return float(line.split()[-1])
        return None
    except (OSError, http.client.HTTPException):
        return None
    finally:
        conn.close()


def _stub_stream(what, urls, prompt, budget, cycle, parameters=None,
                 max_reconnects=10, on_reconnect=None):
    """One slowed stub generation (25 ms a token); ``(None, None)`` on a
    user-visible error, recorded."""
    try:
        return stream_generation(
            urls, "stub", prompt, budget,
            dict({"token_delay_ms": 25}, **(parameters or {})),
            max_reconnects=max_reconnects, on_reconnect=on_reconnect)
    except Exception as e:  # noqa: BLE001 — the invariant
        fail("{} cycle {}: user-visible stream error ({}: {}: {})".format(
            what.split()[0], cycle, what, type(e).__name__, e))
        return None, None


def _check_stream(what, cycle, reference, tokens, seqs, budget):
    context = "{} cycle {}".format(what, cycle)
    chaoslib.check_token_identity(
        RECORDER, reference, tokens, context=context,
        message="{}: stream tokens diverged: {} != {}".format(
            context, tokens, reference))
    if seqs is not None:
        chaoslib.check_seq_continuity(
            RECORDER, seqs, expected_len=budget, context=context,
            message="{}: seq gap/duplicate: {}".format(context, seqs))


def _routers_up(supervisor, timeout_s=60.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        routers = supervisor.stats().get("routers", [])
        if routers and all(r["state"] == "up" for r in routers):
            return True
        time.sleep(0.1)
    return False


def _wait_takeover(supervisor, stats_before, timeout_s=60.0):
    """True once ``router_takeovers`` moved past ``stats_before``'s and
    every router process is back up."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        stats = supervisor.stats()
        if (stats.get("router_takeovers", 0)
                > stats_before.get("router_takeovers", 0)
                and _routers_up(supervisor, timeout_s=0.1)):
            return True
        time.sleep(0.1)
    return False


def gray_phase(cycles, soak):
    """``--gray``: gray-failure ejection soak (tail-latency defense).

    A FleetRouter fronts three stub replicas with baseline latency
    jitter.  Each cycle one replica turns GRAY — it keeps answering
    health probes but serves ``/infer`` two orders of magnitude slower
    (``POST /stub/state {"infer_delay_ms": ...}``) — while plain unary
    traffic keeps flowing through the router.  Invariants: the router
    SOFT-EJECTS it (``soft-ejected`` row, ``tpu_router_ejections_total``
    moves) with no health signal changing; fleet p99 returns to within
    2x of the healthy baseline while the fault is still active; zero
    user-visible errors; after the fault clears, probe traffic
    re-admits the replica."""
    from tpuserver_torch.fleet_router import FleetRouter
    from tpuserver_torch.perfanalyzer.metrics import percentile

    ports = [chaos_campaign.free_port() for _ in range(3)]
    procs = [
        subprocess.Popen([sys.executable, STUB, "--port", str(p),
                          "--infer-jitter-ms", "2"])
        for p in ports
    ]
    urls = ["127.0.0.1:{}".format(p) for p in ports]
    infer_body = json.dumps({"inputs": [
        {"name": "INPUT0", "datatype": "FP32", "shape": [8],
         "data": [0.0] * 8}]}).encode("utf-8")

    def infer_once(router):
        """One unary infer through the router: latency seconds, or
        None on a user-visible error (the invariant-3 signal)."""
        host, _, port = router.url.rpartition(":")
        conn = http.client.HTTPConnection(host, int(port), timeout=30)
        t0 = time.monotonic()
        try:
            conn.request("POST", "/v2/models/stub/infer", infer_body,
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            body = resp.read()
            if resp.status != 200:
                fail("gray: user-visible error {}: {}".format(
                    resp.status, body[:200]))
                return None
            return time.monotonic() - t0
        except (OSError, http.client.HTTPException) as e:
            fail("gray: user-visible transport error: {}".format(e))
            return None
        finally:
            conn.close()

    def drive(router, n, workers=4):
        """``n`` requests spread over concurrent workers: the in-flight
        spread gives every replica digest coverage."""
        lats = []
        lock = threading.Lock()

        def worker(_):
            for _ in range(max(1, n // workers)):
                lat = infer_once(router)
                if lat is not None:
                    with lock:
                        lats.append(lat)

        _join(_run_workers(worker, workers), None)
        return lats

    def victim_row(router, url):
        for row in router.stats()["replicas"]:
            if row["url"] == url:
                return row
        return None

    def ejections_metric(router):
        for line in router.metrics_text().splitlines():
            if line.startswith("tpu_router_ejections_total"):
                return float(line.split()[-1])
        return None

    try:
        for p in ports:
            if not chaos_campaign.wait_ready(p):
                fail("gray: stub replica never became ready")
                return
        # fast knobs so each cycle's eject->recover->re-admit arc fits
        # a soak budget: small digest, quarter probe fraction, 10 Hz
        # probes driving the (0.1s-throttled) ejection evaluation
        router = FleetRouter(
            urls, probe_interval_s=0.1, outlier_factor=3.0,
            outlier_min_samples=6, min_eligible=1,
            probe_fraction=1.0 / 4, eject_interval_s=0.1,
            digest_window=12).start()
        try:
            drive(router, 12)  # connection/thread warmup out of baseline
            for cycle in range(cycles):
                victim = ports[cycle % len(ports)]
                victim_url = "127.0.0.1:{}".format(victim)
                baseline = drive(router, soak)
                if not baseline:
                    return
                healthy_p99 = percentile(baseline, 99)
                ejections_before = ejections_metric(router)
                post_stub_state(victim_url, {"infer_delay_ms": 200})
                # traffic under the gray fault: the router needs
                # enough completed requests to see the outlier
                deadline = time.monotonic() + 30.0
                ejected = False
                while time.monotonic() < deadline:
                    drive(router, 6)
                    row = victim_row(router, victim_url)
                    if row is not None and row["status"] == "soft-ejected":
                        ejected = True
                        break
                if not ejected:
                    fail("gray cycle {}: router never soft-ejected the "
                         "slow replica".format(cycle))
                    post_stub_state(victim_url, {"infer_delay_ms": 0})
                    continue
                if not victim_row(router, victim_url)["eligible"]:
                    fail("gray cycle {}: ejection leaked into health "
                         "eligibility (gray != down)".format(cycle))
                after = ejections_metric(router)
                if ejections_before is not None and (
                        after is None or after <= ejections_before):
                    fail("gray cycle {}: tpu_router_ejections_total did "
                         "not move ({} -> {})".format(
                             cycle, ejections_before, after))
                # the tail recovers while the fault is STILL active:
                # within 2x of healthy (floored at 50 ms of noise
                # headroom) AND strictly under the injected 200 ms, so
                # a noisy baseline never masks a defense that is not
                # working; one re-measure absorbs a lone host spike
                bound = min(max(2 * healthy_p99, 0.05), 0.18)
                p99 = None
                for _attempt in range(2):
                    recovered = drive(router, soak)
                    if not recovered:
                        break
                    p99 = percentile(recovered, 99)
                    if p99 <= bound:
                        break
                if p99 is not None and p99 > bound:
                    fail("gray cycle {}: fleet p99 {:.1f}ms did not "
                         "recover (healthy baseline {:.1f}ms, bound "
                         "{:.1f}ms)".format(
                             cycle, p99 * 1e3, healthy_p99 * 1e3,
                             bound * 1e3))
                # recovery: clear the fault, probe traffic re-admits
                post_stub_state(victim_url, {"infer_delay_ms": 0})
                deadline = time.monotonic() + 30.0
                readmitted = False
                while time.monotonic() < deadline:
                    drive(router, 8)
                    row = victim_row(router, victim_url)
                    if row is not None and row["status"] == "ok":
                        readmitted = True
                        break
                if not readmitted:
                    fail("gray cycle {}: replica never re-admitted "
                         "after the fault cleared".format(cycle))
                print("gray cycle {}: ejected + p99 recovered + "
                      "re-admitted (healthy p99 {:.1f}ms)".format(
                          cycle, healthy_p99 * 1e3), flush=True)
        finally:
            router.stop()
    finally:
        for proc in procs:
            proc.kill()
        for proc in procs:
            proc.wait(timeout=10)


def router_kill_phase(cycles, soak, budget):
    """``--router-kill``: router-HA soak.

    A FleetSupervisor owns two stub replicas AND the front tier: an
    active ``router_cli`` process (``--journal``) plus a warm standby
    tailing the same journal.  Each cycle, worker clients carrying BOTH
    router urls stream slow generations while the ACTIVE router is
    SIGKILLed mid-traffic.  Invariants: the standby is promoted
    (``router_takeovers`` moves) and the casualty respawns as the new
    standby; zero user-visible stream errors; every stream token-
    identical with gap-free seqs; the new active's
    ``recovered_generations`` and ``tpu_router_journal_records_total``
    are nonzero."""
    supervisor = chaos_campaign.stub_fleet(
        cycles + 4, "rk-stub-", roles=False)
    prompt = [5, 7, 9]
    try:
        if not supervisor.wait_ready(timeout_s=60.0):
            fail("router-kill: stub replicas never became ready")
            return
        if not _routers_up(supervisor):
            fail("router-kill: router processes never came up")
            return
        reference, _ = _stub_stream("router-kill reference",
                                    supervisor.router_urls(), prompt,
                                    budget, -1)
        if reference is None:
            return
        print("reference tokens: {}; {} SIGKILL-the-active-router "
              "cycles".format(reference, cycles), flush=True)

        for cycle in range(cycles):
            stats_before = supervisor.stats()
            urls = supervisor.router_urls()

            def worker(wid, cycle=cycle, urls=urls):
                for i in range(soak):
                    tokens, seqs = _stub_stream(
                        "router-kill worker {} stream {}".format(wid, i),
                        urls, prompt, budget, cycle)
                    if tokens is not None:
                        _check_stream("router-kill", cycle, reference,
                                      tokens, seqs, budget)

            threads = _run_workers(worker, 3)
            time.sleep(0.3)  # streams mid-generation on the router
            active = [r for r in supervisor.stats().get("routers", [])
                      if r["role"] == "active" and r["state"] == "up"
                      and r["pid"]]
            if not active:
                fail("router-kill cycle {}: no live active router to "
                     "kill".format(cycle))
            else:
                os.kill(active[0]["pid"], signal.SIGKILL)
            _join(threads, 300)
            # recovery bar: takeover observed, both routers back up
            if not _wait_takeover(supervisor, stats_before):
                fail("router-kill cycle {}: standby takeover never "
                     "completed (stats={})".format(
                         cycle, supervisor.stats()))
            active_url = supervisor.active_router_url()
            rstats = get_json(active_url, "/router/stats") or {}
            if not rstats.get("recovered_generations"):
                fail("router-kill cycle {}: promoted router recovered "
                     "zero generations from the journal".format(cycle))
            records = _metric(active_url,
                              "tpu_router_journal_records_total")
            if not records:
                fail("router-kill cycle {}: "
                     "tpu_router_journal_records_total missing or zero "
                     "on the active router".format(cycle))
            stats = supervisor.stats()
            print("cycle {:2d} takeovers={} router_restarts={} "
                  "recovered={} journal_records={}".format(
                      cycle, stats.get("router_takeovers"),
                      stats.get("router_restarts"),
                      rstats.get("recovered_generations"), records),
                  flush=True)
    finally:
        supervisor.stop()


def pin_gid(part, tag):
    """A generation id that hashes into partition ``part`` of two
    (brute-forced — the partition function is pure, so the draw is
    deterministic per tag)."""
    from tpuserver_torch.fleet_router import FleetRouter

    n = 0
    while True:
        gid = "mr-{}-{}".format(tag, n)
        if FleetRouter.partition_of(gid, 2) == part:
            return gid
        n += 1


def multi_router_phase(cycles, soak, budget):
    """``--multi-router``: the horizontal front tier.

    A FleetSupervisor owns two stub replicas and a PARTITIONED front
    tier: TWO active ``router_cli`` processes (partitions 0 and 1, each
    with its own journal subdirectory and the selector relay) plus one
    warm standby tailing every partition.  Each cycle, clients pinned
    to BOTH partitions stream slow generations while partition 0's
    active is SIGKILLed mid-traffic.  Invariants:

      1. ``partition_blast_radius``: partition-1 streams — dialed at
         their owner on a single connection with NO fallback urls —
         ride through the sibling's kill with zero reconnects and
         gap-free seqs;
      2. the standby promotes INTO partition 0 (``router_takeovers``
         and the partition-map epoch both advance) and the killed
         partition's streams resume token-identically inside the
         reconnect budget;
      3. ``journal_single_writer`` holds PER PARTITION throughout;
      4. peer handoff: a stream pinned to partition 1 but dialed at
         partition 0's owner relays through the thin proxy hop
         token-identically (the owner's ``partition.forwarded``
         counter moves).
    """
    supervisor = chaos_campaign.stub_fleet(
        cycles + 4, "mr-stub-", roles=False, active_routers=2)
    prompt = [5, 7, 9]

    def router_stats(url):
        return get_json(url, "/router/stats") or {}

    def forwarded(url):
        return (router_stats(url).get("partition") or {}).get(
            "forwarded", 0)

    def owner_urls():
        pmap = supervisor.stats().get("partition_map") or []
        if len(pmap) != 2 or not all(pmap):
            fail("multi-router: partition map incomplete: {}".format(pmap))
            return None
        return pmap

    try:
        if not supervisor.wait_ready(timeout_s=60.0):
            fail("multi-router: stub replicas never became ready")
            return
        if not _routers_up(supervisor):
            fail("multi-router: router processes never came up")
            return
        pmap = owner_urls()
        if pmap is None:
            return
        reference, _ = _stub_stream(
            "multi-router reference", [pmap[0], pmap[1]], prompt, budget,
            -1, {"generation_id": pin_gid(0, "ref")})
        if reference is None:
            return
        print("reference tokens: {}; {} partitioned-tier SIGKILL "
              "cycles".format(reference, cycles), flush=True)

        for cycle in range(cycles):
            stats_before = supervisor.stats()
            pmap = owner_urls()
            if pmap is None:
                return
            all_urls = supervisor.router_urls()
            epoch_before = router_stats(pmap[1]).get("epoch", 0)

            # (4) peer handoff, fault-free: pinned to partition 1,
            # dialed at partition 0's owner — the thin proxy hop
            fwd_before = forwarded(pmap[0])
            tokens, seqs = _stub_stream(
                "multi-router peer-hop",
                [pmap[0]] + [u for u in all_urls if u != pmap[0]],
                prompt, budget, cycle,
                {"generation_id": pin_gid(1, "hop-c{}".format(cycle))})
            if tokens is not None:
                _check_stream("multi-router", cycle, reference, tokens,
                              seqs, budget)
            fwd_after = forwarded(pmap[0])
            if not fwd_after > fwd_before:
                fail("multi-router cycle {}: partition.forwarded never "
                     "moved across a peer-forwarded stream ({} -> {})"
                     .format(cycle, fwd_before, fwd_after))

            # main traffic: victim-partition streams carry the full
            # fallback rotation; survivor streams get NO fallbacks —
            # one unbroken connection or a recorded violation
            survivor_obs = []
            results = []
            lock = threading.Lock()

            def victim_worker(wid, cycle=cycle, pmap=pmap, urls=all_urls):
                for i in range(soak):
                    tokens, seqs = _stub_stream(
                        "multi-router victim w{} s{}".format(wid, i),
                        [pmap[0]] + [u for u in urls if u != pmap[0]],
                        prompt, budget, cycle,
                        {"generation_id": pin_gid(
                            0, "v-c{}-w{}-s{}".format(cycle, wid, i))})
                    if tokens is not None:
                        with lock:
                            results.append((tokens, seqs))

            def survivor_worker(wid, cycle=cycle, pmap=pmap):
                for i in range(soak):
                    count = [0]
                    tokens, seqs = _stub_stream(
                        "multi-router survivor w{} s{}".format(wid, i),
                        [pmap[1]], prompt, budget, cycle,
                        {"generation_id": pin_gid(
                            1, "s-c{}-w{}-s{}".format(cycle, wid, i))},
                        max_reconnects=0,
                        on_reconnect=lambda a, e, count=count:
                            count.__setitem__(0, count[0] + 1))
                    if tokens is not None:
                        with lock:
                            survivor_obs.append({
                                "partition": 1, "reconnects": count[0],
                                "seqs": seqs})
                            results.append((tokens, None))

            threads = (_run_workers(victim_worker, 2)
                       + _run_workers(survivor_worker, 2))
            time.sleep(0.3)  # streams mid-generation on both actives
            victims = [r for r in supervisor.stats().get("routers", [])
                       if r.get("partition") == 0
                       and r["state"] == "up" and r["pid"]]
            if not victims:
                fail("multi-router cycle {}: no live partition-0 "
                     "active to kill".format(cycle))
            else:
                os.kill(victims[0]["pid"], signal.SIGKILL)
            _join(threads, 300)

            for tokens, seqs in results:
                _check_stream("multi-router", cycle, reference, tokens,
                              seqs, budget)
            # (1) the blast radius stayed partition-sized
            chaoslib.check_partition_blast_radius(
                RECORDER, survivor_obs,
                context="multi-router cycle {}".format(cycle))
            if len(survivor_obs) < 2 * soak:
                fail("multi-router cycle {}: only {}/{} survivor "
                     "streams completed".format(
                         cycle, len(survivor_obs), 2 * soak))

            # (2) recovery bar: takeover INTO partition 0 observed,
            # every router process back up, the map rebound under a
            # newer epoch
            if not _wait_takeover(supervisor, stats_before):
                fail("multi-router cycle {}: takeover into the killed "
                     "partition never completed (stats={})".format(
                         cycle, supervisor.stats()))
                return
            pmap = owner_urls()
            if pmap is None:
                return
            epoch_after = router_stats(pmap[1]).get("epoch", 0)
            if not epoch_after > epoch_before:
                fail("multi-router cycle {}: partition-map epoch never "
                     "advanced across the takeover ({} -> {})".format(
                         cycle, epoch_before, epoch_after))
            # (3) one journal writer per partition, throughout
            stats = supervisor.stats()
            chaoslib.check_journal_single_writer(
                RECORDER, stats.get("routers", []),
                context="multi-router cycle {}".format(cycle))
            rstats = router_stats(pmap[0])
            if not rstats.get("recovered_generations"):
                fail("multi-router cycle {}: the promoted partition-0 "
                     "owner recovered zero generations from its "
                     "journal".format(cycle))
            print("cycle {:2d} takeovers={} epoch={} survivors={} "
                  "recovered={}".format(
                      cycle, stats.get("router_takeovers"),
                      epoch_after, len(survivor_obs),
                      rstats.get("recovered_generations")), flush=True)
    finally:
        supervisor.stop()


def disagg_phase(cycles, soak, budget):
    """``--disagg``: disaggregated prefill/decode soak.

    A FleetSupervisor owns a ROLE fleet of stub replicas — one
    ``--role prefill``, one ``--role decode`` — fronted by its
    in-process FleetRouter, which splits every admission (prefill leg,
    one-shot KV-export descriptor claim, decode leg).  Each cycle,
    workers stream slowed generations while the PREFILL replica is
    SIGKILLed.  Invariants: zero user-visible stream errors (an orphaned
    split degrades to the fused path); every stream token-identical with
    gap-free seqs; the supervisor heals the prefill pool back to target
    WITH its role; the healed replica rejoins the split plane (``splits``
    moves again) and the disagg counters never move backwards."""
    supervisor = chaos_campaign.stub_fleet(
        cycles + 4, "disagg-stub-", router_processes=False,
        router_kwargs={"probe_interval_s": 0.05})
    router = supervisor.router
    prompt = [5, 7, 9, 2, 4]

    def prefill_handle():
        rows = [r for r in supervisor.stats()["replicas"]
                if r.get("role") == "prefill"]
        return rows[0] if rows else None

    def disagg_stats():
        return router.stats()["disagg"]

    def splits_resume(splits_before, cycle, timeout_s=30.0):
        """Drive streams until the router's splits counter moves past
        the post-kill value: the healed prefill replica rejoined the
        split plane."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            tokens, _ = _stub_stream("disagg probe", [router.url], prompt,
                                     budget, cycle)
            if tokens is not None and not chaoslib.check_token_identity(
                    RECORDER, reference, tokens,
                    context="disagg cycle {}".format(cycle),
                    message="disagg cycle {}: post-heal tokens "
                            "diverged: {} != {}".format(
                                cycle, tokens, reference)):
                return False
            if disagg_stats()["splits"] > splits_before:
                return True
        return False

    try:
        if not supervisor.wait_ready(timeout_s=60.0):
            fail("disagg: role replicas never became ready")
            return
        reference, ref_seqs = _stub_stream("disagg reference",
                                           [router.url], prompt, budget, -1)
        if reference is None:
            return
        if ref_seqs != list(range(budget)):
            fail("disagg: reference stream seqs not gap-free: "
                 "{}".format(ref_seqs))
        if disagg_stats()["splits"] < 1:
            fail("disagg: the reference stream did not take the "
                 "phase-split path (stats={})".format(disagg_stats()))
        print("reference tokens: {}; {} SIGKILL-the-prefill-replica "
              "cycles".format(reference, cycles), flush=True)

        for cycle in range(cycles):
            restarts_before = supervisor.stats()["replica_restarts"]
            before = disagg_stats()

            def worker(wid, cycle=cycle):
                for i in range(soak):
                    tokens, seqs = _stub_stream(
                        "disagg worker {} stream {}".format(wid, i),
                        [router.url], prompt, budget, cycle)
                    if tokens is not None:
                        _check_stream("disagg", cycle, reference, tokens,
                                      seqs, budget)

            threads = _run_workers(worker, 3)
            # 25 ms token cadence x ``budget`` tokens: by now every
            # worker's stream is mid-handoff or about to re-admit one
            time.sleep(0.3)
            victim = prefill_handle()
            if victim is None or victim["state"] != "up" \
                    or not victim["pid"]:
                fail("disagg cycle {}: no live prefill replica to "
                     "kill".format(cycle))
            else:
                os.kill(victim["pid"], signal.SIGKILL)
            _join(threads, 300)
            if not chaoslib.wait_fleet_converged(
                    supervisor.stats, membership_fn=router.membership,
                    restarts_above=restarts_before,
                    phase_up={"prefill": 1, "decode": 1}, members=2,
                    timeout_s=60.0):
                fail("disagg cycle {}: prefill pool never healed back "
                     "to target with its role (stats={})".format(
                         cycle, supervisor.stats()))
            healed = prefill_handle()
            if healed is None or healed.get("role") != "prefill":
                fail("disagg cycle {}: healed replica lost its role: "
                     "{}".format(cycle, healed))
            after = disagg_stats()
            chaoslib.check_counters_monotonic(
                RECORDER, before, after,
                ("splits", "transfers", "transfer_bytes"),
                context="disagg cycle {}".format(cycle),
                message_fmt=lambda key, prev, now, cycle=cycle:
                    "disagg cycle {}: counter {} moved backwards "
                    "{} -> {}".format(cycle, key, prev, now))
            if not splits_resume(after["splits"], cycle):
                fail("disagg cycle {}: healed prefill replica never "
                     "rejoined the split plane (stats={})".format(
                         cycle, disagg_stats()))
            stats = disagg_stats()
            print("cycle {:2d} splits {} -> {} fallbacks={} "
                  "restarts={}".format(
                      cycle, before["splits"], stats["splits"],
                      stats["fallbacks"],
                      supervisor.stats()["replica_restarts"]),
                  flush=True)
    finally:
        supervisor.stop()


def supervisor_phase(cycles, soak, budget):
    """``--supervisor``: supervisor crash durability soak.

    The supervisor here is a REAL ``python -m tpuserver_torch.fleet_cli``
    PROCESS (stub replicas, a supervised router process, ``--manifest``
    and ``--heartbeat-file``).  Each cycle, workers stream slowed
    generations through the router process while the SUPERVISOR ITSELF
    is SIGKILLed mid-traffic; the streams keep flowing unsupervised, then
    a successor boots against the same manifest under live traffic.
    Invariants: zero user-visible stream errors, headless and across the
    adoption; the successor ADOPTS the survivors (heartbeat
    ``adoptions`` moves, every replica keeps its pid and restart count);
    while headless each replica's port still serves
    ``/v2/health/stats`` from the pid the last heartbeat reported; the
    successor takes the manifest's lock without ``--takeover``."""

    workdir = tempfile.mkdtemp(prefix="chaos-supervisor-")
    manifest_dir = os.path.join(workdir, "manifest")
    heartbeat = os.path.join(workdir, "heartbeat.json")
    # the router PROCESS outlives every supervisor death, so clients
    # keep one stable address all soak
    router_url = "127.0.0.1:{}".format(chaos_campaign.free_port())
    # --stop-fleet pins the FINAL SIGTERM to full teardown (this soak
    # proves adoption via SIGKILL, which never reaches a handler)
    argv = [
        sys.executable, "-m", "tpuserver_torch.fleet_cli",
        "--stub", "--replicas", "2", "--min-replicas", "2",
        "--max-replicas", "2", "--router-processes",
        "--router-port", router_url.rpartition(":")[2],
        "--manifest", manifest_dir, "--heartbeat-file", heartbeat,
        "--probe-interval", "0.1",
        "--max-restarts", str(cycles + 4),
        "--restart-window", "3600", "--stop-fleet",
    ]
    env = dict(os.environ, PYTHONPATH=chaos_campaign.SRC_PYTHON)
    generation = [0]

    def spawn_supervisor():
        generation[0] += 1
        # a file, not a pipe: the children inherit it and outlive the
        # supervisor
        with open(os.path.join(workdir, "supervisor-{}.log".format(
                generation[0])), "wb") as log:
            return subprocess.Popen(argv, env=env, stdout=log,
                                    stderr=subprocess.STDOUT)

    def supervisor_log_tail():
        path = os.path.join(
            workdir, "supervisor-{}.log".format(generation[0]))
        try:
            with open(path, "rb") as fh:
                return fh.read().decode(errors="replace")[-2000:]
        except OSError:
            return "<no log>"

    def read_heartbeat():
        try:
            with open(heartbeat) as fh:
                return json.load(fh)
        except (OSError, ValueError):
            return None

    def wait_heartbeat(predicate, timeout_s=60.0):
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            beat = read_heartbeat()
            if beat is not None and predicate(beat):
                return beat
            time.sleep(0.1)
        return None

    prompt = [5, 7, 9]
    sup = spawn_supervisor()
    try:
        beat = wait_heartbeat(
            lambda b: b.get("replicas") and b.get("routers")
            and all(r["state"] == "up" for r in b["replicas"])
            and all(r["state"] == "up" for r in b["routers"]))
        if beat is None:
            fail("supervisor: fleet never became ready (heartbeat={} "
                 "log tail: {})".format(
                     read_heartbeat(), supervisor_log_tail()))
            return
        reference, _ = _stub_stream("supervisor reference", [router_url],
                                    prompt, budget, -1)
        if reference is None:
            return
        print("reference tokens: {}; {} SIGKILL-the-SUPERVISOR "
              "cycles".format(reference, cycles), flush=True)

        for cycle in range(cycles):
            before = read_heartbeat()
            if not before or not before.get("replicas"):
                fail("supervisor cycle {}: no heartbeat before the "
                     "kill".format(cycle))
                return

            def worker(wid, cycle=cycle):
                for i in range(soak):
                    tokens, seqs = _stub_stream(
                        "supervisor worker {} stream {}".format(wid, i),
                        [router_url], prompt, budget, cycle)
                    if tokens is not None:
                        _check_stream("supervisor", cycle, reference,
                                      tokens, seqs, budget)

            threads = _run_workers(worker, 3)
            time.sleep(0.3)  # streams mid-generation on the router
            os.kill(sup.pid, signal.SIGKILL)
            sup.wait(timeout=30)
            # the fleet is now HEADLESS: keep streaming through it for
            # a beat before anyone could re-supervise it
            time.sleep(0.4)
            for row in before["replicas"]:
                snap = get_json(row["url"], "/v2/health/stats")
                if snap is None:
                    fail("supervisor cycle {}: replica {} ({}) stopped "
                         "serving while unsupervised".format(
                             cycle, row["index"], row["url"]))
                elif snap.get("pid") != row["pid"]:
                    fail("supervisor cycle {}: replica {} port {} "
                         "served by pid {} != heartbeat pid {} — "
                         "something double-spawned it".format(
                             cycle, row["index"], row["url"],
                             snap.get("pid"), row["pid"]))
            # successor under LIVE traffic; the kernel released the
            # flock with the SIGKILL, so no --takeover needed
            sup = spawn_supervisor()
            new_pid = sup.pid
            _join(threads, 300)
            beat = wait_heartbeat(
                lambda b: b.get("pid") == new_pid and b.get("replicas")
                and all(r["state"] == "up" for r in b["replicas"]))
            if beat is None:
                fail("supervisor cycle {}: successor never stamped a "
                     "healthy heartbeat (heartbeat={} log tail: "
                     "{})".format(cycle, read_heartbeat(),
                                  supervisor_log_tail()))
                return
            chaoslib.check_supervisor_adoption(
                RECORDER,
                {r["index"]: r for r in before["replicas"]},
                {r["index"] for r in before["replicas"]},
                {"adoptions": beat["adoptions"] - before["adoptions"],
                 "replicas": beat["replicas"]},
                context="supervisor cycle {}".format(cycle))
            print("cycle {:2d} adoptions {} -> {} replica pids {} "
                  "restarts={}".format(
                      cycle, before["adoptions"], beat["adoptions"],
                      [r["pid"] for r in beat["replicas"]],
                      beat["replica_restarts"]), flush=True)
    finally:
        if sup.poll() is None:
            sup.terminate()  # --stop-fleet: SIGTERM = full teardown
            try:
                sup.wait(timeout=60)
            except subprocess.TimeoutExpired:
                sup.kill()
                sup.wait(timeout=10)
        # if a cycle failed while headless, reap whatever the last
        # heartbeat still names
        beat = read_heartbeat()
        for row in ((beat or {}).get("replicas", [])
                    + (beat or {}).get("routers", [])):
            if row.get("pid"):
                try:
                    os.kill(row["pid"], signal.SIGKILL)
                except OSError:
                    pass
        shutil.rmtree(workdir, ignore_errors=True)


def build_parser():
    from tpuserver_torch.models.llama import PRESETS

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--rounds", type=int, default=8,
                        help="chaos rounds (default 8: two full cycles)")
    parser.add_argument("--slots", type=int, default=2,
                        help="scheduler slots (default 2)")
    parser.add_argument("--budget", type=int, default=6,
                        help="tokens per generation (default 6)")
    parser.add_argument("--pool", action="store_true",
                        help="the client library's endpoint-pool soak: "
                             "not ported (exits 2)")
    parser.add_argument("--router", action="store_true",
                        help="soak the fleet-router tier instead: plain "
                             "clients stream through a FleetRouter while "
                             "one replica SIGTERM-drains/revives and live "
                             "streams are severed mid-generation")
    parser.add_argument("--fleet", action="store_true",
                        help="soak the supervised fleet tier instead: "
                             "real replica processes under a "
                             "FleetSupervisor, one SIGKILLed at random "
                             "mid-traffic every cycle")
    parser.add_argument("--kill-loop", action="store_true",
                        help="soak the supervised-restart layer instead: "
                             "kill the decode loop mid-traffic every "
                             "round, assert auto-restart with zero lost "
                             "or corrupted streams")
    parser.add_argument("--router-kill", action="store_true",
                        help="soak router HA instead: a supervised stub "
                             "fleet with active + standby router processes "
                             "sharing one crash journal; the ACTIVE router "
                             "is SIGKILLed mid-traffic every cycle")
    parser.add_argument("--multi-router", action="store_true",
                        dest="multi_router",
                        help="soak the partitioned front tier instead: a "
                             "supervised stub fleet with TWO active "
                             "partitioned routers + a warm standby; "
                             "partition 0's active is SIGKILLed "
                             "mid-traffic every cycle")
    parser.add_argument("--disagg", action="store_true",
                        help="soak disaggregated prefill/decode serving "
                             "instead: a role stub fleet with the PREFILL "
                             "replica SIGKILLed mid-handoff every cycle")
    parser.add_argument("--supervisor", action="store_true",
                        help="soak supervisor crash durability instead: "
                             "a real fleet_cli process (stub replicas, "
                             "router process, manifest + heartbeat) "
                             "SIGKILLed mid-traffic every cycle")
    parser.add_argument("--gray", action="store_true",
                        help="soak the gray-failure ejection layer "
                             "instead: a stub-fleet router with one "
                             "replica turned slow-but-alive mid-soak")
    parser.add_argument("--shm", action="store_true",
                        help="soak the shm data plane instead: token-"
                             "ring streams + park-export/attach-resume "
                             "under decode-loop kills")
    parser.add_argument("--cycles", type=int, default=4,
                        help="fault cycles of the router, fleet and stub "
                             "modes (default 4)")
    parser.add_argument("--soak", type=int, default=None,
                        help="requests per worker per cycle (default: 6 "
                             "full generations in router mode, 4 in "
                             "fleet mode, 160 in gray mode, 2-3 in the "
                             "other stub modes)")
    parser.add_argument("--spec-tokens", type=int, default=0,
                        help="router mode: run both replicas with the "
                             "speculative decoding engine at this draft "
                             "budget (0 = off); every identity check "
                             "must still hold")
    parser.add_argument("--config", default="tiny", choices=sorted(PRESETS),
                        help="the model modes' llama config (default "
                             "tiny, at vocab 512)")
    parser.add_argument("--dtype", default="float32",
                        choices=("float32", "bfloat16"),
                        help="the model modes' weight type (default "
                             "float32)")
    parser.add_argument("--device", default=None,
                        help="the model modes' device (default: the card; "
                             "'cpu' for a CPU run)")
    parser.add_argument("--max-seq", type=int, default=MAX_SEQ,
                        help="the model modes' context length (default "
                             "{}; the decode kernel runs from 128, the "
                             "least length its blocks tile)".format(
                                 MAX_SEQ))
    return parser


#: mode -> (its soak's default per-worker requests, the OK line's format
#: over (cycles or rounds, seconds)); the model-free modes double the
#: token budget, as their slowed stub streams are cheap
MODES = {
    "router_kill": (3, "router-kill chaos smoke OK: {} active-router "
                       "SIGKILL cycles, {:.1f}s, standby takeover + "
                       "journal recovery, zero user-visible errors, zero "
                       "lost or duplicated tokens"),
    "multi_router": (2, "multi-router chaos smoke OK: {} partitioned-tier "
                        "SIGKILL cycles, {:.1f}s, surviving partition "
                        "uninterrupted (zero reconnects), standby promoted "
                        "into the killed partition, epoch advanced, peer "
                        "handoff token-identical"),
    "disagg": (3, "disagg chaos smoke OK: {} prefill-SIGKILL cycles, "
                  "{:.1f}s, zero user-visible errors, token-identical "
                  "gap-free streams, role-preserving healing, split plane "
                  "re-armed every cycle"),
    "supervisor": (3, "supervisor chaos smoke OK: {} supervisor-SIGKILL "
                      "cycles, {:.1f}s, zero user-visible errors, every "
                      "survivor adopted (no double-spawn, no budget "
                      "burn)"),
    "gray": (160, "gray chaos smoke OK: {} gray cycles, {:.1f}s, "
                  "soft-ejection + p99 recovery + re-admission, zero "
                  "user-visible errors"),
    "shm": (None, "shm chaos smoke OK: {} rounds, {:.1f}s, token-identical "
                  "rings, consistent cuda_shm_status, zero leaked "
                  "regions"),
    "fleet": (4, "fleet chaos smoke OK: {} SIGKILL cycles, {:.1f}s, zero "
                 "user-visible errors, zero lost or duplicated tokens, "
                 "fleet back at target count every cycle"),
    "router": (6, "router chaos smoke OK: {} drain/sever cycles, {:.1f}s, "
                  "zero user-visible errors, zero lost or duplicated "
                  "tokens"),
    "kill_loop": (None, "kill-loop chaos smoke OK: {} loop kills healed, "
                        "{:.1f}s, zero lost or corrupted streams"),
    "default": (None, "chaos smoke OK: {} rounds + overload phase + drain, "
                      "{:.1f}s, all invariants held"),
}


def main(argv=None, params=None):
    """Run the soak that ``argv`` names; 0 when every invariant held, 1
    on a violation, 2 for ``--pool``.  ``params``: the weights the model
    modes serve (on ``--device``, in ``--dtype``), else drawn from seed
    0."""
    args = build_parser().parse_args(argv)
    if args.pool:
        print("--pool is not ported: it soaks the client library's "
              "endpoint pool and circuit breakers, not the server; run "
              "tools/chaos_smoke.py --pool", file=sys.stderr)
        return 2
    mode = next((m for m in MODES if m != "default"
                 and getattr(args, m, False)), "default")
    default_soak, ok_line = MODES[mode]
    soak = args.soak if args.soak is not None else default_soak
    del _failures[:]
    STATS.clear()
    STATS["mode"] = mode
    t0 = time.monotonic()
    try:
        if mode in ("router_kill", "multi_router", "disagg", "supervisor"):
            {"router_kill": router_kill_phase,
             "multi_router": multi_router_phase,
             "disagg": disagg_phase,
             "supervisor": supervisor_phase}[mode](
                args.cycles, soak, args.budget * 2)
        elif mode == "gray":
            gray_phase(args.cycles, soak)
        elif mode == "fleet":
            fleet_phase((args.config, args.dtype, args.device,
                         args.max_seq), args.cycles, soak, args.budget)
        else:
            serving = Serving(args.config, args.dtype, args.device, params,
                              args.max_seq)
            if mode == "router":
                router_phase(serving, args.cycles, soak, args.budget,
                             spec_tokens=args.spec_tokens)
            else:
                STATS["rounds"] = args.rounds
                {"shm": shm_phase, "kill_loop": kill_loop_phase,
                 "default": default_phase}[mode](
                    serving, args.rounds, args.slots, args.budget)
    finally:
        fault_points.clear()
    elapsed = time.monotonic() - t0
    STATS["seconds"] = elapsed
    name = "" if mode == "default" else mode.replace("_", "-") + " "
    if _failures:
        print("\n{}chaos smoke FAILED: {} violation(s) in {:.1f}s".format(
            name, len(_failures), elapsed), file=sys.stderr)
        return 1
    count = args.rounds if mode in ("shm", "kill_loop", "default") \
        else args.cycles
    print("\n" + ok_line.format(count, elapsed))
    return 0


if __name__ == "__main__":
    sys.exit(main())
