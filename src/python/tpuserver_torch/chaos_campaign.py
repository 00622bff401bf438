"""Seeded multi-fault chaos campaigns against a supervised fleet.

    PYTHONPATH=src/python python -m tpuserver_torch.chaos_campaign \
        --seed 3 --cycles 2 --faults prefill_sigkill,gray_slow

The port's copy of the JAX package's campaign tool, on the port's own
fleet tier (``FleetSupervisor``, ``router_cli`` processes, chaoslib).
One fault at a time proves one defense; real incidents compose faults — a replica dies while another is gray, a
stream is severed while the prefill pool is healing.  This tool runs
that composition deterministically:

- ``tpuserver_torch.chaoslib.FaultSchedule.compose(seed, ...)`` turns the
  requested fault kinds into a schedule where every offset, victim
  pick, and knob comes from one ``random.Random(seed)`` — the same
  ``--seed`` replays the exact campaign (pin: ``--print-schedule``);
- each cycle drives concurrent resumable streams through the ACTIVE
  router of a supervised disagg stub fleet (1 prefill + 1 decode
  role replica, ``tests/fleet_stub.py``; active + standby
  ``python -m tpuserver_torch.router_cli`` processes on one crash
  journal) while the cycle's scheduled faults fire;
- the shared invariant library (``tpuserver_torch.chaoslib``) checks every
  cycle: token identity against the fault-free reference, gap/dup-
  free seqs, zero user-visible errors, fleet-metric monotonicity on
  the active router (rebinding across takeovers), journal single-
  writer discipline, per-role fleet convergence; plus an end-of-run
  non-daemon thread-leak check;
- a failing campaign prints every typed violation AND a MINIMIZED
  REPRO: one command replaying the same seed truncated to the first
  violating cycle with only the fault kinds that had fired by then.

The streams are read by the port's stdlib resumable SSE reader
(:func:`generate_stream` over ``resumable_stream.sse_generation``),
which reconnects with ``Last-Event-ID`` and rotates through the router
urls as the client library's does.  ``--quick`` shrinks everything to a <=10s single-cycle
smoke.

``--proof OUT_JSON`` measures under the campaign instead: ``python -m
tpuserver_torch.perf_analyzer --workers N --generation`` (the
distributed perf analyzer, ``--concurrency`` streams a worker) runs
through the active router while each cycle's faults fire, and the run
writes one BENCH row whose ``error_budget`` is the perf side's stream
errors plus the campaign's user-visible violations; it exits 0 only
when no invariant was violated.

    PYTHONPATH=src/python python -m tpuserver_torch.chaos_campaign \
        --proof proof_row.json --seed 10 --cycles 2 \
        --faults prefill_sigkill,replica_sigkill,gray_slow,stream_sever
"""

import argparse
import http.client
import json
import os
import shutil
import signal
import sys
import tempfile
import threading
import time

from tpuserver_torch import chaoslib, fleetmanifest
from tpuserver_torch.resumable_stream import sse_generation

#: the directory that holds the package (what a child's PYTHONPATH needs)
SRC_PYTHON = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(os.path.dirname(SRC_PYTHON))

#: kinds this tool can inject into the stub fleet (subset of
#: chaoslib.FAULT_KINDS: shm faults need a real core, so they stay
#: with the core's own tests)
INJECTABLE = (
    "replica_sigkill", "prefill_sigkill", "supervisor_sigkill",
    "router_sigkill", "router_sigterm", "active_router_sigkill",
    "gray_slow", "gray_jitter", "stream_sever", "partition",
)

DEFAULT_FAULTS = "prefill_sigkill,gray_slow,stream_sever"

#: kinds that target the router tier: each one fired lands as exactly
#: one standby promotion, which is what the per-cycle takeover settle
#: waits for before the recording metrics scrape
ROUTER_FAULTS = ("router_sigkill", "router_sigterm",
                 "active_router_sigkill")

PROMPT = [5, 7, 9, 2, 4]


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="campaign seed: same seed => identical fault "
                         "schedule (offsets, victims, knobs)")
    ap.add_argument("--faults", default=DEFAULT_FAULTS,
                    help="comma-separated fault kinds to compose "
                         "(default {}; known: {})".format(
                             DEFAULT_FAULTS, ",".join(INJECTABLE)))
    ap.add_argument("--cycles", type=int, default=3,
                    help="fault cycles (default 3)")
    ap.add_argument("--window", type=float, default=2.0,
                    help="per-cycle fault window seconds (default 2.0)")
    ap.add_argument("--budget", type=int, default=6,
                    help="tokens per campaign stream (default 6)")
    ap.add_argument("--streams", type=int, default=3,
                    help="concurrent worker streams per cycle "
                         "(default 3)")
    ap.add_argument("--soak", type=int, default=2,
                    help="streams per worker per cycle (default 2)")
    ap.add_argument("--print-schedule", action="store_true",
                    help="print the composed schedule and exit (the "
                         "deterministic-replay pin)")
    ap.add_argument("--quick", action="store_true",
                    help="one short cycle against a minimal fleet "
                         "(<=10s)")
    ap.add_argument("--proof", default=None, metavar="OUT_JSON",
                    help="run the distributed-generation perf proof "
                         "under the campaign and write its BENCH row "
                         "here")
    ap.add_argument("--workers", type=int, default=2,
                    help="--proof: perf_analyzer worker processes "
                         "(default 2)")
    ap.add_argument("--concurrency", type=int, default=32,
                    help="--proof: generation streams per worker "
                         "(default 32 => 64 total)")
    ap.add_argument("--spec-tokens", type=int, default=0,
                    help="run the stub replicas' speculative-decoding "
                         "twin at this draft budget (0 = off); token "
                         "identity must hold under every fault")
    ap.add_argument("--json", default=None,
                    help="write the campaign report (violations, "
                         "schedule, stats) here")
    return ap


# -- fleet ------------------------------------------------------------------


def start_fleet(cycles, manifest_dir=None, spec_tokens=0,
                active_routers=1):
    """The campaign target: a role-split stub fleet (1 prefill + 1
    decode) supervised together with an active+standby router pair
    sharing one crash journal — every tier a scheduled fault can hit
    is a real, supervised OS process.  ``manifest_dir`` makes the
    supervisor itself a target: ``supervisor_sigkill`` crashes it and
    a successor built from the SAME manifest adopts the fleet.
    ``spec_tokens`` turns on the replicas' stub speculative-decoding
    twin — burst emission must survive every scheduled fault with the
    identical token streams.  ``active_routers=2`` (scheduled
    automatically when ``active_router_sigkill`` is in the mix) runs
    the PARTITIONED front tier — two actives with per-partition
    journal subdirectories plus the standby."""
    return stub_fleet(
        2 * cycles + 6, "campaign-stub-", manifest_dir=manifest_dir,
        spec_tokens=spec_tokens, active_routers=active_routers)


def stub_fleet(max_restarts, scope_prefix, roles=True,
               router_processes=True, active_routers=1, manifest_dir=None,
               spec_tokens=0, router_kwargs=None):
    """A started :class:`~tpuserver_torch.fleet.FleetSupervisor` over
    ``tests/fleet_stub.py`` replicas, each pool pinned at its target
    (min == max: the soaks are about healing back to it, not about
    scaling): one prefill and one decode replica with ``roles``, else
    two fused ones.  ``router_processes`` fronts them with an active and
    a warm-standby ``python -m tpuserver_torch.router_cli`` process on
    one crash journal (``active_routers`` actives, each owning a
    partition, when above 1); without it the supervisor's in-process
    router (``router_kwargs``) fronts them.  The campaign's fleet and
    the chaos soak's stub modes (``tpuserver_torch.chaos_smoke``)."""
    from tpuserver_torch.fleet import FleetSupervisor

    stub = os.path.join(REPO, "tests", "fleet_stub.py")
    command = [sys.executable, stub, "--port", "{port}",
               "--scope", "{scope}"]
    if spec_tokens > 0:
        command += ["--spec-tokens", str(spec_tokens)]
    pools = (dict(prefill_replicas=1, decode_replicas=1, min_replicas=1,
                  max_replicas=1) if roles
             else dict(replicas=2, min_replicas=2, max_replicas=2))
    front = {"router_kwargs": router_kwargs}
    if router_processes:
        front = dict(router_command=[
            sys.executable, "-m", "tpuserver_torch.router_cli",
            "--backends", "{backends}", "--port", "{port}",
            "--journal", "{journal}", "--probe-interval", "0.1",
        ], router_standby=True, active_routers=active_routers)
    return FleetSupervisor(
        command, probe_interval_s=0.1, probe_timeout_s=2.0,
        start_timeout_s=60.0, drain_grace_s=5.0,
        max_restarts=max_restarts, restart_window_s=3600.0,
        restart_backoff_s=0.05, scope_prefix=scope_prefix,
        env={"PYTHONPATH": SRC_PYTHON}, manifest_dir=manifest_dir,
        **pools, **front).start()


def free_port():
    """An OS-assigned free localhost port."""
    from tpuserver_torch.fleet import _free_port

    return _free_port("127.0.0.1")


def wait_ready(port, timeout_s=20.0):
    """Poll a just-spawned server's ``/v2/health/ready`` on localhost
    until it answers 200; False once ``timeout_s`` passed."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=2)
        try:
            conn.request("GET", "/v2/health/ready")
            if conn.getresponse().status == 200:
                return True
        except OSError:
            pass
        finally:
            conn.close()
        time.sleep(0.05)
    return False


def post_stub_state(url, update):
    """POST /stub/state to one replica (gray/sever/partition knobs)."""
    host, _, port = url.rpartition(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=5)
    try:
        body = json.dumps(update)
        conn.request("POST", "/stub/state", body,
                     {"Content-Type": "application/json"})
        conn.getresponse().read()
    finally:
        conn.close()


def get_json(url, path):
    host, _, port = url.rpartition(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=5)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        if resp.status != 200:
            return None
        return json.loads(resp.read())
    except (OSError, ValueError, http.client.HTTPException):
        return None
    finally:
        conn.close()


class FleetInjectors:
    """chaoslib injector registry bound to one supervised fleet.
    Victim selection uses the schedule's deterministic ``pick`` so the
    same seed hits the same target; gray knobs poked into a replica
    are recorded and cleared at cycle end (``heal_grays``) so one
    cycle's latency injection never bleeds into the next cycle's
    measurements."""

    def __init__(self, supervisor, manifest_dir=None):
        self.supervisor = supervisor
        self.manifest_dir = manifest_dir
        # pre-crash replica rows, set by supervisor_sigkill; the cycle
        # loop restarts the supervisor and runs the adoption check
        self.supervisor_down = None
        self._grayed = []  # urls with nonzero delay/jitter this cycle

    # -- victim pools ------------------------------------------------------

    def _up_replicas(self, role=None):
        rows = [r for r in self.supervisor.stats()["replicas"]
                if r["state"] == "up" and r.get("pid")]
        if role is not None:
            rows = [r for r in rows if r.get("role") == role]
        return rows

    def _active_router(self):
        rows = [r for r in self.supervisor.stats().get("routers", [])
                if r["role"] == "active" and r["state"] == "up"
                and r.get("pid")]
        return rows[0] if rows else None

    def _inject(self, candidates, pick, what, action):
        """Deterministic victim pick that tolerates a victim a
        same-cycle kill already took down: the supervisor's stats lag
        its next probe tick, so a replica another fault felled moments
        ago can still read "up" (campaign seed 4: stream_sever drew
        exactly that corpse and got ECONNREFUSED).  Walk the candidate
        list starting at the schedule's ``pick`` until one accepts the
        fault — still fully seed-deterministic.  An EMPTY pool gets
        the same grace ``_kill_router`` gives a dead active: when the
        previous cycle's kill felled the only candidate, the next
        cycle's injection can land before the supervisor's respawn is
        probed up (seed 10: cycle-1 prefill_sigkill raced the cycle-0
        heal) — re-resolve briefly rather than faulting the
        injector."""
        deadline = time.monotonic() + 5.0
        while True:
            ups = candidates()
            last = None
            for i in range(len(ups)):
                victim = ups[(pick + i) % len(ups)]
                try:
                    return action(victim)
                except OSError as e:  # dead pid / refused control POST
                    last = e
            if time.monotonic() >= deadline:
                if last is not None:
                    raise RuntimeError(
                        "every up candidate rejected {}: {}".format(
                            what, last))
                raise RuntimeError("no up replica to {}".format(what))
            time.sleep(0.05)

    def _kill_router(self, sig, what):
        """Signal the ACTIVE router, re-resolving briefly: when two
        router faults share a window, the role bookkeeping can still
        name the already-dead process (stats lag again) — re-resolve
        until a live active exists rather than faulting the injector."""
        deadline = time.monotonic() + 5.0
        while True:
            active = self._active_router()
            if active is not None:
                try:
                    os.kill(active["pid"], sig)
                    return
                except ProcessLookupError:
                    pass  # that active already died; re-resolve
            if time.monotonic() >= deadline:
                raise RuntimeError(
                    "no live active router to {}".format(what))
            time.sleep(0.05)

    # -- injectors (kind -> callable(entry)) -------------------------------

    @staticmethod
    def _sigkill(pid, timeout_s=5.0):
        """SIGKILL ``pid`` and return once it is dead (gone or a zombie):
        the signal lands asynchronously, and a cycle's adoption check
        that reads the victim's ``/proc`` entry a moment later must not
        see it still running and count it a survivor."""
        os.kill(pid, signal.SIGKILL)
        deadline = time.monotonic() + timeout_s
        while fleetmanifest.process_start_token(pid) is not None:
            if time.monotonic() >= deadline:
                raise RuntimeError(
                    "pid {} outlived its SIGKILL by {} s".format(
                        pid, timeout_s))
            time.sleep(0.005)

    def replica_sigkill(self, entry):
        self._inject(self._up_replicas, entry.pick, "SIGKILL",
                     lambda r: self._sigkill(r["pid"]))

    def prefill_sigkill(self, entry):
        self._inject(lambda: self._up_replicas(role="prefill"),
                     entry.pick, "SIGKILL (prefill)",
                     lambda r: self._sigkill(r["pid"]))

    def supervisor_sigkill(self, entry):
        """Crash the supervisor itself mid-traffic.  The campaign
        supervisor is in-process, so the SIGKILL is emulated by
        :meth:`FleetSupervisor.crash` — no checkpoint, no child
        signals, flock released exactly as the kernel would.  Replicas
        and router processes keep serving unsupervised; a later fault
        in the same cycle (serial group ``kill``) lands while nobody
        is healing."""
        if self.manifest_dir is None:
            raise RuntimeError(
                "supervisor_sigkill needs a manifest-backed fleet")
        before = {r["index"]: r
                  for r in self.supervisor.stats()["replicas"]}
        self.supervisor.crash()
        self.supervisor_down = before

    def router_sigkill(self, entry):
        self._kill_router(signal.SIGKILL, "SIGKILL")

    def router_sigterm(self, entry):
        self._kill_router(signal.SIGTERM, "SIGTERM")

    def active_router_sigkill(self, entry):
        """SIGKILL one ACTIVE of the PARTITIONED tier (scheduling this
        kind makes :func:`start_fleet` run ``active_routers=2``): the
        entry's pick draws the victim partition deterministically; the
        standby must promote INTO the dead active's partition while
        ``journal_single_writer`` keeps holding per partition."""
        deadline = time.monotonic() + 5.0
        while True:
            rows = [r for r in
                    self.supervisor.stats().get("routers", [])
                    if r["role"] == "active" and r["state"] == "up"
                    and r.get("pid") and r.get("partition") is not None]
            if rows:
                victim = rows[entry.pick % len(rows)]
                try:
                    os.kill(victim["pid"], signal.SIGKILL)
                    return
                except ProcessLookupError:
                    pass  # stats lag: re-resolve a fresher victim
            if time.monotonic() >= deadline:
                raise RuntimeError(
                    "no live partitioned active router to SIGKILL")
            time.sleep(0.05)

    def _gray(self, entry, key):
        def act(replica):
            post_stub_state(
                replica["url"],
                {key: entry.params.get("delay_ms", 200)})
            self._grayed.append(replica["url"])

        self._inject(self._up_replicas, entry.pick, "gray", act)

    def gray_slow(self, entry):
        self._gray(entry, "infer_delay_ms")

    def gray_jitter(self, entry):
        self._gray(entry, "infer_jitter_ms")

    def stream_sever(self, entry):
        self._inject(
            self._up_replicas, entry.pick, "sever streams on",
            lambda r: post_stub_state(
                r["url"],
                {"sever_streams": entry.params.get("streams", 1)}))

    def partition(self, entry):
        self._inject(
            self._up_replicas, entry.pick, "partition",
            lambda r: post_stub_state(
                r["url"],
                {"partition_ms": entry.params.get("stall_ms", 300)}))

    def registry(self):
        return {kind: getattr(self, kind) for kind in INJECTABLE}

    def heal_grays(self):
        for url in self._grayed:
            try:
                post_stub_state(url, {"infer_delay_ms": 0,
                                      "infer_jitter_ms": 0})
            except OSError:
                pass  # the grayed replica may have been killed too
        self._grayed = []


# -- campaign traffic --------------------------------------------------------


def generate_stream(urls, model, prompt, max_tokens, parameters=None,
                    max_reconnects=10, backoff_s=0.05, read_timeout=600.0,
                    on_reconnect=None):
    """Yield each event of one ``generate_stream`` generation of
    ``prompt``, resuming a dropped stream (see :func:`sse_generation`)."""
    body = json.dumps({
        "inputs": [
            {"name": "PROMPT_IDS", "datatype": "INT32",
             "shape": [len(prompt)], "data": list(prompt)},
            {"name": "MAX_TOKENS", "datatype": "INT32", "shape": [1],
             "data": [int(max_tokens)]}],
        "parameters": dict(parameters or {})})
    return sse_generation(urls, model, body, max_reconnects=max_reconnects,
                          backoff_s=backoff_s, read_timeout=read_timeout,
                          on_reconnect=on_reconnect)


def run_stream(urls, recorder, context, budget):
    """One resumable campaign stream; any raised error is the
    zero-user-visible-errors violation."""
    tokens, seqs = [], []
    try:
        for event in generate_stream(
                urls, "stub", PROMPT, budget,
                parameters={"token_delay_ms": 25}, max_reconnects=10):
            for out in event.get("outputs", []):
                if out["name"] == "TOKEN":
                    tokens.append(int(out["data"][0]))
            params = event.get("parameters") or {}
            if "seq" in params:
                seqs.append(params["seq"])
    except Exception as e:  # noqa: BLE001 — ANY client-visible error
        # is the invariant; typed or not, it must be zero
        recorder.record(
            "user_visible_error",
            "{}: user-visible stream error: {}: {}".format(
                context, type(e).__name__, e),
            context=context, error=type(e).__name__)
        return None, None
    return tokens, seqs


def wait_converged(supervisor, recorder, context, timeout_s=60.0):
    """Fleet convergence after a cycle: per-role pools back at target,
    both router processes up, no replica retired."""

    def stats_fn():
        return supervisor.stats()

    ok = chaoslib.wait_fleet_converged(
        stats_fn, phase_up={"prefill": 1, "decode": 1},
        timeout_s=timeout_s)
    routers_ok = False
    deadline = time.monotonic() + 30.0
    while time.monotonic() < deadline:
        routers = supervisor.stats().get("routers", [])
        if routers and all(r["state"] == "up" for r in routers):
            routers_ok = True
            break
        time.sleep(0.1)
    if not ok:
        recorder.record(
            "fleet_convergence",
            "{}: fleet never converged to per-role targets "
            "(stats={})".format(context, supervisor.stats()),
            context=context)
    if not routers_ok:
        recorder.record(
            "fleet_convergence",
            "{}: router tier never back to active+standby "
            "(routers={})".format(
                context, supervisor.stats().get("routers")),
            context=context)
    return ok and routers_ok


def wait_router_takeovers(supervisor, before, expected, timeout_s=20.0):
    """Wait until every router fault of the cycle has LANDED: a
    SIGTERMed active keeps serving ``/metrics`` while draining and
    only exits (standby promoted, takeover counted) once quiescent —
    scraping before the takeover lands reads a process about to die
    mid-check (campaign seed 3's flaky "not scrapeable").  Each router
    fault ends in exactly one promotion, so the cycle is settled once
    the counter moved by the number of router faults scheduled.
    Returns the final takeover count."""
    deadline = time.monotonic() + timeout_s
    while True:
        takeovers = supervisor.stats().get("router_takeovers", 0)
        if takeovers - before >= expected or \
                time.monotonic() >= deadline:
            return takeovers
        time.sleep(0.1)


def settle_metrics_target(supervisor, metrics_check, timeout_s=8.0):
    """Follow the ACTIVE router through a drain-exit before the
    recording scrape: a SIGTERMed active passes the 'up' convergence
    check, then exits once drained — one-shot scraping that window
    reads as a false "/metrics not scrapeable" violation (campaign
    seeds 1/5/6 with composed router_sigkill+router_sigterm).
    Re-resolves the active URL each poll, rebinding the check when the
    role moved (a promoted standby's counters legitimately restart).
    Returns whether it rebound."""
    rebound = False
    deadline = time.monotonic() + timeout_s
    while True:
        active = supervisor.active_router_url()
        if active:
            host, _, port = active.rpartition(":")
            if (host, int(port)) != (metrics_check.host,
                                     metrics_check.port):
                metrics_check.rebind(active)
                rebound = True
        if metrics_check.scrapeable():
            return rebound
        if time.monotonic() >= deadline:
            return rebound
        time.sleep(0.1)


def run_campaign(args, schedule):
    """Execute the composed campaign; returns (recorder, summary)."""
    baseline_threads = chaoslib.thread_baseline()
    first_violation_cycle = [None]
    current_cycle = [-1]

    def sink(violation):
        if first_violation_cycle[0] is None:
            first_violation_cycle[0] = max(0, current_cycle[0])
        print("INVARIANT VIOLATED: {}".format(violation.message),
              file=sys.stderr, flush=True)

    recorder = chaoslib.InvariantRecorder(sink)
    manifest_dir = None
    if "supervisor_sigkill" in schedule.kinds:
        manifest_dir = tempfile.mkdtemp(prefix="campaign-manifest-")
    supervisor = start_fleet(
        args.cycles, manifest_dir=manifest_dir,
        spec_tokens=args.spec_tokens,
        active_routers=(2 if "active_router_sigkill" in schedule.kinds
                        else 1))
    injectors = FleetInjectors(supervisor, manifest_dir=manifest_dir)
    runner = chaoslib.CampaignRunner(
        schedule, injectors.registry(), recorder)
    summary = {"cycles_run": 0, "streams": 0, "takeovers": 0,
               "supervisor_restarts": 0, "adoptions": 0}
    try:
        if not supervisor.wait_ready(timeout_s=60.0):
            recorder.record(
                "fleet_convergence",
                "campaign: stub fleet never became ready")
            return recorder, summary
        if not wait_converged(supervisor, recorder, "campaign start"):
            return recorder, summary
        urls = supervisor.router_urls()
        metrics_check = chaoslib.MetricsMonotonicityCheck(
            supervisor.active_router_url(), "campaign", recorder,
            require_prefix=False)
        reference, ref_seqs = run_stream(
            urls, recorder, "campaign reference", args.budget)
        if reference is None:
            return recorder, summary
        chaoslib.check_seq_continuity(
            recorder, ref_seqs, args.budget, context="campaign reference")
        print("reference tokens: {}; campaign: {}".format(
            reference, schedule.describe()), flush=True)

        for cycle in range(args.cycles):
            current_cycle[0] = cycle
            context = "campaign cycle {}".format(cycle)
            takeovers_before = supervisor.stats().get(
                "router_takeovers", 0)
            urls = supervisor.router_urls()
            stop = threading.Event()

            def worker(wid, cycle=cycle, urls=urls):
                for i in range(args.soak):
                    if stop.is_set():
                        break
                    ctx = "campaign cycle {} worker {} stream {}" \
                        .format(cycle, wid, i)
                    tokens, seqs = run_stream(
                        urls, recorder, ctx, args.budget)
                    if tokens is None:
                        continue
                    summary["streams"] += 1
                    chaoslib.check_token_identity(
                        recorder, reference, tokens, context=ctx)
                    chaoslib.check_seq_continuity(
                        recorder, seqs, args.budget, context=ctx)

            threads = [
                threading.Thread(target=worker, args=(w,), daemon=True)
                for w in range(args.streams)
            ]
            for t in threads:
                t.start()
            time.sleep(0.2)  # streams live before the first fault
            runner.run_cycle(cycle)
            for t in threads:
                t.join(timeout=300)
            stop.set()
            injectors.heal_grays()
            if injectors.supervisor_down is not None:
                # the supervisor was SIGKILLed this cycle (streams
                # above ran unsupervised): restart it from the SAME
                # manifest and prove it adopts the survivors instead
                # of double-spawning a serving fleet
                before_rows = injectors.supervisor_down
                injectors.supervisor_down = None
                survivors = {
                    index for index, row in before_rows.items()
                    if row.get("pid") is not None
                    and fleetmanifest.process_start_token(
                        row["pid"]) is not None}
                supervisor = start_fleet(
                    args.cycles, manifest_dir=manifest_dir,
                    spec_tokens=args.spec_tokens)
                injectors.supervisor = supervisor
                summary["supervisor_restarts"] += 1
                wait_converged(supervisor, recorder, context)
                chaoslib.check_supervisor_adoption(
                    recorder, before_rows, survivors,
                    supervisor.stats(), context=context)
                summary["adoptions"] = supervisor.stats().get(
                    "adoptions", 0)
            else:
                wait_converged(supervisor, recorder, context)
            # the router tier may have failed over (or still be mid
            # drain-exit): wait for every scheduled router fault's
            # promotion to LAND, rebind on ANY takeover — a double
            # takeover can return the active role to the SAME port
            # with fresh counters (campaign seed 6's false DECREASED)
            # so URL comparison alone cannot detect the new process —
            # then follow the active target until it answers and run
            # the ONE recording check for this cycle
            takeovers = wait_router_takeovers(
                supervisor, takeovers_before,
                sum(1 for e in schedule.for_cycle(cycle)
                    if e.kind in ROUTER_FAULTS))
            summary["takeovers"] += max(
                0, takeovers - takeovers_before)
            if takeovers > takeovers_before:
                active_now = supervisor.active_router_url()
                if active_now:
                    metrics_check.rebind(active_now)
            settle_metrics_target(supervisor, metrics_check)
            metrics_check.check(cycle)
            chaoslib.check_journal_single_writer(
                recorder, supervisor.stats().get("routers", []),
                context=context)
            summary["cycles_run"] += 1
            print("cycle {:2d} ok: restarts={} takeovers={} "
                  "violations={}".format(
                      cycle, supervisor.stats().get("replica_restarts"),
                      supervisor.stats().get("router_takeovers"),
                      recorder.count), flush=True)
    finally:
        supervisor.stop()
        if manifest_dir is not None:
            shutil.rmtree(manifest_dir, ignore_errors=True)
    chaoslib.check_no_thread_leaks(
        recorder, baseline_threads, grace_s=5.0, context="campaign end")
    return recorder, summary


# -- the proof run -----------------------------------------------------------


def run_proof(args, schedule):
    """BENCH proof: ``perf_analyzer --workers N --generation`` through
    the coordinator against the supervised disagg fleet behind the
    active router, while the composed campaign fires.  Zero
    user-visible errors (perf-side AND campaign-side) is the bar."""
    import subprocess

    perf_json = args.proof + ".perf.tmp"
    if os.path.exists(perf_json):
        os.remove(perf_json)

    baseline_threads = chaoslib.thread_baseline()

    def sink(violation):
        print("INVARIANT VIOLATED: {}".format(violation.message),
              file=sys.stderr, flush=True)

    recorder = chaoslib.InvariantRecorder(sink)
    supervisor = start_fleet(
        args.cycles, spec_tokens=args.spec_tokens,
        active_routers=(2 if "active_router_sigkill" in schedule.kinds
                        else 1))
    injectors = FleetInjectors(supervisor)
    runner = chaoslib.CampaignRunner(
        schedule, injectors.registry(), recorder)
    perf_row = None
    proc = None
    try:
        if not supervisor.wait_ready(timeout_s=60.0):
            recorder.record("fleet_convergence",
                            "proof: stub fleet never became ready")
            return 1
        if not wait_converged(supervisor, recorder, "proof start"):
            return 1
        urls = supervisor.router_urls()
        active = supervisor.active_router_url()
        metrics_check = chaoslib.MetricsMonotonicityCheck(
            active, "proof", recorder, require_prefix=False)
        reference, _ = run_stream(
            urls, recorder, "proof reference", args.budget)
        if reference is None:
            return 1
        env = dict(os.environ, PYTHONPATH=SRC_PYTHON)
        proc = subprocess.Popen(
            [sys.executable, "-m", "tpuserver_torch.perf_analyzer",
             "--backend", "http",
             "--workers", str(args.workers), "--generation",
             "-m", "stubgen",
             "--concurrency-range", str(args.concurrency),
             "-u", active, "--windows", "3",
             "--measurement-interval", "1000",
             "--prompt-len", "8", "--shared-prefix-tokens", "4",
             "--max-tokens", str(args.budget),
             "--warmup", "0.5", "--seed", str(args.seed),
             "--json", perf_json],
            env=env)
        # composed campaign cycles while the perf run measures; each
        # cycle also samples streams whose tokens must stay identical
        for cycle in range(args.cycles):
            context = "proof cycle {}".format(cycle)
            if proc.poll() is not None:
                break
            takeovers_before = supervisor.stats().get(
                "router_takeovers", 0)
            sampled = []
            runner.run_cycle(cycle)
            for i in range(3):
                tokens, seqs = run_stream(
                    supervisor.router_urls(), recorder,
                    "{} sample {}".format(context, i), args.budget)
                if tokens is not None:
                    sampled.append((tokens, seqs))
            for i, (tokens, seqs) in enumerate(sampled):
                ctx = "{} sample {}".format(context, i)
                chaoslib.check_token_identity(
                    recorder, reference, tokens, context=ctx)
                chaoslib.check_seq_continuity(
                    recorder, seqs, args.budget, context=ctx)
            injectors.heal_grays()
            wait_converged(supervisor, recorder, context)
            takeovers = wait_router_takeovers(
                supervisor, takeovers_before,
                sum(1 for e in schedule.for_cycle(cycle)
                    if e.kind in ROUTER_FAULTS))
            if takeovers > takeovers_before:
                active_now = supervisor.active_router_url()
                if active_now:
                    metrics_check.rebind(active_now)
            settle_metrics_target(supervisor, metrics_check)
            metrics_check.check(cycle)
            chaoslib.check_journal_single_writer(
                recorder, supervisor.stats().get("routers", []),
                context=context)
            print("{} ok (perf running={})".format(
                context, proc.poll() is None), flush=True)
        rc = proc.wait(timeout=600)
        if rc != 0:
            recorder.record(
                "user_visible_error",
                "proof: perf_analyzer exited {}".format(rc))
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        supervisor.stop()
    chaoslib.check_no_thread_leaks(
        recorder, baseline_threads, grace_s=5.0, context="proof end")
    if os.path.exists(perf_json):
        with open(perf_json) as fh:
            rows = [json.loads(line) for line in fh if line.strip()]
        os.remove(perf_json)
        perf_row = rows[0] if rows else None
    if perf_row is None:
        recorder.record("user_visible_error",
                        "proof: perf_analyzer produced no report row")
        return 1
    perf_errors = int(perf_row.get("errors") or 0)
    if perf_errors:
        recorder.record(
            "user_visible_error",
            "proof: {} perf-side stream errors under the campaign "
            "(error budget is ZERO)".format(perf_errors))
    error_budget = perf_errors + sum(
        1 for v in recorder.violations
        if v.invariant == "user_visible_error")
    row = {
        "config": "chaos_campaign_proof",
        "metric": "stubgen_campaign_gen_streams{}".format(
            perf_row.get("level")),
        "value": perf_row.get("value"),
        "unit": "tokens/sec",
        "vs_baseline": None,
        "workers": args.workers,
        "streams": perf_row.get("level"),
        "fault_kinds": list(schedule.kinds),
        "seed": args.seed,
        "cycles": args.cycles,
        "ttft_p50_ms": perf_row.get("ttft_p50_ms"),
        "ttft_p99_ms": perf_row.get("ttft_p99_ms"),
        "itl_p50_ms": perf_row.get("itl_p50_ms"),
        "itl_p99_ms": perf_row.get("itl_p99_ms"),
        "gen_per_sec": perf_row.get("gen_per_sec"),
        "prefix_hit_pct": perf_row.get("prefix_hit_pct"),
        "resumed_streams": perf_row.get("resumed_streams"),
        "resume_events": perf_row.get("resume_events"),
        "error_budget": error_budget,
    }
    with open(args.proof, "w") as fh:
        json.dump(row, fh, indent=1, sort_keys=True)
        fh.write("\n")
    print("proof row -> {}: {}".format(args.proof, json.dumps(row)),
          flush=True)
    return 0 if recorder.ok else 1


# -- entry -------------------------------------------------------------------


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.quick:
        args.cycles = 1
        args.window = min(args.window, 1.0)
        args.streams = 2
        args.soak = 1
        args.budget = min(args.budget, 4)
    kinds = [k.strip() for k in args.faults.split(",") if k.strip()]
    unknown = [k for k in kinds if k not in INJECTABLE]
    if unknown:
        print("unknown fault kind(s) {}; injectable here: {}".format(
            unknown, ", ".join(INJECTABLE)), file=sys.stderr)
        return 2
    schedule = chaoslib.FaultSchedule.compose(
        args.seed, kinds, args.cycles, window_s=args.window)
    if args.print_schedule:
        print(schedule.describe())
        return 0
    if args.proof:
        return run_proof(args, schedule)

    t0 = time.monotonic()
    recorder, summary = run_campaign(args, schedule)
    elapsed = time.monotonic() - t0
    if args.json:
        with open(args.json, "w") as fh:
            json.dump({
                "seed": args.seed,
                "kinds": kinds,
                "cycles": args.cycles,
                "summary": summary,
                "violations": [v.as_dict()
                               for v in recorder.violations],
            }, fh, indent=1, sort_keys=True)
            fh.write("\n")
    if not recorder.ok:
        first_cycle = 0
        for v in recorder.violations:
            ctx = v.context or v.message
            for cycle in range(args.cycles - 1, -1, -1):
                if "cycle {}".format(cycle) in ctx:
                    first_cycle = cycle
                    break
            else:
                continue
            break
        repro = chaoslib.minimized_repro(
            args.seed, first_cycle, schedule.kinds_through(first_cycle))
        print("\nchaos campaign FAILED: {} invariant violation(s) "
              "over {} cycle(s), {:.1f}s".format(
                  recorder.count, summary["cycles_run"], elapsed),
              file=sys.stderr, flush=True)
        print("MINIMIZED REPRO: {}".format(repro), flush=True)
        return 1
    print("\nchaos campaign OK: seed {}, {} cycle(s) composing [{}], "
          "{} streams, {} takeover(s), {} supervisor restart(s) "
          "({} adoption(s)), {:.1f}s, zero user-visible errors, zero "
          "lost or duplicated tokens".format(
              args.seed, summary["cycles_run"], ",".join(kinds),
              summary["streams"], summary["takeovers"],
              summary.get("supervisor_restarts", 0),
              summary.get("adoptions", 0), elapsed),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
