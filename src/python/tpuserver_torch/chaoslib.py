"""Chaos campaign engine: the shared invariant library + the seeded
fault scheduler (docs/resilience.md "Chaos campaigns").

The port's copy of ``tpuserver.chaoslib``.  One deliberate difference:
:func:`check_shm_consistency` is documented against the port core's
``cuda_shm_status`` (where its ``kvexport/*`` regions live; the port
answers ``xla_shm_status`` with nothing).

Single-fault soaks each prove one defense, and each carried its own
copy of the same assertions — token identity against a fault-free reference,
gap/dup-free seq continuity, fleet-metric monotonicity, zero leaked
regions, fleet convergence.  Real incidents COMPOSE faults, and a
composed campaign needs those assertions as first-class, reusable
checks.  This module is that extraction, in two halves:

**Invariant library** — every check is named, takes an
:class:`InvariantRecorder`, and records a typed :class:`Violation`
(invariant name, context, message, structured details) instead of
ad-hoc prints.  A soak wires the recorder's sink to an
``INVARIANT VIOLATED:`` stderr line;
``tpuserver_torch.chaos_campaign`` collects the same objects to print
a minimized repro.  The catalog:

========================  ==================================================
``token_identity``         stream tokens equal the fault-free reference
``seq_continuity``         event seqs are gap-free and duplicate-free
``metric_monotonicity``    fleet-aggregated cumulative families (incl. the
                           ``tpu_disagg_*`` counters) never decrease or
                           vanish across cycles
                           (:class:`MetricsMonotonicityCheck`)
``counter_monotonicity``   a stats-dict counter set never moves backwards
``stream_drain``           the scheduler's live registry empties (zero
                           leaked streams) — :func:`wait_stream_drain`
``fleet_convergence``      the supervised fleet returns to its per-role
                           targets — :func:`wait_fleet_converged`
``journal_single_writer``  exactly one ACTIVE router process at a time
                           per partition (a horizontal tier holds one
                           active per journal subdirectory)
``partition_blast_radius``  an active's death touches ONLY its own
                           partition: sibling partitions' streams
                           complete with zero reconnects and gap-free
                           seqs — :func:`check_partition_blast_radius`
``shm_consistency``        ``cuda_shm_status`` holds exactly the expected
                           regions (no stale ``kvexport/*`` leaks)
``thread_leak``            no non-daemon threads outlive the campaign
``supervisor_restarts_clean``  a restarted supervisor ADOPTS every
                           surviving child (same pid, same restart
                           budget, same role) and respawns ONLY the
                           actually-dead — :func:`check_supervisor_adoption`
========================  ==================================================

**Seeded fault scheduler** — :meth:`FaultSchedule.compose` turns the
existing fault arsenal (replica SIGKILL, router SIGKILL/SIGTERM, the
``slow``/``jitter``/``partition`` gray modes, mid-stream severs,
disagg prefill kills, shm faults) into a deterministic multi-fault
schedule: every draw comes from one ``random.Random(seed)``, so the
same ``--seed`` replays the exact schedule, and
:func:`minimized_repro` renders a failing campaign as ONE command
restricted to the cycles and fault kinds that had fired by the first
violation.  :data:`FAULT_KINDS` carries the composition matrix: kinds
in the same ``serial`` group never overlap inside a cycle (the
scheduler spaces them); everything else may overlap freely.

Clocks are monotonic throughout (tpulint R3) and this module spawns
no threads of its own (R5); checks never block under a lock (R2).
"""

import json
import random
import threading
import time

__all__ = [
    "Violation", "InvariantRecorder",
    "check_token_identity", "check_seq_continuity",
    "check_counters_monotonic", "MetricsMonotonicityCheck",
    "wait_stream_drain", "wait_fleet_converged",
    "check_journal_single_writer", "check_partition_blast_radius",
    "check_shm_consistency", "check_supervisor_adoption",
    "thread_baseline", "check_no_thread_leaks",
    "FAULT_KINDS", "ScheduledFault", "FaultSchedule",
    "minimized_repro", "CampaignRunner",
]


class Violation:
    """One typed invariant violation: which named invariant, where
    (free-form context like ``"fleet cycle 3"``), the human line the
    CLI prints, and structured details for programmatic consumers."""

    __slots__ = ("invariant", "context", "message", "details")

    def __init__(self, invariant, message, context="", details=None):
        self.invariant = invariant
        self.context = context
        self.message = message
        self.details = dict(details or {})

    def as_dict(self):
        return {
            "invariant": self.invariant,
            "context": self.context,
            "message": self.message,
            "details": self.details,
        }

    def __repr__(self):
        return "Violation({!r}, {!r})".format(self.invariant, self.message)

    def __str__(self):
        return self.message


class InvariantRecorder:
    """Collects :class:`Violation` objects; ``sink`` (if given) sees
    each one as it lands — a soak's sink prints an
    ``INVARIANT VIOLATED: {message}`` stderr line, the campaign tool's
    also remembers the first violation's cycle for the minimized
    repro.  Thread-safe: worker threads record concurrently."""

    def __init__(self, sink=None):
        self._lock = threading.Lock()
        self._violations = []  # guarded-by: _lock
        self._sink = sink

    def record(self, invariant, message, context="", **details):
        violation = Violation(invariant, message, context, details)
        with self._lock:
            self._violations.append(violation)
        # the sink runs OUTSIDE the lock: it may print, flush, or
        # re-enter the recorder without deadlocking a worker
        if self._sink is not None:
            self._sink(violation)
        return violation

    @property
    def violations(self):
        with self._lock:
            return list(self._violations)

    @property
    def count(self):
        with self._lock:
            return len(self._violations)

    @property
    def ok(self):
        return self.count == 0


# -- named invariant checks --------------------------------------------------


def check_token_identity(recorder, expected, actual, context="",
                         message=None, invariant="token_identity",
                         **details):
    """The token-identity oracle: a stream that claims success must be
    token-exact against the fault-free reference.  Returns True when
    the invariant held."""
    expected = list(expected)
    actual = list(actual)
    if actual == expected:
        return True
    recorder.record(
        invariant,
        message or "{}: tokens diverged: {} != {}".format(
            context, actual, expected),
        context=context, expected=expected, actual=actual, **details)
    return False


def check_seq_continuity(recorder, seqs, expected_len=None, context="",
                         message=None, invariant="seq_continuity",
                         **details):
    """Gap-free, duplicate-free seq numbering: the event seqs must be
    exactly ``0..n-1`` (and ``n == expected_len`` when given) — a gap
    is a lost token, a duplicate is a replayed one the splice failed
    to dedup."""
    seqs = list(seqs)
    ok = seqs == list(range(len(seqs)))
    if ok and expected_len is not None:
        ok = len(seqs) == expected_len
    if ok:
        return True
    recorder.record(
        invariant,
        message or "{}: seq gap/duplicate: {}".format(context, seqs),
        context=context, seqs=seqs, expected_len=expected_len, **details)
    return False


def check_counters_monotonic(recorder, before, after, keys, context="",
                             invariant="counter_monotonicity",
                             message_fmt=None, **details):
    """A stats-dict counter set (e.g. the router's ``disagg`` block)
    must never move backwards across a fault cycle.  ``message_fmt``
    receives ``(key, before_value, after_value)``."""
    ok = True
    for key in keys:
        prev, now = before[key], after[key]
        if now < prev:
            ok = False
            recorder.record(
                invariant,
                (message_fmt(key, prev, now) if message_fmt is not None
                 else "{}: counter {} moved backwards {} -> {}".format(
                     context, key, prev, now)),
                context=context, counter=key, before=prev, after=now,
                **details)
    return ok


class MetricsMonotonicityCheck:
    """Fleet-metric monotonicity (the telemetry invariant): ``GET /metrics``
    on the router must stay scrapeable under chaos, and its cumulative
    families (counters — including the ``tpu_disagg_*`` set —
    histogram buckets, and the ``*_total``/``*_count`` compatibility
    gauges) must NEVER decrease or vanish across cycles: the
    fleet-aggregated view survives replica restarts and membership
    churn without resetting.

    ``require_prefix`` additionally demands the paged-KV prefix-cache
    hit counter be present; ``prefix_hits`` holds the last scraped
    fleet-wide total so phases can assert a healed replica's cold
    radix cache RE-WARMS.

    :meth:`rebind` re-seeds the baseline against a NEW scrape target —
    the router-takeover edge: a freshly promoted standby is a
    different process whose owned counters legitimately start over, so
    carrying the dead active's baseline across a takeover would read
    as a (false) monotonicity violation."""

    def __init__(self, router_url, context, recorder,
                 require_prefix=False, invariant="metric_monotonicity"):
        host, _, port = router_url.rpartition(":")
        self.host, self.port = host, int(port)
        self.context = context
        self.recorder = recorder
        self.invariant = invariant
        self._prev = {}
        self.require_prefix = require_prefix
        self.prefix_hits = None

    def rebind(self, router_url):
        """Point at a new router process (standby takeover) and drop
        the old baseline — its owned counters restart legitimately."""
        host, _, port = router_url.rpartition(":")
        self.host, self.port = host, int(port)
        self._prev = {}

    def _scrape(self):
        import http.client

        conn = http.client.HTTPConnection(
            self.host, self.port, timeout=10)
        try:
            conn.request("GET", "/metrics")
            resp = conn.getresponse()
            if resp.status != 200:
                return None
            return resp.read().decode("utf-8", errors="replace")
        except (OSError, http.client.HTTPException):
            return None
        finally:
            conn.close()

    def scrapeable(self):
        """Probe-only: does the current target answer /metrics right
        now?  Records nothing — campaign runners use it to wait out a
        drain-exit/takeover settle before the real :meth:`check` (a
        SIGTERMed active can pass an 'up' convergence check and exit
        moments later; one-shot scraping that window reads as a false
        violation — found by campaign seeds 1/5/6)."""
        return self._scrape() is not None

    def check(self, cycle):
        from tpuserver_torch.metrics import is_cumulative, parse_prometheus_text

        text = self._scrape()
        if text is None:
            self.recorder.record(
                self.invariant,
                "{} cycle {}: router /metrics not scrapeable".format(
                    self.context, cycle),
                context=self.context, cycle=cycle, kind="unscrapeable")
            return
        current = {}
        for name, fam in parse_prometheus_text(text).items():
            # the SAME cumulative-family rule the router's aggregator
            # folds by — the soak checks what the router aggregates
            if not is_cumulative(name, fam["type"]):
                continue
            for sample_name, labels, value in fam["samples"]:
                current[(sample_name,
                         tuple(sorted(labels.items())))] = value
        for key, prev in self._prev.items():
            now = current.get(key)
            if now is None:
                self.recorder.record(
                    self.invariant,
                    "{} cycle {}: fleet counter {} vanished from "
                    "/metrics (aggregation reset?)".format(
                        self.context, cycle, key),
                    context=self.context, cycle=cycle, kind="vanished",
                    counter=list(key[0:1]) and key[0])
            elif now < prev:
                self.recorder.record(
                    self.invariant,
                    "{} cycle {}: fleet counter {} DECREASED {} -> "
                    "{} across a replica restart".format(
                        self.context, cycle, key, prev, now),
                    context=self.context, cycle=cycle, kind="decreased",
                    counter=key[0], before=prev, after=now)
        self._prev = current
        hits = [v for (name, _labels), v in current.items()
                if name == "tpu_prefix_cache_hits_total"]
        if hits:
            self.prefix_hits = sum(hits)
        elif self.require_prefix:
            self.recorder.record(
                self.invariant,
                "{} cycle {}: tpu_prefix_cache_hits_total missing "
                "from the fleet /metrics view".format(
                    self.context, cycle),
                context=self.context, cycle=cycle,
                kind="prefix_missing")


def wait_stream_drain(stats_fn, timeout_s=10.0):
    """Zero leaked streams: poll a scheduler's ``stats()`` until its
    live registry empties (``live_streams == 0 and pending == 0``).
    Returns ``(drained, last_stats)``; the caller records the
    violation with its phase-specific wording when not drained."""
    deadline = time.monotonic() + timeout_s
    stats = stats_fn()
    while time.monotonic() < deadline:
        stats = stats_fn()
        if stats["live_streams"] == 0 and stats["pending"] == 0:
            return True, stats
    return False, stats


def wait_fleet_converged(stats_fn, membership_fn=None, restarts_above=None,
                         up=None, phase_up=None, members=None,
                         max_retired=0, timeout_s=60.0, poll_s=0.1):
    """Fleet convergence to per-role targets: poll the supervisor's
    ``stats()`` until every requested condition holds at once —

    - ``restarts_above``: ``replica_restarts`` moved PAST this
      baseline (the kill was actually noticed; guards against polling
      a stale 'up' before the monitor's next tick);
    - ``up``: total replicas up equals the target;
    - ``phase_up``: ``phase_replicas_up`` equals this per-role dict
      (role fleets heal WITH their role);
    - ``members``: router membership size equals this;
    - ``max_retired``: no replica burned its restart budget.

    Returns True once converged, False on timeout (the caller records
    the violation with the final stats)."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        stats = stats_fn()
        ok = stats.get("retired_replicas", 0) <= max_retired
        if ok and restarts_above is not None:
            ok = stats.get("replica_restarts", 0) > restarts_above
        if ok and up is not None:
            ok = stats.get("up") == up
        if ok and phase_up is not None:
            ok = stats.get("phase_replicas_up") == phase_up
        if ok and members is not None and membership_fn is not None:
            ok = len({r["url"] for r in membership_fn()}) == members
        if ok:
            return True
        time.sleep(poll_s)
    return False


def check_journal_single_writer(recorder, routers, context="",
                                message=None,
                                invariant="journal_single_writer"):
    """Journal single-writer discipline, PER PARTITION: at most ONE
    router process may hold the active role for any one journal
    directory at a time — two actives appending to the same directory
    would interleave frames and corrupt recovery.  Unpartitioned rows
    (``partition`` absent/None — the single-active tier) all share one
    journal and form one group; a partitioned tier owns one journal
    subdirectory per partition, so one active PER PARTITION is the
    invariant.  ``routers`` is the supervisor's ``stats()["routers"]``
    list."""
    groups = {}
    for r in routers:
        if r.get("role") == "active" and r.get("state") == "up":
            groups.setdefault(r.get("partition"), []).append(r)
    bad = {part: rows for part, rows in groups.items()
           if len(rows) > 1}
    if not bad:
        return True
    recorder.record(
        invariant,
        message or "{}: multiple active routers sharing one journal "
        "(single-writer discipline broken) in partition(s) {}: "
        "{}".format(
            context, sorted(bad, key=str),
            [(r.get("pid"), r.get("role"), r.get("partition"))
             for r in routers]),
        context=context,
        active=sum(len(rows) for rows in bad.values()),
        routers=list(routers))
    return False


def check_partition_blast_radius(recorder, survivors, context="",
                                 message=None,
                                 invariant="partition_blast_radius"):
    """An active-router SIGKILL must blast ONLY its own partition:
    every stream homed on a SURVIVING partition rides through the
    sibling's death with ZERO reconnects and gap-free, duplicate-free
    seqs — the horizontal tier's whole point is that a front-door
    failure is a partition-sized event, never a fleet-sized one.
    ``survivors`` is a list of per-stream observation dicts:
    ``{"partition": k, "reconnects": n, "seqs": [...]}`` (``seqs``
    optional; when present it must be exactly ``0..n-1``)."""
    ok = True
    for i, row in enumerate(survivors):
        part = row.get("partition")
        reconnects = int(row.get("reconnects") or 0)
        if reconnects:
            ok = False
            recorder.record(
                invariant,
                message or "{}: stream {} on surviving partition {} "
                "reconnected {} time(s) during a sibling's kill — "
                "the blast radius leaked across partitions".format(
                    context, i, part, reconnects),
                context=context, stream=i, partition=part,
                reconnects=reconnects)
        seqs = row.get("seqs")
        if seqs is not None and list(seqs) != list(range(len(seqs))):
            ok = False
            recorder.record(
                invariant,
                message or "{}: stream {} on surviving partition {} "
                "has a seq gap/duplicate during a sibling's kill: "
                "{}".format(context, i, part, list(seqs)),
                context=context, stream=i, partition=part,
                seqs=list(seqs))
    return ok


def check_supervisor_adoption(recorder, before, survivors, stats,
                              context="",
                              invariant="supervisor_restarts_clean"):
    """A restarted supervisor must ADOPT, not respawn: every replica
    whose process survived the supervisor outage keeps its pid, its
    restart count, and its role (a changed pid is a double-spawn; a
    bumped restart count is a budget charged for a crash that never
    happened), every replica that actually died gets a NEW pid with
    exactly one restart charged, and the supervisor's ``adoptions``
    counter covers every survivor.  ``before`` maps replica index to
    its pre-outage ``stats()`` row, ``survivors`` is the set of
    indices whose process outlived the outage, ``stats`` is the
    successor's converged ``stats()``."""
    after = {r["index"]: r for r in stats.get("replicas", [])}
    ok = True
    for index, row in before.items():
        succ = after.get(index)
        if succ is None:
            ok = False
            recorder.record(
                invariant,
                "{}: replica {} vanished across the supervisor "
                "restart".format(context, index),
                context=context, index=index)
            continue
        if index in survivors:
            if succ.get("pid") != row.get("pid"):
                ok = False
                recorder.record(
                    invariant,
                    "{}: surviving replica {} was respawned (pid {} "
                    "-> {}) instead of adopted".format(
                        context, index, row.get("pid"),
                        succ.get("pid")),
                    context=context, index=index,
                    before_pid=row.get("pid"), after_pid=succ.get("pid"))
            if succ.get("restarts") != row.get("restarts"):
                ok = False
                recorder.record(
                    invariant,
                    "{}: surviving replica {} charged restart budget "
                    "({} -> {}) for a crash that never happened".format(
                        context, index, row.get("restarts"),
                        succ.get("restarts")),
                    context=context, index=index,
                    before=row.get("restarts"),
                    after=succ.get("restarts"))
        else:
            if succ.get("pid") == row.get("pid"):
                ok = False
                recorder.record(
                    invariant,
                    "{}: dead replica {} still shows its corpse pid "
                    "{}".format(context, index, row.get("pid")),
                    context=context, index=index, pid=row.get("pid"))
            if succ.get("restarts") != row.get("restarts", 0) + 1:
                ok = False
                recorder.record(
                    invariant,
                    "{}: dead replica {} should be charged exactly "
                    "one restart ({} -> {})".format(
                        context, index, row.get("restarts"),
                        succ.get("restarts")),
                    context=context, index=index,
                    before=row.get("restarts"),
                    after=succ.get("restarts"))
        if succ.get("role") != row.get("role"):
            ok = False
            recorder.record(
                invariant,
                "{}: replica {} changed role across the supervisor "
                "restart ({} -> {})".format(
                    context, index, row.get("role"), succ.get("role")),
                context=context, index=index,
                before_role=row.get("role"), after_role=succ.get("role"))
    if stats.get("adoptions", 0) < len(survivors):
        ok = False
        recorder.record(
            invariant,
            "{}: adoptions counter {} does not cover the {} "
            "surviving replica(s)".format(
                context, stats.get("adoptions", 0), len(survivors)),
            context=context, adoptions=stats.get("adoptions", 0),
            survivors=sorted(survivors))
    return ok


def check_shm_consistency(recorder, status, expected, context="",
                          message=None, invariant="shm_consistency"):
    """Zero leaked kv-export regions/pages: ``cuda_shm_status`` (the
    port core's CUDA regions, where a server-owned ``kvexport/*``
    export lives) must hold exactly the expected region names — a
    lingering ``kvexport/*`` entry is a leaked server-owned export, a
    missing client region is a dropped registration."""
    status = set(status)
    expected = set(expected)
    if status == expected:
        return True
    recorder.record(
        invariant,
        message or "{}: cuda_shm_status inconsistent: {} != {}".format(
            context, sorted(status), sorted(expected)),
        context=context, status=sorted(status),
        expected=sorted(expected),
        leaked=sorted(status - expected),
        missing=sorted(expected - status))
    return False


def thread_baseline():
    """Idents of live non-daemon threads — capture BEFORE a campaign;
    :func:`check_no_thread_leaks` diffs against it after."""
    return {t.ident for t in threading.enumerate()
            if not t.daemon and t.ident is not None}


def check_no_thread_leaks(recorder, baseline, grace_s=5.0, context="",
                          invariant="thread_leak"):
    """Zero leaked non-daemon threads: anything alive past the grace
    window that was not in the baseline would outlive the process's
    intended shutdown (the conftest thread-leak guard's twin, usable
    outside pytest)."""
    deadline = time.monotonic() + grace_s
    while time.monotonic() < deadline:
        leaked = [t for t in threading.enumerate()
                  if not t.daemon and t.ident not in baseline]
        if not leaked:
            return True
        for t in leaked:
            t.join(timeout=0.1)
    leaked = [t for t in threading.enumerate()
              if not t.daemon and t.ident not in baseline]
    if not leaked:
        return True
    recorder.record(
        invariant,
        "{}: leaked non-daemon thread(s) after {:.1f}s grace: "
        "{}".format(context, grace_s, [t.name for t in leaked]),
        context=context, threads=[t.name for t in leaked])
    return False


# -- seeded fault scheduler --------------------------------------------------

#: The schedulable fault arsenal and its COMPOSITION MATRIX.  Each kind
#: maps to ``(description, serial_group)``: kinds sharing a non-None
#: serial group never overlap within a cycle — the scheduler spaces
#: them ``serial_gap_s`` apart (two process kills racing each other
#: would leave no fleet to assert invariants against; two router-tier
#: faults racing would fight over one takeover).  Kinds with group
#: ``None`` may overlap anything: gray latency, severed streams, and
#: half-open partitions composing OVER a kill is exactly the
#: interaction surface the campaigns exist to probe.
FAULT_KINDS = {
    "replica_sigkill": (
        "SIGKILL one up replica process (no drain, no warning); the "
        "supervisor must heal it back to target", "kill"),
    "prefill_sigkill": (
        "SIGKILL the PREFILL-role replica mid-handoff; orphaned "
        "splits must degrade to the fused path invisibly", "kill"),
    "supervisor_sigkill": (
        "SIGKILL the SUPERVISOR itself mid-traffic; the fleet keeps "
        "serving unsupervised, and the restarted supervisor must "
        "ADOPT the survivors from its manifest (no double-spawn, no "
        "budget burn)", "kill"),
    "router_sigkill": (
        "SIGKILL the ACTIVE router; the standby must take over and "
        "recover resume state from the journal", "router"),
    "router_sigterm": (
        "SIGTERM the ACTIVE router (drain-first path): in-flight "
        "streams finish or hand off before exit", "router"),
    "active_router_sigkill": (
        "SIGKILL one ACTIVE of a partitioned multi-router tier; the "
        "standby must promote INTO the dead router's partition while "
        "sibling partitions' streams ride through untouched "
        "(partition_blast_radius)", "router"),
    "gray_slow": (
        "turn one replica gray: alive to probes, orders of magnitude "
        "slower to serve (faults 'slow' / stub infer_delay_ms)", None),
    "gray_jitter": (
        "deterministic pseudo-random per-event latency on one "
        "replica (faults 'jitter')", None),
    "stream_sever": (
        "sever live streams mid-generation with no terminal event; "
        "clients must auto-resume via Last-Event-ID", None),
    "partition": (
        "half-open partition: the connection stays accepted but "
        "reads stall (faults 'partition' / stub partition_ms)", None),
    "shm_fault": (
        "fail a shared-memory read (faults 'core.shm_read'); the "
        "request gets a typed error, siblings keep decoding", None),
}

#: minimum in-cycle spacing between two faults of the same serial group
SERIAL_GAP_S = 0.5


class ScheduledFault:
    """One scheduled injection: fire ``kind`` at ``offset_s`` into
    cycle ``cycle``.  ``pick`` is a deterministic victim-selector draw
    (injectors use ``ups[pick % len(ups)]`` so the same seed kills the
    same replica) and ``params`` carries per-kind knobs drawn from the
    same seeded stream (gray delay, sever count, ...)."""

    __slots__ = ("cycle", "kind", "offset_s", "pick", "params")

    def __init__(self, cycle, kind, offset_s, pick, params=None):
        self.cycle = cycle
        self.kind = kind
        self.offset_s = float(offset_s)
        self.pick = int(pick)
        self.params = dict(params or {})

    def as_dict(self):
        return {
            "cycle": self.cycle,
            "kind": self.kind,
            "offset_s": round(self.offset_s, 4),
            "pick": self.pick,
            "params": self.params,
        }

    def __repr__(self):
        return ("ScheduledFault(cycle={}, kind={!r}, offset_s={:.3f}, "
                "pick={})".format(self.cycle, self.kind, self.offset_s,
                                  self.pick))


class FaultSchedule:
    """A deterministic multi-fault schedule: every draw comes from ONE
    ``random.Random(seed)`` consumed in a fixed order, so the same
    ``(seed, kinds, cycles, window_s)`` replays the exact same
    schedule — the property the deterministic-replay test pins and
    the minimized repro relies on."""

    def __init__(self, seed, kinds, cycles, window_s, entries):
        self.seed = int(seed)
        self.kinds = tuple(kinds)
        self.cycles = int(cycles)
        self.window_s = float(window_s)
        self.entries = list(entries)

    @classmethod
    def compose(cls, seed, kinds, cycles, window_s=2.0,
                serial_gap_s=SERIAL_GAP_S):
        """Compose ``kinds`` into ``cycles`` fault windows.  Each kind
        fires once per cycle at a seeded offset inside
        ``[0.1, 0.7 * window_s]``; kinds sharing a serial group are
        re-spaced at least ``serial_gap_s`` apart (in sorted-kind
        order, so the spacing itself is deterministic too)."""
        kinds = list(kinds)
        unknown = [k for k in kinds if k not in FAULT_KINDS]
        if unknown:
            raise ValueError(
                "unknown fault kind(s) {}; known: {}".format(
                    unknown, sorted(FAULT_KINDS)))
        rng = random.Random(int(seed))
        entries = []
        for cycle in range(int(cycles)):
            cycle_entries = []
            # fixed draw order (the requested kind order), so the
            # stream of rng consumptions — and thus every later draw —
            # is a pure function of (seed, kinds, cycles)
            for kind in kinds:
                offset = rng.uniform(0.1, max(0.15, 0.7 * window_s))
                pick = rng.randrange(1 << 30)
                params = {}
                if kind in ("gray_slow", "gray_jitter"):
                    params["delay_ms"] = rng.choice((120, 200, 320))
                elif kind == "stream_sever":
                    params["streams"] = rng.choice((1, 2, 3))
                elif kind == "partition":
                    params["stall_ms"] = rng.choice((150, 300, 500))
                cycle_entries.append(
                    ScheduledFault(cycle, kind, offset, pick, params))
            # serialization pass: same-group entries get ordered,
            # spaced offsets (sorted draws assigned in kind order)
            groups = {}
            for entry in cycle_entries:
                group = FAULT_KINDS[entry.kind][1]
                if group is not None:
                    groups.setdefault(group, []).append(entry)
            for group_entries in groups.values():
                if len(group_entries) < 2:
                    continue
                offsets = sorted(e.offset_s for e in group_entries)
                last = None
                for entry, offset in zip(group_entries, offsets):
                    if last is not None and offset < last + serial_gap_s:
                        offset = last + serial_gap_s
                    entry.offset_s = offset
                    last = offset
            cycle_entries.sort(key=lambda e: (e.offset_s, e.kind))
            entries.extend(cycle_entries)
        return cls(seed, kinds, cycles, window_s, entries)

    def for_cycle(self, cycle):
        return [e for e in self.entries if e.cycle == cycle]

    def kinds_through(self, cycle):
        """The distinct kinds that fire in cycles ``0..cycle`` — the
        restricted fault set a minimized repro replays."""
        seen = []
        for entry in self.entries:
            if entry.cycle <= cycle and entry.kind not in seen:
                seen.append(entry.kind)
        return seen

    def to_json(self):
        return json.dumps({
            "seed": self.seed,
            "kinds": list(self.kinds),
            "cycles": self.cycles,
            "window_s": self.window_s,
            "entries": [e.as_dict() for e in self.entries],
        }, indent=1, sort_keys=True)

    def describe(self):
        lines = ["schedule seed={} cycles={} window={:.1f}s".format(
            self.seed, self.cycles, self.window_s)]
        for entry in self.entries:
            lines.append(
                "  cycle {} +{:6.3f}s  {:<16} pick={} {}".format(
                    entry.cycle, entry.offset_s, entry.kind, entry.pick,
                    entry.params or ""))
        return "\n".join(lines)


def minimized_repro(seed, failing_cycle, kinds,
                    tool="-m tpuserver_torch.chaos_campaign",
                    extra_args=()):
    """The single command that replays a failing campaign minimized to
    its first violation: same seed (the schedule prefix is identical —
    compose() draws per cycle in order), cycles truncated to the
    failing one, faults restricted to the kinds that had fired."""
    parts = ["python", tool, "--seed", str(int(seed)),
             "--cycles", str(int(failing_cycle) + 1),
             "--faults", ",".join(kinds)]
    parts.extend(str(a) for a in extra_args)
    return " ".join(parts)


class CampaignRunner:
    """Executes one cycle of a :class:`FaultSchedule` against a
    registry of injectors (``kind -> callable(entry)``).  The runner
    sleeps to each entry's offset and fires it in the calling thread —
    the caller owns worker traffic and per-cycle invariant checks;
    this owns only deterministic fault timing.  Injector exceptions
    are recorded as ``injector_error`` violations rather than killing
    the campaign mid-schedule (a broken injector must not read as a
    passed cycle)."""

    def __init__(self, schedule, injectors, recorder):
        self.schedule = schedule
        self.injectors = dict(injectors)
        self.recorder = recorder
        missing = [e.kind for e in schedule.entries
                   if e.kind not in self.injectors]
        if missing:
            raise ValueError(
                "no injector for scheduled kind(s): {}".format(
                    sorted(set(missing))))
        self.fired = []  # entries actually fired, in order

    def run_cycle(self, cycle):
        """Fire every entry of ``cycle`` at its offset; returns the
        entries fired."""
        start = time.monotonic()
        fired = []
        for entry in self.schedule.for_cycle(cycle):
            delay = entry.offset_s - (time.monotonic() - start)
            if delay > 0:
                time.sleep(delay)
            try:
                self.injectors[entry.kind](entry)
            except Exception as e:  # noqa: BLE001 — a broken injector
                # must surface as a violation, not a silent pass
                self.recorder.record(
                    "injector_error",
                    "cycle {}: injector {} failed: {}: {}".format(
                        cycle, entry.kind, type(e).__name__, e),
                    context="cycle {}".format(cycle), kind=entry.kind)
            fired.append(entry)
            self.fired.append(entry)
        return fired
