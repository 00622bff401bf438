"""Fleet router: a server-side front-tier that makes N replicas look
like ONE resilient KServe server.

The port's copy of the JAX package's ``tpuserver.router`` (named
``fleet_router`` so that tpulint's router-surface rule keeps reading
the JAX router alone).  Its wire is the JAX router's: the routes (the
shm broadcast set names ``xla`` regions too, which a port replica
answers with its typed 400), the ``tpu_router_*``, ``tpu_disagg_*``,
``tpu_fleet_*`` and ``tpu_supervisor_*`` metric families, the SSE
``id:`` grammar and the ``Server`` token, so clients and scrapers see
one router whichever package runs it.

Without a router the resilience stack lives either in the replica (deadlines,
shedding, the self-healing scheduler) or in the client
(``tritonclient.EndpointPool``) — so every one of "millions of users"
must run a smart client, and a replica death still strands its
replica-local replay state (stream resume is same-endpoint only).
:class:`FleetRouter` moves that intelligence server-side: a thin HTTP
process speaking the same KServe v2 + ``/generate_stream`` surface as a
replica, load-balancing N backends with four robustness behaviors:

1. **Health/drain-aware routing.**  A background prober polls every
   replica's ``/v2/health/stats`` (the cheap lifecycle + scheduler-
   counter snapshot — no per-model inference statistics) and folds it
   into a per-replica eligibility flag and load score: draining,
   tripped (restart budget exhausted), or stopped replicas rotate out
   *before* a request lands on them, and requests go to the
   least-loaded eligible replica.  Generation admissions additionally
   carry **prefix affinity**: the router hashes the prompt's leading
   tokens and prefers (as a load-score bonus, never an eligibility
   override) the replica that last served that prefix — whose radix
   prefix cache is already warm, so the shared-system-prompt traffic
   shape prefills nearly free fleet-wide.  A router-level
   ``max_inflight`` cap sheds excess load with a typed 429 +
   ``Retry-After`` instead of queueing.
2. **Sticky resume.**  Every routed generation gets a router-assigned
   ``generation_id`` and a generation→home-replica map whose TTL
   matches the replicas' ``replay_ttl_s``; a reconnect carrying
   ``Last-Event-ID`` (or ``resume_generation_id``) replays the
   client-acked gap from the router's own event buffer and routes the
   live continuation home to the replica that owns the replay state.
3. **Cross-replica resume handoff.**  When the home replica is dead or
   tripped, the router re-admits ``prompt + emitted-token history`` on
   a healthy replica (greedy decode is deterministic, so the
   continuation is token-identical — the same invariant the
   scheduler's supervised restart relies on) and splices it behind the
   replayed prefix with continued sequence numbers: a replica loss no
   longer kills in-flight generations, and the client never learns a
   handoff happened.  Handoff needs the ``PROMPT_IDS`` /
   ``MAX_TOKENS`` / ``TOKEN`` generate contract; other streams degrade
   to passthrough (failover before the first token only).
4. **Passthrough resilience.**  Unary requests ride a failover loop:
   connect-phase and typed-overload failures (the
   ``tpuserver_torch._retry.FAILURE_*`` classification) fall through
   to another replica under the request's own deadline budget (its
   ``timeout`` parameter); typed non-overload answers relay untouched
   — every replica would say the same.

A **plain** ``tritonclient.http`` client pointed at the router gets all
of this for free — resume included — with no ``EndpointPool``.  The
router's own surface adds ``/router/stats`` (failover/handoff/shed
counters + per-replica routing state) and ``/router/replicas`` (the
membership admin surface: list / add / remove) for perf tooling, ops,
and the fleet supervisor (``tpuserver_torch.fleet``).

**Dynamic membership.**  The replica set is live state, not a
construction-time constant: :meth:`FleetRouter.add_replica` joins a
replica (its prober spins up, traffic routes to it once a probe sees
it ready) and :meth:`FleetRouter.remove_replica` retires one
mid-flight.  Removal keeps sticky state honest: a removed replica's
homed generations never route to the dead address again — a resume
either hands off (handoff-capable streams re-admit prompt + history on
a live replica) or answers a typed 404.  Every forwarding loop
snapshots the membership once per request, so a concurrent removal can
neither skew an attempt budget nor index into a mutated list.

Run one with ``python -m tpuserver_torch.router_cli --backends
a:8000,b:8000``; see docs/resilience.md "Fleet router" for the full
semantics.
"""

import http.client
import json
import os
import random
import re
import socket
import socketserver
import statistics
import sys
import threading
import time
import uuid
import zlib
from collections import OrderedDict

from tpuserver_torch._http_base import (
    BaseHttpHandler, ClientGone as _ClientGone, RelayStream, SseRelayLoop)
from tpuserver_torch.disagg import PhaseSplitOrchestrator
from tpuserver_torch.journal import JournalFollower, JournalWriter, read_journal
from tpuserver_torch.metrics import (
    MetricsRegistry,
    is_cumulative,
    parse_prometheus_text,
    _fmt_value,
    _render_labels,
)
from tpuserver_torch._retry import (
    FAILURE_CONNECT,
    FAILURE_INTERRUPTED,
    RetryPolicy,
)

__all__ = ["FleetRouter"]

_GENERATE_STREAM_URI = re.compile(
    r"^/v2/models/[^/]+(/versions/[^/]+)?/generate_stream$"
)

#: Mutating verbs whose side effect lives on ONE server (shm regions,
#: repository state, settings): the router broadcasts them to every
#: replica — routing them through failover would land the mutation on
#: an arbitrary replica and desync the fleet (same contract as
#: ``EndpointPool``'s broadcast set).
_BROADCAST_URI = re.compile(
    r"^/v2/(repository/models/[^/]+/(load|unload)"
    r"|(system|cuda|xla)sharedmemory(/region/[^/]+)?/(register|unregister)"
    r"|logging|trace/setting)$"
)

#: Request headers forwarded to replicas (lowercased).  Hop-by-hop
#: headers (connection, transfer framing) are the router's own;
#: Content-Encoding is absent because the router decodes once and
#: forwards identity.
_FORWARD_REQUEST_HEADERS = (
    "content-type",
    "inference-header-content-length",
    "accept-encoding",
)

#: Replica response headers relayed to the client, in canonical casing
#: (the raw-socket client reads them case-sensitively).
_RELAY_RESPONSE_HEADERS = {
    "retry-after": "Retry-After",
    "inference-header-content-length": "Inference-Header-Content-Length",
    "content-encoding": "Content-Encoding",
}


def _relay_headers(resp_headers):
    """The upstream response headers a client must see, re-keyed to
    canonical casing."""
    lowered = {k.lower(): v for k, v in resp_headers.items()}
    return {canon: lowered[k]
            for k, canon in _RELAY_RESPONSE_HEADERS.items()
            if k in lowered}


def _coerce_int(value, default=0):
    try:
        return int(value)
    except (TypeError, ValueError):
        return default


def _probe_phase(url, interval_s):
    """Deterministic per-replica phase offset in ``[0, interval_s)``
    for the health prober.

    Probers created together (router start, a supervisor's fleet-wide
    restart or scale-up) would otherwise all fire on the same cadence
    from the same instant — a synchronized probe storm landing on
    just-booted replicas every ``interval_s``.  Hashing the replica url
    spreads the phases across the whole interval, and stays stable
    across router restarts so the spread never collapses."""
    return (zlib.crc32(url.encode("utf-8")) % 4096) / 4096.0 * interval_s


def _snapshot_signals(snap):
    """``(eligible, load)`` routing signals from one replica's
    ``/v2/health/stats`` snapshot.

    ``ready`` already folds in the lifecycle state machine AND the
    model health veto (a tripped scheduler reports unhealthy), so
    eligibility is the server's own truthful readiness; the load score
    is in-flight requests plus every scheduler's live + queued
    generations — what "least-loaded" means for this stack."""
    if not isinstance(snap, dict):
        return False, float("inf")
    eligible = bool(snap.get("ready")) and snap.get("state") == "ready"
    load = _coerce_int(snap.get("inflight"))
    for stats in (snap.get("models") or {}).values():
        if not isinstance(stats, dict):
            continue
        if stats.get("tripped") or stats.get("closed"):
            eligible = False  # belt over the ready veto
        load += _coerce_int(stats.get("live_streams"))
        load += _coerce_int(stats.get("pending"))
    return eligible, float(load)


def _generation_contract(request_json):
    """``(prompt, max_tokens, eos_id)`` when the request follows the
    PROMPT_IDS / MAX_TOKENS generate contract (what cross-replica
    handoff re-prefills), else ``(None, None, None)``."""
    prompt = max_tokens = None
    try:
        for tin in request_json.get("inputs") or []:
            if tin.get("name") == "PROMPT_IDS":
                prompt = [int(v) for v in tin.get("data") or []]
            elif tin.get("name") == "MAX_TOKENS":
                max_tokens = int((tin.get("data") or [0])[0])
    except (TypeError, ValueError):
        return None, None, None
    eos = (request_json.get("parameters") or {}).get("eos_id")
    try:
        eos = int(eos) if eos is not None else None
    except (TypeError, ValueError):
        eos = None
    return prompt, max_tokens, eos


def _token_of(payload):
    """The emitted token an SSE event carries (the handoff re-prefill
    feed), or None when the event has no TOKEN output."""
    for out in payload.get("outputs") or []:
        if out.get("name") == "TOKEN":
            data = out.get("data") or []
            try:
                return int(data[0]) if data else None
            except (TypeError, ValueError):
                return None
    return None


def _request_deadline(body, headers):
    """The request's own monotonic deadline from its ``timeout``
    parameter (microseconds, Triton semantics), or None.  Failover
    attempts must fit inside the caller's single budget — a router
    retrying past it would answer a client that stopped waiting."""
    if not body:
        return None
    try:
        hlen = headers.get("inference-header-content-length")
        blob = body[: int(hlen)] if hlen else body
        t = (json.loads(blob).get("parameters") or {}).get("timeout")
        return time.monotonic() + int(t) / 1e6 if t else None
    except (AttributeError, TypeError, ValueError, UnicodeDecodeError):
        # AttributeError: valid JSON that is not an object (e.g. "[]")
        # — the replica owns the typed 400, not the router
        return None


def _rewrite_timeout(body, headers, remaining_s):
    """Rewrite a relayed request's ``timeout`` parameter (µs, Triton
    semantics) to the REMAINING monotonic deadline budget, returning
    ``(body, headers)``.

    The router's failover/hedge loop can burn most of a request's
    budget before an attempt ever reaches a replica; relaying the
    ORIGINAL timeout would let that attempt occupy a replica slot for
    the full budget again — a doomed request the caller already gave
    up on.  The replica resolves its own deadline from this parameter
    (``InferenceServer._resolve_deadline``), so shrinking it here is
    the fleet-wide form of deadline propagation: the scheduler's
    pending-admission expiry and mid-generation retirement fire at the
    caller's true deadline, not a fresh one.  Bodies using the binary
    extension carry the JSON object in their first
    ``inference-header-content-length`` bytes — the rewrite re-frames
    that prefix and updates the header.  Requests without a timeout
    parameter relay untouched (no budget to propagate)."""
    try:
        hlen = headers.get("inference-header-content-length")
        jlen = int(hlen) if hlen else None
        blob = body[:jlen] if jlen is not None else body
        obj = json.loads(blob)
        params = obj.get("parameters")
        if not isinstance(params, dict) or not params.get("timeout"):
            return body, headers
        # floor of 1µs: a non-positive timeout would be a malformed
        # request, and the deadline-exhausted case answered 504 above
        params["timeout"] = max(1, int(remaining_s * 1e6))
        new_blob = json.dumps(obj).encode("utf-8")
        if jlen is None:
            return new_blob, headers
        headers = dict(headers)
        headers["inference-header-content-length"] = str(len(new_blob))
        return new_blob + body[jlen:], headers
    except (AttributeError, TypeError, ValueError, UnicodeDecodeError):
        # malformed body: the replica owns the typed 400
        return body, headers


#: POST routes hedge-safe by construction — mirrors the client pool's
#: hedgeable set (tritonclient._pool: infer / metadata / health): an
#: infer executes the same computation on any replica, so a duplicate
#: in-flight attempt is waste, never corruption.  Generations/streams
#: never hedge (a duplicate stream emits duplicate tokens) and
#: broadcast mutations never hedge (the broadcast path never reaches
#: forward_unary).
_HEDGE_URI = re.compile(r"^/v2/models/[^/]+(/versions/[^/]+)?/infer$")

#: Digest verbs: the rolling latency rings key on a tiny closed verb
#: set — per-path keys would make every model name a cardinality axis
#: and cross-model latencies incomparable anyway.
def _verb_of(path):
    tail = path.rstrip("/").rsplit("/", 1)[-1]
    if tail == "infer":
        return "infer"
    if "/health/" in path:
        return "health"
    return "meta"


class _LatencyRing:
    """Fixed-size ring of completed-request latencies (seconds): O(1)
    memory, O(size·log size) on the rare percentile read.  NOT itself
    thread-safe — lives under the owning ``_Replica``'s lock."""

    __slots__ = ("_values", "_idx", "_count")

    def __init__(self, size=64):
        self._values = [0.0] * int(size)
        self._idx = 0
        self._count = 0

    def record(self, value):
        self._values[self._idx] = float(value)
        self._idx = (self._idx + 1) % len(self._values)
        if self._count < len(self._values):
            self._count += 1

    @property
    def samples(self):
        return self._count

    def percentile(self, pct):
        """Linear-interpolated percentile of the retained window, or
        None when empty (matches perfanalyzer.metrics.percentile so
        the serving side and the measuring side agree on what 'p90'
        means)."""
        if self._count == 0:
            return None
        ordered = sorted(self._values[:self._count])
        if len(ordered) == 1:
            return ordered[0]
        rank = (pct / 100.0) * (len(ordered) - 1)
        lo = int(rank)
        hi = min(lo + 1, len(ordered) - 1)
        frac = rank - lo
        return ordered[lo] * (1.0 - frac) + ordered[hi] * frac


class _Replica:
    """One routed backend: its address plus the prober-fed routing
    state (eligibility, load score, router-local in-flight count) and
    the rolling per-verb latency digest gray-failure ejection reads."""

    def __init__(self, url, digest_window=64):
        host, sep, port = url.rpartition(":")
        if not sep or not host:
            raise ValueError(
                "replica url must be host:port (got {!r})".format(url))
        self.url = url
        self.host = host
        self.port = int(port)
        # set on remove_replica: the prober loop exits and routing
        # state is latched ineligible (a re-added url gets a FRESH
        # _Replica — no breaker/score carryover by construction)
        self.removed = threading.Event()
        self._lock = threading.Lock()
        # optimistic until the first probe lands, like the pool's
        # endpoints — a router must be able to serve before its first
        # probe cycle completes  # guarded-by: _lock
        self._eligible = True
        self._load = 0.0            # guarded-by: _lock
        self._local_inflight = 0    # guarded-by: _lock
        self._requests = 0          # guarded-by: _lock
        self._failures = 0          # guarded-by: _lock
        self._snapshot = None       # guarded-by: _lock
        self._digest_window = int(digest_window)
        # rolling per-verb latency digest (gray-failure signal):
        # verb -> _LatencyRing of completed-request latencies.  Hedge
        # losers and probe RPCs never record — only traffic the client
        # actually waited on.  # guarded-by: _lock
        self._digest = {}
        # soft-ejected: health-eligible but routed around (except the
        # probe fraction) because its recent latency is a fleet
        # outlier.  Health/drain verdicts always dominate — this flag
        # is only ever consulted among ELIGIBLE replicas.
        # # guarded-by: _lock
        self._ejected = False
        self._ejections = 0         # guarded-by: _lock

    def update_snapshot(self, snap):
        eligible, load = _snapshot_signals(snap)
        with self._lock:
            self._snapshot = snap
            self._eligible = eligible
            self._load = load

    def health(self):
        """The last probe's raw health snapshot (None while
        unreachable) — where phase-aware consumers read role and
        per-model queue depth from."""
        with self._lock:
            return self._snapshot

    def role(self):
        """The replica's advertised disaggregated-serving role
        (``"prefill"`` / ``"decode"``), or None for fused replicas and
        while no snapshot is held — an unreachable replica belongs to
        no phase pool."""
        snap = self.health()
        return snap.get("role") if isinstance(snap, dict) else None

    def mark_unreachable(self):
        """A probe or request could not reach the replica: rotate it
        out until a probe sees it healthy again."""
        with self._lock:
            self._eligible = False
            self._snapshot = None
            self._failures += 1

    def note_typed_failure(self):
        """A typed shed (429/503): the replica answered — count it but
        leave rotation to the prober's readiness signal."""
        with self._lock:
            self._failures += 1

    def retire(self):
        """The replica left the membership: stop its prober and latch
        it ineligible so an in-flight request holding a stale snapshot
        never picks it again."""
        self.removed.set()
        with self._lock:
            self._eligible = False
            self._snapshot = None

    def begin_request(self):
        with self._lock:
            self._requests += 1
            self._local_inflight += 1

    def end_request(self):
        with self._lock:
            self._local_inflight -= 1

    def routable(self):
        """``(eligible, effective_load, soft_ejected)``: the probe's
        load score plus the router's own in-flight count against this
        replica — the between-probes signal that keeps routing
        least-loaded — and the gray-failure ejection flag (meaningful
        only when ``eligible``; health and drain always dominate)."""
        with self._lock:
            return (self._eligible, self._load + self._local_inflight,
                    self._ejected)

    # -- latency digest / gray-failure ejection ----------------------------

    def note_latency(self, verb, seconds):
        """Record one completed request the client actually waited on.
        Hedge losers are excluded by the caller: a loser's latency is
        the hedge's artifact (its connection was abandoned), not the
        replica's service time."""
        with self._lock:
            ring = self._digest.get(verb)
            if ring is None:
                ring = self._digest[verb] = _LatencyRing(
                    self._digest_window)
            ring.record(seconds)

    def digest_snapshot(self):
        """``{verb: (p90, p95, samples)}`` of the rolling digest."""
        with self._lock:
            return {
                verb: (ring.percentile(90), ring.percentile(95),
                       ring.samples)
                for verb, ring in self._digest.items()
                if ring.samples
            }

    def hedge_delay(self, verb, min_samples):
        """The replica's own rolling p95 for ``verb`` — the hedge
        delay seed — or None below ``min_samples`` (an empty digest
        would seed hedges from noise)."""
        with self._lock:
            ring = self._digest.get(verb)
            if ring is None or ring.samples < min_samples:
                return None
            return ring.percentile(95)

    def soft_eject(self):
        """Latch the gray-failure ejection flag and RESET the digest:
        re-admission is judged on what the probe-fraction traffic
        measures from now on, not on the slow window that caused the
        ejection (which would otherwise pin the replica out long after
        it recovered).  Returns False when already ejected."""
        with self._lock:
            if self._ejected:
                return False
            self._ejected = True
            self._ejections += 1
            self._digest = {}
            return True

    def readmit(self):
        """Clear the ejection flag (fresh probe-window samples came in
        under the outlier bar).  Returns False when not ejected."""
        with self._lock:
            if not self._ejected:
                return False
            self._ejected = False
            return True

    def status(self):
        """The one-word routing state ops dashboards key on — it is
        what lets a scrape distinguish a gray incident (soft-ejected)
        from a planned drain from a dead process, which raw
        ineligibility collapses into one bit."""
        with self._lock:
            if self.removed.is_set():
                return "removed"
            if not self._eligible:
                if self._snapshot is None:
                    return "unreachable"
                state = self._snapshot.get("state") \
                    if isinstance(self._snapshot, dict) else None
                return "draining" if state == "draining" else "ineligible"
            return "soft-ejected" if self._ejected else "ok"

    def stats(self):
        status = self.status()
        with self._lock:
            return {
                "url": self.url,
                "eligible": self._eligible,
                "load": self._load + self._local_inflight,
                "requests": self._requests,
                "failures": self._failures,
                "status": status,
                "ejected": self._ejected,
                "ejections": self._ejections,
                "digest": {
                    verb: {"p90_s": ring.percentile(90),
                           "p95_s": ring.percentile(95),
                           "samples": ring.samples}
                    for verb, ring in self._digest.items()
                    if ring.samples
                },
            }


class _Generation:
    """Router-side record of one streamed generation: the original
    request (the handoff re-prefill source), every event relayed so far
    (the resume replay buffer), and the home replica that owns the live
    replay state."""

    def __init__(self, gen_id, path, request_json):
        self.gen_id = gen_id
        self.path = path
        self.request = request_json  # read-only after construction
        prompt, max_tokens, eos_id = _generation_contract(request_json)
        self.prompt = prompt
        self.max_tokens = max_tokens
        self.eos_id = eos_id
        # the request's own monotonic deadline (its ``timeout``
        # parameter, µs): every upstream (re)admission — failover,
        # handoff, resume splice — relays the REMAINING budget, so a
        # slow first home cannot grant its successor a fresh window
        try:
            t = (request_json.get("parameters") or {}).get("timeout")
            self.deadline = (time.monotonic() + int(t) / 1e6
                             if t else None)
        except (AttributeError, TypeError, ValueError):
            # AttributeError: valid-JSON non-dict "parameters" — the
            # replica owns the typed 400, not the router
            self.deadline = None
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        # rendered SSE blocks; router seq of _events[i] is _base + i.
        # A LIVE generation always has _base == 0; a generation
        # rebuilt from the journal may hold only the retained tail
        # (_base = count of events that aged out with their segments)
        # # guarded-by: _lock
        self._events = []
        self._base = 0          # guarded-by: _lock
        # rebuilt from the crash journal (recovery / standby tailing):
        # the flag that authorizes fast_forward — a live router's
        # watermark can never truthfully trail its client's
        # # guarded-by: _lock
        self._recovered = False
        # the router's journal writer (None on journal-less routers
        # and on standbys): set by register_generation / promote.
        # Appends are a single lock-free deque.append — the relay hot
        # path acquires no lock beyond the _lock it already holds.
        self.journal = None
        self._journaled_bind = False  # guarded-by: _lock
        # emitted TOKEN ints (None once an event arrives without one:
        # the generation is not handoff-capable)  # guarded-by: _lock
        self._tokens = [] if prompt is not None else None
        # router seq = _offset + backend seq (bumped at each handoff:
        # a re-admitted generation restarts backend numbering at 0)
        self._offset = 0        # guarded-by: _lock
        self._home = None       # guarded-by: _lock
        # the home was REMOVED from the membership (vs never assigned):
        # a resume must never dial it again — hand off or typed-404
        self._home_lost = False  # guarded-by: _lock
        self._completed = False  # guarded-by: _lock
        # one serving connection at a time: a fast reconnect waits for
        # the previous relay to notice its dead client  # guarded-by: _lock
        self._busy = False

    # -- serving-slot ownership -------------------------------------------

    def acquire(self, wait_s=5.0):
        deadline = time.monotonic() + wait_s
        with self._cond:
            while self._busy:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(remaining)
            self._busy = True
            return True

    def release(self):
        with self._cond:
            self._busy = False
            self._cond.notify_all()

    # -- event recording ---------------------------------------------------

    def record_event(self, backend_seq, payload):
        """Rewrite one upstream event into router numbering and append
        it to the replay buffer.  Returns ``(router_seq, block_bytes)``
        or ``(None, None)`` for an upstream replay duplicate."""
        token = _token_of(payload)
        with self._lock:
            seq = self._offset + int(backend_seq)
            expected = self._base + len(self._events)
            if seq < expected:
                return None, None  # upstream replayed an acked event
            params = payload.setdefault("parameters", {})
            params["generation_id"] = self.gen_id
            params["seq"] = expected
            # post-handoff events mark their id line with the handoff
            # epoch ("gen~offset/seq"): router seqs no longer equal the
            # serving replica's own numbering, and a router holding no
            # offset map for the epoch must see that in the client's
            # Last-Event-ID and fail the resume typed instead of
            # forwarding a misaligned replay point to a replica
            gid = (self.gen_id if not self._offset
                   else "{}~{}".format(self.gen_id, self._offset))
            block = (
                "id: {}/{}\n".format(gid, expected).encode("utf-8")
                + b"data: " + json.dumps(payload).encode("utf-8") + b"\n\n"
            )
            self._events.append(block)
            # a live relay just confirmed the watermark: fast_forward
            # disarms — from here a resume point past the watermark is
            # a client lying, not a crash's lost flush window
            self._recovered = False
            if self._tokens is not None:
                if token is None:
                    self._tokens = None  # not re-prefillable
                else:
                    self._tokens.append(token)
            journal = self.journal
            if journal is not None:
                # enqueue-only durability: one lock-free deque append
                # under the _lock the relay already holds — framing,
                # I/O, and fsync happen on the journal's writer thread
                journal.append({"t": "ev", "gen": self.gen_id,
                                "seq": expected, "id": gid, "p": payload})
            return expected, block

    def mark_unresumable(self):
        """The upstream sent an event without a seq (a non-scheduler
        generation): no replay buffer, no handoff — passthrough only."""
        with self._lock:
            self._tokens = None

    def replay_from(self, from_seq):
        """``(blocks, completed, next_seq, available)`` for a client
        resume.  ``available`` is False when ``from_seq`` predates a
        recovered generation's retained journal tail — the events
        before ``_base`` aged out with their segments and cannot be
        replayed."""
        with self._lock:
            if from_seq < self._base:
                return [], self._completed, \
                    self._base + len(self._events), False
            return (
                list(self._events[from_seq - self._base:]),
                self._completed,
                self._base + len(self._events),
                True,
            )

    def fast_forward(self, to_seq):
        """Advance a RECOVERED generation's watermark to a client's
        resume point that is ahead of the journal's last record: the
        crash lost the final flush window, but the client provably
        received those events (its ``Last-Event-ID`` names them) and
        the home replica still holds them — the upstream resume splice
        continues from the client's own position.  The skipped span is
        unreplayable afterwards (``_base`` jumps) and the token
        history is no longer complete, so handoff capability drops.
        Refused (False) on live generations — a live router's
        watermark can never truthfully trail its client's."""
        with self._lock:
            if not self._recovered or self._completed:
                return False
            if to_seq <= self._base + len(self._events):
                return False
            self._base = to_seq
            self._events = []
            self._tokens = None
            return True

    # -- home / lifecycle --------------------------------------------------

    def set_home(self, url, rebase=False):
        """Point the generation at a (new) owning replica; ``rebase``
        restarts backend seq numbering at the current router seq (a
        handed-off generation is a FRESH admission on its new home)."""
        with self._lock:
            self._home = url
            self._home_lost = False
            if rebase:
                self._offset = self._base + len(self._events)
            journal = self.journal
            if journal is not None:
                if not self._journaled_bind:
                    self._journaled_bind = True
                    journal.append({
                        "t": "bind", "gen": self.gen_id,
                        "path": self.path, "req": self.request,
                        "home": url, "offset": self._offset})
                else:
                    journal.append({
                        "t": "home", "gen": self.gen_id,
                        "home": url, "offset": self._offset})

    def home_removed(self, url):
        """The membership dropped ``url``: if it was this generation's
        home, forget the address (resumes must hand off or fail typed,
        never dial a removed replica)."""
        with self._lock:
            if self._home == url and not self._completed:
                self._home = None
                self._home_lost = True

    def complete(self):
        with self._lock:
            already = self._completed
            self._completed = True
            journal = self.journal
            if journal is not None and not already:
                journal.append({"t": "fin", "gen": self.gen_id})

    def emitted(self):
        with self._lock:
            return self._base + len(self._events)

    def snapshot(self):
        with self._lock:
            return {
                "home": self._home,
                "home_lost": self._home_lost,
                "seq": self._base + len(self._events),
                "offset": self._offset,
                "completed": self._completed,
                "handoff_capable": self._tokens is not None,
                "recovered": self._recovered,
            }

    # -- journal recovery --------------------------------------------------

    @classmethod
    def from_journal(cls, gen_id, path, request_json):
        """Rebuild a generation from its journal ``bind`` record.  The
        original request's deadline is NOT reconstructed — it was
        anchored to a dead process's monotonic clock; the replicas
        still enforce their own resolved deadlines."""
        gen = cls(gen_id, path or "", request_json
                  if isinstance(request_json, dict) else {})
        gen.deadline = None
        with gen._lock:
            gen._recovered = True
            # the bind is already durable; re-journaling it on the
            # first post-recovery set_home would only duplicate it
            gen._journaled_bind = True
        return gen

    def apply_home(self, url, offset):
        """Apply a journal ``bind``/``home`` record: the owning
        replica and the handoff offset at that point."""
        with self._lock:
            self._home = url or None
            self._home_lost = url is None
            self._offset = int(offset or 0)

    def apply_event(self, seq, gid, payload):
        """Apply a journal ``ev`` record, rebuilding the exact SSE
        block the client saw.  A seq gap (older segments rotated out,
        or records lost to a crash's final flush window) keeps only
        the contiguous tail ending at ``seq`` — and drops the token
        history, which is no longer complete enough to hand off."""
        with self._lock:
            watermark = self._base + len(self._events)
            if seq < watermark:
                return
            if seq > watermark:
                self._base = seq
                self._events = []
                self._tokens = None
            block = (
                "id: {}/{}\n".format(gid, seq).encode("utf-8")
                + b"data: " + json.dumps(payload).encode("utf-8")
                + b"\n\n"
            )
            self._events.append(block)
            if self._tokens is not None:
                token = _token_of(payload)
                if token is None:
                    self._tokens = None
                else:
                    self._tokens.append(token)

    # -- upstream request builders ----------------------------------------

    def upstream_request(self, resuming):
        """``(body, headers)`` that (re)establishes the upstream
        stream: the original request with the router's generation id
        injected; when ``resuming``, a ``Last-Event-ID`` in the home
        replica's OWN numbering so it replays exactly the gap the
        router has not buffered (usually nothing) and splices live."""
        with self._lock:
            request = dict(self.request)
            params = dict(request.get("parameters") or {})
            params.pop("resume_generation_id", None)
            params.pop("resume_from_seq", None)
            params["generation_id"] = self.gen_id
            self._propagate_deadline(params)
            request["parameters"] = params
            headers = {"Content-Type": "application/json"}
            if resuming:
                backend_last = (self._base + len(self._events)
                                - self._offset - 1)
                headers["Last-Event-ID"] = "{}/{}".format(
                    self.gen_id, backend_last)
            return json.dumps(request).encode("utf-8"), headers

    def _propagate_deadline(self, params):
        """Rewrite ``timeout`` to the generation's REMAINING budget: a
        failover/handoff admission must arrive at its new replica with
        the caller's true deadline, not the original full window (the
        replica resolves its own deadline from this parameter)."""
        if self.deadline is None:
            return
        remaining = self.deadline - time.monotonic()
        params["timeout"] = max(1, int(remaining * 1e6))

    def handoff_request(self):
        """The re-admission body for a healthy replica: the original
        inputs with ``PROMPT_IDS`` extended by every emitted token and
        ``MAX_TOKENS`` shrunk by the emitted count — greedy decode is
        deterministic, so re-prefilling the full emitted prefix yields
        a token-identical continuation (the supervised-restart
        invariant, applied across replicas).  Returns ``None`` when the
        generation is not handoff-capable, or ``b""`` when every token
        was already emitted and only the terminal marker was lost."""
        with self._lock:
            if (self._tokens is None or self.prompt is None
                    or self.max_tokens is None):
                return None
            emitted = len(self._tokens)
            remaining = self.max_tokens - emitted
            if remaining <= 0 or (
                self.eos_id is not None and emitted
                and self._tokens[-1] == self.eos_id
            ):
                return b""
            request = dict(self.request)
            inputs = []
            for tin in request.get("inputs") or []:
                tin = dict(tin)
                if tin.get("name") == "PROMPT_IDS":
                    data = list(self.prompt) + list(self._tokens)
                    tin["data"] = data
                    tin["shape"] = [len(data)]
                elif tin.get("name") == "MAX_TOKENS":
                    tin["data"] = [remaining]
                inputs.append(tin)
            request["inputs"] = inputs
            params = dict(request.get("parameters") or {})
            params.pop("resume_generation_id", None)
            params.pop("resume_from_seq", None)
            params["generation_id"] = self.gen_id
            self._propagate_deadline(params)
            request["parameters"] = params
            return json.dumps(request).encode("utf-8")


class _FleetMetricsAggregator:
    """Churn-safe fleet aggregation of replica ``/metrics`` scrapes.

    The router's ``GET /metrics`` must present ONE fleet view whose
    monotonic counters never decrease — across replica process
    restarts (a respawned replica's counters reset to zero) and
    membership churn (scale-down removes a replica's exposition
    entirely).  Standard federation math: per ``(replica, sample)``
    last-seen values plus a retained base.

    - A **cumulative** sample (``TYPE counter``/``histogram``, or an
      untyped ``*_total``/``*_count`` compatibility family like
      ``nv_inference_count``) whose new value is LOWER than its last
      seen one is a process restart: the pre-reset total folds into
      the base and counting restarts from the new value.
    - A replica whose process identity changed since its last scrape
      (``identities``: the pid and spawn nonce its health snapshot
      reported around the scrape) is a process restart too, whatever
      its values: a respawn that has caught up to its predecessor's
      count (the same ``16`` prefix hits again) lowers nothing, so
      the drop alone would miss it and the fleet view would stall.
    - A replica that leaves the membership folds its whole last
      contribution into the base — the fleet view keeps everything it
      ever served.
    - **Gauges** are point-in-time: they sum over the replicas
      reachable in THIS scrape, no retained state.

    All state lives under one small lock held only for dict math —
    the scrapes themselves happen outside (R2: no blocking under a
    lock).
    """

    def __init__(self):
        self._lock = threading.Lock()
        # (url, sample_key) -> last seen value  # guarded-by: _lock
        self._last = {}
        # sample_key -> folded pre-reset/pre-removal total  # guarded-by: _lock
        self._base = {}
        # url -> the process identity of its last folded scrape
        # guarded-by: _lock
        self._identity = {}
        # family -> (kind, help)  # guarded-by: _lock
        self._meta = {}
        # monotonic stamp of the last APPLIED fold: concurrent
        # /metrics handlers scrape outside any lock, so an older
        # scrape landing after a newer one must not fold — its lower
        # values would read as counter resets and permanently inflate
        # the fleet totals  # guarded-by: _lock
        self._last_stamp = float("-inf")

    def render(self, live_urls, scrapes, stamp=None, exclude=(),
               identities=None):
        """Fold this round of ``scrapes`` (url -> parsed families of
        the replica's exposition) and render the aggregate lines.
        ``stamp`` is the monotonic instant the scrape round STARTED:
        a round older than the last applied one renders the current
        aggregate without folding (stale values never corrupt the
        reset detection).  ``exclude`` names families the caller's own
        registry already rendered — when replicas are themselves
        routers (routers stack), re-emitting their ``tpu_router_*``
        families would declare the same family twice and invalidate
        the exposition.  ``identities`` maps a scraped url to its
        process identity (None: unknown); a changed one folds the url's
        last values into the base first."""
        live = set(live_urls)
        exclude = set(exclude)
        identities = identities or {}
        with self._lock:
            fold = stamp is None or stamp >= self._last_stamp
            if fold and stamp is not None:
                self._last_stamp = stamp
            gauges = {}
            if fold:
                respawned = set()
                for url in scrapes:
                    ident = identities.get(url)
                    if ident is None:
                        continue
                    if self._identity.get(url, ident) != ident:
                        respawned.add(url)
                    self._identity[url] = ident
                for url, key in list(self._last):
                    if url not in live or url in respawned:
                        # membership churn or a new process: the
                        # departed one's totals are history the fleet
                        # view must keep
                        self._base[key] = (self._base.get(key, 0.0)
                                           + self._last.pop((url, key)))
            for url, families in scrapes.items():
                for fam_name, fam in families.items():
                    if fam_name in exclude:
                        continue
                    kind = fam["type"]
                    self._meta[fam_name] = (kind, fam["help"])
                    cumulative = is_cumulative(fam_name, kind)
                    for sample_name, labels, value in fam["samples"]:
                        key = (fam_name, sample_name,
                               tuple(sorted(labels.items())))
                        if not cumulative:
                            gauges[key] = gauges.get(key, 0.0) + value
                        elif fold:
                            prev = self._last.get((url, key))
                            if prev is not None and value < prev:
                                # counter reset: a healed process
                                self._base[key] = (
                                    self._base.get(key, 0.0) + prev)
                            self._last[(url, key)] = value
            totals = dict(self._base)
            for (_url, key), value in self._last.items():
                totals[key] = totals.get(key, 0.0) + value
            totals.update(gauges)
            meta = dict(self._meta)
        by_family = {}
        for (fam_name, sample_name, labels), value in totals.items():
            if fam_name in exclude:
                continue  # retained state from before an exclusion
            by_family.setdefault(fam_name, []).append(
                (sample_name, labels, value))

        def sample_order(sample):
            # histogram buckets must leave in ascending numeric ``le``
            # order (OpenMetrics consumers reject lexicographic order:
            # "+Inf" < "0.0001" as strings); every other label sorts
            # lexicographically for a stable exposition
            sample_name, labels, _value = sample
            le = dict(labels).get("le")
            if le is None:
                le_key = float("-inf")
            elif le == "+Inf":
                le_key = float("inf")
            else:
                try:
                    le_key = float(le)
                except ValueError:
                    le_key = float("inf")
            rest = tuple(kv for kv in labels if kv[0] != "le")
            return (sample_name, rest, le_key)

        lines = []
        for fam_name in sorted(by_family):
            kind, help_text = meta.get(fam_name, (None, None))
            if help_text:
                lines.append("# HELP {} {}".format(fam_name, help_text))
            if kind:
                lines.append("# TYPE {} {}".format(fam_name, kind))
            for sample_name, labels, value in sorted(
                    by_family[fam_name], key=sample_order):
                lines.append("{}{} {}".format(
                    sample_name, _render_labels(labels),
                    _fmt_value(value)))
        return "\n".join(lines) + "\n" if lines else ""


class FleetRouter:
    """The router process core: replica set, prober, generation
    registry, counters, and the embedded HTTP front-tier.

    Parameters
    ----------
    backends : list[str]
        ``host:port`` of each replica.
    probe_interval_s / probe_timeout_s
        Health-prober cadence and per-probe timeout.  One synchronous
        probe round runs inside :meth:`start` so routing state is real
        before the first request.
    max_inflight : int or None
        Router-level cap on concurrently forwarded requests; excess
        sheds with a typed 429 + ``Retry-After`` instead of queueing.
    gen_ttl_s / gen_capacity
        Generation-registry bounds: match ``gen_ttl_s`` to the
        replicas' ``replay_ttl_s`` (the windows must agree for sticky
        resume to mean anything).
    read_timeout_s / stream_wait_s
        Upstream socket read timeout, and how long a resume waits for
        a previous relay of the same generation to release it.
    outlier_factor / outlier_min_samples / min_eligible / probe_fraction
        Gray-failure ejection (docs/resilience.md "Tail-latency
        defense"): a replica whose recent per-verb p90 (over at least
        ``outlier_min_samples`` of its own completed requests) exceeds
        ``outlier_factor`` × the fleet median is soft-ejected — routed
        around like drain but fed ``probe_fraction`` of real traffic
        so it re-admits itself on recovery.  Ejection never shrinks
        the healthy set below ``min_eligible``.
    eject_interval_s / digest_window
        Ejection-evaluation throttle and the per-verb latency ring
        size (O(1) memory per replica per verb).
    hedge_delay_s
        Opt-in hedged unary requests (None = off): an idempotent
        attempt still pending after the primary's rolling p95 —
        floored at this value, which alone applies while the digest
        is cold — races a duplicate on the next-ranked different
        replica, first response wins.  Never streams, never
        broadcasts.
    journal
        Directory of the crash-durable generation journal
        (docs/resilience.md "Router HA & state durability").  On
        :meth:`start` the router replays every retained record —
        rebuilding sticky bindings, handoff offsets, watermarks, and
        the relayed-event tail — so marked (``gen~offset/seq``)
        resumes survive a router restart, then journals all new
        resume-critical state off the hot relay path.  None (default)
        keeps the pre-journal behavior.
    standby
        Run as a WARM STANDBY: tail ``journal`` (required) instead of
        writing it, keep the replica membership + prober live, but
        shed all /v2 traffic with a typed 503 until :meth:`promote`
        (or ``POST /router/promote``) turns this router active.
    partition_index / partition_count / peers / partition_epoch
        The horizontal front tier (docs/resilience.md "Horizontal
        router tier"): with ``partition_count > 1`` this router owns
        only the generation ids hashing to ``partition_index``
        (``crc32(bare_id) % count``), journals under its own
        per-partition subdirectory (``<journal>/p<index>`` — the
        single-writer discipline holds per partition), and
        peer-forwards everything else to the owner in ``peers`` (the
        url-by-partition map, rebindable at runtime via ``POST
        /router/partition`` with a newer ``epoch``).  A partitioned
        standby tails EVERY partition's journal and is promoted INTO
        one dead active's partition (``promote(partition=k)``).
        ``partition_count == 1`` (default) is the unpartitioned
        single-active behavior, byte-identical to before.
    relay_mode
        ``"selector"`` hands every established token stream to one
        event-loop thread (:class:`~tpuserver_torch._http_base.SseRelayLoop`)
        so thousands of idle streams do not pin a thread each;
        ``"thread"`` keeps the classic thread-per-stream relay.  None
        picks selector for partitioned routers and thread otherwise.
    """

    def __init__(self, backends, host="127.0.0.1", port=0,
                 probe_interval_s=1.0, probe_timeout_s=2.0,
                 max_inflight=None, gen_ttl_s=60.0, gen_capacity=1024,
                 read_timeout_s=600.0, stream_wait_s=5.0, verbose=False,
                 affinity_bonus=2.0, affinity_prefix_tokens=16,
                 outlier_factor=3.0, outlier_min_samples=16,
                 min_eligible=1, probe_fraction=1.0 / 16,
                 eject_interval_s=0.5, digest_window=64,
                 hedge_delay_s=None, journal=None, standby=False,
                 journal_flush_s=0.02, spawn_nonce=None,
                 partition_index=None, partition_count=1, peers=None,
                 partition_epoch=0, relay_mode=None):
        if not backends:
            raise ValueError("FleetRouter requires at least one backend")
        if relay_mode not in (None, "thread", "selector"):
            raise ValueError(
                "relay_mode must be 'thread' or 'selector' "
                "(got {!r})".format(relay_mode))
        partition_count = max(1, int(partition_count))
        if partition_count > 1:
            if partition_index is None and not standby:
                raise ValueError(
                    "a partitioned ACTIVE router needs its partition: "
                    "pass partition_index with partition_count > 1")
            if (partition_index is not None
                    and not 0 <= int(partition_index) < partition_count):
                raise ValueError(
                    "partition_index {} out of range for {} "
                    "partition(s)".format(partition_index, partition_count))
        # spawn identity nonce (fleet supervisor adoption): echoed in
        # health_snapshot so a restarted supervisor can claim this
        # router process the same way it claims replicas
        self.spawn_nonce = spawn_nonce
        if standby and not journal:
            raise ValueError(
                "a standby router needs the journal to tail: pass "
                "journal=<directory> with standby=True")
        if len(set(backends)) != len(backends):
            raise ValueError(
                "FleetRouter backends must be unique: {}".format(backends))
        self._replicas_lock = threading.Lock()
        # -- tail-latency defense knobs (docs/resilience.md) --------------
        # gray-failure ejection: a replica whose recent per-verb p90
        # exceeds outlier_factor x the fleet median (across at least
        # outlier_min_samples of its own samples) is soft-ejected —
        # routed around like drain, but probed with 1/probe_fraction of
        # real traffic so it re-admits itself on recovery.  Ejection
        # NEVER drops the eligible-and-not-ejected set below
        # min_eligible: the fleet degrades to slow, never unavailable.
        self._outlier_factor = float(outlier_factor)
        self._outlier_min_samples = int(outlier_min_samples)
        self._min_eligible = int(min_eligible)
        self._probe_every = max(1, int(round(1.0 / probe_fraction))) \
            if probe_fraction and probe_fraction > 0 else 0
        self._eject_interval_s = float(eject_interval_s)
        self._digest_window = int(digest_window)
        # hedged unary requests: None = off.  When on, an idempotent
        # unary attempt still pending after the primary replica's own
        # rolling p95 — floored at hedge_delay_s, which alone applies
        # while the digest is cold — gets a second attempt on the
        # next-ranked DIFFERENT replica, first response wins.
        self._hedge_delay_s = (float(hedge_delay_s)
                               if hedge_delay_s is not None else None)
        # live membership: add_replica/remove_replica mutate it while
        # requests are in flight, so every consumer goes through
        # _replicas_snapshot()  # guarded-by: _replicas_lock
        self._replicas = [_Replica(url, digest_window=self._digest_window)
                          for url in backends]
        # the failure classifier (stateless); attempt budgets are sized
        # per request from the membership snapshot
        self._policy = RetryPolicy()
        self._probe_interval_s = float(probe_interval_s)
        self._probe_timeout_s = float(probe_timeout_s)
        self._max_inflight = max_inflight
        self._gen_ttl_s = float(gen_ttl_s)
        self._gen_capacity = int(gen_capacity)
        self._read_timeout_s = float(read_timeout_s)
        self._stream_wait_s = float(stream_wait_s)
        self._verbose = verbose
        self._lock = threading.Lock()
        # generation_id -> (generation, expires_monotonic): the sticky
        # map + replay buffer registry, TTL'd and capacity-bounded like
        # the replicas' own replay buffers  # guarded-by: _lock
        self._gens = OrderedDict()
        self._inflight = 0   # guarded-by: _lock
        self._shed = 0       # guarded-by: _lock
        self._failovers = 0  # guarded-by: _lock
        self._handoffs = 0   # guarded-by: _lock
        self._resumed = 0    # guarded-by: _lock
        # gray-failure ejection events (soft-ejections applied) and
        # hedge outcomes: won = the hedge's response was used, lost =
        # the primary answered after the hedge was already issued,
        # cancelled = the hedge was abandoned still in flight when the
        # primary won  # guarded-by: _lock
        self._ejections = 0
        self._hedges = {"won": 0, "lost": 0, "cancelled": 0}
        # rotation counter steering every probe_every'th pick onto a
        # soft-ejected replica (its real-traffic probe)  # guarded-by: _lock
        self._eject_tick = 0
        # -- horizontal front tier (docs/resilience.md "Horizontal
        # router tier"): stable gen-id partitions across N actives ----------
        self._partition_count = partition_count
        # rebound by promote(partition=k)  # guarded-by: _lock
        self._partition_index = (int(partition_index)
                                 if partition_index is not None else None)
        # url-by-partition owner map + its epoch: higher epochs win
        # (supervisor broadcast after a takeover)  # guarded-by: _lock
        self._partition_map = [str(u) for u in peers] if peers else []
        self._partition_epoch = int(partition_epoch)  # guarded-by: _lock
        self._partition_owned = 0      # guarded-by: _lock
        self._partition_forwarded = 0  # guarded-by: _lock
        self._partition_moved = 0      # guarded-by: _lock
        self._relay_mode = relay_mode or (
            "selector" if partition_count > 1 else "thread")
        # the selector relay loop (created in start() when mode is
        # "selector"; None keeps the thread-per-stream relay)
        self._relay_loop = None
        # -- router HA state (docs/resilience.md "Router HA") -------------
        # partitioned actives journal under their own subdirectory —
        # the journal's single-writer discipline, per partition
        self._journal_base = journal
        if (journal is not None and partition_count > 1
                and partition_index is not None):
            self._journal_dir = os.path.join(
                journal, "p{}".format(int(partition_index)))
        else:
            self._journal_dir = journal
        self._journal_flush_s = float(journal_flush_s)
        # the journal writer (active routers with a journal only);
        # created in start()/promote(), closed in stop()
        self._journal = None
        self._follower = None
        # partitioned standby: one follower per partition journal
        self._followers = None
        self._tail_thread = None
        self._tail_stop = threading.Event()
        # warm-standby flag: /v2 traffic sheds typed 503 while set;
        # promote() clears it  # guarded-by: _lock
        self._standby = bool(standby)
        # promote() in-flight claim: the takeover signal can arrive
        # from an admin POST and a process signal at once, and the
        # promotion body blocks (thread join, file I/O) so it runs
        # OUTSIDE any lock  # guarded-by: _lock
        self._promoting = False
        # SIGTERM drain latch: stop admitting, let in-flight finish
        # # guarded-by: _lock
        self._draining = False
        # generations rebuilt from the journal (boot recovery + standby
        # tailing) and standby->active promotions  # guarded-by: _lock
        self._recovered = 0
        self._takeovers = 0
        # monotonic stamp of the last ejection evaluation (the
        # throttle check-and-set is one atomic region under _lock —
        # two racing callers cannot both pass)  # guarded-by: _lock
        self._eject_eval_last = float("-inf")
        # prefix-affinity routing (the fleet half of the replicas'
        # radix prefix cache): prompt-prefix hash -> (replica url,
        # expires_monotonic).  A generation admission whose prefix was
        # recently served routes to the replica whose radix cache is
        # already warm — as a LOAD-SCORE BONUS only: health, drain and
        # eligibility always win, and a busier-by-more-than-the-bonus
        # warm replica loses to a colder idle one.
        # ``affinity_bonus <= 0`` disables the signal (hash-blind
        # routing — the perfanalyzer A/B control).
        self._affinity_bonus = float(affinity_bonus)
        self._affinity_prefix_tokens = int(affinity_prefix_tokens)
        # prefix hash -> (url, expires)  # guarded-by: _lock
        self._affinity = OrderedDict()
        self._affinity_routed = 0  # guarded-by: _lock
        self._stop = threading.Event()
        self._httpd = _RouterServer((host, port), _RouterHandler)
        self._httpd.router = self
        self._thread = None
        self._started = False    # guarded-by: _replicas_lock
        self._probers = []       # guarded-by: _replicas_lock
        # optional fleet-supervisor stats hook: folded into /router/
        # stats so perf tooling sees restart/scale counters per window
        self._supervisor_stats = None
        # the router tier's own telemetry (collector over stats() — the
        # counters stay singly accounted) + the fleet aggregator behind
        # GET /metrics (docs/observability.md)
        self.metrics = MetricsRegistry()
        self.metrics.register_collector(self._collect_metrics)
        self._aggregator = _FleetMetricsAggregator()
        # disaggregated prefill/decode admission (tpuserver_torch.disagg):
        # engages only when the prober sees BOTH role pools, so a
        # role-less (or single-replica) fleet rides today's fused
        # path byte-identically
        self.disagg = PhaseSplitOrchestrator(self)

    # -- lifecycle ---------------------------------------------------------

    @property
    def port(self):
        return self._httpd.server_address[1]

    @property
    def url(self):
        return "{}:{}".format(self._httpd.server_address[0], self.port)

    def start(self):
        # crash durability first: a journaled router replays its
        # predecessor's resume-critical state BEFORE the first request
        # can name a generation; a standby starts tailing instead
        if self._journal_dir is not None:
            with self._lock:
                standby = self._standby
            if standby:
                if self._partition_count > 1:
                    # a partitioned standby is the warm copy of EVERY
                    # partition: it tails all N journals and only at
                    # promotion binds to the dead active's partition
                    self._followers = [
                        JournalFollower(os.path.join(
                            self._journal_base, "p{}".format(k)))
                        for k in range(self._partition_count)]
                else:
                    self._follower = JournalFollower(self._journal_dir)
                self._tail_thread = threading.Thread(
                    target=self._tail_loop,
                    name="fleet-router-journal-tail", daemon=True)
                self._tail_thread.start()
            else:
                self._recover_journal()
                self._open_journal_writer()
        if self._relay_mode == "selector":
            self._relay_loop = SseRelayLoop(name="fleet-router-relay")
        # one synchronous probe round before serving: routing decisions
        # start from real replica state, not optimism
        self._probe_round()
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.05},
            name="fleet-router-http", daemon=True,
        )
        self._thread.start()
        # one persistent prober thread per replica: a black-holed peer
        # costs its own probe_timeout_s without stalling anyone else's
        # cadence, and no per-round thread churn
        with self._replicas_lock:
            self._started = True
            replicas = list(self._replicas)
        for rep in replicas:
            self._spawn_prober(rep)
        return self

    def stop(self):
        self._stop.set()
        self._tail_stop.set()
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        if self._tail_thread is not None:
            self._tail_thread.join(timeout=5)
            self._tail_thread = None
        if self._relay_loop is not None:
            self._relay_loop.stop()
        journal = self._journal
        if journal is not None:
            journal.close()
        with self._replicas_lock:
            self._started = False
            probers, self._probers = self._probers, []
        for t in probers:
            t.join(timeout=5)

    # -- crash durability: journal recovery / standby / drain --------------

    def _open_journal_writer(self):
        """Open the append side and attach it to every registered
        generation (recovered ones included): from here on, all
        resume-critical state changes are journaled."""
        self._journal = JournalWriter(
            self._journal_dir,
            rotate_interval_s=self._gen_ttl_s,
            flush_interval_s=self._journal_flush_s)
        with self._lock:
            gens = [gen for gen, _ in self._gens.values()]
        for gen in gens:
            gen.journal = self._journal

    def _recover_journal(self):
        """Boot-time replay: rebuild the sticky registry from every
        retained record.  A torn final record (crash mid-write) was
        already truncated by the reader — recovery is never fatal."""
        records, truncated = read_journal(self._journal_dir)
        for rec in records:
            self._apply_journal_record(rec)
        with self._lock:
            recovered = self._recovered
        if records or truncated:
            self._log(
                "journal: replayed {} record(s), {} generation(s) "
                "recovered{}".format(
                    len(records), recovered,
                    ", {} torn segment tail(s) truncated".format(
                        truncated) if truncated else ""))

    def _tail_loop(self):
        """The standby's warm copy: apply journal records as the
        active router writes them."""
        while not self._tail_stop.is_set():
            followers = (self._followers if self._followers is not None
                         else [self._follower])
            for follower in followers:
                if follower is None:
                    continue
                try:
                    for rec in follower.poll():
                        self._apply_journal_record(rec)
                except Exception as e:  # noqa: BLE001 — a bad record
                    # must not end the tail (the next poll continues
                    # past it)
                    self._log("journal tail error: {}".format(e))
            if self._tail_stop.wait(0.05):
                return

    def _apply_journal_record(self, rec):
        """Fold one journal record into the registry (shared by boot
        recovery and the standby tail)."""
        if not isinstance(rec, dict):
            return
        kind = rec.get("t")
        gid = rec.get("gen")
        if not gid or not isinstance(gid, str):
            return
        if kind == "bind":
            gen = self.lookup_generation(gid)
            if gen is None:
                gen = _Generation.from_journal(
                    gid, rec.get("path"), rec.get("req"))
                if self.register_generation(gen, if_absent=True):
                    with self._lock:
                        self._recovered += 1
                else:
                    gen = self.lookup_generation(gid)
            if gen is not None:
                gen.apply_home(rec.get("home"), rec.get("offset"))
            return
        gen = self.lookup_generation(gid)
        if gen is None:
            return
        if kind == "home":
            gen.apply_home(rec.get("home"), rec.get("offset"))
        elif kind == "ev":
            payload = rec.get("p")
            seq = rec.get("seq")
            if isinstance(payload, dict) and isinstance(seq, int):
                gen.apply_event(seq, rec.get("id") or gid, payload)
        elif kind == "fin":
            gen.complete()
        elif kind == "drop":
            self.drop_generation(gid)

    def promote(self, partition=None, peers=None, epoch=None):
        """Turn a standby active (the takeover signal): final journal
        catch-up, open the append side, start serving.  Returns True
        when a promotion happened (False on an already-active router,
        or while another caller's promotion is in flight).

        On a partitioned tier, ``partition`` names the dead active's
        partition this standby is promoted INTO: the journal re-attach
        is scoped to that partition's directory (single-writer holds
        per partition), tailed state belonging to the surviving
        actives' partitions is shed, and ``peers``/``epoch`` rebind
        the ownership map the supervisor broadcast."""
        with self._lock:
            # one atomic claim: the blocking promotion body (thread
            # join, journal file I/O) must not run under a lock
            if not self._standby or self._promoting:
                return False
            self._promoting = True
        try:
            self._tail_stop.set()
            tail = self._tail_thread
            if tail is not None:
                tail.join(timeout=5)
                self._tail_thread = None
            followers = []
            if self._followers is not None:
                followers = list(self._followers)
                self._followers = None
            elif self._follower is not None:
                followers = [self._follower]
                self._follower = None
            for follower in followers:
                # final catch-up: the dead active's last flushed
                # records land before the first request is admitted
                try:
                    for rec in follower.poll():
                        self._apply_journal_record(rec)
                except Exception as e:  # noqa: BLE001
                    self._log("journal catch-up error: {}".format(e))
            if partition is not None and self._partition_count > 1:
                partition = int(partition)
                self._journal_dir = os.path.join(
                    self._journal_base, "p{}".format(partition))
                with self._lock:
                    self._partition_index = partition
                    if peers is not None:
                        self._partition_map = [str(u) for u in peers]
                    if epoch is not None:
                        self._partition_epoch = max(
                            self._partition_epoch, int(epoch))
                    # shed tailed generations the surviving actives
                    # own: their journals stay theirs (no drop record
                    # is written — that would be a second writer)
                    foreign = [
                        gid for gid in self._gens
                        if self._partition_of(gid) != partition]
                    for gid in foreign:
                        self._gens.pop(gid, None)
            self._open_journal_writer()
            with self._lock:
                self._standby = False
                self._takeovers += 1
        finally:
            with self._lock:
                self._promoting = False
        self._log("standby promoted to active (takeover{})".format(
            "" if partition is None
            else ", partition {}".format(partition)))
        return True

    def begin_drain(self):
        """Stop admitting: /v2 traffic sheds typed 503 from here on;
        in-flight requests and streams run to completion."""
        with self._lock:
            self._draining = True

    def drain(self, timeout_s=10.0):
        """SIGTERM drain: stop admitting, wait for in-flight work to
        finish (streams hand off or complete on their own), then flush
        + fsync the journal so a successor recovers everything this
        process relayed.  Returns True when in-flight reached zero."""
        self.begin_drain()
        deadline = time.monotonic() + timeout_s
        drained = False
        while time.monotonic() < deadline:
            with self._lock:
                inflight = self._inflight
            if inflight <= 0:
                drained = True
                break
            time.sleep(0.05)
        journal = self._journal
        if journal is not None:
            journal.flush()
        return drained

    def rejecting(self):
        """Why /v2 traffic is being shed ("standby" / "draining"), or
        None when serving."""
        with self._lock:
            if self._standby:
                return "standby"
            if self._draining:
                return "draining"
        return None

    def _spawn_prober(self, rep):
        thread = threading.Thread(
            target=self._probe_loop_one, args=(rep,),
            name="fleet-router-prober", daemon=True)
        with self._replicas_lock:
            # prune exited probers (removed replicas) so membership
            # churn — a supervisor healing and scaling for days —
            # cannot grow the list without bound
            self._probers = [t for t in self._probers if t.is_alive()]
            self._probers.append(thread)
        thread.start()

    # -- membership --------------------------------------------------------

    def _replicas_snapshot(self):
        """The membership at one instant.  Every request-scoped loop
        works off ONE snapshot so a concurrent add/remove cannot skew
        its attempt budget or index into a mutated list."""
        with self._replicas_lock:
            return list(self._replicas)

    def add_replica(self, url):
        """Join ``url`` to the live membership.  The replica is probed
        once synchronously (outside the lock — a dead address must not
        stall routing) so it either enters with real state or starts
        rotated-out until its prober sees it ready.  Raises
        ``ValueError`` on a malformed or duplicate url."""
        rep = _Replica(url, digest_window=self._digest_window)  # validates host:port
        snap = self._fetch_snapshot(rep)
        if snap is None:
            rep.mark_unreachable()
        else:
            rep.update_snapshot(snap)
        with self._replicas_lock:
            if any(r.url == url for r in self._replicas):
                raise ValueError(
                    "replica {} is already a member".format(url))
            self._replicas.append(rep)
            started = self._started
        if started:
            self._spawn_prober(rep)
        self._log("membership: added replica {}".format(url))
        return rep.stats()

    def remove_replica(self, url):
        """Retire ``url`` from the live membership.  Its prober exits,
        in-flight snapshots see it latched ineligible, and every
        generation homed on it forgets the address — a later resume
        hands off (handoff-capable) or answers typed-404, never dials
        the removed replica.  Raises ``KeyError`` when ``url`` is not a
        member."""
        with self._replicas_lock:
            for i, rep in enumerate(self._replicas):
                if rep.url == url:
                    del self._replicas[i]
                    break
            else:
                raise KeyError(
                    "replica {} is not a member".format(url))
        rep.retire()
        with self._lock:
            gens = [gen for gen, _ in self._gens.values()]
        for gen in gens:
            gen.home_removed(url)
        self._log("membership: removed replica {}".format(url))
        return rep.stats()

    def membership(self):
        """The admin view of the replica set (``/router/replicas``)."""
        return [rep.stats() for rep in self._replicas_snapshot()]

    def attach_supervisor(self, stats_fn):
        """Register a fleet supervisor's ``stats()`` callable: its
        restart/scale counters ride ``/router/stats`` so the perf
        tooling that already diffs router counters per window sees
        process-level healing too."""
        self._supervisor_stats = stats_fn

    # -- health probing ----------------------------------------------------

    def _probe_round(self):
        """One synchronous probe of every replica (the pre-serving round
        :meth:`start` runs, so routing decisions begin from real state —
        an already-draining replica never sees even the first request)."""
        for rep in self._replicas_snapshot():
            snap = self._fetch_snapshot(rep)
            if snap is None:
                rep.mark_unreachable()
            else:
                rep.update_snapshot(snap)

    def _probe_loop_one(self, rep):
        # phase-staggered cadence: a fleet-wide restart or scale-up
        # creates many probers at the same instant; without per-replica
        # jitter they would synchronize into probe storms against
        # just-booted replicas every interval
        interval = self._probe_interval_s
        rng = random.Random(zlib.crc32(rep.url.encode("utf-8")))
        if self._stop.wait(_probe_phase(rep.url, interval)):
            return
        while not (self._stop.is_set() or rep.removed.is_set()):
            snap = self._fetch_snapshot(rep)
            if self._stop.is_set() or rep.removed.is_set():
                return
            if snap is None:
                rep.mark_unreachable()
            else:
                rep.update_snapshot(snap)
            # the ejection controller rides the probe cadence (itself
            # throttled to eject_interval_s): gray verdicts update even
            # when traffic is too sparse to trigger the request-path
            # evaluation
            self._evaluate_ejections()
            if self._stop.wait(interval * rng.uniform(0.9, 1.1)):
                return

    def refresh_snapshot(self, rep):
        """Probe ``rep`` now, outside the prober's cadence (a failed
        probe changes nothing: the prober owns unreachability)."""
        snap = self._fetch_snapshot(rep)
        if snap is not None:
            rep.update_snapshot(snap)

    def _fetch_snapshot(self, rep):
        conn = http.client.HTTPConnection(
            rep.host, rep.port, timeout=self._probe_timeout_s)
        try:
            conn.request("GET", "/v2/health/stats")
            resp = conn.getresponse()
            if resp.status != 200:
                return None
            return json.loads(resp.read())
        except (OSError, ValueError, http.client.HTTPException):
            return None
        finally:
            conn.close()

    # -- routing -----------------------------------------------------------

    def pick_replica(self, exclude=(), replicas=None, prefer=None,
                     healthy_only=False):
        """The least-loaded eligible replica (ties break on backend
        order), or — when nothing is eligible — the least-failed
        ineligible one as a last resort, so a fleet whose probes all
        failed transiently still self-heals instead of hard-failing
        every request.  ``exclude`` holds urls already tried;
        ``replicas`` lets a request-scoped loop pick from its own
        membership snapshot.  A removed replica is never picked, even
        from a stale snapshot.

        ``prefer`` names a url whose load score gets the affinity
        bonus subtracted (its radix prefix cache is presumed warm for
        this request) — a bonus on an ELIGIBLE replica's score only,
        never an eligibility override: a draining, tripped or
        much-busier preferred replica still loses.

        Soft-ejected replicas (gray-failure latency outliers) form a
        middle pool: routed around while healthy capacity exists, but
        every ``probe_every``'th pick lands on one as its real-traffic
        probe (how an ejected replica re-earns a digest and re-admits
        itself), and when NOTHING un-ejected is eligible they serve —
        the fleet degrades to slow, never to unavailable."""
        eligible, probation, fallback = [], [], []
        if replicas is None:
            replicas = self._replicas_snapshot()
        for idx, rep in enumerate(replicas):
            if rep.url in exclude or rep.removed.is_set():
                continue
            ok, load, ejected = rep.routable()
            if ok and prefer is not None and rep.url == prefer:
                load -= self._affinity_bonus
            pool = (probation if ok and ejected
                    else eligible if ok else fallback)
            pool.append((load, idx, rep))
        if healthy_only:
            # the hedge/shadow BACKUP pick: racing a suspected-slow
            # primary against another gray (or worse) replica would
            # defeat the whole point — no healthy candidate means no
            # backup, and the caller waits the primary out
            return min(eligible)[2] if eligible else None
        if eligible and probation and self._probe_every:
            with self._lock:
                self._eject_tick += 1
                probe = self._eject_tick % self._probe_every == 0
            if probe:
                return min(probation)[2]
        for pool in (eligible, probation, fallback):
            if pool:
                return min(pool)[2]
        return None

    def _affinity_key(self, prompt):
        """The routing hash of a generation's prompt prefix, or None
        when the request carries no generate contract (or affinity is
        disabled).  Only the first ``affinity_prefix_tokens`` ids
        hash: sharers of a long system prompt must collide even when
        their suffixes differ, so the span must not exceed the SHARED
        part of the traffic's prompts.  The default (16) matches the
        scheduler's default ``page_size`` — the smallest prefix the
        radix cache can share at all, so any population the replica
        tier could deduplicate also collides here.  (A longer span
        only discriminates better when the shared prefix is known to
        be longer — tune ``--affinity-prefix-tokens`` with the
        workload.)"""
        if not prompt or self._affinity_bonus <= 0:
            return None
        head = prompt[:self._affinity_prefix_tokens]
        return zlib.crc32(
            ",".join(str(int(t)) for t in head).encode("ascii"))

    def pick_for_generation(self, gen, exclude=(), replicas=None):
        """Route one generation admission (or handoff) with prefix
        affinity: siblings of a recently routed prompt prefix land on
        the replica whose radix cache already holds it, so the
        fleet-wide prefix-cache hit rate tracks the per-replica one.
        The chosen replica (affine or not) becomes the prefix's new
        home, so a failover or handoff moves the warm set with it.
        ``replicas`` restricts the candidate set (the disagg
        orchestrator passes the prefill pool — the radix caches the
        affinity map points at live there)."""
        key = self._affinity_key(gen.prompt)
        prefer = None
        if key is not None:
            now = time.monotonic()
            with self._lock:
                entry = self._affinity.get(key)
                if entry is not None and entry[1] > now:
                    prefer = entry[0]
        rep = self.pick_replica(exclude=exclude, replicas=replicas,
                                prefer=prefer)
        if rep is None or key is None:
            return rep
        # the map update is last-writer-wins by design: two racing
        # sibling admissions both record a home and the later one
        # simply re-points the prefix — next siblings converge on it.
        # The counter marks admissions that LANDED on their prefix's
        # warm replica (whether or not the bonus was decisive: ties
        # the affine replica would have won anyway still count).
        hit = prefer is not None and rep.url == prefer
        now = time.monotonic()
        with self._lock:  # tpulint: disable=R7 — benign last-writer-wins
            if hit:
                self._affinity_routed += 1
            self._affinity[key] = (rep.url, now + self._gen_ttl_s)
            self._affinity.move_to_end(key)
            while len(self._affinity) > self._gen_capacity:
                self._affinity.popitem(last=False)
        return rep

    def replica_by_url(self, url):
        for rep in self._replicas_snapshot():
            if rep.url == url:
                return rep
        return None

    def any_routable(self):
        return any(rep.routable()[0] for rep in self._replicas_snapshot())

    # -- gray-failure ejection ---------------------------------------------

    def _evaluate_ejections(self, force=False):
        """Differential latency observation (the gray-failure signal):
        compare every replica's recent per-verb p90 against the fleet
        median and soft-eject the outliers.

        Runs throttled to ``eject_interval_s`` (the check-and-stamp is
        one atomic region under ``_lock``, so racing callers — probers
        and request paths — cannot double-evaluate).  The decision
        itself works off one consistent pass: per-replica digests are
        snapshotted first, verdicts computed from the snapshot, then
        applied through the replicas' own atomic
        ``soft_eject``/``readmit`` latches — a replica whose state
        changed concurrently simply reports False and nothing is
        counted.  Invariants:

        - each replica is judged against the median of the OTHER
          covered replicas (leave-one-out: a median that included the
          candidate would be dragged toward it — on a 2-replica fleet
          median-of-2 is the mean, and a 6x outlier reads as under
          2x); at least one OTHER replica must have
          ``outlier_min_samples`` for the verb, so a lone replica (no
          differential signal) and a uniformly slow fleet (load, not
          gray failure) never eject;
        - health/drain dominate: only currently-ELIGIBLE replicas are
          ever ejected, and ineligible ones keep any ejection flag
          (re-judged once they return);
        - ejections never shrink the eligible-and-unejected set below
          ``min_eligible`` — worst outliers go first, the rest stay
          serving (degrade to slow, not to unavailable);
        - re-admission is judged on POST-ejection samples only
          (``soft_eject`` reset the digest): once the probe-fraction
          traffic accumulates ``outlier_min_samples`` under the bar
          for every verb, the replica returns.
        """
        now = time.monotonic()
        with self._lock:
            if not force and (now - self._eject_eval_last
                              < self._eject_interval_s):
                return
            self._eject_eval_last = now
        rows = []  # (rep, eligible, ejected, {verb: (p90, p95, n)})
        for rep in self._replicas_snapshot():
            if rep.removed.is_set():
                continue
            ok, _load, ejected = rep.routable()
            rows.append((rep, ok, ejected, rep.digest_snapshot()))
        # per-verb p90 coverage over eligible UN-EJECTED replicas: the
        # population each candidate is judged against (a draining/dead
        # replica's digest is history, and an ejected replica's probe
        # samples must not drag the median it is judged against)
        coverage = {}  # verb -> [(rep, p90)]
        for rep, ok, ejected, digest in rows:
            if not ok or ejected:
                continue
            for verb, (p90, _p95, n) in digest.items():
                if n >= self._outlier_min_samples and p90 is not None:
                    coverage.setdefault(verb, []).append((rep, p90))

        def fleet_median(verb, exclude_rep=None):
            """Median p90 of the OTHER covered replicas (leave-one-out:
            a median including the candidate is dragged toward it — on
            a 2-replica fleet median-of-2 is the mean and a 6x outlier
            reads as under 2x), or None without a differential."""
            vals = [p90 for rep, p90 in coverage.get(verb, ())
                    if rep is not exclude_rep]
            return statistics.median(vals) if vals else None

        def worst_ratio(rep, digest):
            """max over verbs of p90 / leave-one-out fleet median (0
            when no verb has both enough own samples and at least one
            OTHER covered replica)."""
            worst = 0.0
            for verb, (p90, _p95, n) in digest.items():
                if n < self._outlier_min_samples:
                    continue
                med = fleet_median(verb, exclude_rep=rep)
                if med:
                    worst = max(worst, p90 / med)
            return worst

        # re-admissions first: they grow the healthy pool the
        # min_eligible floor is measured against
        for rep, ok, ejected, digest in rows:
            if not (ok and ejected):
                continue
            judged = [
                (verb, p90, fleet_median(verb))
                for verb, (p90, _p95, n) in digest.items()
                if n >= self._outlier_min_samples
            ]
            if not judged:
                continue  # probe traffic still accumulating
            if all(med is None or p90 <= self._outlier_factor * med
                   for _verb, p90, med in judged):
                if rep.readmit():
                    self._log("gray: re-admitted {} (recent p90 back "
                              "under the outlier bar)".format(rep.url))
        healthy = sum(1 for rep, ok, _ej, _d in rows
                      if ok and not rep.routable()[2])
        candidates = sorted(
            ((worst_ratio(rep, digest), rep) for rep, ok, ejected,
             digest in rows if ok and not ejected),
            key=lambda pair: -pair[0])
        for ratio, rep in candidates:
            if ratio <= self._outlier_factor:
                break  # sorted: nothing further is an outlier
            if healthy - 1 < self._min_eligible:
                self._log(
                    "gray: ejection of {} deferred — only {} healthy "
                    "replica(s), min_eligible={}".format(
                        rep.url, healthy, self._min_eligible))
                break
            if rep.soft_eject():
                healthy -= 1
                with self._lock:
                    self._ejections += 1
                self._log(
                    "gray: soft-ejected {} (p90 {:.1f}x the fleet "
                    "median)".format(rep.url, ratio))

    # -- router-level admission valve --------------------------------------

    def enter_inflight(self):
        with self._lock:
            if (self._max_inflight is not None
                    and self._inflight >= self._max_inflight):
                self._shed += 1
                shed = True
            else:
                self._inflight += 1
                shed = False
        if shed:
            self._log("shed: in-flight cap {} reached".format(
                self._max_inflight))
        return not shed

    def exit_inflight(self):
        with self._lock:
            self._inflight -= 1

    # -- counters ----------------------------------------------------------

    def _log(self, msg):
        if self._verbose:
            print("[fleet-router] " + msg, file=sys.stderr, flush=True)

    def count_failover(self):
        with self._lock:
            self._failovers += 1
        self._log("failover")

    def count_handoff(self):
        with self._lock:
            self._handoffs += 1
        self._log("handoff")

    def count_resume(self):
        with self._lock:
            self._resumed += 1
        self._log("resume")

    # -- horizontal partitioning (docs/resilience.md "Horizontal router
    # tier"): stable gen-id ownership across N simultaneous actives ---------

    @staticmethod
    def partition_of(gen_id, count):
        """The owning partition of a generation id: CRC32 over the
        BARE id — a ``gen~offset`` handoff-epoch suffix is stripped so
        every epoch of one generation hashes to the same owner."""
        base, tilde, off = gen_id.rpartition("~")
        if tilde and base and off.isdigit():
            gen_id = base
        return zlib.crc32(gen_id.encode("utf-8")) % count

    def _partition_of(self, gen_id):
        return self.partition_of(gen_id, self._partition_count)

    def owns_generation(self, gen_id):
        """``(owned, partition)`` for one generation id.  An
        unpartitioned router owns everything."""
        if self._partition_count <= 1:
            return True, 0
        part = self._partition_of(gen_id)
        with self._lock:
            return part == self._partition_index, part

    def partition_peer(self, part):
        """The owning peer's ``host:port`` for ``part`` per the
        current map (None when the map holds no entry for it)."""
        with self._lock:
            if 0 <= part < len(self._partition_map):
                return self._partition_map[part] or None
        return None

    def mint_generation_id(self):
        """A fresh id that hashes into THIS router's partition, so an
        admission landing here stays here (expected ~count draws; the
        unpartitioned path is the plain uuid mint)."""
        if self._partition_count <= 1:
            return uuid.uuid4().hex
        while True:
            gid = uuid.uuid4().hex
            owned, _ = self.owns_generation(gid)
            if owned:
                return gid

    def partition_view(self):
        """The partition surface of ``/router/stats`` and ``GET
        /router/partition``: index/count/epoch, the url-by-partition
        owner map, and the ownership counters."""
        with self._lock:
            return {
                "index": self._partition_index,
                "count": self._partition_count,
                "epoch": self._partition_epoch,
                "map": list(self._partition_map),
                "owned": self._partition_owned,
                "forwarded": self._partition_forwarded,
                "moved": self._partition_moved,
            }

    def adopt_partition_map(self, new_map, epoch):
        """Adopt a broadcast owner map when its epoch is NEWER (an
        equal epoch is an idempotent re-broadcast; an older one is
        stale and refused — the supervisor bumps the epoch on every
        takeover rebind).  Returns the view after the call."""
        epoch = int(epoch)
        applied = False
        with self._lock:
            if epoch > self._partition_epoch:
                old = self._partition_map
                adopted = [str(u) for u in new_map]
                moved = sum(
                    1 for k in range(len(adopted))
                    if k >= len(old) or old[k] != adopted[k])
                self._partition_map = adopted
                self._partition_epoch = epoch
                self._partition_moved += moved
                applied = True
        if applied:
            self._log("partition map epoch {} adopted".format(epoch))
        return self.partition_view()

    def count_partition_owned(self):
        if self._partition_count <= 1:
            return
        with self._lock:
            self._partition_owned += 1

    def count_partition_forwarded(self):
        with self._lock:
            self._partition_forwarded += 1

    # -- generation registry -----------------------------------------------

    def _sweep_gens_locked(self, now):
        expired = [gid for gid, (_, expires) in self._gens.items()
                   if expires <= now]
        for gid in expired:
            self._gens.pop(gid, None)

    def register_generation(self, gen, if_absent=False):
        """Register ``gen`` in the id registry.  With ``if_absent`` the
        insert is atomic with the existence check: a live or parked
        record with the same id wins and the call returns False (a
        fresh admission must never clobber an existing replay
        buffer)."""
        now = time.monotonic()
        # journaled routers persist every registered generation's
        # resume-critical state (the writer is None on standbys and
        # journal-less routers; recovered generations re-attach on
        # promote via _open_journal_writer)
        gen.journal = self._journal
        with self._lock:
            self._sweep_gens_locked(now)
            if if_absent and gen.gen_id in self._gens:
                return False
            self._gens[gen.gen_id] = (gen, now + self._gen_ttl_s)
            self._gens.move_to_end(gen.gen_id)
            while len(self._gens) > self._gen_capacity:
                self._gens.popitem(last=False)
            return True

    def lookup_generation(self, gen_id):
        """The generation record for a resume, with its TTL refreshed
        (a generation being actively resumed is live state)."""
        now = time.monotonic()
        with self._lock:
            self._sweep_gens_locked(now)
            entry = self._gens.get(gen_id)
            if entry is None:
                return None
            gen, _ = entry
            self._gens[gen_id] = (gen, now + self._gen_ttl_s)
            self._gens.move_to_end(gen_id)
            return gen

    def drop_generation(self, gen_id):
        with self._lock:
            entry = self._gens.pop(gen_id, None)
        journal = self._journal
        if journal is not None and entry is not None:
            journal.append({"t": "drop", "gen": gen_id})

    def generation_snapshot(self, gen_id):
        with self._lock:
            entry = self._gens.get(gen_id)
        return entry[0].snapshot() if entry is not None else None

    # -- observability -----------------------------------------------------

    def stats(self):
        with self._lock:
            out = {
                "inflight": self._inflight,
                "max_inflight": self._max_inflight,
                "shed": self._shed,
                "failovers": self._failovers,
                "handoffs": self._handoffs,
                "resumed_streams": self._resumed,
                "generations": len(self._gens),
                "affinity_routed": self._affinity_routed,
                "affinity_entries": len(self._affinity),
                # tail-latency defense: soft-ejection events and hedge
                # outcomes (the per-replica ejected/status/digest view
                # rides each replica's own stats row below)
                "ejections": self._ejections,
                "hedges": sum(self._hedges.values()),
                "hedges_by_outcome": dict(self._hedges),
                # router HA: journal recovery + warm-standby takeover
                "recovered_generations": self._recovered,
                "takeovers": self._takeovers,
                "standby": self._standby,
                "draining": self._draining,
                # horizontal front tier: this router's partition, the
                # url-by-partition owner map, and the map epoch the
                # clients' resume paths chase moved partitions with
                "partition": {
                    "index": self._partition_index,
                    "count": self._partition_count,
                    "owned": self._partition_owned,
                    "forwarded": self._partition_forwarded,
                    "moved": self._partition_moved,
                },
                "peers": list(self._partition_map),
                "epoch": self._partition_epoch,
            }
        relay = {"mode": self._relay_mode}
        if self._relay_loop is not None:
            relay.update(self._relay_loop.stats())
        out["relay"] = relay
        journal = self._journal
        out["journal"] = journal.stats() if journal is not None else None
        out["disagg"] = self.disagg.stats()
        out["replicas"] = [rep.stats() for rep in self._replicas_snapshot()]
        stats_fn = self._supervisor_stats
        if stats_fn is not None:
            try:
                out["supervisor"] = stats_fn()
            except Exception:  # noqa: BLE001 — observability must not
                # take the routing surface down with a dying supervisor
                out["supervisor"] = None
        return out

    def _collect_metrics(self):
        """Scrape-time collector over :meth:`stats`: the router's
        counters (and an attached fleet supervisor's process-healing
        counters) surface in /metrics without a second account of any
        event."""
        snap = self.stats()
        families = [
            ("tpu_router_failovers_total", [({}, snap["failovers"])]),
            ("tpu_router_handoffs_total", [({}, snap["handoffs"])]),
            ("tpu_router_resumed_streams_total",
             [({}, snap["resumed_streams"])]),
            ("tpu_router_shed_total", [({}, snap["shed"])]),
            ("tpu_router_inflight_requests", [({}, snap["inflight"])]),
            ("tpu_router_generations", [({}, snap["generations"])]),
            ("tpu_router_affinity_routed_total",
             [({}, snap["affinity_routed"])]),
            ("tpu_router_ejections_total", [({}, snap["ejections"])]),
            ("tpu_router_hedges_total",
             [({"outcome": outcome}, count) for outcome, count
              in sorted(snap["hedges_by_outcome"].items())]),
            ("tpu_router_recovered_generations_total",
             [({}, snap["recovered_generations"])]),
            ("tpu_router_takeovers_total", [({}, snap["takeovers"])]),
            ("tpu_router_partition_owned_total",
             [({}, snap["partition"]["owned"])]),
            ("tpu_router_partition_forwarded_total",
             [({}, snap["partition"]["forwarded"])]),
            ("tpu_router_partition_moved_total",
             [({}, snap["partition"]["moved"])]),
            ("tpu_router_partition_epoch", [({}, snap["epoch"])]),
        ]
        journal = snap.get("journal")
        if isinstance(journal, dict):
            families.extend([
                ("tpu_router_journal_records_total",
                 [({}, journal.get("records", 0))]),
                ("tpu_router_journal_bytes_total",
                 [({}, journal.get("bytes", 0))]),
                ("tpu_router_journal_fsyncs_total",
                 [({}, journal.get("fsyncs", 0))]),
            ])
        disagg = snap.get("disagg")
        if isinstance(disagg, dict):
            families.extend([
                ("tpu_disagg_splits_total", [({}, disagg["splits"])]),
                ("tpu_disagg_transfers_total",
                 [({}, disagg["transfers"])]),
                ("tpu_disagg_transfer_bytes_total",
                 [({}, disagg["transfer_bytes"])]),
                ("tpu_disagg_transfer_seconds_total",
                 [({}, disagg["transfer_ms_total"] / 1000.0)]),
                ("tpu_disagg_prefill_queue_seconds_total",
                 [({}, disagg["prefill_queue_ms_total"] / 1000.0)]),
            ])
            fallbacks = disagg.get("fallbacks") or {}
            if fallbacks:
                families.append((
                    "tpu_disagg_fallbacks_total",
                    [({"reason": reason}, count)
                     for reason, count in sorted(fallbacks.items())]))
            depths = disagg.get("phase_queue_depth") or {}
            if depths:
                families.append((
                    "tpu_disagg_phase_queue_depth",
                    [({"phase": phase}, depth)
                     for phase, depth in sorted(depths.items())]))
        eligible, load, state, p90 = [], [], [], []
        for rep in snap["replicas"]:
            labels = {"replica": rep["url"]}
            eligible.append((labels, 1 if rep["eligible"] else 0))
            load.append((labels, rep["load"]))
            # one sample per replica, the current state as the label
            # value: a scrape distinguishes a gray incident
            # (soft-ejected) from a planned drain from a dead process
            # — raw ineligibility collapses all three
            state.append((
                {"replica": rep["url"], "state": rep["status"]}, 1))
            for verb, digest in sorted(rep.get("digest", {}).items()):
                if digest.get("p90_s") is not None:
                    p90.append((
                        {"replica": rep["url"], "verb": verb},
                        digest["p90_s"]))
        if eligible:
            families.append(("tpu_router_replica_eligible", eligible))
            families.append(("tpu_router_replica_load", load))
            families.append(("tpu_router_replica_state", state))
        if p90:
            families.append(("tpu_router_replica_p90_seconds", p90))
        sup = snap.get("supervisor")
        if isinstance(sup, dict):
            families.extend([
                ("tpu_fleet_replica_restarts_total",
                 [({}, sup.get("replica_restarts", 0))]),
                ("tpu_fleet_scale_up_total",
                 [({}, sup.get("scale_up_events", 0))]),
                ("tpu_fleet_scale_down_total",
                 [({}, sup.get("scale_down_events", 0))]),
                ("tpu_fleet_retired_replicas_total",
                 [({}, sup.get("retired_replicas", 0))]),
                ("tpu_fleet_replicas_up", [({}, sup.get("up", 0))]),
            ])
            if "adoptions" in sup:
                # presence-guarded: a supervisor snapshot that
                # predates the crash-durability counters (an external
                # /router/stats shape) must not break the scrape
                families.extend([
                    ("tpu_supervisor_adoptions_total",
                     [({}, sup.get("adoptions", 0))]),
                    ("tpu_supervisor_manifest_records_total",
                     [({}, sup.get("manifest_records", 0))]),
                    ("tpu_supervisor_clean_handovers_total",
                     [({}, sup.get("clean_handovers", 0))]),
                    ("tpu_supervisor_stale_children_reaped_total",
                     [({}, sup.get("stale_children_reaped", 0))]),
                ])
        return families

    def _fetch_metrics(self, rep):
        """One replica's raw ``/metrics`` text, or None when
        unreachable (the aggregator keeps its last contribution)."""
        conn = http.client.HTTPConnection(
            rep.host, rep.port, timeout=self._probe_timeout_s)
        try:
            conn.request("GET", "/metrics")
            resp = conn.getresponse()
            if resp.status != 200:
                return None
            return resp.read().decode("utf-8", errors="replace")
        except (OSError, ValueError, http.client.HTTPException):
            return None
        finally:
            conn.close()

    def metrics_text(self):
        """The router's ``GET /metrics`` exposition: its own tier
        counters followed by the FLEET-AGGREGATED replica families —
        every replica's ``/metrics`` scraped (no locks held across the
        sockets) and folded churn-safe, so a scraper pointed at the
        router sees one monotonic fleet view that survives replica
        restarts, scale events, and retirements."""
        replicas = [rep for rep in self._replicas_snapshot()
                    if not rep.removed.is_set()]
        live_urls = [rep.url for rep in replicas]
        # stamp BEFORE the fetches start: concurrent scrapes fold in
        # start order, so a slower round can never overwrite a newer
        # one's last-seen values (see _FleetMetricsAggregator.render)
        stamp = time.monotonic()
        # fan the fetches out like the prober does: a dead replica
        # costs its own probe_timeout_s, never N of them in sequence
        # (a post-SIGKILL scrape must still answer within one timeout)
        results = {}
        identities = {}
        results_lock = threading.Lock()

        def identity(rep):
            snap = self._fetch_snapshot(rep)
            return None if snap is None else (snap.get("pid"),
                                              snap.get("spawn_nonce"))

        def fetch_one(rep):
            # the process that answered: its identity read before and
            # after the scrape; a scrape that straddled a respawn is
            # left out of this round
            before = identity(rep)
            text = self._fetch_metrics(rep)
            after = identity(rep)
            if text is not None and before == after:
                with results_lock:
                    results[rep.url] = parse_prometheus_text(text)
                    identities[rep.url] = after

        threads = [
            threading.Thread(target=fetch_one, args=(rep,),
                             name="fleet-router-metrics", daemon=True)
            for rep in replicas
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=self._probe_timeout_s + 1.0)
        with results_lock:
            scrapes = dict(results)
            idents = dict(identities)
        own = self.metrics.render()
        # families this tier already declared must not re-emit from
        # the aggregate: when replicas are themselves routers (routers
        # stack), their tpu_router_*/tpu_fleet_* families would
        # otherwise appear twice and invalidate the exposition
        own_names = {
            line.split(" ", 3)[2] for line in own.splitlines()
            if line.startswith("# TYPE ")
        }
        return own + self._aggregator.render(
            live_urls, scrapes, stamp=stamp, exclude=own_names,
            identities=idents)

    def health_snapshot(self):
        """The router's own replica-shaped ``/v2/health/stats`` answer,
        so routers stack (a router can front other routers) and pools
        can probe them.  A standby or draining router reports
        not-ready (upstream routers and pools rotate it out) with its
        shedding reason as the lifecycle state — the supervisor still
        reads the 200 answer itself as process liveness."""
        routable = self.any_routable()
        rejecting = self.rejecting()
        snap = self.stats()
        snap.update({
            "state": rejecting or ("ready" if routable else "unavailable"),
            "ready": routable and rejecting is None,
            "router": True,
            "models": {},
        })
        if self.spawn_nonce is not None:
            snap["spawn_nonce"] = self.spawn_nonce
        return snap

    # -- unary forwarding --------------------------------------------------

    @staticmethod
    def _upstream_once(rep, method, path, body, headers, timeout_s):
        conn = http.client.HTTPConnection(
            rep.host, rep.port, timeout=timeout_s)
        try:
            conn.request(method, path, body=body, headers=headers)
            resp = conn.getresponse()
            return resp.status, dict(resp.headers), resp.read()
        finally:
            conn.close()

    def _attempt_unary(self, rep, method, path, body, headers, timeout_s):
        """One upstream attempt with the router's failure
        classification: ``(response, error, kind, elapsed_s)``."""
        error = kind = None
        response = None
        start = time.monotonic()
        rep.begin_request()
        try:
            response = self._upstream_once(
                rep, method, path, body, headers, timeout_s)
        except (ConnectionRefusedError, socket.gaierror) as e:
            error, kind = e, FAILURE_CONNECT
        except (ConnectionError, socket.timeout, OSError,
                http.client.HTTPException) as e:
            error, kind = e, FAILURE_INTERRUPTED
        finally:
            rep.end_request()
        return response, error, kind, time.monotonic() - start

    def _attempt_hedged(self, primary, replicas, tried, method, path,
                        body, headers, timeout_s, verb, probe=False,
                        deadline=None):
        """The Tail-at-Scale hedge: run the primary attempt, and if it
        is still pending after the hedge delay — the primary replica's
        own rolling p95 for this verb, floored at the configured
        ``hedge_delay_s`` (which alone applies while the digest is
        cold) — issue the same request on the next-ranked DIFFERENT
        replica.  First response
        wins; the loser's connection is abandoned (its thread drains
        on its own) and its latency sample is never recorded — a
        loser's service time is the hedge's artifact, not the
        replica's.

        ``probe=True`` is the gray-failure re-admission path: the
        primary is a soft-ejected replica taking its probe-fraction of
        real traffic, so the backup launches IMMEDIATELY (delay zero —
        the probed replica's suspected slowness must never reach the
        client, or the probe fraction would reappear in fleet p99) and
        the probe attempt's own service time records to the probed
        replica's digest when it completes, win or lose, in the
        background — that sample is exactly what re-admission is
        judged on.  Probe pairs are not counted as hedges.

        Returns ``(rep, response, error, kind, elapsed, recorded)``
        for whichever attempt won (the primary's failure when both
        lost), with the second replica added to ``tried``;
        ``recorded`` tells the caller the winner's digest sample was
        already handled here."""
        import queue as _queue

        results = _queue.Queue()

        def run(rep, tag, done=None):
            out = (tag, rep) + self._attempt_unary(
                rep, method, path, body, headers, timeout_s)
            if probe and tag == "primary":
                _t, _r, resp_, err_, _kind, elapsed_ = out
                if err_ is None and resp_[0] < 500 \
                        and not self._policy.should_failover(
                            self._policy.classify_http_status(resp_[0]),
                            idempotent=True):
                    # the probe's measurement, recorded even as a
                    # hedge loser: this is the traffic the ejected
                    # replica re-earns its digest with.  Typed
                    # overload answers (429/503) are excluded exactly
                    # as on the main recording path — a saturated
                    # replica's fast shed responses must not read as a
                    # recovered service time
                    rep.note_latency(verb, elapsed_)
            if done is not None:
                done.set()
            results.put(out)

        threading.Thread(
            target=run, args=(primary, "primary"),
            name="fleet-router-hedge", daemon=True).start()
        first = None
        if not probe:
            # the primary's rolling p95 seeds the delay, FLOORED at the
            # configured hedge_delay_s (the operator's cap on duplicate
            # traffic), which alone applies while the digest is cold
            delay = primary.hedge_delay(verb, self._outlier_min_samples)
            delay = (self._hedge_delay_s if delay is None
                     else max(delay, self._hedge_delay_s))
            delay = min(delay, timeout_s)
            try:
                first = results.get(timeout=delay)
            except _queue.Empty:
                first = None
        if first is not None:
            # the primary answered inside the hedge delay: no hedge
            _tag, rep, response, error, kind, elapsed = first
            return rep, response, error, kind, elapsed, False
        backup = self.pick_replica(exclude=tried, replicas=replicas,
                                   healthy_only=True)
        if backup is None:
            # nowhere healthy to hedge/shadow to: wait the primary out
            _tag, rep, response, error, kind, elapsed = results.get()
            return rep, response, error, kind, elapsed, probe
        tried.add(backup.url)
        backup_done = threading.Event()
        threading.Thread(
            target=run, args=(backup, "hedge", backup_done),
            name="fleet-router-hedge", daemon=True).start()
        winner = None
        losers = []
        for _ in range(2):
            out = results.get()
            if out[3] is None:  # a response (typed or not) wins
                winner = out
                break
            losers.append(out)
        budget_gone = (deadline is not None
                       and deadline - time.monotonic() <= 0)
        for _ltag, lrep, _lresp, lerr, lkind, _lel in losers:
            if budget_gone and isinstance(lerr, socket.timeout):
                # the loser's socket timeout was the CALLER's own
                # deadline clamp (same no-blame rule as the unary
                # path): an impatient request must not rotate healthy
                # replicas out of the fleet
                continue
            if lkind in (FAILURE_CONNECT, FAILURE_INTERRUPTED):
                # a loser that already failed in transport rotates out
                # like any other unreachable peer
                lrep.mark_unreachable()
        if winner is None:
            # both attempts died in transport: surface the primary's
            # failure to the failover loop (the backup replica was
            # rotated out above and sits in ``tried``)
            for tag, rep, response, error, kind, elapsed in losers:
                if tag == "primary":
                    return rep, response, error, kind, elapsed, False
        tag, rep, response, error, kind, elapsed = winner
        if not probe:
            outcome = ("won" if tag == "hedge"
                       else "lost" if backup_done.is_set() else "cancelled")
            with self._lock:
                self._hedges[outcome] += 1
            self._log("hedge {} (primary {}, hedge {})".format(
                outcome, primary.url, backup.url))
        # a probe-primary win was recorded in its own thread; a backup
        # win records normally in the caller
        return (rep, response, error, kind, elapsed,
                probe and tag == "primary")

    def forward_unary(self, method, path, body, headers, idempotent=False):
        """One logical request with failover: connect-phase and typed-
        overload failures fall through to the next replica under the
        request's own deadline budget; a typed 4xx/5xx outside the
        overload set relays untouched (it would be the same on every
        replica).  A request that was *sent* and then lost its
        connection mid-response may already have executed, so it fails
        over only when the caller marks it ``idempotent`` (GETs) —
        otherwise it surfaces as a typed 502 the client's retry policy
        will not blindly re-execute.  Returns
        ``(status, headers, body)``.

        Two tail-defense behaviors ride the loop (docs/resilience.md
        "Tail-latency defense"): every attempt relays the REMAINING
        deadline budget (the ``timeout`` parameter is rewritten per
        attempt — a slow first attempt shrinks the second's budget),
        and with hedging enabled the FIRST attempt of an idempotent
        request races a delayed duplicate on a different replica."""
        deadline = _request_deadline(body, headers)
        verb = _verb_of(path)
        # the pool's idempotency classification: GETs plus the infer
        # verb (re-executing either elsewhere is waste, never
        # corruption) — the precondition for BOTH duplicate-in-flight
        # shapes below (hedges and shadowed ejection probes)
        hedge_safe = idempotent or (
            method == "POST" and _HEDGE_URI.match(path) is not None)
        hedge_ok = self._hedge_delay_s is not None and hedge_safe
        # ONE membership snapshot per logical request: a concurrent
        # remove_replica must not shrink the attempt budget mid-loop
        # or hand the loop a list whose indices shifted under it
        replicas = self._replicas_snapshot()
        tried = set()
        last_response = None
        first_attempt = True
        for _ in range(max(1, 2 * len(replicas))):
            timeout_s = self._read_timeout_s
            attempt_body, attempt_headers = body, headers
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return (504, {}, json.dumps({
                        "error": "router: request deadline exhausted during "
                                 "failover"}).encode("utf-8"))
                # each attempt gets at most the budget that is left: a
                # replica that accepted the connection and then wedged
                # must not hold the request past its own deadline —
                # and the replica itself must see the SHRUNK budget,
                # so its scheduler never queues work for a request
                # whose caller already gave up (deadline propagation)
                timeout_s = min(timeout_s, remaining)
                attempt_body, attempt_headers = _rewrite_timeout(
                    body, headers, remaining)
            rep = self.pick_replica(exclude=tried, replicas=replicas)
            if rep is None:
                break
            tried.add(rep.url)
            recorded = False
            # a soft-ejected pick IS the re-admission probe: shadow it
            # with an immediate backup when a duplicate is safe (the
            # probed slowness must not reach the client); an unsafe
            # verb probes unshadowed — slow for this one caller, but
            # single-execution
            probe = hedge_safe and rep.routable()[2]
            if probe or (hedge_ok and first_attempt):
                (rep, response, error, kind, elapsed,
                 recorded) = self._attempt_hedged(
                    rep, replicas, tried, method, path, attempt_body,
                    attempt_headers, timeout_s, verb, probe=probe,
                    deadline=deadline)
            else:
                response, error, kind, elapsed = self._attempt_unary(
                    rep, method, path, attempt_body, attempt_headers,
                    timeout_s)
            first_attempt = False
            if error is None:
                kind = self._policy.classify_http_status(response[0])
                if not self._policy.should_failover(kind, idempotent):
                    if response[0] < 500 and not recorded:
                        # the gray-failure digest: completed requests
                        # the client actually waited on (5xx answers
                        # and failover casualties measure the failure
                        # path, not the replica's service time)
                        rep.note_latency(verb, elapsed)
                    if response[0] < 500:
                        self._evaluate_ejections()
                    return response
                # typed overload: the replica did no work — another may
                rep.note_typed_failure()
                last_response = response
                self.count_failover()
                continue
            if (isinstance(error, socket.timeout) and deadline is not None
                    and deadline - time.monotonic() <= 0):
                # the attempt's socket timeout was the CALLER's own
                # deadline clamp, not replica sickness: answer the
                # truthful typed 504 (the replica, which received the
                # shrunk budget, is expiring the request on its own
                # deadline path right now) and do not rotate a healthy
                # replica out for our impatience
                return (504, {}, json.dumps({
                    "error": "router: request deadline exhausted during "
                             "upstream attempt to {}".format(rep.url)
                }).encode("utf-8"))
            # transport failure: rotate the replica out until a probe
            # sees it again; fail over when the classification allows
            rep.mark_unreachable()
            if not self._policy.should_failover(kind, idempotent):
                if kind == FAILURE_INTERRUPTED:
                    # the replica may have executed the request;
                    # re-execution elsewhere is not safe and 429/503
                    # would invite a blind client retry
                    return (502, {}, json.dumps({
                        "error": "router: replica {} dropped the "
                                 "connection mid-request: {}".format(
                                     rep.url, error)
                    }).encode("utf-8"))
                break
            self.count_failover()
        if last_response is not None:
            return last_response  # the fleet-wide typed overload answer
        return (503, {"Retry-After": "1"}, json.dumps({
            "error": "router: no replica available for {} {}".format(
                method, path)}).encode("utf-8"))

    def forward_broadcast(self, method, path, body, headers):
        """Apply a per-server mutation to EVERY replica; the first
        failure is relayed after all were attempted (replicas must
        agree on shm regions / repository state or the next routed
        request lands on one missing the side effect)."""
        first_bad = None
        last_ok = None
        for rep in self._replicas_snapshot():
            if rep.removed.is_set():
                continue
            try:
                response = self._upstream_once(
                    rep, method, path, body, headers, self._read_timeout_s)
            except (ConnectionError, socket.timeout, OSError,
                    http.client.HTTPException) as e:
                rep.mark_unreachable()
                if first_bad is None:
                    first_bad = (503, {}, json.dumps({
                        "error": "router: replica {} unreachable during "
                                 "broadcast: {}".format(rep.url, e)
                    }).encode("utf-8"))
                continue
            if response[0] >= 400:
                if first_bad is None:
                    first_bad = response
            else:
                last_ok = response
        if first_bad is not None:
            return first_bad
        if last_ok is not None:
            return last_ok
        return (503, {}, json.dumps(
            {"error": "router: no replica reachable"}).encode("utf-8"))


class _DetachedRelay:
    """The per-stream adapter between :class:`SseRelayLoop` and the
    router's generation bookkeeping — the event-loop mirror of
    ``_RouterHandler._relay_events``.  ``on_line``/``on_upstream_end``
    run on the relay loop's single thread; everything they touch
    (``record_event``, ``complete``, ``drop_generation``) is its own
    lock-protected state, and the journal append stays enqueue-only.

    On upstream EOF without a terminal event ("died" in the threaded
    relay) the loop closes the client abruptly: the client's
    auto-resume reconnects, and the RESUME path — a short-lived
    handler thread — performs the replay splice / cross-replica
    handoff before detaching again.  ``on_closed`` settles the
    accounting the detaching handler deferred: the replica's in-flight
    slot, the generation's serving slot, and the router's own
    inflight gauge."""

    __slots__ = ("_router", "_gen", "_rep", "_on_first")

    def __init__(self, router, gen, rep, on_first):
        self._router = router
        self._gen = gen
        self._rep = rep
        self._on_first = on_first

    def on_line(self, line):
        if not line.startswith(b"data: "):
            # id lines are rebuilt from the payload's seq
            return ("continue", [])
        try:
            payload = json.loads(line[len(b"data: "):])
        except ValueError:
            return ("continue", [])
        if payload.get("final"):
            self._gen.complete()
            return ("final", [b'data: {"final": true}\n\n'])
        if "error" in payload:
            # a typed in-band failure is terminal fleet-wide
            self._router.drop_generation(self._gen.gen_id)
            return ("error", [b"data: " + json.dumps(
                payload).encode("utf-8") + b"\n\n"])
        if self._on_first is not None:
            self._on_first()
            self._on_first = None
        backend_seq = (payload.get("parameters") or {}).get("seq")
        if backend_seq is None:
            # non-resumable upstream: pure passthrough, no replay
            self._gen.mark_unresumable()
            return ("continue", [b"data: " + json.dumps(
                payload).encode("utf-8") + b"\n\n"])
        seq, block = self._gen.record_event(backend_seq, payload)
        if seq is None:
            return ("continue", [])  # upstream replayed an acked event
        return ("continue", [block])

    def on_upstream_end(self):
        pass  # the client's reconnect drives the handoff, see above

    def on_closed(self, reason):
        self._rep.end_request()
        self._gen.release()
        self._router.exit_inflight()


class _RouterServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True
    # a horizontal tier takes connection bursts (10k-stream benches,
    # whole-partition reconnect storms after a sibling's death): the
    # stock backlog of 5 turns those into dial timeouts
    request_queue_size = 128

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._detached_lock = threading.Lock()
        # requests whose sockets an SseRelayLoop adopted (via a dup):
        # shutdown_request must NOT half-close these — a
        # shutdown(SHUT_WR) on the original socket applies to the
        # dup'd one too and would sever the live detached stream
        self._detached = set()  # guarded-by: _detached_lock

    def detach_request(self, request):
        with self._detached_lock:
            self._detached.add(request)

    def shutdown_request(self, request):
        with self._detached_lock:
            detached = request in self._detached
            self._detached.discard(request)
        if detached:
            # close only this server's fd; the relay loop's dup keeps
            # the connection itself alive
            self.close_request(request)
        else:
            super().shutdown_request(request)


class _RouterHandler(BaseHttpHandler):
    """The router's HTTP surface: same wire shape as the replica
    frontend (tpuserver_torch.http_server) — the framing is literally the
    same class, ``tpuserver_torch._http_base.BaseHttpHandler`` — but every
    model-facing route forwards to the fleet instead of executing
    locally.  A dead downstream client surfaces as the base class's
    :class:`~tpuserver_torch._http_base.ClientGone`, which the relay loops
    use to park resume state instead of blaming a healthy replica."""

    server_token = b"tpu-triton-router"

    @property
    def router(self):
        return self.server.router

    def _dispatch(self, method):
        try:
            self._route(method)
        except (BrokenPipeError, ConnectionResetError, _ClientGone):
            raise  # dead client socket: handle() ends the connection
        except Exception as e:  # noqa: BLE001 — the router must answer
            # typed even on internal faults; a raw traceback would tear
            # the keep-alive connection instead
            if self._started:
                raise _ClientGone() from e
            self._send_error_json("router error: {}".format(e), 500)

    def _forward_headers(self):
        fwd = {}
        for key in _FORWARD_REQUEST_HEADERS:
            val = self.headers.get(key)
            if val is not None:
                fwd[key] = val
        return fwd

    # -- routing -----------------------------------------------------------

    def _route(self, method):
        path = self.path.split("?", 1)[0]
        router = self.router
        if path == "/v2/health/live":
            return self._send(200)
        if path == "/v2/health/ready":
            return self._send(
                200 if router.any_routable()
                and router.rejecting() is None else 503)
        if path == "/v2/health/stats":
            return self._send_json(router.health_snapshot())
        if path == "/metrics":
            # the fleet scrape surface: router-tier counters + the
            # churn-safe aggregate of every replica's /metrics —
            # protocol parity with the replica frontend (tpulint R8)
            return self._send(
                200, router.metrics_text().encode("utf-8"),
                content_type="text/plain")
        if path == "/router/stats":
            return self._send_json(router.stats())
        if path == "/router/replicas":
            return self._route_replicas_admin(method)
        if path == "/router/partition":
            return self._route_partition_admin(method)
        if path == "/router/promote":
            # the takeover signal: a standby turns active (final
            # journal catch-up included); idempotent on an active.
            # On a partitioned tier the body names the dead active's
            # partition (+ the rebound owner map and its epoch) the
            # standby is promoted INTO.
            if method != "POST":
                return self._send_error_json(
                    "/router/promote supports POST only", 400)
            try:
                request = json.loads(self._read_body() or b"{}")
            except ValueError:
                request = {}
            kwargs = {}
            if isinstance(request, dict):
                if request.get("partition") is not None:
                    kwargs["partition"] = int(request["partition"])
                if request.get("peers") is not None:
                    kwargs["peers"] = list(request["peers"])
                if request.get("epoch") is not None:
                    kwargs["epoch"] = int(request["epoch"])
            promoted = router.promote(**kwargs)
            return self._send_json({
                "promoted": promoted,
                "standby": router.rejecting() == "standby",
            })
        if not (path == "/v2" or path.startswith("/v2/")):
            return self._send_error_json("unknown endpoint: " + path, 404)
        rejecting = router.rejecting()
        if rejecting is not None:
            # standby: the warm copy sheds until promoted; draining: a
            # SIGTERM'd router stops admitting while in-flight streams
            # finish.  Both are typed transitions the clients' resume
            # retry path rides out against the active/peer router.
            return self._send_error_json(
                "router is {}; retry against the active router".format(
                    rejecting)
                if rejecting == "standby"
                else "router is draining; retry later",
                503, {"Retry-After": 1})
        if not router.enter_inflight():
            # the router-level shed valve: typed, with the backoff
            # contract the clients' retry policies key on
            return self._send_error_json(
                "router is at its in-flight request cap; retry later",
                429, {"Retry-After": 1})
        try:
            if (method == "POST"
                    and _GENERATE_STREAM_URI.match(path) is not None):
                return self._route_generate_stream(path)
            body = self._read_body() if method == "POST" else None
            fwd_headers = self._forward_headers()
            if method == "POST" and _BROADCAST_URI.match(path) is not None:
                response = router.forward_broadcast(
                    method, path, body, fwd_headers)
            else:
                response = router.forward_unary(
                    method, path, body, fwd_headers,
                    idempotent=(method == "GET"))
            status, resp_headers, resp_body = response
            relay = _relay_headers(resp_headers)
            content_type = {
                k.lower(): v for k, v in resp_headers.items()
            }.get("content-type", "application/json")
            return self._send(status, resp_body, relay, content_type)
        finally:
            if not self._detached:
                # a detached stream's inflight slot is released by the
                # relay adapter's on_closed, not this handler thread
                router.exit_inflight()

    # -- membership admin surface ------------------------------------------

    def _route_replicas_admin(self, method):
        """``/router/replicas``: GET lists the live membership; POST
        ``{"action": "add"|"remove", "url": "host:port"}`` mutates it —
        the surface the fleet supervisor (and ops) drives elastic
        scaling and planned replacement through."""
        router = self.router
        if method == "GET":
            return self._send_json({"replicas": router.membership()})
        if method != "POST":
            return self._send_error_json(
                "/router/replicas supports GET and POST only", 400)
        try:
            request = json.loads(self._read_body() or b"{}")
            action = request.get("action")
            url = request.get("url")
        except (ValueError, AttributeError):
            return self._send_error_json(
                "malformed /router/replicas request: JSON object with "
                "'action' and 'url' required", 400)
        if action not in ("add", "remove") or not isinstance(url, str):
            return self._send_error_json(
                "bad membership request: action must be 'add' or "
                "'remove' with a 'url' string", 400)
        try:
            if action == "add":
                router.add_replica(url)
            else:
                router.remove_replica(url)
        except (ValueError, KeyError) as e:
            # KeyError reprs its argument with quotes; unwrap
            msg = e.args[0] if e.args else str(e)
            return self._send_error_json(str(msg), 400)
        return self._send_json({"replicas": router.membership()})

    def _route_partition_admin(self, method):
        """``/router/partition``: GET returns this router's partition
        view (index/count/epoch + the url-by-partition owner map and
        ownership counters); POST ``{"action": "set_map", "map":
        [...], "epoch": N}`` adopts a supervisor-broadcast map when
        the epoch is newer — the rebind that repoints a dead active's
        partition at its promoted standby on every router at once."""
        router = self.router
        if method == "GET":
            return self._send_json(router.partition_view())
        if method != "POST":
            return self._send_error_json(
                "/router/partition supports GET and POST only", 400)
        try:
            request = json.loads(self._read_body() or b"{}")
            action = request.get("action")
            new_map = request.get("map")
            epoch = request.get("epoch")
        except (ValueError, AttributeError):
            return self._send_error_json(
                "malformed /router/partition request: JSON object with "
                "'action', 'map' and 'epoch' required", 400)
        if (action != "set_map" or not isinstance(new_map, list)
                or not isinstance(epoch, int)):
            return self._send_error_json(
                "bad partition request: action must be 'set_map' with "
                "a 'map' list and an integer 'epoch'", 400)
        return self._send_json(router.adopt_partition_map(new_map, epoch))

    # -- streaming: sticky resume + cross-replica handoff ------------------

    def _route_generate_stream(self, path):
        router = self.router
        try:
            request_json = json.loads(self._read_body())
        except ValueError as e:
            return self._send_error_json(
                "malformed generate request: {}".format(e), 400)
        parameters = dict(request_json.get("parameters") or {})
        resume_id = None
        resume_from = 0
        last_id = self.headers.get("last-event-id")
        if last_id:
            gid, sep, seq = last_id.rpartition("/")
            if sep and gid:
                try:
                    resume_from = int(seq) + 1
                    resume_id = gid
                except ValueError:
                    pass
        if resume_id is None and parameters.get("resume_generation_id"):
            resume_id = str(parameters["resume_generation_id"])
            resume_from = _coerce_int(parameters.get("resume_from_seq"), 0)
        if resume_id is not None:
            owned, part = router.owns_generation(resume_id)
            if not owned:
                # a sibling's partition: the thin peer hop — a plain
                # client pointed at ANY active still lands correctly
                return self._forward_to_partition(path, part, request_json)
            router.count_partition_owned()
            gen = router.lookup_generation(resume_id)
            handoff_marked = False
            if gen is None:
                # a "gen~offset" id names a handoff epoch (record_event
                # marks post-handoff events): strip it for the registry
                # lookup — the record lives under the bare id
                base, tilde, off = resume_id.rpartition("~")
                if tilde and base and off.isdigit():
                    handoff_marked = True
                    gen = router.lookup_generation(base)
                    if (gen is not None
                            and int(off) > gen.snapshot()["offset"]):
                        # the client saw a handoff epoch this router's
                        # journal never recorded (records lost past the
                        # crash's final flush window): the offset map
                        # for that epoch is unreconstructable, and a
                        # guessed splice could gap or duplicate — the
                        # honest typed 404 below.  A LOWER epoch is
                        # fine: router seqs stayed continuous across
                        # every handoff the registry does know.
                        gen = None
            if gen is None:
                if handoff_marked:
                    # the generation was handed off across replicas and
                    # this router holds no offset map for that epoch
                    # (restart without a journal / aged out / lost
                    # records): router seqs are unreconstructable, and
                    # a guessed replay point could silently gap or
                    # duplicate tokens — fail typed instead
                    return self._send_error_json(
                        "generation '{}' was handed off across replicas "
                        "and its resume state is gone with the "
                        "router".format(resume_id), 404)
                # router restarted or the entry aged out: a replica may
                # still hold the replay state — seq continuity, not
                # endpoint identity, is the contract
                return self._resume_passthrough(path, resume_id, resume_from)
            router.count_resume()
            return self._serve_resume(gen, resume_from)
        explicit_id = parameters.get("generation_id")
        if explicit_id:
            gen_id = str(explicit_id)
            owned, part = router.owns_generation(gen_id)
            if not owned:
                # the client pinned an id that hashes to a sibling's
                # partition: the same thin hop as a resume
                return self._forward_to_partition(path, part, request_json)
        else:
            # router-minted ids hash home by construction
            gen_id = router.mint_generation_id()
        router.count_partition_owned()
        gen = _Generation(gen_id, path, request_json)
        if not router.register_generation(gen, if_absent=True):
            # the id names a live or parked generation: a fresh
            # admission must never clobber a replay buffer the client
            # could still resume from — with ONE exception.  A
            # predecessor that never relayed an event has no resumable
            # state, and the plain client's own reconnect after a
            # drop-before-first-token blind-re-POSTs the identical
            # admission (it has no Last-Event-ID to resume with): that
            # predecessor is superseded, exactly as the replica
            # scheduler supersedes a reused id's parked record.  The
            # insert is atomic with the existence check: two concurrent
            # admissions with the same explicit id cannot both pass.
            superseded = False
            prior = router.lookup_generation(gen_id)
            if (prior is not None and prior.emitted() == 0
                    and prior.acquire(wait_s=router._stream_wait_s)):
                try:
                    if prior.emitted() == 0:
                        router.drop_generation(gen_id)
                        superseded = router.register_generation(
                            gen, if_absent=True)
                finally:
                    prior.release()
            if not superseded:
                return self._send_error_json(
                    "generation id '{}' is already in use".format(gen_id),
                    400)
        gen.acquire(wait_s=0.0)  # fresh record: never contended
        try:
            return self._run_generation(gen, resuming=False)
        finally:
            if not self._detached:
                # a detached stream's serving slot is released by the
                # relay adapter's on_closed, not this handler thread
                gen.release()

    def _serve_resume(self, gen, from_seq):
        """Sticky resume: replay the client's gap from the router's own
        buffer, then splice the live continuation from the home replica
        (or hand off when the home is gone)."""
        router = self.router
        if not gen.acquire(wait_s=router._stream_wait_s):
            return self._send_error_json(
                "generation '{}' is busy on another connection".format(
                    gen.gen_id), 503, {"Retry-After": 1})
        try:
            blocks, completed, next_seq, available = gen.replay_from(
                from_seq)
            if not available:
                # a recovered generation holds only the retained
                # journal tail; a resume point before it is
                # unreplayable — typed, never a silent gap
                return self._send_error_json(
                    "resume point {} of generation '{}' predates the "
                    "recovered journal tail".format(
                        from_seq, gen.gen_id), 404)
            if from_seq > next_seq:
                # ahead of a RECOVERED watermark: the crash lost the
                # final flush window's records, but the client provably
                # received those events — fast-forward and splice from
                # the client's own position (refused on live
                # generations, where a watermark can never trail)
                if gen.fast_forward(from_seq):
                    blocks, completed, next_seq, _ = gen.replay_from(
                        from_seq)
                else:
                    return self._send_error_json(
                        "resume point {} is beyond generation '{}' ({} "
                        "events relayed)".format(
                            from_seq, gen.gen_id, next_seq), 404)
            snapshot = gen.snapshot()
            if (not completed and snapshot["home_lost"]
                    and not snapshot["handoff_capable"]
                    and gen.emitted() > 0):
                # the home replica was REMOVED from the membership and
                # the stream cannot be reconstructed elsewhere: fail
                # typed before the response starts — a partial replay
                # with no continuation would only masquerade as a live
                # stream (and the dead address is never dialed)
                router.drop_generation(gen.gen_id)
                return self._send_error_json(
                    "generation '{}' was homed on a replica that was "
                    "removed from the fleet and is not handoff-capable"
                    .format(gen.gen_id), 404)
            self._ensure_started()
            for block in blocks:
                self._send_chunk(block)
            if completed:
                self._send_chunk(b'data: {"final": true}\n\n')
                self._end_chunks()
                return
            return self._run_generation(gen, resuming=True)
        finally:
            if not self._detached:
                gen.release()

    def _run_generation(self, gen, resuming):
        """Drive one generation to its terminal event, failing over
        (before the first token) or handing off (after it) when the
        serving replica dies.  Caller holds the generation's busy slot
        and has already replayed any client-acked prefix."""
        router = self.router
        snapshot = gen.snapshot()
        rep = None
        # armed by a phase-split plan: frees the prefill replica's KV
        # export once the decode leg's first token proves the attach
        # consumed it (the replay-TTL sweep is the backstop)
        release_export = None
        if resuming and snapshot["home"] is not None:
            rep = router.replica_by_url(snapshot["home"])
        if resuming and rep is not None:
            body, headers = gen.upstream_request(resuming=True)
        elif resuming and (snapshot["home_lost"]
                           or snapshot["home"] is not None):
            # the home replica LEFT THE MEMBERSHIP (remove_replica
            # latched home_lost, or it vanished between the snapshot
            # and the lookup): the dead address is never dialed again.
            # A handoff-capable stream re-admits its emitted history on
            # a live replica; anything else answers typed-404 — unless
            # nothing was ever delivered, where re-routing the original
            # admission cannot duplicate tokens.
            handoff_body = gen.handoff_request()
            if handoff_body is None:
                if gen.emitted() == 0 and not self._started:
                    rep = router.pick_for_generation(gen)
                    body, headers = gen.upstream_request(resuming=False)
                    if rep is not None:
                        gen.set_home(rep.url)
                    resuming = False
                else:
                    return self._stream_fail(
                        gen,
                        "generation '{}' was homed on a replica that was "
                        "removed from the fleet and is not "
                        "handoff-capable".format(gen.gen_id), status=404)
            elif handoff_body == b"":
                # every token already reached the client; only the
                # terminal marker went down with the removed replica
                gen.complete()
                self._ensure_started()
                self._send_chunk(b'data: {"final": true}\n\n')
                self._end_chunks()
                return
            else:
                rep = router.pick_for_generation(gen)
                if rep is None:
                    return self._stream_fail(
                        gen, "no replica available to hand off generation "
                             "'{}'".format(gen.gen_id))
                router.count_handoff()
                gen.set_home(rep.url, rebase=True)
                body = handoff_body
                headers = {"Content-Type": "application/json"}
                resuming = False
        else:
            # fresh admission: phase-split it when both role pools are
            # routable (tpuserver_torch.disagg) — the prefill leg's token has
            # already relayed by the time a plan comes back, and the
            # decode leg below is handoff-shaped, so every later
            # failure heals on the existing machinery
            plan = router.disagg.try_admit(self, gen)
            if plan is not None:
                terminal = plan.get("terminal")
                if terminal == "complete":
                    gen.complete()
                    self._ensure_started()
                    self._send_chunk(b'data: {"final": true}\n\n')
                    self._end_chunks()
                    return
                if terminal == "error":
                    # typed in-band failure already relayed: terminal
                    router.drop_generation(gen.gen_id)
                    self._end_chunks()
                    return
                if terminal == "fail":
                    return self._stream_fail(
                        gen, "generation '{}' lost its prefill leg and "
                             "is not handoff-capable".format(gen.gen_id))
                rep = plan["rep"]
                body, headers = plan["body"], plan["headers"]
                release_export = plan.get("release")
                if rep is None:
                    # the decode pool emptied AFTER the prefill leg
                    # relayed token 0 (composed kills: decode replica
                    # down while the prefill replica streams, then the
                    # fallback picks find nothing).  The stream is
                    # started and ``body`` is already the handoff
                    # re-admission, so failing here is user-visible —
                    # wait out the supervisor heal exactly like the
                    # mid-stream handoff path (found by a seeded chaos
                    # campaign's composed kills)
                    rep = self._wait_for_handoff_replica(gen, None)
                    if rep is not None:
                        gen.set_home(rep.url, rebase=True)
            else:
                # prefix affinity steers siblings of a warm prompt
                # prefix to the replica already holding it
                rep = router.pick_for_generation(gen)
                body, headers = gen.upstream_request(resuming=False)
                if rep is not None:
                    gen.set_home(rep.url)
        attempts = 0
        max_attempts = 2 * len(router._replicas_snapshot()) + 2
        give_up_at = None  # armed mid-stream: wall-clock, not attempts
        while True:
            attempts += 1
            exhausted = attempts > max_attempts
            if exhausted and self._started:
                # mid-stream the attempt cap converts to a wall-clock
                # budget: composed kills (prefill AND decode replica
                # SIGKILLed inside one chaos cycle) can burn the whole
                # cap on pick → dial → die rounds while the fleet is
                # at zero capacity, and an in-band failure here is
                # TERMINAL at the client — user-visible.  The fleet
                # contract is that the supervisor heals within
                # seconds; ride the heal out (found by a seeded chaos
                # campaign's composed kills).
                if give_up_at is None:
                    give_up_at = time.monotonic() + self.HANDOFF_WAIT_S
                if time.monotonic() < give_up_at:
                    exhausted = False
                    time.sleep(0.05)
            if rep is None or exhausted:
                return self._stream_fail(
                    gen, "no replica available for generation '{}'".format(
                        gen.gen_id))
            outcome = None
            status_error = None
            conn = None
            rep.begin_request()
            admitted_at = time.monotonic()
            serving_rep = rep
            ttft_fresh = not resuming and gen.emitted() == 0
            try:
                conn = http.client.HTTPConnection(
                    rep.host, rep.port, timeout=router._read_timeout_s)
                conn.request("POST", gen.path, body=body, headers=headers)
                resp = conn.getresponse()
                if resp.status != 200:
                    status_error = (
                        resp.status, dict(resp.headers), resp.read())
                else:
                    # the stream tier's gray-failure sample is TTFT
                    # (total stream time scales with max_tokens, so it
                    # cannot be compared across replicas) — fresh
                    # admissions only: a resume/handoff splice starts
                    # mid-generation and would read artificially fast
                    def _note_ttft():
                        serving_rep.note_latency(
                            "generate_stream",
                            time.monotonic() - admitted_at)

                    on_first = (_note_ttft if ttft_fresh
                                else release_export)
                    release_export = None  # one-shot
                    if router._relay_loop is not None:
                        outcome = self._detach_relay(
                            gen, rep, conn, resp, on_first)
                    if outcome is None:
                        outcome = self._relay_events(gen, resp, on_first)
            except (ConnectionError, socket.timeout, OSError,
                    http.client.HTTPException):
                outcome = "died"
            finally:
                if outcome != "detached":
                    rep.end_request()
                    if conn is not None:
                        conn.close()
            if outcome == "detached":
                # the selector relay owns the stream (and the deferred
                # generation/replica/inflight accounting) from here
                return
            if outcome == "final":
                gen.complete()
                # the replica's last probe may have read its load while
                # this stream was live, and that stale load outweighs
                # the affinity bonus: the prefix's next sibling would
                # land on a cold replica.  The replica released the
                # stream before its final marker, so one probe now, before
                # the client reads the marker, reads it idle
                router.refresh_snapshot(serving_rep)
                self._ensure_started()
                self._send_chunk(b'data: {"final": true}\n\n')
                self._end_chunks()
                return
            if outcome == "error":
                # a typed in-band failure already relayed: terminal —
                # the generation is dead fleet-wide, drop its state
                router.drop_generation(gen.gen_id)
                self._end_chunks()
                return
            if status_error is not None:
                status, resp_headers, resp_body = status_error
                kind = router._policy.classify_http_status(status)
                failover_ok = (
                    router._policy.should_failover(kind, idempotent=True)
                    or (resuming and status == 404)
                )
                if not failover_ok:
                    # a typed non-overload answer every replica would
                    # repeat: relay it
                    if self._started:
                        try:
                            msg = json.loads(resp_body).get(
                                "error", "upstream failure")
                        except (ValueError, AttributeError):
                            msg = "upstream failure (status {})".format(
                                status)
                        self._send_chunk(b"data: " + json.dumps(
                            {"error": msg}).encode("utf-8") + b"\n\n")
                        self._end_chunks()
                        return
                    return self._send(
                        status, resp_body, _relay_headers(resp_headers))
                rep.note_typed_failure()
            else:
                # transport death mid-request: rotate the replica out
                rep.mark_unreachable()
            if gen.emitted() == 0 and not self._started and not resuming:
                # nothing delivered anywhere yet: a plain failover —
                # re-sending the same admission cannot duplicate tokens.
                # ``_started`` matters independently of the buffer: an
                # unresumable upstream (no seqs) relays events WITHOUT
                # recording them, and re-sending after any of those
                # reached the client would duplicate its tokens
                router.count_failover()
                rep = router.pick_for_generation(gen, exclude={rep.url})
                if rep is not None:
                    gen.set_home(rep.url)
                body, headers = gen.upstream_request(resuming=False)
                continue
            # tokens are out: only a token-identical re-admission keeps
            # the stream gap- and duplicate-free
            handoff_body = gen.handoff_request()
            if handoff_body is None:
                return self._stream_fail(
                    gen,
                    "replica {} lost mid-generation and generation '{}' "
                    "is not handoff-capable".format(rep.url, gen.gen_id))
            if handoff_body == b"":
                # every token was already relayed; only the terminal
                # marker was lost with the replica
                gen.complete()
                self._ensure_started()
                self._send_chunk(b'data: {"final": true}\n\n')
                self._end_chunks()
                return
            new_rep = (router.pick_for_generation(gen, exclude={rep.url})
                       or router.pick_for_generation(gen))
            if new_rep is None:
                # mid-stream zero-capacity window: every routable
                # replica is down at once (composed kills can land
                # between supervisor heals — prefill AND decode
                # SIGKILLed in one chaos cycle).  Tokens are already
                # out, so a typed failure here is USER-VISIBLE and the
                # in-band error event is terminal at the client; the
                # fleet contract is that the supervisor heals the pool
                # within seconds — wait for capacity instead of
                # failing the stream (found by a seeded chaos
                # campaign's composed kills)
                new_rep = self._wait_for_handoff_replica(gen, rep.url)
            if new_rep is None:
                return self._stream_fail(
                    gen, "no replica available to hand off generation "
                         "'{}'".format(gen.gen_id))
            router.count_handoff()
            gen.set_home(new_rep.url, rebase=True)
            rep = new_rep
            body = handoff_body
            headers = {"Content-Type": "application/json"}
            resuming = False

    def _relay_events(self, gen, resp, on_first=None):
        """Relay one upstream SSE response: record + rewrite each event
        into router numbering and emit it.  Returns ``"final"``,
        ``"error"`` (typed in-band failure, already relayed), or
        ``"died"`` (EOF without a terminal event — the handoff
        trigger).  Upstream socket failures propagate to the caller's
        transport handler; a dead client raises :class:`_ClientGone`.
        ``on_first`` fires once before the first data event relays —
        the TTFT probe feeding the serving replica's latency digest."""
        for raw in resp:
            line = raw.rstrip(b"\r\n")
            if not line.startswith(b"data: "):
                continue  # id lines are rebuilt from the payload's seq
            payload = json.loads(line[len(b"data: "):])
            if payload.get("final"):
                return "final"
            if "error" in payload:
                self._ensure_started()
                self._send_chunk(b"data: " + json.dumps(payload).encode("utf-8")
                           + b"\n\n")
                return "error"
            # TTFT samples only real token events: an in-band error
            # answer measures the failure path, not service time (a
            # fast-erroring replica must not read as a fast replica —
            # the same exclusion the unary recording path applies)
            if on_first is not None:
                on_first()
                on_first = None
            backend_seq = (payload.get("parameters") or {}).get("seq")
            if backend_seq is None:
                # a non-resumable upstream (no scheduler ids): pure
                # passthrough, no replay buffer, no handoff
                gen.mark_unresumable()
                self._ensure_started()
                self._send_chunk(b"data: " + json.dumps(payload).encode("utf-8")
                           + b"\n\n")
                continue
            seq, block = gen.record_event(backend_seq, payload)
            if seq is None:
                continue  # upstream replayed an event the client acked
            self._ensure_started()
            self._send_chunk(block)
        return "died"

    def _forward_to_partition(self, path, part, request_json):
        """The thin peer hop: a generate-stream request that hashes to
        a sibling's partition relays raw through THIS router to its
        owner, so a plain client pointed at ANY active lands
        correctly.  An unreachable or unmapped owner (the takeover
        window) answers a typed 503 carrying the partition and map
        epoch — the client's reconnect rotation retries until the
        supervisor's rebind lands the promoted standby in the map."""
        router = self.router
        peer = router.partition_peer(part)
        epoch = router.partition_view()["epoch"]
        if peer is None:
            return self._send_json(
                {"error": "partition {} has no live owner yet; "
                          "retry".format(part),
                 "partition": part, "owner": None, "epoch": epoch},
                503, {"Retry-After": 1})
        router.count_partition_forwarded()
        host, _, port = peer.rpartition(":")
        body = json.dumps(request_json).encode("utf-8")
        headers = self._forward_headers()
        headers["Content-Type"] = "application/json"
        last_id = self.headers.get("last-event-id")
        if last_id:
            headers["Last-Event-ID"] = last_id
        conn = None
        try:
            conn = http.client.HTTPConnection(
                host, int(port), timeout=router._read_timeout_s)
            conn.request("POST", path, body=body, headers=headers)
            resp = conn.getresponse()
            if resp.status != 200:
                # the owner's typed answer (404 resume-gone, 503
                # takeover shed, ...) IS the fleet's answer: relay it
                return self._send(
                    resp.status, resp.read(),
                    _relay_headers(dict(resp.headers)))
            for raw in resp:
                line = raw.rstrip(b"\r\n")
                if not (line.startswith(b"id: ")
                        or line.startswith(b"data: ")):
                    continue
                self._ensure_started()
                self._send_chunk(line + b"\n\n"
                                 if line.startswith(b"data: ")
                                 else line + b"\n")
            if self._started:
                self._end_chunks()
            else:
                self._send_error_json(
                    "partition {} owner {} produced no events".format(
                        part, peer), 502)
        except (ConnectionError, socket.timeout, OSError,
                http.client.HTTPException):
            if self._started:
                raise _ClientGone()  # mid-hop loss: the client retries
            return self._send_json(
                {"error": "partition {} owner {} is unreachable; "
                          "retry".format(part, peer),
                 "partition": part, "owner": peer, "epoch": epoch},
                503, {"Retry-After": 1})
        finally:
            if conn is not None:
                conn.close()

    def _detach_relay(self, gen, rep, conn, resp, on_first):
        """Hand an established upstream stream to the router's
        selector relay loop: the handler thread returns once the
        response headers are on the wire, and one event-loop thread
        multiplexes the token relay for every detached stream (the
        thread-per-connection ceiling, retired).  Returns
        ``"detached"``, or None to fall back to the threaded relay."""
        router = self.router
        loop = router._relay_loop
        if loop is None:
            return None
        upstream = getattr(conn, "sock", None)
        dup = None
        drain = upstream
        if upstream is None:
            # read-until-close framing (no Content-Length, not
            # chunked): http.client hands the connection to the
            # response (``will_close``) and drops ``conn.sock`` inside
            # getresponse().  The fd is still open — the response's
            # makefile holds the last io-ref — so adopt a dup: the
            # relay loop owns an independent socket object and the
            # response's eventual GC close cannot sever the stream.
            raw = getattr(getattr(resp, "fp", None), "raw", None)
            base = getattr(raw, "_sock", None)
            if base is None:
                return None
            try:
                upstream = socket.socket(
                    base.family, base.type, base.proto,
                    fileno=os.dup(base.fileno()))
            except OSError:
                return None
            dup = upstream
            drain = base
        # pull the body bytes http.client buffered past the response
        # headers — they belong to the relay stream, not the (about to
        # be neutralized) HTTPResponse.  The non-blocking flip must
        # land on the socket OBJECT the response reads through
        # (``drain``): Python-level timeouts live on the object, not
        # the fd, so flipping only a dup would leave ``read1`` parked
        # in its 10-minute read timeout until the upstream closes.
        saved_timeout = drain.gettimeout()
        drain.setblocking(False)
        leftover = []
        try:
            while True:
                piece = resp.fp.read1(65536)
                if not piece:
                    break
                leftover.append(piece)
        except (BlockingIOError, InterruptedError):
            pass
        except (ValueError, OSError):
            drain.settimeout(saved_timeout)
            if dup is not None:
                try:
                    dup.close()
                except OSError:
                    pass
            return None
        self._ensure_started()
        client = self._detach_socket()
        stream = RelayStream(
            upstream, client, _DetachedRelay(router, gen, rep, on_first),
            leftover=b"".join(leftover),
            chunked_in=bool(getattr(resp, "chunked", True)),
            chunked_out=self._chunked_ok)
        # neutralize http.client's ownership of the detached fd:
        # conn.close()/garbage collection must not close a live socket
        conn.sock = None
        resp.fp = None
        self.server.detach_request(self.connection)
        try:
            loop.adopt(stream)
        except RuntimeError:
            # loop already stopped (router shutdown): the stream dies
            # with this handler — restore the deferred accounting path
            self._detached = False
            for sock in (upstream, client):
                try:
                    sock.close()
                except OSError:
                    pass
            raise _ClientGone()
        return "detached"

    def _resume_passthrough(self, path, resume_id, resume_from):
        """Resume of a generation the router does not hold: one of the
        replicas may still own the replay state (router restart), so
        try each in turn — a 404 from one replica is not the fleet's
        answer.  Relayed raw: without buffered history the router can
        neither rewrite seqs nor hand off."""
        router = self.router
        body = self._read_body()
        headers = self._forward_headers()
        headers["Last-Event-ID"] = "{}/{}".format(resume_id, resume_from - 1)
        replicas = router._replicas_snapshot()
        tried = set()
        last_status = None
        for _ in range(len(replicas)):
            rep = router.pick_replica(exclude=tried, replicas=replicas)
            if rep is None:
                break
            tried.add(rep.url)
            conn = None
            rep.begin_request()
            try:
                conn = http.client.HTTPConnection(
                    rep.host, rep.port, timeout=router._read_timeout_s)
                conn.request("POST", path, body=body, headers=headers)
                resp = conn.getresponse()
                if resp.status == 404:
                    last_status = (resp.status, dict(resp.headers),
                                   resp.read())
                    continue  # another replica may hold the state
                if resp.status != 200:
                    return self._send(
                        resp.status, resp.read(),
                        _relay_headers(dict(resp.headers)))
                router.count_resume()
                for raw in resp:
                    line = raw.rstrip(b"\r\n")
                    if line.startswith(b"id: ") or line.startswith(
                            b"data: "):
                        self._ensure_started()
                        self._send_chunk(line + b"\n\n" if line.startswith(
                            b"data: ") else line + b"\n")
                # a clean upstream end carries its own final event; a
                # mid-stream death simply ends the chunked body with no
                # terminal event, and the resuming client retries
                if self._started:
                    self._end_chunks()
                else:
                    self._send_error_json(
                        "generation '{}' produced no events on "
                        "resume".format(resume_id), 502)
                return
            except (ConnectionError, socket.timeout, OSError,
                    http.client.HTTPException):
                rep.mark_unreachable()
                if self._started:
                    raise _ClientGone()  # mid-relay loss: client retries
                continue
            finally:
                rep.end_request()
                if conn is not None:
                    conn.close()
        if last_status is not None:
            status, resp_headers, resp_body = last_status
            return self._send(status, resp_body)
        return self._send_error_json(
            "unknown generation '{}' and no replica holds it".format(
                resume_id), 404)

    #: mid-stream zero-capacity wait: how long a handoff with tokens
    #: already relayed polls for a healed replica before surfacing the
    #: terminal in-band error.  The supervisor's SIGKILL → respawn →
    #: probe re-admission cycle is seconds; this covers two serial
    #: heals (the composed-kill worst case) with margin.
    HANDOFF_WAIT_S = 15.0

    def _wait_for_handoff_replica(self, gen, dead_url):
        """Poll for a routable handoff target while the supervisor
        heals a zero-capacity fleet; None only after HANDOFF_WAIT_S."""
        router = self.router
        deadline = time.monotonic() + self.HANDOFF_WAIT_S
        while time.monotonic() < deadline:
            time.sleep(0.05)
            rep = (router.pick_for_generation(gen, exclude={dead_url})
                   or router.pick_for_generation(gen))
            if rep is not None:
                return rep
        return None

    def _stream_fail(self, gen, message, status=503):
        """Terminal router-side stream failure: typed (503 by default,
        404 for unresumable-after-removal) before the stream started,
        in-band error event after."""
        self.router.drop_generation(gen.gen_id)
        if self._started:
            self._send_chunk(b"data: " + json.dumps(
                {"error": message}).encode("utf-8") + b"\n\n")
            self._end_chunks()
            return
        headers = {"Retry-After": 1} if status == 503 else None
        self._send_error_json(message, status, headers)
