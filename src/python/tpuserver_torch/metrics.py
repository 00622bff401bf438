"""A dependency-free Prometheus-text-format metrics registry: the
port of ``tpuserver/metrics.py`` (a copy; it uses only ``bisect``, ``re``
and ``threading``).

The role of the reference server's metrics plane (the ``:8002/metrics``
endpoint perf_analyzer's ``--collect-metrics`` scrapes): counters,
gauges and histograms with explicit buckets, optional labels, and one
:meth:`MetricsRegistry.render` producing the ``# HELP``/``# TYPE`` +
sample exposition any Prometheus scraper consumes.  The text format is
the contract.

Two registration shapes, chosen by where the numbers live:

- **Owned instruments** (:meth:`~MetricsRegistry.counter` /
  :meth:`~MetricsRegistry.gauge` / :meth:`~MetricsRegistry.histogram`)
  for values produced *at* the instrumentation site: request counts,
  latency observations.  Multi-writer instruments take a tiny
  per-child lock on update: an unlocked ``+=`` is a non-atomic
  read-modify-write whose stale store can roll a counter *backwards*
  mid-race, which a scraper would misread as a process restart.  The
  decode scheduler's histograms opt out with ``single_writer=True``:
  the loop is their only writer, so plain adds are exact and the loop
  never pays a lock per step.
- **Collectors** (:meth:`~MetricsRegistry.register_collector`) for
  values that already exist as authoritative counters elsewhere
  (``DecodeScheduler.stats()``, ``InferenceServer.shm_stats()``).  The
  collector reads them at scrape time, so the registry is a *view*,
  never a second account of the same event.

Every family name must be declared in :data:`CATALOG` (name -> (type,
help)): the registry rejects unknown names.  The catalog is the JAX
package's, family for family (the router, fleet and disagg tiers' names
included, so one exposition parses the same against either server),
plus the port's own data-plane families, marked below.

:func:`parse_prometheus_text` is the minimal parser the fleet router's
aggregator and the chaos soaks share.
"""

import bisect
import re
import threading

__all__ = [
    "CATALOG",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "is_cumulative",
    "parse_prometheus_text",
]

#: The metric catalog: every family either tier may expose, name ->
#: (type, help).  Code registers only names declared here (the
#: registry enforces it), so the scrape surface and the code cannot
#: drift apart.
CATALOG = {
    # -- replica core (every request, both frontends) ----------------------
    "tpu_requests_total": (
        "counter",
        "Requests executed, by verb (infer / stream_infer)."),
    "tpu_request_seconds": (
        "histogram",
        "End-to-end request latency by verb, seconds (streamed verbs "
        "measure submit-to-terminal-event)."),
    "tpu_request_errors_total": (
        "counter",
        "Typed request failures by verb and HTTP status code (429 = "
        "shed, 504 = deadline, 503 = draining/shutdown, ...)."),
    "tpu_inflight_requests": (
        "gauge", "Requests currently executing in the core."),
    # -- shared-memory data plane ------------------------------------------
    "tpu_shm_regions": (
        "gauge",
        "Registered shared-memory regions, by kind (system / cuda / "
        "xla; server-owned KV exports count as xla)."),
    "tpu_shm_bytes_read_total": (
        "counter",
        "Bytes materialized from registered shared-memory regions "
        "(request inputs resolved by reference; device-resident "
        "zero-copy reads count their logical tensor size)."),
    "tpu_shm_bytes_written_total": (
        "counter",
        "Bytes written into registered shared-memory regions (shm-"
        "delivered outputs and token-ring slots)."),
    "tpu_shm_ring_torn_total": (
        "counter",
        "Token-ring slot reads that observed a torn or stale seqlock "
        "word and fell back to the event's in-band payload (requests "
        "opting in via shm_ring_seq_base; process-wide)."),
    # the port's own (no JAX counterpart): the rest of the data plane's
    # shm_stats() counts
    "tpu_shm_zero_copy_reads_total": (
        "counter",
        "Inputs read from a CUDA shared-memory region as a view of its "
        "device memory (no host copy)."),
    "tpu_kv_exports_made_total": (
        "counter",
        "KV exports parked as server-owned CUDA regions "
        "(kvexport/<generation_id>)."),
    "tpu_kv_exports_attached_total": (
        "counter",
        "KV exports attached by a resume or a decode leg, on this "
        "server or through its descriptors."),
    "tpu_kv_exports_dropped_total": (
        "counter", "KV exports released (and their regions freed)."),
    # -- decode scheduler (continuous batching) ----------------------------
    "tpu_scheduler_admissions_total": (
        "counter",
        "Generations admitted into a cache slot (prefill-on-admit), "
        "per model; re-admissions after a supervised restart count."),
    "tpu_scheduler_tokens_total": (
        "counter", "Tokens emitted to streams, per model."),
    "tpu_scheduler_restarts_total": (
        "counter",
        "Supervised decode-loop restarts, per model — the flapping "
        "signal ops rotate on."),
    "tpu_scheduler_quarantined_total": (
        "counter",
        "Slots quarantined for non-finite output (poisoned "
        "generations), per model."),
    "tpu_scheduler_replay_hits_total": (
        "counter",
        "Resume requests served from the replay buffer, per model."),
    "tpu_scheduler_live_streams": (
        "gauge", "Live (pending + slotted) generations, per model."),
    "tpu_scheduler_pending": (
        "gauge", "Generations waiting for a slot, per model."),
    "tpu_scheduler_queue_wait_seconds": (
        "histogram",
        "Time from submit to slot admission (the scheduler queue "
        "bucket), per model, seconds."),
    "tpu_scheduler_step_seconds": (
        "histogram",
        "Batched decode-step dispatch latency, per model, seconds."),
    "tpu_scheduler_codel_sheds_total": (
        "counter",
        "Admissions shed by the adaptive (CoDel-style) queue "
        "controller — sojourn above target for a full control "
        "interval — per model.  The fixed max_pending cliff sheds "
        "count in tpu_request_errors_total{code=429} as before."),
    "tpu_scheduler_codel_shedding": (
        "gauge",
        "Whether the adaptive queue-shed controller is actively "
        "shedding (1) or the admission queue's sojourn is under "
        "target (0), per model."),
    # the port's own (no JAX counterpart)
    "tpu_scheduler_attach_admissions_total": (
        "counter",
        "Admissions over an attached KV export (no prefill: a kv_park "
        "resume or a decode leg), per model."),
    # -- paged KV + radix prefix cache -------------------------------------
    "tpu_prefix_cache_hits_total": (
        "counter",
        "Prompt tokens served from shared radix-cache pages at "
        "admission (skipped prefill), per model."),
    "tpu_prefix_cache_misses_total": (
        "counter",
        "Prompt tokens actually prefilled at admission (cold or "
        "unshared), per model."),
    "tpu_prefix_cache_evictions_total": (
        "counter",
        "KV pages evicted from the radix prefix cache under memory "
        "pressure (LRU, unpinned branches only), per model."),
    "tpu_kv_pages_total": (
        "gauge", "KV page pool size, per model."),
    "tpu_kv_pages_free": (
        "gauge", "KV pages on the free list, per model."),
    "tpu_kv_pages_cached": (
        "gauge",
        "KV pages held only by the radix prefix cache (unpinned, "
        "evictable), per model."),
    # -- speculative decoding ----------------------------------------------
    "tpu_spec_tokens_proposed_total": (
        "counter",
        "Draft tokens proposed by the n-gram speculative drafter and "
        "fed through batched verify steps, per model."),
    "tpu_spec_tokens_accepted_total": (
        "counter",
        "Draft tokens whose greedy argmax matched and were emitted "
        "(token-identical to single-token decoding), per model."),
    "tpu_spec_rollbacks_total": (
        "counter",
        "Speculative steps that rejected at least one draft token "
        "and rolled the slot's KV write cursor back, per model."),
    "tpu_spec_steps_total": (
        "counter",
        "Batched decode steps that carried at least one draft token "
        "into the multi-token verify path, per model."),
    "tpu_spec_accept_per_step": (
        "gauge",
        "Lifetime mean tokens emitted per speculative step (bonus + "
        "accepted drafts; 1.0 is the non-speculative bound), per "
        "model."),
    # -- fleet router ------------------------------------------------------
    "tpu_router_failovers_total": (
        "counter", "Requests re-routed to another replica."),
    "tpu_router_handoffs_total": (
        "counter",
        "Mid-generation cross-replica handoffs (token-identical "
        "re-admission on a live replica)."),
    "tpu_router_resumed_streams_total": (
        "counter", "Client resumes served from the router's buffer."),
    "tpu_router_shed_total": (
        "counter", "Requests shed at the router's in-flight cap."),
    "tpu_router_inflight_requests": (
        "gauge", "Requests currently forwarded by the router."),
    "tpu_router_generations": (
        "gauge", "Generations live in the router's sticky registry."),
    "tpu_router_replica_eligible": (
        "gauge",
        "Routing eligibility per replica (1 = receives traffic)."),
    "tpu_router_replica_load": (
        "gauge",
        "Routing load score per replica (probe load + router-local "
        "in-flight)."),
    "tpu_router_affinity_routed_total": (
        "counter",
        "Generation admissions routed to their prompt prefix's warm "
        "(affine) replica — the radix cache was already primed."),
    "tpu_router_ejections_total": (
        "counter",
        "Gray-failure soft-ejections: replicas routed around because "
        "their recent p90 was an outlier against the fleet median "
        "(they keep answering health probes — that is what makes the "
        "failure gray)."),
    "tpu_router_hedges_total": (
        "counter",
        "Hedged unary attempts by outcome: won = the hedge's response "
        "was used, lost = the primary answered after the hedge fired, "
        "cancelled = the hedge was abandoned in flight."),
    "tpu_router_replica_state": (
        "gauge",
        "Routing state per replica: one sample per replica whose "
        "'state' label is ok / soft-ejected / draining / unreachable "
        "/ ineligible / removed (value always 1) — distinguishes a "
        "gray incident from a planned drain from a dead process."),
    "tpu_router_replica_p90_seconds": (
        "gauge",
        "Rolling per-verb p90 latency per replica from the router's "
        "gray-failure digest (fixed-window, completed requests only; "
        "hedge losers excluded), seconds."),
    # -- router HA: crash journal + warm standby ---------------------------
    "tpu_router_journal_records_total": (
        "counter",
        "Records written to the crash-durable generation journal "
        "(bind/home/ev/fin/drop; enqueued lock-free on the relay "
        "path, framed + fsynced by the writer thread)."),
    "tpu_router_journal_bytes_total": (
        "counter",
        "Bytes appended to the generation journal (length-prefixed + "
        "checksummed frames)."),
    "tpu_router_journal_fsyncs_total": (
        "counter",
        "fsync batches the journal writer issued (many records "
        "amortize into one fsync)."),
    "tpu_router_recovered_generations_total": (
        "counter",
        "Generations rebuilt from the journal: boot-time recovery on "
        "a restarted router plus the warm standby's continuous "
        "tailing — the state that turns a marked (gen~offset/seq) "
        "resume from a typed 404 into a served splice."),
    "tpu_router_takeovers_total": (
        "counter",
        "Standby-to-active promotions this router performed (the "
        "warm-standby takeover signal: POST /router/promote, SIGUSR1, "
        "or the fleet supervisor on active-router death)."),
    # -- horizontal router tier: gen-id partitioning -----------------------
    "tpu_router_partition_owned_total": (
        "counter",
        "Generation admissions this router served because the "
        "generation id hashed into its own partition."),
    "tpu_router_partition_forwarded_total": (
        "counter",
        "Wrong-partition requests this router thin-proxied to the "
        "owning peer (one extra in-tier hop; clients carrying the "
        "full tier in fallback_urls mostly dial the owner directly)."),
    "tpu_router_partition_moved_total": (
        "counter",
        "Generations whose owning partition URL changed under an "
        "adopted partition-map epoch (standby promoted INTO a dead "
        "active's partition, or a respawn on a new port)."),
    "tpu_router_partition_epoch": (
        "gauge",
        "Monotonic epoch of the partition map this router is serving "
        "under (bumped by the supervisor on every broadcast; routers "
        "adopt strictly newer epochs only)."),
    # -- disaggregated prefill/decode (phase-split serving) ----------------
    "tpu_disagg_splits_total": (
        "counter",
        "Generations served phase-split: prefill leg on a prefill "
        "replica, KV pages exported, decode leg attached on a decode "
        "replica (no re-prefill)."),
    "tpu_disagg_fallbacks_total": (
        "counter",
        "Phase-split admissions that degraded to the fused path, by "
        "reason (no_prefill_replica, prefill_rejected, prefill_died, "
        "descriptor_missing, descriptor_conflict, "
        "descriptor_unreachable, prefill_died_after_token). Every "
        "fallback is token-identical to a fused run."),
    "tpu_disagg_transfers_total": (
        "counter",
        "KV-export descriptors fetched for cross-replica attach "
        "(one-shot claim per generation)."),
    "tpu_disagg_transfer_bytes_total": (
        "counter",
        "Bytes of exported KV cache referenced by fetched descriptors "
        "(host-synced on the prefill replica at descriptor time)."),
    "tpu_disagg_transfer_seconds_total": (
        "counter",
        "Wall time spent fetching KV-export descriptors (includes the "
        "prefill replica's device-to-host sync of the region)."),
    "tpu_disagg_prefill_queue_seconds_total": (
        "counter",
        "Wall time from prefill-leg dispatch to its first (and only) "
        "token — prefill queue + prefill compute as seen by the "
        "router."),
    "tpu_disagg_phase_queue_depth": (
        "gauge",
        "Queued plus live work per fleet phase ('phase' label: "
        "prefill / decode / fused) from the router's health "
        "snapshots."),
    # -- fleet supervisor (process-level healing) --------------------------
    "tpu_fleet_replica_restarts_total": (
        "counter", "Replica processes healed by the supervisor."),
    "tpu_fleet_scale_up_total": (
        "counter", "Elastic scale-up events."),
    "tpu_fleet_scale_down_total": (
        "counter", "Elastic scale-down events."),
    "tpu_fleet_retired_replicas_total": (
        "counter",
        "Replicas retired after exhausting their restart budget."),
    "tpu_fleet_replicas_up": (
        "gauge", "Replica processes currently up and routed."),
    # -- supervisor crash durability (manifest + adoption) -----------------
    "tpu_supervisor_adoptions_total": (
        "counter",
        "Live children (replicas and routers) ADOPTED by a restarted "
        "supervisor from its fleet-state manifest instead of being "
        "respawned (pid + start token + spawn nonce all matched)."),
    "tpu_supervisor_manifest_records_total": (
        "counter",
        "Records appended to the fleet-state manifest (spawn/restart/"
        "retire/scale/promote/config/checkpoint) by the off-hot-path "
        "writer thread."),
    "tpu_supervisor_clean_handovers_total": (
        "counter",
        "Graceful supervisor handovers: manifest checkpointed, "
        "single-writer lock released, children LEFT SERVING for a "
        "successor to adopt."),
    "tpu_supervisor_stale_children_reaped_total": (
        "counter",
        "Manifest rows whose process failed the adoption contract "
        "(dead pid, reused pid, nonce mismatch, unreachable health) "
        "and were reaped-then-respawned instead of adopted."),
}

#: Default latency buckets (seconds): spans the ~60us simple-model hot
#: path through multi-second generation tails.
DEFAULT_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


def _escape_label(value):
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_value(value):
    """Prometheus sample value: integral floats render as integers so
    counters read naturally; everything else as repr-precision float."""
    try:
        if float(value) == int(value):
            return str(int(value))
    except (OverflowError, ValueError):
        pass
    return repr(float(value))


def _render_labels(labels):
    if not labels:
        return ""
    return "{" + ",".join(
        '{}="{}"'.format(k, _escape_label(v)) for k, v in labels) + "}"


class Counter:
    """One monotonically non-decreasing sample.  ``inc`` takes a
    per-child lock: an unlocked ``+=`` is a LOAD/STORE pair whose
    stale store can visibly roll the value backwards under concurrent
    writers — a fake counter reset to any scraper.  The lock is
    per-child and uncontended on the paths that use it (never the
    decode loop)."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, amount=1):
        with self._lock:
            self._value += amount

    @property
    def value(self):
        # a bare attribute read is one atomic load; no lock needed
        return self._value


class Gauge:
    """One point-in-time sample (``set`` is a single atomic store;
    ``inc``/``dec`` read-modify-write under the child lock)."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0

    def set(self, value):
        self._value = value

    def inc(self, amount=1):
        with self._lock:
            self._value += amount

    def dec(self, amount=1):
        with self._lock:
            self._value -= amount

    @property
    def value(self):
        return self._value


class Histogram:
    """Cumulative-bucket histogram with explicit upper bounds.

    ``observe`` takes the child lock by default (multi-writer request
    paths); a ``single_writer=True`` child skips it — exact without a
    lock when one thread owns every observe, which is how the decode
    loop stamps its step/queue histograms without paying a lock per
    step.  A render racing an observe may see the new bucket count
    before the new ``_sum`` — scrape-level skew every cumulative
    histogram tolerates by design.
    """

    __slots__ = ("buckets", "_counts", "_sum", "_lock")

    def __init__(self, buckets, single_writer=False):
        bounds = tuple(sorted(float(b) for b in buckets))
        if not bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self.buckets = bounds
        self._counts = [0] * (len(bounds) + 1)  # [-1] is +Inf
        self._sum = 0.0
        self._lock = None if single_writer else threading.Lock()

    def observe(self, value):
        value = float(value)
        idx = bisect.bisect_left(self.buckets, value)
        lock = self._lock
        if lock is None:
            self._counts[idx] += 1
            self._sum += value
        else:
            with lock:
                self._counts[idx] += 1
                self._sum += value

    def snapshot(self):
        """(cumulative_bucket_counts_with_inf, sum, count)."""
        counts = list(self._counts)
        cumulative = []
        running = 0
        for c in counts:
            running += c
            cumulative.append(running)
        return cumulative, self._sum, running


class _Family:
    """One metric family: name, declared type, and a child instrument
    per label-value tuple.  Child creation is rare (first request with
    a new label set) and takes the family lock; the hot path holds a
    child reference and never touches the family again."""

    def __init__(self, name, kind, help_text, labelnames, buckets=None,
                 single_writer=False):
        self.name = name
        self.kind = kind
        self.help = help_text
        self.labelnames = tuple(labelnames)
        self.buckets = buckets
        self.single_writer = single_writer
        self._lock = threading.Lock()
        self._children = {}  # label-values tuple -> instrument  # guarded-by: _lock

    def _make_child(self):
        if self.kind == "counter":
            return Counter()
        if self.kind == "gauge":
            return Gauge()
        return Histogram(self.buckets or DEFAULT_BUCKETS,
                         single_writer=self.single_writer)

    def labels(self, **labelvalues):
        if set(labelvalues) != set(self.labelnames):
            raise ValueError(
                "family '{}' takes labels {}, got {}".format(
                    self.name, self.labelnames, sorted(labelvalues)))
        key = tuple(str(labelvalues[n]) for n in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._make_child()
                self._children[key] = child
            return child

    def child(self):
        """The label-less singleton child (families with no labels)."""
        if self.labelnames:
            raise ValueError(
                "family '{}' requires labels {}".format(
                    self.name, self.labelnames))
        return self.labels()

    def render(self, lines):
        lines.append("# HELP {} {}".format(self.name, self.help))
        lines.append("# TYPE {} {}".format(self.name, self.kind))
        with self._lock:
            children = list(self._children.items())
        for key, child in children:
            labels = list(zip(self.labelnames, key))
            if self.kind in ("counter", "gauge"):
                lines.append("{}{} {}".format(
                    self.name, _render_labels(labels),
                    _fmt_value(child.value)))
            else:
                cumulative, total, count = child.snapshot()
                for bound, cum in zip(
                        list(child.buckets) + ["+Inf"], cumulative):
                    le = ("+Inf" if bound == "+Inf"
                          else _fmt_value(bound))
                    lines.append("{}_bucket{} {}".format(
                        self.name,
                        _render_labels(labels + [("le", le)]), cum))
                lines.append("{}_sum{} {}".format(
                    self.name, _render_labels(labels),
                    _fmt_value(total)))
                lines.append("{}_count{} {}".format(
                    self.name, _render_labels(labels), count))


class MetricsRegistry:
    """The per-process family registry + renderer.

    Families register idempotently: a second registration of the same
    name returns the existing family (so every model can ask for the
    shared scheduler histograms), but a type or label-shape mismatch
    is a hard error — one name, one meaning.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._families = {}    # name -> _Family  # guarded-by: _lock
        self._collectors = []  # callables        # guarded-by: _lock

    def _register(self, name, kind, labelnames, buckets=None,
                  single_writer=False):
        entry = CATALOG.get(name)
        if entry is None:
            raise ValueError(
                "metric '{}' is not declared in tpuserver_torch."
                "metrics.CATALOG — declare it there first".format(name))
        declared_kind, help_text = entry
        if declared_kind != kind:
            raise ValueError(
                "metric '{}' is declared as a {} in CATALOG, not a "
                "{}".format(name, declared_kind, kind))
        with self._lock:
            family = self._families.get(name)
            if family is not None:
                if (family.kind != kind
                        or family.labelnames != tuple(labelnames)):
                    raise ValueError(
                        "metric '{}' re-registered with a different "
                        "shape".format(name))
                return family
            family = _Family(name, kind, help_text, labelnames, buckets,
                             single_writer=single_writer)
            self._families[name] = family
            return family

    def counter(self, name, labelnames=()):
        return self._register(name, "counter", labelnames)

    def gauge(self, name, labelnames=()):
        return self._register(name, "gauge", labelnames)

    def histogram(self, name, labelnames=(), buckets=None,
                  single_writer=False):
        """``single_writer=True`` children skip the per-observe lock:
        ONLY for families where one thread owns every observe (the
        decode loop's per-model histograms)."""
        return self._register(name, "histogram", labelnames,
                              buckets=buckets or DEFAULT_BUCKETS,
                              single_writer=single_writer)

    def register_collector(self, fn):
        """Register a scrape-time collector: ``fn()`` returns an
        iterable of ``(name, samples)`` where ``samples`` is a list of
        ``(labels_dict, value)`` and ``name`` is a CATALOG family.
        Collectors are how authoritative counters that live elsewhere
        (scheduler stats, router stats) surface without a second
        account of the same events."""
        with self._lock:
            self._collectors.append(fn)

    def render(self):
        """The Prometheus text exposition, trailing newline included."""
        with self._lock:
            families = list(self._families.values())
            collectors = list(self._collectors)
        lines = []
        rendered = set()
        for family in families:
            family.render(lines)
            rendered.add(family.name)
        for fn in collectors:
            try:
                emitted = list(fn())
            except Exception:  # noqa: BLE001 — observability must not
                # take the serving surface down with a dying collector
                continue
            for name, samples in emitted:
                entry = CATALOG.get(name)
                if entry is None or name in rendered:
                    continue  # undeclared or double-declared family
                rendered.add(name)
                kind, help_text = entry
                lines.append("# HELP {} {}".format(name, help_text))
                lines.append("# TYPE {} {}".format(name, kind))
                for labels, value in samples:
                    lines.append("{}{} {}".format(
                        name, _render_labels(sorted(labels.items())),
                        _fmt_value(value)))
        return "\n".join(lines) + "\n" if lines else ""


# -- the shared minimal parser ----------------------------------------------

_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>.*)\})?\s+(?P<value>\S+)$")
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def is_cumulative(name, kind):
    """Whether a family's samples are cumulative (aggregate churn-safe
    across process restarts): declared counters and histograms, plus
    the untyped ``*_total``/``*_count`` compatibility families
    (``nv_inference_count``).  The ONE definition the fleet
    aggregator and the chaos soak's monotonicity check share."""
    if kind in ("counter", "histogram"):
        return True
    return kind is None and name.endswith(("_total", "_count"))


def _unescape_label(value):
    # a single left-to-right scan: sequential str.replace would decode
    # an escaped backslash followed by 'n' ("\\\\n") into a newline
    out = []
    i = 0
    while i < len(value):
        ch = value[i]
        if ch == "\\" and i + 1 < len(value):
            nxt = value[i + 1]
            if nxt == "n":
                out.append("\n")
                i += 2
                continue
            if nxt in ('"', "\\"):
                out.append(nxt)
                i += 2
                continue
        out.append(ch)
        i += 1
    return "".join(out)


def parse_prometheus_text(text):
    """Parse an exposition into ``{family: {"type", "help",
    "samples"}}`` where ``samples`` is a list of ``(sample_name,
    labels_dict, value)``.

    Histogram ``_bucket``/``_sum``/``_count`` samples attach to their
    declared family; samples with no ``# TYPE`` line become their own
    family with ``type=None`` (the nv_* compatibility gauges).  This
    is the parser the fleet aggregator and the chaos soaks share —
    tests pin the format with their own independent parser."""
    families = {}

    def fam(name):
        return families.setdefault(
            name, {"type": None, "help": None, "samples": []})

    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("# HELP "):
            name, _, help_text = line[len("# HELP "):].partition(" ")
            fam(name)["help"] = help_text
            continue
        if line.startswith("# TYPE "):
            name, _, kind = line[len("# TYPE "):].partition(" ")
            fam(name)["type"] = kind.strip()
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            continue
        name = m.group("name")
        labels = {
            k: _unescape_label(v)
            for k, v in _LABEL_RE.findall(m.group("labels") or "")
        }
        try:
            value = float(m.group("value"))
        except ValueError:
            continue
        family = name
        for suffix in ("_bucket", "_sum", "_count"):
            stripped = name[: -len(suffix)] if name.endswith(suffix) else None
            if stripped and stripped in families:
                family = stripped
                break
        fam(family)["samples"].append((name, labels, value))
    return families
