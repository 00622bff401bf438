"""Report writer: stdout table, CSV, and BENCH-schema JSON rows.

Role of the reference's ``ReportWriter`` (report_writer.cc): one
measurement per load level in, three renderings out.  The JSON rows
use the same one-line-per-measurement schema as the repo's
``BENCH_*.json`` trajectory (``config``/``metric``/``value``/``unit``/
``vs_baseline`` + extras), so perf_analyzer output can land next to
the existing bench history unmodified.

The port's copy of ``perfanalyzer/report.py``: the same table columns,
CSV header and JSON row keys, so a benchmark reads the port's rows as it
reads the JAX tool's, the distributed mode's per-window CSV, and the
table's fleet-router footer, which a router target's counter deltas
fill.
"""

import csv
import json


_SCALAR_COLUMNS = [
    ("level", "{:d}"),
    ("throughput", "{:.1f}"),
    ("avg_usec", "{:.1f}"),
    ("p50_usec", "{:.1f}"),
    ("p90_usec", "{:.1f}"),
    ("p95_usec", "{:.1f}"),
    ("p99_usec", "{:.1f}"),
    ("p99.9_usec", "{:.1f}"),
    ("queue_usec", "{:.1f}"),
    ("compute_infer_usec", "{:.1f}"),
    ("client_overhead_pct", "{:.1f}"),
    ("errors", "{:d}"),
    ("stable", "{}"),
]

_SCALAR_HEADERS = [
    "Level", "infer/sec", "avg(us)", "p50(us)", "p90(us)", "p95(us)",
    "p99(us)", "p99.9(us)", "queue(us)", "compute(us)", "overhead%",
    "errors", "stable",
]

_GEN_COLUMNS = [
    ("level", "{:d}"),
    ("throughput", "{:.1f}"),
    ("gen_per_sec", "{:.2f}"),
    ("ttft_avg_ms", "{:.1f}"),
    ("ttft_p50_ms", "{:.1f}"),
    ("ttft_p99_ms", "{:.1f}"),
    ("itl_p50_ms", "{:.2f}"),
    ("itl_p90_ms", "{:.2f}"),
    ("itl_p99_ms", "{:.2f}"),
    ("prefix_hit_pct", "{:.1f}"),
    # speculative decoding (window-delta'd like the prefix-cache
    # column): mean tokens per speculative step and the draft
    # acceptance rate; absent on pre-speculation targets
    ("spec_accept_per_step", "{:.2f}"),
    ("spec_hit_pct", "{:.1f}"),
    # per-phase columns from the router's disagg counters (set by
    # attach_router_delta only when the target router runs the
    # phase-split plane; absent fields render "-", never 0)
    ("prefill_queue_ms", "{:.2f}"),
    ("kv_transfer_ms", "{:.2f}"),
    ("errors", "{:d}"),
    ("stable", "{}"),
]

_GEN_HEADERS = [
    "Streams", "tokens/sec", "gen/sec", "TTFT avg(ms)", "TTFT p50(ms)",
    "TTFT p99(ms)", "ITL p50(ms)", "ITL p90(ms)", "ITL p99(ms)",
    "prefix-hit%", "accept/step", "spec-hit%",
    "prefill-q(ms)", "kv-xfer(ms)", "errors", "stable",
]

#: Per-window CSV schema: the reference ReportWriter's columns
#: (report_writer.cc:73-260, SURVEY §6) plus the generation columns
#: (TTFT/ITL/tokens-per-sec), the JAX tool's header.  One row per
#: measurement window; absent fields render empty, never zero (a 0 is a
#: measurement, an empty cell is "not measured").
WINDOW_CSV_COLUMNS = [
    ("Concurrency", "concurrency"),
    ("Inferences/Second", "throughput"),
    ("Client Send", "client_send_usec"),
    ("Network+Server Send/Recv", "network_usec"),
    ("Server Queue", "queue_usec"),
    ("Server Compute Input", "compute_input_usec"),
    ("Server Compute Infer", "compute_infer_usec"),
    ("Server Compute Output", "compute_output_usec"),
    ("Client Recv", "client_recv_usec"),
    ("p50 latency", "p50_usec"),
    ("p90 latency", "p90_usec"),
    ("p95 latency", "p95_usec"),
    ("p99 latency", "p99_usec"),
    ("p99.9 latency", "p99.9_usec"),
    ("TTFT avg ms", "ttft_avg_ms"),
    ("ITL p50 ms", "itl_p50_ms"),
    ("Tokens/Second", "tokens_per_sec"),
]

#: The keys of a JSON row of a closed-loop (concurrency) level, and of a
#: generation level against a continuous-batching model (whose scheduler
#: reports prefix-cache and speculation counters): the JAX tool's keys
#: for the same run, which tests/test_torch_perf_analyzer_e2e.py holds
#: both tools' rows to.  A first SIGINT adds ``early_exit``.
_ROW_BASE = {"config", "metric", "value", "unit", "vs_baseline", "mode",
             "level", "stable", "interrupted", "trials", "errors",
             "duration_s"}
CONCURRENCY_ROW_KEYS = frozenset(_ROW_BASE | {
    "completed", "server_inference_count", "server_execution_count",
    "client_overhead_pct", "avg_usec", "min_usec", "max_usec", "p50_usec",
    "p90_usec", "p95_usec", "p99_usec", "p99.9_usec", "queue_usec",
    "compute_input_usec", "compute_infer_usec", "compute_output_usec",
    "server_total_usec"})
GENERATION_ROW_KEYS = frozenset(_ROW_BASE | {
    "tokens", "generations", "gen_per_sec", "resumed_streams",
    "resume_events", "prefix_cache_hits", "prefix_cache_misses",
    "prefix_hit_pct", "spec_steps", "spec_proposed", "spec_accepted",
    "spec_accept_per_step", "spec_hit_pct", "ttft_avg_ms", "ttft_p50_ms",
    "ttft_p90_ms", "ttft_p95_ms", "ttft_p99_ms", "itl_avg_ms", "itl_p50_ms",
    "itl_p90_ms", "itl_p95_ms", "itl_p99_ms"})


def _fmt(value, fmt):
    if value is None:
        return "-"
    try:
        return fmt.format(value)
    except (TypeError, ValueError):
        return str(value)


class ReportWriter:
    """Render a sweep's :class:`ProfileResult` rows."""

    def __init__(self, model, backend_kind, extra_tags=None):
        self.model = model
        self.backend_kind = backend_kind
        self.extra_tags = dict(extra_tags or {})

    @staticmethod
    def _is_generation(results):
        # covers generation_concurrency AND distributed_generation
        return bool(results) and "generation" in results[0].get("mode", "")

    def table(self, results):
        """The stdout table, as a string."""
        if not results:
            return "(no measurements)"
        columns = (_GEN_COLUMNS if self._is_generation(results)
                   else _SCALAR_COLUMNS)
        headers = (_GEN_HEADERS if self._is_generation(results)
                   else _SCALAR_HEADERS)
        rows = [
            [_fmt(r.get(key), fmt) for key, fmt in columns]
            for r in results
        ]
        widths = [
            max(len(h), max((len(row[i]) for row in rows), default=0))
            for i, h in enumerate(headers)
        ]
        lines = [
            "  ".join(h.rjust(w) for h, w in zip(headers, widths)),
            "  ".join("-" * w for w in widths),
        ]
        for row in rows:
            lines.append(
                "  ".join(c.rjust(w) for c, w in zip(row, widths)))
        return "\n".join(lines)

    def print_table(self, results, file=None):
        mode = results[0]["mode"] if results else "?"
        print("\n*** {} | model={} backend={} mode={} ***".format(
            "perf_analyzer", self.model, self.backend_kind, mode),
            file=file)
        print(self.table(results), file=file, flush=True)
        if any(r.get("router_handoffs") is not None for r in results):
            # the target is a fleet router: its per-level resilience
            # counters sit next to the client-side resumed_streams —
            # nonzero means replicas died or shed under this level even
            # when every request above still succeeded
            for r in results:
                if r.get("router_handoffs") is None:
                    continue  # this level's snapshot transiently failed
                line = ("  level {}: router failovers={} handoffs={} "
                        "resumed_streams={} shed={}".format(
                            r.get("level"),
                            r.get("router_failovers"),
                            r.get("router_handoffs"),
                            r.get("router_resumed_streams"),
                            r.get("router_shed")))
                if r.get("router_ejections") is not None:
                    # tail-latency defense: gray-failure soft-ejections
                    # and hedge fires under this level — nonzero
                    # ejections with flat errors means the router
                    # routed around a slow replica without the client
                    # noticing
                    line += " ejections={} hedges={}".format(
                        r.get("router_ejections"),
                        r.get("router_hedges"))
                if r.get("router_takeovers") is not None:
                    # router HA: a nonzero takeover delta means the
                    # FRONT TIER itself failed over (standby promoted)
                    # under this level; recovered counts the
                    # generations the journal rebuilt for resumes
                    line += " takeovers={} recovered={}".format(
                        r.get("router_takeovers"),
                        r.get("router_recovered_generations"))
                if r.get("supervisor_replica_restarts") is not None:
                    # a supervised fleet sits behind the router: its
                    # per-window process-healing counters ride along —
                    # nonzero means whole replica processes died or
                    # scaled under this level
                    line += (" | supervisor restarts={} scale_up={} "
                             "scale_down={} retired={}".format(
                                 r.get("supervisor_replica_restarts"),
                                 r.get("supervisor_scale_up_events"),
                                 r.get("supervisor_scale_down_events"),
                                 r.get("supervisor_retired_replicas")))
                if r.get("supervisor_adoptions") is not None:
                    # crash durability: a nonzero adoption delta means
                    # the SUPERVISOR itself restarted under this level
                    # and adopted its children instead of respawning
                    # them — serving never flinched
                    line += " adoptions={}".format(
                        r.get("supervisor_adoptions"))
                print(line, file=file, flush=True)

    def write_csv(self, path, results):
        """Reference-style CSV: one row per load level."""
        if not results:
            return
        columns = (_GEN_COLUMNS if self._is_generation(results)
                   else _SCALAR_COLUMNS)
        with open(path, "w", newline="") as fh:
            writer = csv.writer(fh)
            writer.writerow([key for key, _ in columns])
            for r in results:
                writer.writerow([r.get(key) for key, _ in columns])

    def json_rows(self, results):
        """BENCH-schema dicts, one per load level."""
        rows = []
        generation = self._is_generation(results)
        for r in results:
            row = {
                "config": "perf_analyzer",
                "metric": "{}_{}_{}{}".format(
                    self.model, self.backend_kind,
                    "gen_streams" if generation else r.get(
                        "mode", "level"),
                    r.get("level")),
                "value": round(r.get("throughput") or 0.0, 2),
                "unit": "tokens/sec" if generation else "infer/sec",
                "vs_baseline": None,
                "mode": r.get("mode"),
                "level": r.get("level"),
                "stable": bool(r.get("stable")),
            }
            for key, val in r.items():
                if key in ("mode", "level", "throughput", "stable"):
                    continue
                if isinstance(val, float):
                    row[key] = round(val, 3)
                elif isinstance(val, (int, bool, str)) or val is None:
                    row[key] = val
            row.update(self.extra_tags)
            rows.append(row)
        return rows

    def print_json(self, results, file=None):
        for row in self.json_rows(results):
            print(json.dumps(row), file=file, flush=True)

    def write_json(self, path, results):
        with open(path, "w") as fh:
            for row in self.json_rows(results):
                fh.write(json.dumps(row) + "\n")

    def write_window_csv(self, path, windows):
        """Per-window CSV (``--report-csv``): one row per synchronized
        measurement window in the reference schema
        (:data:`WINDOW_CSV_COLUMNS`).  ``windows`` is the list of merged
        window rows the distributed coordinator produces."""
        with open(path, "w", newline="") as fh:
            writer = csv.writer(fh)
            writer.writerow([header for header, _ in WINDOW_CSV_COLUMNS])
            for w in windows:
                writer.writerow([
                    "" if w.get(key) is None else w.get(key)
                    for _, key in WINDOW_CSV_COLUMNS])
