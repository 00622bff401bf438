"""Report writer: stdout table, CSV, and BENCH-schema JSON rows.

Role of the reference's ``ReportWriter`` (report_writer.cc): one
measurement per load level in, three renderings out.  The JSON rows
use the same one-line-per-measurement schema as the repo's
``BENCH_*.json`` trajectory (``config``/``metric``/``value``/``unit``/
``vs_baseline`` + extras), so perf_analyzer output can land next to
the existing bench history unmodified.

The port's copy of ``perfanalyzer/report.py``: the same table columns,
CSV header and JSON row keys, so a benchmark reads the port's rows as it
reads the JAX tool's.  Left out: the fleet-router footer of the table and
the per-window CSV, which only a router target and the distributed
coordinator produce.
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
    # per-phase columns of a disaggregated fleet behind a router (the
    # JAX tool's; no in-process run sets them, and absent fields render
    # "-", never 0)
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
