"""Pure measurement math: percentiles, window summaries, and
client/server statistic merging.

Role of the reference's ``PerfStatus`` / ``ClientSideStats`` /
``ServerSideStats`` plumbing (inference_profiler.h:97-162,
MergePerfStatusReports at inference_profiler.cc:948).  Everything here
is deterministic and clock-free so the unit tests can drive it with
synthetic numbers.

The port's copy of ``perfanalyzer/metrics.py``, less the fleet-router
deltas (``attach_router_delta``), which only a router target reaches,
and the per-replica pairing of multi-replica snapshots: the in-process
backend drives one core.

Execution counts differ from the JAX package's: the port's core counts
one execution per model call, so a dynamic batch counts once however
many requests it served, where JAX's counts one per request.  Every
per-request figure here (:func:`server_breakdown`) divides by the
success count, never by the execution count.
"""


def percentile(values, pct, presorted=False):
    """Linear-interpolated percentile of ``values`` (``pct`` in 0..100).

    Matches numpy's default ('linear') method so client-side latency
    percentiles agree with any offline re-analysis of the raw records.
    ``presorted=True`` skips the sort — callers that already hold a
    sorted sample (latency summaries over tens of thousands of window
    records) pay for one sort, not one per percentile.
    """
    if not values:
        raise ValueError("percentile of an empty sample")
    if not 0 <= pct <= 100:
        raise ValueError(
            "percentile must be in [0, 100], got {}".format(pct))
    ordered = values if presorted else sorted(values)
    if len(ordered) == 1:
        return ordered[0]
    rank = (pct / 100.0) * (len(ordered) - 1)
    lo = int(rank)
    hi = min(lo + 1, len(ordered) - 1)
    frac = rank - lo
    return ordered[lo] * (1.0 - frac) + ordered[hi] * frac


#: percentiles are always computed over POOLED raw samples — never an
#: average of per-window percentiles, which has no statistical meaning
#: (reference MergePerfStatusReports semantics)
LATENCY_PERCENTILES = (50, 90, 95, 99, 99.9)


def _pct_key(p):
    """``p99_usec`` / ``p99.9_usec``: integral percentiles render
    without the float's trailing ``.0``."""
    return "p{:g}_usec".format(p)


def latency_summary(latencies_s):
    """p50/p90/p95/p99/p99.9 + avg/min/max of a latency sample, in
    microseconds (the unit every report row carries)."""
    if not latencies_s:
        return {"avg_usec": None, "min_usec": None, "max_usec": None,
                **{_pct_key(p): None for p in LATENCY_PERCENTILES}}
    usec = sorted(v * 1e6 for v in latencies_s)
    out = {
        "avg_usec": sum(usec) / len(usec),
        "min_usec": usec[0],
        "max_usec": usec[-1],
    }
    for p in LATENCY_PERCENTILES:
        out[_pct_key(p)] = percentile(usec, p, presorted=True)
    return out


# -- server-side statistics ------------------------------------------------

_DURATION_KEYS = ("success", "fail", "queue", "compute_input",
                  "compute_infer", "compute_output")


def server_stats_snapshot(stats, model_name):
    """Normalize one model's cumulative stats out of a
    ``model_statistics()`` result (the KServe statistics extension's
    shape; int64s that arrive as strings are coerced to int).  Returns a
    flat dict: ``inference_count``, ``execution_count``, and
    ``<bucket>_count`` / ``<bucket>_ns`` for each duration bucket.
    """
    for entry in stats.get("model_stats", []):
        if entry.get("name") == model_name:
            infer_stats = entry.get("inference_stats", {})
            snap = {
                "inference_count": int(entry.get("inference_count", 0)),
                "execution_count": int(entry.get("execution_count", 0)),
            }
            for key in _DURATION_KEYS:
                bucket = infer_stats.get(key, {})
                snap[key + "_count"] = int(bucket.get("count", 0))
                snap[key + "_ns"] = int(bucket.get("ns", 0))
            return snap
    raise KeyError(
        "model '{}' not present in server statistics".format(model_name))


def server_stats_delta(before, after):
    """Per-bucket deltas between two snapshots (one measurement window's
    worth of server-side work).  Counters are cumulative on the server,
    so the diff isolates exactly the window — the profiler reads queue
    vs compute time for the requests IT sent, not the server's
    lifetime."""
    return {key: after[key] - before[key] for key in after}


def server_breakdown(delta):
    """Per-request server-side microsecond breakdown + the fractions the
    overhead report prints.

    Returns ``queue_usec`` / ``compute_infer_usec`` (+input/output) per
    successful request, and ``server_total_usec`` (their sum) — the
    time the server itself accounts for.  Per request means per success:
    a dynamic batch is one execution for all of its requests.  The
    client-overhead percentage is computed against the measured client
    latency by :func:`client_overhead_pct`."""
    n = max(1, delta.get("success_count", 0))
    out = {}
    total = 0.0
    for key in ("queue", "compute_input", "compute_infer",
                "compute_output"):
        usec = delta.get(key + "_ns", 0) / 1e3 / n
        out[key + "_usec"] = usec
        total += usec
    out["server_total_usec"] = total
    return out


def client_overhead_pct(client_avg_usec, server_total_usec):
    """Share of the client-observed latency NOT accounted for by the
    server's own buckets: transport, (de)serialization, client stack.
    Clamped to [0, 100] — clock skew between the two sides can
    otherwise push it slightly negative."""
    if not client_avg_usec or client_avg_usec <= 0:
        return None
    pct = 100.0 * (1.0 - server_total_usec / client_avg_usec)
    return min(100.0, max(0.0, pct))


def merge_window_records(windows):
    """Merge per-window request records into one report sample.

    ``windows`` is a list of (duration_s, [latency_s, ...], error_count)
    tuples — the stability run's last three windows.  Throughput is
    total completions over total duration (NOT the mean of per-window
    rates: windows may differ slightly in length, and requests are the
    natural weight); the latency sample is pooled so percentiles rest
    on every record (reference MergePerfStatusReports semantics).
    """
    total_s = sum(w[0] for w in windows)
    latencies = [lat for w in windows for lat in w[1]]
    errors = sum(w[2] for w in windows)
    throughput = len(latencies) / total_s if total_s > 0 else 0.0
    return {
        "throughput": throughput,
        "latencies_s": latencies,
        "completed": len(latencies),
        "errors": errors,
        "duration_s": total_s,
    }
