"""The windowed inference profiler.

Role of the reference's ``InferenceProfiler``
(inference_profiler.h:243-297, ProfileHelper at
inference_profiler.cc:670-778): per load level, repeat measurement
windows (time- or count-based) until the last three agree on throughput
and latency within the stability percentage, then merge those three
windows into one reported sample with client-side percentiles and a
server-side queue/compute breakdown diffed from
the server's statistics.

The port's copy of ``perfanalyzer/profiler.py``; against a fleet router
each level also carries the router's counter deltas
(:func:`~tpuserver_torch.perfanalyzer.metrics.attach_router_delta`).
"""

import time

from tpuserver_torch.perfanalyzer import metrics
from tpuserver_torch.perfanalyzer.stability import StabilityDetector


class ProfileResult(dict):
    """One load level's merged measurement (a plain dict with attribute
    sugar so report code reads cleanly)."""

    __getattr__ = dict.get


class InferenceProfiler:
    """Windows + stability + stat merging over one load manager.

    Parameters mirror the reference CLI: ``measurement_mode`` is
    ``"time_windows"`` (each window ``measurement_interval_s`` long) or
    ``"count_windows"`` (each window runs until
    ``measurement_request_count`` completions); ``stability_pct`` and
    ``max_trials`` bound the stability search; ``early_exit`` (a
    ``threading.Event``) is the two-stage-SIGINT hook — when set, the
    current window is cut short, reported as-is, and the sweep stops.
    """

    def __init__(self, backend, model, manager,
                 measurement_mode="time_windows",
                 measurement_interval_s=1.0,
                 measurement_request_count=50,
                 stability_pct=10.0, stability_windows=3, max_trials=10,
                 check_latency_stability=True, warmup_s=0.0,
                 early_exit=None, verbose=False):
        if measurement_mode not in ("time_windows", "count_windows"):
            raise ValueError(
                "measurement_mode must be time_windows or count_windows "
                "(got {!r})".format(measurement_mode))
        if max_trials < stability_windows:
            raise ValueError(
                "max_trials ({}) must be >= stability_windows ({})"
                .format(max_trials, stability_windows))
        self.backend = backend
        self.model = model
        self.manager = manager
        self.measurement_mode = measurement_mode
        self.measurement_interval_s = float(measurement_interval_s)
        self.measurement_request_count = int(measurement_request_count)
        self.stability_pct = float(stability_pct)
        self.stability_windows = int(stability_windows)
        self.max_trials = int(max_trials)
        self.check_latency_stability = bool(check_latency_stability)
        self.warmup_s = float(warmup_s)
        self.early_exit = early_exit
        self.verbose = verbose

    # -- one window --------------------------------------------------------

    def _run_window(self):
        """One measurement window; returns
        ``(duration_s, latencies_s, errors, server_delta)``."""
        collector = self.manager.collector
        before = self.backend.stats_snapshot(self.model)
        collector.start_window()
        t0 = time.perf_counter()
        if self.measurement_mode == "time_windows":
            deadline = t0 + self.measurement_interval_s
            while True:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                if (self.early_exit is not None
                        and self.early_exit.is_set()):
                    break
                time.sleep(min(0.05, remaining))
        else:
            # a count window still needs an escape hatch: a wedged
            # server must not hang the profiler forever
            collector.wait_for_completions(
                self.measurement_request_count,
                timeout_s=max(60.0, 100 * self.measurement_interval_s),
                early_exit=self.early_exit)
        duration = time.perf_counter() - t0
        latencies, errors = collector.end_window()
        after = self.backend.stats_snapshot(self.model)
        return duration, latencies, errors, metrics.server_stats_delta(
            before, after)

    # -- one load level ----------------------------------------------------

    def profile_level(self, level):
        """Measure one load level to stability; returns a
        :class:`ProfileResult`.

        ``result.stable`` is False when ``max_trials`` windows never
        converged (a trending system) or the early-exit event fired —
        the partial numbers are still reported, flagged."""
        self.manager.change_level(level)
        if self.warmup_s > 0:
            # event-aware: a first SIGINT mid-warmup must fall through
            # to the (truncated) window and its partial report, not
            # stall out the whole warmup first
            if self.early_exit is not None:
                self.early_exit.wait(self.warmup_s)
            else:
                time.sleep(self.warmup_s)
        detector = StabilityDetector(
            self.stability_pct, self.stability_windows,
            check_latency=self.check_latency_stability)
        router_before = self.backend.router_snapshot()
        windows = []  # (duration, latencies, errors, server_delta)
        stable = False
        interrupted = False
        for trial in range(self.max_trials):
            window = self._run_window()
            duration, latencies, errors, _ = window
            if duration <= 0:
                continue
            windows.append(window)
            avg_lat = (sum(latencies) / len(latencies)
                       if latencies else 0.0)
            detector.add_window(len(latencies) / duration, avg_lat)
            if self.verbose:
                print("  trial {:2d}: {:8.1f} infer/sec, avg {:8.1f} usec"
                      .format(trial + 1, len(latencies) / duration,
                              avg_lat * 1e6), flush=True)
            if self.early_exit is not None and self.early_exit.is_set():
                interrupted = True
                break
            if len(windows) >= self.stability_windows and detector.stable():
                stable = True
                break
        merge_from = windows[-self.stability_windows:]
        merged = metrics.merge_window_records(
            [(w[0], w[1], w[2]) for w in merge_from])
        # server-side deltas sum across the merged windows
        server_delta = {}
        for w in merge_from:
            for key, val in w[3].items():
                server_delta[key] = server_delta.get(key, 0) + val
        breakdown = metrics.server_breakdown(server_delta)
        latency = metrics.latency_summary(merged["latencies_s"])
        result = ProfileResult(
            mode=self.manager.mode,
            level=level,
            stable=stable,
            interrupted=interrupted,
            trials=len(windows),
            throughput=merged["throughput"],
            completed=merged["completed"],
            errors=merged["errors"],
            duration_s=merged["duration_s"],
            server_inference_count=server_delta.get("inference_count", 0),
            server_execution_count=server_delta.get("execution_count", 0),
            client_overhead_pct=metrics.client_overhead_pct(
                latency["avg_usec"], breakdown["server_total_usec"]),
        )
        result.update(latency)
        result.update(breakdown)
        metrics.attach_router_delta(result, router_before,
                                    self.backend.router_snapshot())
        return result

    # -- the sweep ---------------------------------------------------------

    def sweep(self, levels):
        """Linear sweep over load levels (the reference's
        ``--concurrency-range start:end:step`` walk).  Stops early when
        the early-exit event fires; always returns the levels measured
        so far."""
        results = []
        for level in levels:
            if self.early_exit is not None and self.early_exit.is_set():
                break
            results.append(self.profile_level(level))
            if results[-1]["interrupted"]:
                break
        return results


def parse_range(text):
    """``start:end[:step]`` -> list of levels (reference CLI form).
    A bare number means that single level."""
    parts = [int(p) for p in str(text).split(":")]
    if len(parts) == 1:
        return parts
    if len(parts) == 2:
        start, end, step = parts[0], parts[1], 1
    elif len(parts) == 3:
        start, end, step = parts
    else:
        raise ValueError(
            "range must be start:end[:step], got {!r}".format(text))
    if start < 1 or end < start or step < 1:
        raise ValueError(
            "bad range {!r}: need 1 <= start <= end, step >= 1".format(
                text))
    return list(range(start, end + 1, step))
