"""3-consecutive-window stability detection.

Role of the reference's ``DetermineStability``
(inference_profiler.cc:780-833): a load level's measurement is accepted
only once the last three windows agree on BOTH throughput and average
latency within the stability percentage — so a trending system (still
warming up, compiling, or saturating a queue) keeps measuring instead
of reporting a transient.

The port's copy of ``perfanalyzer/stability.py``.
"""

from collections import deque


class StabilityDetector:
    """Sliding window over (throughput, latency) measurements.

    ``stability_pct`` is the reference's ``--stability-percentage``
    (default 10): a metric is stable when every one of the last
    ``window_count`` values lies within ±pct of their mean.  Both
    metrics must be stable simultaneously; latency may be exempted
    (``check_latency=False``) the way the reference exempts it under
    request-rate mode's open-loop latencies.
    """

    def __init__(self, stability_pct=10.0, window_count=3,
                 check_latency=True):
        if window_count < 2:
            raise ValueError(
                "stability needs at least 2 windows (got {})".format(
                    window_count))
        self.stability_pct = float(stability_pct)
        self.window_count = int(window_count)
        self.check_latency = bool(check_latency)
        self._windows = deque(maxlen=self.window_count)

    def add_window(self, throughput, avg_latency):
        self._windows.append((float(throughput), float(avg_latency)))

    def reset(self):
        self._windows.clear()

    def _metric_stable(self, values):
        mean = sum(values) / len(values)
        if mean <= 0:
            # a zero-throughput (or zero-latency) plateau is vacuously
            # flat, but it means nothing completed — never "stable"
            return False
        slack = self.stability_pct / 100.0
        return all(abs(v - mean) <= slack * mean for v in values)

    def stable(self):
        """True once ``window_count`` windows agree within the slack."""
        if len(self._windows) < self.window_count:
            return False
        if not self._metric_stable([w[0] for w in self._windows]):
            return False
        if self.check_latency and not self._metric_stable(
                [w[1] for w in self._windows]):
            return False
        return True

    def windows(self):
        return list(self._windows)
