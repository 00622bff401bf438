"""Request-arrival schedules for the request-rate load manager.

Role of the reference's ``ScheduleDistribution`` (perf_utils.h:152):
one shared generator of inter-arrival gaps that both the profiler's
sweep and the deterministic unit tests consume — pure math, no clocks,
no threads.

The port's copy of ``perfanalyzer/schedule.py``.
"""

import random


def schedule_distribution(distribution, rate, seed=0):
    """Infinite generator of inter-arrival gaps (seconds) at ``rate``
    requests/second.

    ``distribution`` is ``"constant"`` (every gap exactly ``1/rate`` —
    a metronome) or ``"poisson"`` (exponentially distributed gaps with
    mean ``1/rate`` — memoryless arrivals, the open-loop traffic model).
    The Poisson stream is seeded, so a given ``(rate, seed)`` pair
    always produces the same schedule (measurements are repeatable and
    the unit tests are exact).
    """
    if rate <= 0:
        raise ValueError(
            "schedule rate must be positive (got {})".format(rate))
    if distribution == "constant":
        gap = 1.0 / rate
        while True:
            yield gap
    elif distribution == "poisson":
        rng = random.Random(seed)
        while True:
            yield rng.expovariate(rate)
    else:
        raise ValueError(
            "unknown schedule distribution '{}' (want 'constant' or "
            "'poisson')".format(distribution))


def take_gaps(distribution, rate, count, seed=0):
    """First ``count`` gaps of a schedule, as a list (test/helper form)."""
    gen = schedule_distribution(distribution, rate, seed)
    return [next(gen) for _ in range(count)]
