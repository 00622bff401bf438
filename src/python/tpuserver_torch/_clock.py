"""Clock discipline: the one sanctioned wall-clock read.

Everything time-shaped in this codebase — deadlines, timeouts, liveness
stamps, backoff windows, TTLs — is ``time.monotonic()`` math, enforced
statically by tpulint rule R3 (wall clocks jump under NTP steps and
suspend/resume; a jumped deadline fires years early or never).  The
single exception is *wire-format reporting*: the KServe statistics
protocol's ``last_inference`` field is epoch milliseconds by contract.
That read lives here, behind one suppressed call, so every other
``time.time()`` in the tree is a finding, not a judgment call.
"""

import time


def wall_clock_ms():
    """Epoch milliseconds for wire-format reporting fields ONLY —
    never for deadline/liveness math (tpulint R3 bans wall-clock reads
    everywhere else)."""
    return int(time.time() * 1000)  # tpulint: disable=R3
