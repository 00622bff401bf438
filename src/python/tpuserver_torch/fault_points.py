"""Named fault-injection points of the port: a copy of
``tpuserver/faults.py`` under another name, whose trigger is
:func:`trip` (JAX: ``fire``), so the two packages' sites never count as
each other's.

Serving code calls :func:`trip` at well-known points; by default that is
a no-op costing one dict check.  Chaos tests arm a point with
:func:`install` or the :class:`injected` context manager, and the next
``times`` passes through it raise :class:`FaultInjected`
(``mode="raise"``) or stall for ``delay`` seconds (``mode="sleep"``).

Registered injection points (one trip site each, as in the JAX package):

==========================  ================================================
``scheduler.step``           before each batched decode-step dispatch
                             (``raise`` = decode-loop death, the
                             supervised-restart path; ``sleep`` = slow
                             step; ``hang`` = a stall inside the
                             watchdog's heartbeat window; ``nan`` =
                             poison one slot's logits row, the per-slot
                             quarantine path, with ``delay`` as the slot)
``scheduler.fetch``          before the device->host token copy of a
                             completed step (loop death / restart)
``scheduler.admit``          before an admission (the request fails,
                             other slots keep decoding)
``core.shm_read``            before a shared-memory input read
``http.generate_stream``     before each SSE event write of
                             ``/generate_stream`` (``raise`` = sever the
                             connection mid-stream, no terminal chunk)
``grpc.stream_infer``        before each ModelStreamInfer response yield
                             (``raise`` = kill the bidi stream mid-flight)
==========================  ================================================

``install(..., skip=N)`` lets the first ``N`` passes through an armed
point succeed before it starts firing: the knob that drops a connection
*mid*-stream rather than before the first token.

Gray-failure modes: ``mode="slow"`` (every trip sleeps ``delay``),
``mode="jitter"`` (a deterministic pseudo-random delay in ``[0, delay)``
from a seeded LCG) and ``mode="partition"`` (``skip`` passes flow, then
the site stalls until :func:`clear`, or for ``delay`` seconds per trip
when ``delay > 0``).  All stay armed until :func:`clear`.

**Scopes**: several in-process servers share this process-global
registry, so a point armed with ``scope="replica-b"`` trips only for the
server (and the scheduler) built with ``fault_scope="replica-b"``.  A
point armed without a scope trips for every firer.

Environment: ``TPUSERVER_FAULTS`` arms points when this module is
imported, as a comma-separated list of
``name[@scope]:mode[:times[:delay]]`` entries, e.g.::

    TPUSERVER_FAULTS="scheduler.step:raise:1,core.shm_read@b:raise:-1"

``times=-1`` means unlimited.  :func:`clear` disarms.
"""

import os
import threading
import time
import zlib

__all__ = [
    "FaultInjected", "POINTS", "trip", "install", "clear", "fired",
    "active", "injected", "load_env",
]

#: The fault-point registry: the JAX package's names, one trip site
#: each in the port (``tests/test_torch_faults.py`` holds each site
#: against JAX's).
POINTS = {
    "scheduler.step": (
        "before each batched decode-step dispatch (raise = loop death "
        "/ supervised restart; sleep = slow step; hang = stall past "
        "the watchdog deadline; nan = poison slot int(delay)'s logits "
        "row / quarantine)"),
    "scheduler.fetch": (
        "before the device->host token transfer of a completed step "
        "(raise = loop death / supervised restart)"),
    "scheduler.admit": (
        "before a prefill-on-admit (admission failure: the request "
        "fails, other slots keep decoding)"),
    "core.shm_read": "before a shared-memory input read",
    "http.generate_stream": (
        "before each /generate_stream SSE event write (raise = sever "
        "the connection mid-stream — drives client auto-resume)"),
    "grpc.stream_infer": (
        "before each ModelStreamInfer response yield (raise = kill "
        "the bidi stream mid-flight)"),
}


class FaultInjected(RuntimeError):
    """The error raised by an armed ``mode="raise"`` injection point."""

    def __init__(self, point):
        super().__init__("injected fault at '{}'".format(point))
        self.point = point


#: LCG constants for ``mode="jitter"`` (glibc's rand() multiplier /
#: increment over a 2^31 modulus): a tiny, dependency-free generator
#: whose whole point is determinism — the same arming replays the exact
#: same delay sequence, so a gray-failure soak is reproducible run to
#: run (a ``random``-based jitter would not be, and seeding the global
#: RNG from a fault hook would perturb every other consumer).
_LCG_A = 1103515245
_LCG_C = 12345
_LCG_M = 1 << 31


class _Fault:
    __slots__ = ("name", "mode", "remaining", "delay", "fired", "scope",
                 "skip", "lcg")

    def __init__(self, name, mode, times, delay, scope=None, skip=0):
        if mode not in ("raise", "sleep", "hang", "nan", "slow",
                        "jitter", "partition"):
            raise ValueError(
                "fault mode must be 'raise', 'sleep', 'hang', 'nan', "
                "'slow', 'jitter' or 'partition' (got {!r})".format(mode)
            )
        self.name = name
        self.mode = mode
        # 'slow', 'jitter' and 'partition' model a DEGRADED-but-alive
        # replica (the gray-failure shape): a latency fault that
        # disarmed itself after N fires would read as a recovered
        # replica mid-soak, so all are persistent until clear()
        # regardless of ``times``
        self.remaining = (-1 if mode in ("slow", "jitter", "partition")
                          else int(times))
        self.delay = float(delay)
        self.fired = 0
        self.scope = scope
        self.skip = int(skip)
        # jitter state: seeded from the point identity so two scoped
        # armings of the same point draw distinct but stable sequences
        self.lcg = zlib.crc32(
            "{}@{}".format(name, scope or "").encode("utf-8")) % _LCG_M


_lock = threading.Lock()
_points = {}  # (name, scope) -> _Fault


def install(name, mode="raise", times=1, delay=0.0, scope=None, skip=0):
    """Arm injection point ``name``: the next ``times`` fires raise
    (``mode="raise"``), sleep ``delay`` seconds inside trip()
    (``mode="sleep"``), or hand the site an action to implement —
    ``mode="nan"`` poisons the logits row of slot ``int(delay)`` and
    ``mode="hang"`` stalls ``delay`` seconds inside the site's
    watchdog-heartbeat window (see :func:`trip`).  ``times=-1`` keeps
    the point armed until :func:`clear`.  ``skip`` lets the first N
    passes through succeed before firing starts (mid-stream chaos).
    With a ``scope``, only :func:`trip` calls carrying that scope trip
    the point (per-replica chaos); scope None matches every firer.

    Three modes model a GRAY failure — a replica that still answers
    probes while its data path misbehaves: ``mode="slow"`` sleeps
    ``delay`` seconds on EVERY fire (thermal throttle, swap storm),
    ``mode="jitter"`` sleeps a deterministic pseudo-random duration in
    ``[0, delay)`` drawn from a per-fault LCG seeded by the point
    identity — the same arming replays the exact same delay sequence,
    so gray-failure soaks reproduce run to run — and
    ``mode="partition"`` stalls the firing site entirely (the
    half-open network shape: connection accepted, ``skip`` passes
    flow, then no bytes and no error) until :func:`clear` releases it,
    or for ``delay`` seconds per fire when ``delay > 0``.  All are
    persistent (``times`` is ignored: a gray fault that disarmed
    itself would read as a recovery mid-soak) until :func:`clear`, and
    all honor ``@scope`` per-replica targeting —
    ``scheduler.step@replica-b:slow:-1:0.05`` degrades exactly one
    replica of a fleet."""
    fault = _Fault(name, mode, times, delay, scope, skip=skip)
    with _lock:
        _points[(name, scope)] = fault
    return fault


_ALL_SCOPES = object()


def clear(name=None, scope=_ALL_SCOPES):
    """Disarm points.  ``clear()`` disarms everything; ``clear(name)``
    disarms the point under every scope; ``clear(name, scope)`` (scope
    may be None for the global arming) disarms exactly one entry."""
    with _lock:
        if name is None:
            _points.clear()
        elif scope is _ALL_SCOPES:
            for key in [k for k in _points if k[0] == name]:
                _points.pop(key, None)
        else:
            _points.pop((name, scope), None)


def _lookup(name, scope):
    """The armed fault matching a fire site: exact scope first, then
    the scope-less global arming.  Call with _lock held."""
    fault = _points.get((name, scope))
    if fault is None and scope is not None:
        fault = _points.get((name, None))
    return fault


def fired(name, scope=None):
    """How many times point ``name`` has actually fired (0 if unarmed).
    With ``scope``, reads the per-scope arming (falling back to the
    global one, mirroring :func:`trip`)."""
    with _lock:
        fault = _lookup(name, scope)
        return fault.fired if fault is not None else 0


def active(name, scope=None):
    """Whether point ``name`` is armed with fires remaining for a firer
    carrying ``scope``."""
    with _lock:
        fault = _lookup(name, scope)
        return fault is not None and fault.remaining != 0


def trip(name, scope=None):
    """The production-side hook: no-op unless ``name`` is armed.

    ``scope`` identifies the firing replica (see module docstring);
    scope-less armings match every firer.  Raises
    :class:`FaultInjected` (mode ``raise``), sleeps (mode ``sleep``),
    or returns an action tuple the site must implement — mode ``nan``
    returns ``("nan", slot_index)`` (the scheduler's step site poisons
    that slot's logits row) and mode ``hang`` returns
    ``("hang", seconds)`` (the step site sleeps AFTER stamping its
    watchdog heartbeat: a sleep inside trip() would stall *before* the
    heartbeat exists and the hung-step watchdog could never observe
    it; sites that don't implement ``hang`` ignore it).  Returns None
    for untripped passes.  The sleep happens OUTSIDE the registry lock
    so a slow point never blocks arming/disarming other points.
    """
    if not _points:  # fast path: nothing armed anywhere
        return None
    with _lock:
        fault = _lookup(name, scope)
        if fault is None or fault.remaining == 0:
            return None
        if fault.skip > 0:
            fault.skip -= 1
            return None
        if fault.remaining > 0:
            fault.remaining -= 1
        fault.fired += 1
        mode, delay = fault.mode, fault.delay
    if mode in ("sleep", "slow"):
        time.sleep(delay)
        return None
    if mode == "partition":
        _stall_partitioned(fault)
        return None
    if mode == "jitter":
        # deterministic per-fire pseudo-random delay in [0, delay):
        # advance the fault's own LCG under the lock (torn updates
        # would fork the sequence), sleep outside it
        with _lock:
            fault.lcg = (_LCG_A * fault.lcg + _LCG_C) % _LCG_M
            jittered = delay * fault.lcg / _LCG_M
        time.sleep(jittered)
        return None
    if mode in ("nan", "hang"):
        return (mode, int(delay) if mode == "nan" else delay)
    raise FaultInjected(name)


#: partition-stall poll cadence: coarse enough to be free, fine enough
#: that clear() releases a stalled fire within one human blink
_PARTITION_POLL_S = 0.02


def _stall_partitioned(fault):
    """``mode="partition"``'s stall: the half-open network shape
    ``slow`` doesn't model.  The connection was ACCEPTED and traffic
    flowed (``skip`` passes), then reads stop — no bytes, no RST, no
    error the firing site could surface — until the arming is
    :func:`clear`-ed (or replaced), or ``delay`` seconds pass when
    ``delay > 0`` (a bounded blackout).  Unlike ``raise`` the site
    never sees an exception, and unlike ``slow`` nothing trickles
    through while armed: the stall polls the registry OUTSIDE the lock
    so a partitioned point never blocks arming/disarming others, and a
    concurrent clear() releases every stalled fire promptly."""
    deadline = (time.monotonic() + fault.delay
                if fault.delay > 0 else None)
    while True:
        with _lock:
            if _points.get((fault.name, fault.scope)) is not fault:
                return  # healed: cleared or re-armed
        if deadline is not None and time.monotonic() >= deadline:
            return
        time.sleep(_PARTITION_POLL_S)


class injected:
    """Context manager: arm a point on enter, disarm on exit.

    >>> with fault_points.injected("scheduler.step"):
    ...     # the next decode step raises FaultInjected
    """

    def __init__(self, name, mode="raise", times=1, delay=0.0, scope=None,
                 skip=0):
        self._name = name
        self._scope = scope
        self._skip = skip
        self._args = (mode, times, delay)
        self.fault = None

    def __enter__(self):
        self.fault = install(self._name, *self._args, scope=self._scope,
                             skip=self._skip)
        return self.fault

    def __exit__(self, exc_type, exc, tb):
        clear(self._name, scope=self._scope)
        return False


def load_env(env=None):
    """Arm points from ``TPUSERVER_FAULTS`` (see module docstring)."""
    spec = (env if env is not None else os.environ).get(
        "TPUSERVER_FAULTS", "")
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        parts = entry.split(":")
        if len(parts) < 2:
            raise ValueError(
                "TPUSERVER_FAULTS entry {!r} needs at least "
                "'name:mode'".format(entry)
            )
        name, mode = parts[0], parts[1]
        name, _, scope = name.partition("@")
        times = int(parts[2]) if len(parts) > 2 else 1
        delay = float(parts[3]) if len(parts) > 3 else 0.0
        install(name, mode=mode, times=times, delay=delay,
                scope=scope or None)


load_env()
