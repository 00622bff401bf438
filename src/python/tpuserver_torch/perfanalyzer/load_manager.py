"""Load managers: closed-loop concurrency and open-loop request rate.

Role of the reference's ``ConcurrencyManager`` / ``RequestRateManager``
(concurrency_manager.h:90, request_rate_manager.h; worker loop idiom of
concurrency_worker.cc:153-257): the concurrency manager maintains
exactly N requests in flight via a context free-list replenished by
completion callbacks; the request-rate manager sends on a fixed
schedule REGARDLESS of completions (open loop — what a real traffic
source does), with constant or Poisson gaps from
:func:`tpuserver_torch.perfanalyzer.schedule.schedule_distribution`.

Both record completions into a :class:`LoadCollector`, which the
profiler windows over.

The port's copy of ``perfanalyzer/load_manager.py``.
"""

import sys
import threading
import time

from tpuserver_torch.perfanalyzer.schedule import schedule_distribution


class LoadCollector:
    """Thread-safe completion sink with measurement-window gating.

    Completions that land outside an open window are dropped — the
    profiler only ever reasons about requests that completed inside the
    window it is measuring (reference ``TimestampVector`` semantics).
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._open = False       # guarded-by: _lock
        self._latencies = []     # guarded-by: _lock
        self._errors = 0         # guarded-by: _lock
        self._completions = 0    # guarded-by: _lock
        self._cond = threading.Condition(self._lock)

    def start_window(self):
        with self._lock:
            self._open = True
            self._latencies = []
            self._errors = 0
            self._completions = 0

    def end_window(self):
        """Close the window; returns ``(latencies_s, error_count)``."""
        with self._lock:
            self._open = False
            return self._latencies, self._errors

    def record(self, start_s, end_s, error):
        with self._lock:
            if not self._open:
                return
            self._completions += 1
            if error is None:
                self._latencies.append(end_s - start_s)
            else:
                self._errors += 1
            self._cond.notify_all()

    def wait_for_completions(self, count, timeout_s, early_exit=None):
        """Block until ``count`` completions land in the open window
        (count-windows measurement mode); returns the elapsed seconds.
        ``early_exit`` (a ``threading.Event``) truncates the wait —
        the two-stage SIGINT path."""
        t0 = time.perf_counter()
        deadline = t0 + timeout_s
        with self._lock:
            while self._completions < count:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                if early_exit is not None and early_exit.is_set():
                    break
                self._cond.wait(min(0.05, remaining))
        return time.perf_counter() - t0


class ConcurrencyManager:
    """Keeps exactly N requests in flight against one model.

    N *contexts* each own a rotating cursor into the prepared-request
    pool (distinct inputs per dispatch — hygiene rule 1).  Free context
    ids sit on a free-list; a dispatcher thread pops one, dispatches
    via ``backend.submit``, and the completion callback records the
    latency and pushes the id back — the reference's
    ``concurrency_worker.cc`` free-list + callback-wakeup shape, which
    holds the in-flight count at N without one thread per request.
    """

    mode = "concurrency"

    def __init__(self, backend, model, prepared, collector=None):
        if not prepared:
            raise ValueError("need at least one prepared request")
        self.backend = backend
        self.model = model
        self.prepared = list(prepared)
        self.collector = collector or LoadCollector()
        self._cond = threading.Condition()
        self._free = 0    # contexts on the free-list  # guarded-by: _cond
        # contexts in circulation (free + in flight)  # guarded-by: _cond
        self._live = 0
        self._target = 0    # guarded-by: _cond
        self._inflight = 0  # guarded-by: _cond
        self._stopping = False  # guarded-by: _cond
        self._cursor = 0    # guarded-by: _cond
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop,
            name="perfanalyzer-concurrency-dispatch", daemon=True)
        self._dispatcher.start()

    # -- the load level knob ----------------------------------------------

    def change_level(self, concurrency):
        """Reconfigure to exactly ``concurrency`` in-flight requests.

        Growing mints new contexts onto the free-list; shrinking drops
        free contexts immediately and retires in-flight ones as they
        complete (no cancellation — the reference drains the same
        way).  Levels may move in any order: contexts are fungible
        counters, so a shrink-then-grow re-mints what it needs."""
        if concurrency < 1:
            raise ValueError(
                "concurrency must be >= 1 (got {})".format(concurrency))
        with self._cond:
            self._target = int(concurrency)
            while self._live < self._target:
                self._free += 1
                self._live += 1
            while self._free > 0 and self._live > self._target:
                self._free -= 1
                self._live -= 1
            self._cond.notify_all()

    def _dispatch_loop(self):
        while True:
            with self._cond:
                while not self._stopping and not (
                        self._free > 0 and self._target > 0):
                    self._cond.wait()
                if self._stopping:
                    return
                self._free -= 1
                self._inflight += 1
                req = self.prepared[self._cursor % len(self.prepared)]
                self._cursor += 1
            start = time.perf_counter()

            def on_done(error, start=start):
                self.collector.record(start, time.perf_counter(), error)
                with self._cond:
                    self._inflight -= 1
                    if self._stopping or self._live > self._target:
                        self._live -= 1  # retire this context
                    else:
                        self._free += 1
                    self._cond.notify_all()

            try:
                self.backend.submit(req, on_done)
            except Exception as e:  # noqa: BLE001 — a failed dispatch
                # counts as a failed request, never a stuck context
                on_done(e)

    def inflight(self):
        with self._cond:
            return self._inflight

    def stop(self, timeout_s=30.0):
        """Stop dispatching and drain in-flight requests."""
        with self._cond:
            self._stopping = True
            self._target = 0
            self._cond.notify_all()
        self._dispatcher.join(timeout=5.0)
        deadline = time.monotonic() + timeout_s
        with self._cond:
            while self._inflight > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(min(0.1, remaining))


class RequestRateManager:
    """Open-loop sender: dispatches on the schedule no matter what.

    The schedule (constant or Poisson gaps) is laid out as absolute
    send times from the epoch of ``change_level``; the sender thread
    walks it, dispatching through ``backend.submit`` without waiting
    for completions — queueing delay under overload therefore shows up
    in the measured latency, which is the whole point of rate mode.
    """

    mode = "request_rate"

    def __init__(self, backend, model, prepared, distribution="constant",
                 seed=0, collector=None):
        if not prepared:
            raise ValueError("need at least one prepared request")
        self.backend = backend
        self.model = model
        self.prepared = list(prepared)
        self.distribution = distribution
        self.seed = seed
        self.collector = collector or LoadCollector()
        self._sender = None
        self._stop_event = threading.Event()
        self._inflight = 0  # guarded-by: _inflight_lock
        self._inflight_lock = threading.Lock()
        self._capacity_warned = False  # guarded-by: _inflight_lock

    def change_level(self, rate):
        """(Re)start the sender at ``rate`` requests/second."""
        if rate <= 0:
            raise ValueError("rate must be > 0 (got {})".format(rate))
        self._stop_sender()
        self._stop_event = threading.Event()
        self._sender = threading.Thread(
            target=self._send_loop, args=(float(rate), self._stop_event),
            name="perfanalyzer-rate-sender", daemon=True)
        self._sender.start()

    def _send_loop(self, rate, stop_event):
        gaps = schedule_distribution(self.distribution, rate, self.seed)
        epoch = time.perf_counter()
        next_send = epoch
        cursor = 0
        while not stop_event.is_set():
            next_send += next(gaps)
            while True:
                delay = next_send - time.perf_counter()
                if delay <= 0:
                    break
                if stop_event.wait(min(delay, 0.05)):
                    return
            req = self.prepared[cursor % len(self.prepared)]
            cursor += 1
            start = time.perf_counter()
            with self._inflight_lock:
                self._inflight += 1
                capacity = getattr(self.backend, "capacity", None)
                if (capacity is not None
                        and self._inflight >= capacity
                        and not self._capacity_warned):
                    # past this point dispatches queue INSIDE the
                    # backend and the loop is no longer open: the run
                    # stays valid for throughput but latencies include
                    # client-side queueing — say so once, loudly
                    self._capacity_warned = True
                    print(
                        "perf_analyzer warning: outstanding requests "
                        "reached the backend capacity ({}); the "
                        "schedule is no longer open-loop — resize "
                        "with --max-outstanding".format(capacity),
                        file=sys.stderr, flush=True)

            def on_done(error, start=start):
                self.collector.record(start, time.perf_counter(), error)
                with self._inflight_lock:
                    self._inflight -= 1

            try:
                self.backend.submit(req, on_done)
            except Exception as e:  # noqa: BLE001 — a failed dispatch is
                # a failed request; the schedule marches on
                on_done(e)

    def inflight(self):
        with self._inflight_lock:
            return self._inflight

    def _stop_sender(self):
        if self._sender is not None:
            self._stop_event.set()
            self._sender.join(timeout=5.0)
            self._sender = None

    def stop(self, timeout_s=30.0):
        self._stop_sender()
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._inflight_lock:
                if self._inflight == 0:
                    return
            time.sleep(0.02)
