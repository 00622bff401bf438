"""Generation mode: token-level metrics for decoupled/streaming models.

The serving-side scheduler exists to lift sustained generation
throughput; these are the client-side numbers that prove it: TTFT
(time-to-first-token), ITL (inter-token latency) percentiles, and
aggregate tokens/sec, measured over ``/generate_stream`` SSE, decoupled
gRPC streams, or the in-process core — whatever the backend speaks.

Same window/stability machinery as the scalar profiler: tokens are
counted the moment they ARRIVE (throughput is arrival-rate, not
completion-rate), while TTFT/ITL samples are attributed to the window
their generation completes in.

The port's copy of ``perfanalyzer/generation.py``: against a fleet
router each level also carries the router's counter deltas, as in
JAX's.  It keeps one count the JAX module does not:
:attr:`GenerationProfiler.stream_tokens`, the tokens of each completed
stream by load level, so a run shows that every stream returned what it
asked for.  It stays out of the report rows, which keep the JAX tool's
keys.
"""

import collections
import threading
import time

from tpuserver_torch.perfanalyzer import metrics
from tpuserver_torch.perfanalyzer.profiler import ProfileResult
from tpuserver_torch.perfanalyzer.stability import StabilityDetector


class _GenCollector:
    """Window-gated sink for token arrivals + completed generations."""

    def __init__(self):
        self._lock = threading.Lock()
        self._open = False  # guarded-by: _lock
        # counted window-open or not  # guarded-by: _lock
        self._lifetime_generations = 0
        self._reset_locked()

    def _reset_locked(self):
        self._tokens = 0             # guarded-by: _lock
        self._ttfts = []             # guarded-by: _lock
        self._itls = []              # guarded-by: _lock
        self._generations = 0        # guarded-by: _lock
        self._errors = 0             # guarded-by: _lock
        self._resumed_streams = 0    # guarded-by: _lock
        self._resume_events = 0      # guarded-by: _lock

    def start_window(self):
        with self._lock:
            self._open = True
            self._reset_locked()

    def end_window(self):
        with self._lock:
            self._open = False
            return {
                "tokens": self._tokens,
                "ttfts_s": self._ttfts,
                "itls_s": self._itls,
                "generations": self._generations,
                "errors": self._errors,
                "resumed_streams": self._resumed_streams,
                "resume_events": self._resume_events,
            }

    def record_tokens(self, count):
        with self._lock:
            if self._open:
                self._tokens += count

    def lifetime_generations(self):
        with self._lock:
            return self._lifetime_generations

    def record_generation(self, ttft_s, itls_s, error, resumes=0):
        with self._lock:
            self._lifetime_generations += 1
            if not self._open:
                return
            if resumes:
                # a stream that reconnected mid-generation is counted
                # even when it ultimately errored: under-chaos perf runs
                # must surface the degradation, not hide it behind the
                # transparent splice
                self._resumed_streams += 1
                self._resume_events += resumes
            if error is not None:
                self._errors += 1
                return
            self._generations += 1
            if ttft_s is not None:
                self._ttfts.append(ttft_s)
            self._itls.extend(itls_s)


class GenerationProfiler:
    """Concurrency-mode load + windowed stability for streamed
    generation.

    N worker threads each run back-to-back generations (closed loop at
    the *stream* level — the continuous-batching scheduler keeps N
    slots busy), rotating DISTINCT prompts from the prepared pool.
    Stability is judged on tokens/sec across ``stability_windows``
    consecutive windows.

    ``stream_tokens`` maps each load level to a ``Counter`` of the token
    counts of the streams completed at it (warm-up and the drain at the
    level's end included); it is final once the level's workers have
    stopped (the next level's start, or :meth:`stop`).
    """

    mode = "generation_concurrency"

    def __init__(self, backend, model, input_pool, parameters=None,
                 measurement_interval_s=1.0, stability_pct=10.0,
                 stability_windows=3, max_trials=10, warmup_s=0.0,
                 early_exit=None, verbose=False):
        if not backend.supports_generation:
            raise ValueError(
                "backend '{}' does not support generation mode".format(
                    backend.kind))
        if not input_pool:
            raise ValueError("need at least one prompt input set")
        self.backend = backend
        self.model = model
        self.input_pool = list(input_pool)
        # a callable builds per-stream parameters (the shm token-ring
        # mode hands every stream its own ring lane); a dict is shared
        self.parameters = (parameters if callable(parameters)
                           else dict(parameters or {}))
        self.measurement_interval_s = float(measurement_interval_s)
        self.stability_pct = float(stability_pct)
        self.stability_windows = int(stability_windows)
        self.max_trials = int(max_trials)
        self.warmup_s = float(warmup_s)
        self.early_exit = early_exit
        self.verbose = verbose
        self.collector = _GenCollector()
        self._workers = []
        self._level_baseline = 0
        self._stop_event = threading.Event()
        self._cursor_lock = threading.Lock()
        self._cursor = 0  # guarded-by: _cursor_lock
        self.stream_tokens = {}
        self._tokens_lock = threading.Lock()

    # -- workers -----------------------------------------------------------

    def _next_inputs(self):
        with self._cursor_lock:
            inputs = self.input_pool[self._cursor % len(self.input_pool)]
            self._cursor += 1
        return inputs

    def _worker_loop(self, stop_event, stream_tokens):
        try:
            while not stop_event.is_set():
                inputs = self._next_inputs()
                t0 = time.perf_counter()
                ttft = None
                prev = None
                itls = []
                error = None
                stream_stats = {}
                tokens = 0
                params = (self.parameters() if callable(self.parameters)
                          else self.parameters)
                try:
                    for count in self.backend.generate_stream(
                            self.model, inputs, params,
                            stats=stream_stats):
                        now = time.perf_counter()
                        if ttft is None:
                            ttft = now - t0
                        else:
                            itls.append(now - prev)
                        prev = now
                        tokens += count
                        self.collector.record_tokens(count)
                except Exception as e:  # noqa: BLE001 — a worker must
                    # never die silently mid-profile; the error (typed
                    # BackendError or not) is counted
                    error = e
                self.collector.record_generation(
                    ttft, itls, error,
                    resumes=stream_stats.get("resumes", 0))
                if error is None:
                    with self._tokens_lock:
                        stream_tokens[tokens] += 1
        finally:
            self.backend.release_thread_resources()

    def _set_workers(self, concurrency):
        self._stop_workers()
        # baseline AFTER the old level's workers drained and BEFORE the
        # new ones start: the warmup gate must see a completion from
        # THIS level, not the previous level's final generations
        self._level_baseline = self.collector.lifetime_generations()
        self._stop_event = threading.Event()
        stream_tokens = self.stream_tokens.setdefault(
            concurrency, collections.Counter())
        self._workers = [
            threading.Thread(
                target=self._worker_loop,
                args=(self._stop_event, stream_tokens),
                name="perfanalyzer-gen-{}".format(i), daemon=True)
            for i in range(concurrency)
        ]
        for w in self._workers:
            w.start()

    def _stop_workers(self):
        if self._workers:
            self._stop_event.set()
            # workers finish their CURRENT generation then exit; joining
            # bounds the wait so a wedged stream cannot hang the sweep
            for w in self._workers:
                w.join(timeout=120.0)
            self._workers = []

    # -- profiling ---------------------------------------------------------

    def change_level(self, concurrency):
        self._set_workers(int(concurrency))

    def _run_window(self):
        self.collector.start_window()
        t0 = time.perf_counter()
        deadline = t0 + self.measurement_interval_s
        while True:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            if self.early_exit is not None and self.early_exit.is_set():
                break
            time.sleep(min(0.05, remaining))
        duration = time.perf_counter() - t0
        window = self.collector.end_window()
        window["duration_s"] = duration
        return window

    def profile_level(self, level):
        self.change_level(level)
        # warmup waits for a COMPLETED generation at THIS level, not
        # just wall time: the first stream at a new level can carry
        # one-time costs (a scheduler's first steps, a kernel's first
        # launch) that dwarf every window, then settles to the
        # configured warmup
        seen = self._level_baseline
        deadline = time.monotonic() + 120.0
        while (self.collector.lifetime_generations() <= seen
               and time.monotonic() < deadline):
            if self.early_exit is not None and self.early_exit.is_set():
                break
            time.sleep(0.02)
        if self.warmup_s > 0:
            if self.early_exit is not None:
                self.early_exit.wait(self.warmup_s)
            else:
                time.sleep(self.warmup_s)
        detector = StabilityDetector(
            self.stability_pct, self.stability_windows,
            check_latency=False)
        router_before = self.backend.router_snapshot()
        # radix prefix-cache counters: the level delta becomes the
        # report's hit-rate column — post-warmup, so the first
        # admissions stay out of the rate
        prefix_before = self.backend.prefix_cache_snapshot()
        # speculative-decoding counters: the level delta becomes the
        # accepted-per-step and draft-hit-rate columns
        spec_before = self.backend.spec_snapshot()
        windows = []
        stable = False
        interrupted = False
        for trial in range(self.max_trials):
            window = self._run_window()
            if window["duration_s"] <= 0:
                continue
            windows.append(window)
            tok_rate = window["tokens"] / window["duration_s"]
            detector.add_window(tok_rate, 0.0)
            if self.verbose:
                print("  trial {:2d}: {:8.1f} tokens/sec".format(
                    trial + 1, tok_rate), flush=True)
            if self.early_exit is not None and self.early_exit.is_set():
                interrupted = True
                break
            if len(windows) >= self.stability_windows and detector.stable():
                stable = True
                break
        merged = windows[-self.stability_windows:]
        duration = sum(w["duration_s"] for w in merged)
        tokens = sum(w["tokens"] for w in merged)
        ttfts = [t for w in merged for t in w["ttfts_s"]]
        itls = [t for w in merged for t in w["itls_s"]]
        generations = sum(w["generations"] for w in merged)
        errors = sum(w["errors"] for w in merged)
        result = ProfileResult(
            mode=self.mode,
            level=level,
            stable=stable,
            interrupted=interrupted,
            trials=len(windows),
            throughput=tokens / duration if duration > 0 else 0.0,
            tokens=tokens,
            generations=generations,
            gen_per_sec=generations / duration if duration > 0 else 0.0,
            errors=errors,
            # streams that transparently reconnected+resumed mid-
            # generation (and the raw reconnect count): nonzero under
            # chaos means the transport is degrading even when every
            # token was ultimately delivered
            resumed_streams=sum(w["resumed_streams"] for w in merged),
            resume_events=sum(w["resume_events"] for w in merged),
            duration_s=duration,
        )
        metrics.attach_router_delta(result, router_before,
                                    self.backend.router_snapshot())
        prefix_after = self.backend.prefix_cache_snapshot()
        if prefix_before is not None and prefix_after is not None:
            # counters are cumulative; max() guards a scheduler rebuilt
            # mid-level, whose counts start again at 0
            dh = max(0, prefix_after["hits"] - prefix_before["hits"])
            dm = max(0, prefix_after["misses"] - prefix_before["misses"])
            result["prefix_cache_hits"] = dh
            result["prefix_cache_misses"] = dm
            result["prefix_hit_pct"] = (
                100.0 * dh / (dh + dm) if dh + dm else None)
        spec_after = self.backend.spec_snapshot()
        if spec_before is not None and spec_after is not None:
            ds = max(0, spec_after["steps"] - spec_before["steps"])
            dp = max(0, spec_after["proposed"] - spec_before["proposed"])
            da = max(0, spec_after["accepted"] - spec_before["accepted"])
            result["spec_steps"] = ds
            result["spec_proposed"] = dp
            result["spec_accepted"] = da
            # bonus + accepted drafts per speculative step (> 1 is the
            # win; None when the window never speculated)
            result["spec_accept_per_step"] = (
                (ds + da) / ds if ds else None)
            result["spec_hit_pct"] = (
                100.0 * da / dp if dp else None)
        for prefix, sample in (("ttft", ttfts), ("itl", itls)):
            if sample:
                ms = sorted(v * 1e3 for v in sample)
                result[prefix + "_avg_ms"] = sum(ms) / len(ms)
                for p in (50, 90, 95, 99):
                    result["{}_p{}_ms".format(prefix, p)] = (
                        metrics.percentile(ms, p, presorted=True))
            else:
                result[prefix + "_avg_ms"] = None
                for p in (50, 90, 95, 99):
                    result["{}_p{}_ms".format(prefix, p)] = None
        return result

    def sweep(self, levels):
        results = []
        try:
            for level in levels:
                if (self.early_exit is not None
                        and self.early_exit.is_set()):
                    break
                results.append(self.profile_level(level))
                if results[-1]["interrupted"]:
                    break
        finally:
            self.stop()
        return results

    def stop(self):
        self._stop_workers()
