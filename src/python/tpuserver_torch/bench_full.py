"""Full benchmark on the port: all five BASELINE.md target configs.

    python -m tpuserver_torch.bench_full [--configs 1,2,3,4,5] [--quick]

The port's counterpart of the repo's ``bench_full.py``, against the
port's own front ends (``tpuserver_torch.http_server`` and
``grpc_server``), run in this process, with CUDA regions
(``tpuserver_torch.cuda_shared_memory``) where the JAX bench uses XLA
ones:

  1. simple add/sub model, HTTP, sync, concurrency 1         (infer/sec, p50)
  2. ResNet-50 over gRPC: in-band vs system-shm vs CUDA-shm  (infer/sec, p50)
  3. DenseNet-121 over gRPC with CUDA-region inputs/outputs  (infer/sec, p50)
  4. BERT-base ensemble (tokenizer -> encoder), gRPC
     streaming, pipelined                                    (infer/sec)
  5. Llama decoupled token-by-token generation with the KV
     cache parked in a CUDA region                           (tokens/sec)

Each config prints ONE JSON line per measurement, key for key the JAX
bench's (``ROW_KEYS``):
  {"config": N, "metric": "...", "value": X, "unit": "...",
   "vs_baseline": Y|null, ...}

The clients are the port's perf analyzer backends
(``tpuserver_torch.perfanalyzer.client_backend``: ``HttpBackend`` on
``http.client``, ``GrpcBackend`` on a raw channel).  Everything runs on
the card unless ``--device cpu`` is given; without a card and without it
the run fails.  ``--quick`` shrinks windows for smoke runs (not for
reported numbers); ``--window-s`` and ``--windows`` set them outright.
A config that raises is reported on stderr as ``{"config", "error"}`` and
makes the exit code 1.

``main(argv, core=server, llama_params=params)`` benchmarks a server the
caller built (its front ends attach to it, and the last one's stop stops
it; the caller closes it) and, for config 5's direct rows, weights the
caller holds.
"""

import argparse
import dataclasses
import json
import os
import queue
import re
import statistics
import sys
import threading
import time
import traceback
import uuid

import numpy as np

from tpuserver_torch import resolve_device

BASELINES = {
    "simple_http": 1407.84,      # reference quick_start.md:94
    "simple_http_p50": 690,      # reference quick_start.md:96
    "resnet50_grpc": 165.8,      # benchmarking.md:121-129 (TF-Serving gRPC)
    "densenet_grpc": 159.8,      # benchmarking.md:196-204 (TorchServe HTTP)
}

#: config 5's served llama: the zoo's ``llama_max_seq``
LLAMA_MAX_SEQ = 512

_BASE = ("config", "metric", "value", "unit", "vs_baseline")
#: the keys of each kind of row, the JAX bench's ``_emit`` and summary
#: lines key for key (a CUDA region where it has an XLA one)
ROW_KEYS = {
    "simple_http": frozenset(_BASE + (
        "p50_usec", "p50_vs_baseline", "p90_usec", "p99_usec", "stable",
        "server_queue_usec", "server_compute_usec", "client_overhead_pct")),
    "vision": frozenset(_BASE + ("p50_usec",)),
    "vision_cuda_shm": frozenset(_BASE + (
        "p50_fenced_usec", "distinct_inputs_per_window", "value_fence")),
    "vision_concurrent": frozenset(_BASE + ("p50_usec",)),
    "vision_concurrent_best": frozenset(_BASE + ("batch", "concurrency")),
    "bert_stream": frozenset(_BASE + ("p50_usec",)),
    "bert_bound": frozenset(_BASE + (
        "tokenizer_only", "encoder_only", "encoder_mfu_at_stage_rate",
        "bound")),
    "llama_prefill": frozenset(_BASE + (
        "mfu", "suspect", "attn", "params", "chip")),
    "llama_decode": frozenset(_BASE + (
        "mfu", "mbu", "suspect", "chunk", "params", "weights", "chip")),
    "llama_stream": frozenset(_BASE + ("ttft_ms", "max_tokens")),
    "llama_multistream": frozenset(_BASE + (
        "streams", "per_stream_p50", "ttft_ms", "mbu", "max_tokens")),
    "llama_scaling": frozenset(_BASE + ("streams",)),
    "core_inband": frozenset(_BASE + ("p50_usec",)),
    "core_cuda_shm": frozenset(_BASE + (
        "distinct_inputs_per_window", "value_fence")),
    "core_ratio": frozenset(_BASE),
}

_ROW_KINDS = (
    (r"simple_http_sync_conc1$", "simple_http"),
    (r"(resnet50|densenet121)_grpc_(inband|system_shm)$", "vision"),
    (r"(resnet50|densenet121)_grpc_cuda_shm_hygienic_b\d+_conc\d+$",
     "vision_cuda_shm"),
    (r"(resnet50|densenet121)_grpc_async_b\d+_conc\d+$",
     "vision_concurrent"),
    (r"(resnet50|densenet121)_grpc_async_best$", "vision_concurrent_best"),
    (r"bert_ensemble_grpc_stream_pipelined$", "bert_stream"),
    (r"bert_ensemble_bound_analysis$", "bert_bound"),
    (r"\w+_prefill_T\d+$", "llama_prefill"),
    (r"\w+_decode_ctx\d+$", "llama_decode"),
    (r"llama_decoupled_stream$", "llama_stream"),
    (r"llama_multistream_conc\d+$", "llama_multistream"),
    (r"llama_multistream_scaling$", "llama_scaling"),
    (r"resnet50_core_inband$", "core_inband"),
    (r"resnet50_core_cuda_shm$", "core_cuda_shm"),
    (r"resnet50_core_cuda_vs_inband$", "core_ratio"),
)


def row_kind(metric):
    """The ``ROW_KEYS`` kind of a row's metric (None if unknown)."""
    for pattern, kind in _ROW_KINDS:
        if re.match(pattern, metric):
            return kind
    return None


def _measure(call, window_s, windows, warmup=20):
    """Median infer/sec over `windows` timed windows + overall p50 latency.

    The reference's methodology is 3 stable windows (perf_analyzer
    stability-percentage, inference_profiler.cc:780-833); here each window
    is fixed-duration and the reported rate is the median across windows.
    ``call`` receives a monotonically increasing iteration index so the
    workload can rotate DISTINCT inputs per iteration (hygiene rule 1).
    """
    seq = 0
    for _ in range(warmup):
        call(seq)
        seq += 1
    rates, lats = [], []
    for _ in range(windows):
        n = 0
        t0 = time.perf_counter()
        while True:
            t1 = time.perf_counter()
            call(seq)
            seq += 1
            lats.append(time.perf_counter() - t1)
            n += 1
            dt = time.perf_counter() - t0
            if dt >= window_s:
                break
        rates.append(n / dt)
    lats.sort()
    p50 = lats[len(lats) // 2] * 1e6
    return statistics.median(rates), p50


def _emit(config, metric, value, unit, baseline_key=None, **extra):
    base = BASELINES.get(baseline_key) if baseline_key else None
    line = {
        "config": config,
        "metric": metric,
        "value": round(value, 2),
        "unit": unit,
        "vs_baseline": round(value / base, 4) if base else None,
    }
    line.update(extra)
    print(json.dumps(line), flush=True)
    return line


def _host(array):
    """A response output as a numpy array (a tensor copied to the
    host)."""
    import torch

    from tpuserver_torch import cuda_shared_memory as csm

    if isinstance(array, torch.Tensor):
        return csm.to_host(array)
    return np.asarray(array)


# ---------------------------------------------------------------------------
# config 1: simple model, HTTP, sync, concurrency 1
# ---------------------------------------------------------------------------

def profile_simple_http(http_url, window_s, stability_windows, max_trials,
                        warmup_s):
    """Config 1's measurement: the port's ``HttpBackend`` through the
    perf analyzer's profiler at concurrency 1, its answers checked (a+b,
    a-b) before any timing; returns the profiler's result for the level.
    Shared by :func:`bench_simple_http` and ``tpuserver_torch.bench``."""
    from tpuserver_torch.perfanalyzer.client_backend import (
        HttpBackend,
        build_input_pool,
    )
    from tpuserver_torch.perfanalyzer.load_manager import ConcurrencyManager
    from tpuserver_torch.perfanalyzer.profiler import InferenceProfiler

    backend = HttpBackend(http_url)
    manager = None
    try:
        # correctness smoke before any timing: the profiled path must be
        # computing real answers
        a = np.arange(16, dtype=np.int32).reshape(1, 16)
        b = np.full((1, 16), 2, dtype=np.int32)
        out = backend.infer(backend.prepare(
            "simple", [{"INPUT0": a, "INPUT1": b}])[0])
        assert (out["OUTPUT0"] == a + b).all(), out
        assert (out["OUTPUT1"] == a - b).all(), out
        # rule 1 lives in build_input_pool: 16 distinct input sets
        # rotated across dispatches
        pool = build_input_pool(
            backend.model_metadata("simple"),
            backend.model_config("simple"),
            pool_size=16, batch_size=1)
        manager = ConcurrencyManager(
            backend, "simple", backend.prepare("simple", pool))
        profiler = InferenceProfiler(
            backend, "simple", manager,
            measurement_interval_s=window_s,
            stability_windows=stability_windows,
            max_trials=max_trials,
            warmup_s=warmup_s)
        return profiler.profile_level(1)
    finally:
        if manager is not None:
            manager.stop()
        backend.close()


def bench_simple_http(http_url, window_s, windows):
    """Config 1 on the perf analyzer's profiler: windowed measurement to
    3-window stability, client percentiles, and the server queue/compute
    breakdown — one JSON line."""
    res = profile_simple_http(http_url, window_s, min(3, windows),
                              max(2 * windows, 3), 0.3)
    return _emit(1, "simple_http_sync_conc1", res["throughput"],
                 "infer/sec", "simple_http",
                 p50_usec=round(res["p50_usec"], 1),
                 p50_vs_baseline=round(
                     res["p50_usec"] / BASELINES["simple_http_p50"], 4),
                 p90_usec=round(res["p90_usec"], 1),
                 p99_usec=round(res["p99_usec"], 1),
                 stable=res["stable"],
                 server_queue_usec=round(res["queue_usec"], 2),
                 server_compute_usec=round(res["compute_infer_usec"], 2),
                 client_overhead_pct=round(res["client_overhead_pct"], 1))


# ---------------------------------------------------------------------------
# configs 2/3: vision models over gRPC, in-band vs system shm vs CUDA shm
# ---------------------------------------------------------------------------

def _vision_call_inband(backend, model, imgs):
    """Rotates a pool of distinct pre-serialized inputs (rule 1); the
    response carries values in-band, so each call is self-fencing."""
    pool = backend.prepare(model, [{"INPUT": img} for img in imgs])

    def call(i):
        backend.infer(pool[i % len(pool)])
    return call, lambda: None


def _vision_call_system_shm(backend, model, imgs):
    """Each timed iteration writes a DISTINCT image into the region then
    infers — the honest system-shm workflow (host write + infer), not a
    parked constant.  Output returns in-band values (self-fencing); the
    input region is the data plane under test.  Its key is unique to the
    call (the model, this process and a random tag), so two runs on one
    host never share a file under ``/dev/shm``; each key made is appended
    to ``_vision_call_system_shm.keys``, which a caller's leak check
    reads."""
    from tpuserver_torch.perfanalyzer import system_shared_memory as shm
    from tpuserver_torch.perfanalyzer.client_backend import shm_input_ref

    in_bytes = imgs[0].nbytes
    region_in = "{}_in_{}_{}".format(model, os.getpid(), uuid.uuid4().hex[:8])
    key = "/" + region_in
    h_in = shm.create_shared_memory_region(region_in, key, in_bytes)
    _vision_call_system_shm.keys.append(key)
    try:
        backend.shm_register(region_in, "system", key=key,
                             byte_size=in_bytes)
    except Exception:
        shm.destroy_shared_memory_region(h_in)
        raise
    prepared = backend.prepare_shm(model, [{"INPUT": shm_input_ref(
        region_in, in_bytes, 0, "FP32", imgs[0].shape)}])[0]

    def call(i):
        shm.set_shared_memory_region(h_in, [imgs[i % len(imgs)]])
        backend.infer(prepared)

    def cleanup():
        try:
            backend.shm_unregister(region_in, "system")
        finally:
            shm.destroy_shared_memory_region(h_in)
    return call, cleanup


_vision_call_system_shm.keys = []


def _park_distinct_pool(csm, h_in, rng, slots, img_shape, img_bytes):
    """Fresh distinct images into every input slot (untimed; rule 1)."""
    pool = rng.rand(slots, *img_shape).astype(np.float32)
    for s in range(slots):
        csm.set_shared_memory_region(h_in, [pool[s]], offset=s * img_bytes)
    return pool


def _fence_and_verify(csm, h_out, out_shape, out_bytes, slots, sample_ids,
                      refs):
    """Window close (rule 2): value-fence the LAST slot (executions
    retire in dispatch order, so its values prove the whole window
    completed on-device), then — when references are given — check
    sampled slots against their own input's in-band result and require
    bit-level distinctness between samples (a replayed/cached answer
    would be bit-identical)."""
    last = csm.get_contents_as_numpy(
        h_out, np.float32, out_shape, offset=(slots - 1) * out_bytes)
    assert last.shape == tuple(out_shape)
    if refs is None:
        return
    checked = []
    for s in sample_ids:
        got = csm.get_contents_as_numpy(
            h_out, np.float32, out_shape, offset=s * out_bytes)
        np.testing.assert_allclose(got, refs[s], rtol=2e-2, atol=2e-3)
        checked.append(got)
    for a, b in zip(checked, checked[1:]):
        assert (np.asarray(a) != np.asarray(b)).any(), \
            "distinct inputs produced bit-identical outputs"


def bench_vision_cuda_shm(grpc_url, config, model, windows, infers_per_window,
                          concurrency=8, batch=1, device=None):
    """Hygienic CUDA-shm vision bench (the north-star rows).

    Obeys all five hygiene rules from docs/benchmarking.md:

    - **Rule 1/4 (distinct inputs)**: every timed dispatch reads a
      DISTINCT parked input — a fresh pool of ``infers_per_window``
      images is parked (untimed) before each window, never reused, so
      no (model, values) pair ever repeats in the whole run.
    - **Rule 2 (value fence)**: each window's clock stops only after
      ``get_contents_as_numpy`` of the LAST request's output slot —
      executions retire in dispatch order, so the last value fences the
      whole window.  After the clock, sampled slots are checked against
      in-band reference results computed before the window: values must
      match the slot's own input (content-cache or enqueue-rate
      inflation would fail here).
    - **Rule 5**: one full warmup window runs before timing.

    ``concurrency`` async requests ride in flight; ``batch`` images per
    parked slot fold into each dispatch.  Every request whose input is
    read from a CUDA region adds one to ``bench_vision_cuda_shm.
    dispatches``.
    """
    from tpuserver_torch import cuda_shared_memory as csm
    from tpuserver_torch.perfanalyzer.client_backend import (
        GrpcBackend,
        shm_input_ref,
    )

    baseline_key = "resnet50_grpc" if model == "resnet50" else "densenet_grpc"
    img_shape = (batch, 224, 224, 3)
    img_bytes = int(np.prod(img_shape)) * 4
    out_bytes = batch * 1000 * 4
    slots = max(1, infers_per_window // batch)
    region_in, region_out = (
        "{}_hcin_b{}".format(model, batch),
        "{}_hcout_b{}".format(model, batch),
    )
    backend = GrpcBackend(grpc_url)
    h_in = h_out = None
    registered = []
    rng = np.random.RandomState(1234)
    sample_ids = sorted({0, slots // 2, slots - 1})

    def park_pool():
        return _park_distinct_pool(
            csm, h_in, rng, slots, img_shape, img_bytes)

    def reference_logits(pool):
        """In-band results for the sampled slots (untimed, pre-window):
        the ground truth the fenced shm outputs must reproduce."""
        return {s: backend.infer(backend.prepare(
            model, [{"INPUT": pool[s]}])[0])["OUTPUT"] for s in sample_ids}

    def run_window(prepared, timed):
        pool = park_pool()
        refs = reference_logits(pool) if timed else None
        done = queue.Queue()

        def issue(s):
            bench_vision_cuda_shm.dispatches += 1
            backend.submit(prepared[s], done.put)

        t0 = time.perf_counter()
        inflight = 0
        next_slot = 0
        while next_slot < slots and inflight < concurrency:
            issue(next_slot)
            next_slot += 1
            inflight += 1
        while inflight:
            err = done.get(timeout=300)
            assert err is None, repr(err)
            inflight -= 1
            if next_slot < slots:
                issue(next_slot)
                next_slot += 1
                inflight += 1
        _fence_and_verify(
            csm, h_out, [batch, 1000], out_bytes, slots, sample_ids,
            refs if timed else None)
        return slots * batch / (time.perf_counter() - t0)

    try:
        # setup inside the try: a failed register must still release the
        # already-created regions and registrations, or one transient
        # error poisons every later invocation's region names
        h_in = csm.create_shared_memory_region(
            region_in, slots * img_bytes, device=device)
        h_out = csm.create_shared_memory_region(
            region_out, slots * out_bytes, device=device)
        for name, h in ((region_in, h_in), (region_out, h_out)):
            backend.shm_register(name, "cuda",
                                 raw_handle=csm.get_raw_handle(h),
                                 byte_size=h.byte_size,
                                 device_id=h.device_id)
            registered.append(name)
        # one prepared request per slot, serialized once (untimed)
        prepared = [backend.prepare_shm(
            model, [{"INPUT": shm_input_ref(
                region_in, img_bytes, s * img_bytes, "FP32", img_shape)}],
            [("OUTPUT", region_out, out_bytes, s * out_bytes)])[0]
            for s in range(slots)]

        run_window(prepared, timed=False)  # warmup: first-use work
        rates = [run_window(prepared, timed=True) for _ in range(windows)]

        # honest single-request latency: one dispatch, value-fenced
        park_pool()
        lats = []
        for s in range(min(slots, 16)):
            t0 = time.perf_counter()
            bench_vision_cuda_shm.dispatches += 1
            backend.infer(prepared[s])
            csm.get_contents_as_numpy(
                h_out, np.float32, [batch, 1000], offset=s * out_bytes)
            lats.append(time.perf_counter() - t0)
        lats.sort()
        return _emit(
            config, "{}_grpc_cuda_shm_hygienic_b{}_conc{}".format(
                model, batch, concurrency),
            statistics.median(rates), "infer/sec", baseline_key,
            p50_fenced_usec=round(lats[len(lats) // 2] * 1e6, 1),
            distinct_inputs_per_window=slots,
            value_fence="per-window drain + sampled in-band check")
    finally:
        for name in registered:
            try:
                backend.shm_unregister(name, "cuda")
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass
        for h in (h_in, h_out):
            if h is not None:
                csm.destroy_shared_memory_region(h)
        backend.close()


bench_vision_cuda_shm.dispatches = 0


def bench_vision(grpc_url, config, model, modes, window_s, windows):
    from tpuserver_torch.perfanalyzer.client_backend import GrpcBackend

    backend = GrpcBackend(grpc_url)
    imgs = [
        np.random.RandomState(s).rand(1, 224, 224, 3).astype(np.float32)
        for s in range(16)
    ]
    baseline_key = "resnet50_grpc" if model == "resnet50" else "densenet_grpc"
    makers = {
        "inband": _vision_call_inband,
        "system_shm": _vision_call_system_shm,
    }
    results = {}
    try:
        for mode in modes:
            call, cleanup = makers[mode](backend, model, imgs)
            try:
                call(0)  # smoke + first use
                rate, p50 = _measure(call, window_s, windows, warmup=5)
            finally:
                cleanup()
            results[mode] = _emit(
                config, "{}_grpc_{}".format(model, mode), rate,
                "infer/sec", baseline_key, p50_usec=round(p50, 1))
    finally:
        backend.close()
    return results


def bench_vision_concurrent(grpc_url, config, model, window_s, windows,
                            sweep=((1, 4), (1, 8), (1, 16), (1, 32),
                                   (4, 8), (8, 4))):
    """Async concurrency sweep for the vision configs.

    perf_analyzer's async mode: N in-flight requests amortize the round
    trip, and the server's dynamic batcher folds them into one batched
    dispatch.  Sweeps (client_batch, concurrency) pairs; reports each plus
    the best.
    """
    from tpuserver_torch.perfanalyzer.client_backend import GrpcBackend

    baseline_key = "resnet50_grpc" if model == "resnet50" else "densenet_grpc"
    best = None
    backend = GrpcBackend(grpc_url)
    try:
        for batch, conc in sweep:
            # rule 1: rotate distinct pre-serialized inputs; responses
            # carry values in-band, so each completion is self-fencing
            pool = backend.prepare(model, [
                {"INPUT": np.random.RandomState(1000 + s).rand(
                    batch, 224, 224, 3).astype(np.float32)}
                for s in range(16)])
            done = queue.Queue()
            issued = [0]

            def issue():
                t0 = time.perf_counter()
                req = pool[issued[0] % len(pool)]
                issued[0] += 1
                backend.submit(req, lambda error, t0=t0: done.put(
                    (error, time.perf_counter() - t0)))

            # warmup burst at the target concurrency, so the batch
            # bucket this level actually lands in is warm now, not
            # inside a measured window
            for _ in range(conc):
                issue()
            for _ in range(conc):
                err, _ = done.get(timeout=600)
                assert err is None, repr(err)

            rates, lats = [], []
            for _ in range(windows):
                inflight = 0
                completed = 0
                t0 = time.perf_counter()
                while inflight < conc:
                    issue()
                    inflight += 1
                while True:
                    err, lat = done.get(timeout=300)
                    assert err is None, repr(err)
                    completed += batch
                    inflight -= 1
                    lats.append(lat)
                    dt = time.perf_counter() - t0
                    if dt >= window_s:
                        break
                    issue()
                    inflight += 1
                while inflight:
                    err, _ = done.get(timeout=300)
                    assert err is None, repr(err)
                    inflight -= 1
                rates.append(completed / dt)
            lats.sort()
            line = _emit(
                config,
                "{}_grpc_async_b{}_conc{}".format(model, batch, conc),
                statistics.median(rates), "infer/sec", baseline_key,
                p50_usec=round(lats[len(lats) // 2] * 1e6, 1))
            if best is None or line["value"] > best["value"]:
                best = dict(line, batch=batch, concurrency=conc)
    finally:
        backend.close()
    if best is not None:
        print(json.dumps({
            "config": config,
            "metric": "{}_grpc_async_best".format(model),
            "value": best["value"], "unit": "infer/sec",
            "vs_baseline": best["vs_baseline"],
            "batch": best["batch"], "concurrency": best["concurrency"],
        }), flush=True)
    return best


# ---------------------------------------------------------------------------
# config 4: BERT ensemble, gRPC streaming, pipelined
# ---------------------------------------------------------------------------

class _Stream:
    """One long-lived ``ModelStreamInfer`` bidi stream on a
    ``GrpcBackend``'s channel: ``send`` enqueues a prepared request, every
    response (or the error that ended the stream) lands on ``responses``
    as ``(response, error)``."""

    _END = object()

    def __init__(self, backend):
        self._requests = queue.Queue()
        self.responses = queue.Queue()
        self._call = backend._calls["ModelStreamInfer"](
            iter(self._requests.get, self._END))
        self._reader = threading.Thread(target=self._read,
                                        name="bench-stream-reader",
                                        daemon=True)
        self._reader.start()

    def _read(self):
        import grpc

        try:
            for resp in self._call:
                self.responses.put((resp, resp.error_message or None))
        except grpc.RpcError as e:
            if e.code() != grpc.StatusCode.CANCELLED:
                self.responses.put((None, e))

    def send(self, request):
        self._requests.put(request)

    def close(self):
        self._requests.put(self._END)
        self._call.cancel()
        self._reader.join(timeout=10)


def bench_bert_stream(grpc_url, window_s, windows, attempts=2):
    """Pipelined streaming over a long-lived bidi stream; one retry with
    a fresh channel covers transient stream resets."""
    last_error = None
    for _ in range(attempts):
        try:
            return _bench_bert_stream_once(grpc_url, window_s, windows)
        except Exception as e:
            last_error = e
    raise last_error


def _bench_bert_stream_once(grpc_url, window_s, windows):
    from tpuserver_torch.perfanalyzer.client_backend import GrpcBackend

    backend = GrpcBackend(grpc_url)
    stream = _Stream(backend)
    done = stream.responses
    words = ("alpha", "brown", "crane", "delta", "ember", "frost",
             "grove", "heron")

    def issue(i):
        # rule 1: every request carries a DISTINCT text (the index is
        # woven into the token stream), so no (model, values) pair
        # repeats; responses return values in-band (self-fencing)
        text = "bench {} {} {}".format(
            i, words[i % len(words)], words[(i // len(words)) % len(words)]
        ).encode("utf-8")
        stream.send(backend.prepare("bert_ensemble", [
            {"TEXT": np.array([[text]], dtype=np.object_)}])[0])

    def issue_tokenizer(i):
        text = "stage {} {}".format(i, words[i % len(words)]).encode()
        stream.send(backend.prepare("bert_tokenizer", [
            {"TEXT": np.array([[text]], dtype=np.object_)}])[0])

    def issue_encoder(i):
        # distinct ids per request (rule 1); realistic token-id range
        ids = np.random.RandomState(i).randint(
            1000, 29000, (1, 128)).astype(np.int32)
        ids[0, 0] = 101
        mask = np.ones((1, 128), np.int32)
        stream.send(backend.prepare("bert_encoder", [
            {"INPUT_IDS": ids, "ATTENTION_MASK": mask}])[0])

    def pipelined_rate(issue_fn, inflight_target, record_lat=None):
        inflight = 0
        completed = 0
        t0 = time.perf_counter()
        sent_at = {}
        seq = 0
        while True:
            while inflight < inflight_target:
                sent_at[seq] = time.perf_counter()
                issue_fn(seq)
                seq += 1
                inflight += 1
            result, error = done.get(timeout=300)
            assert error is None, repr(error)
            completed += 1
            inflight -= 1
            if record_lat is not None:
                record_lat.append(
                    time.perf_counter() - sent_at.pop(completed - 1, t0))
            dt = time.perf_counter() - t0
            if dt >= window_s:
                break
        while inflight:
            result, error = done.get(timeout=300)
            assert error is None, repr(error)
            inflight -= 1
        return completed / dt

    try:
        # prime: the first request carries every first-use cost
        issue(0)
        result, error = done.get(timeout=600)
        assert error is None, repr(error)

        rates = []
        lat = []
        inflight_target = 8
        for _ in range(windows):
            rates.append(pipelined_rate(issue, inflight_target, lat))

        # stage accounting: measure each composing model at the same
        # inflight over the same stream, plus the encoder roofline
        issue_tokenizer(0)
        assert done.get(timeout=600)[1] is None
        tok_rate = pipelined_rate(issue_tokenizer, inflight_target)
        issue_encoder(0)
        assert done.get(timeout=600)[1] is None
        enc_rate = pipelined_rate(issue_encoder, inflight_target)
    finally:
        stream.close()
        backend.close()
    lat.sort()
    e2e = statistics.median(rates)
    line = _emit(4, "bert_ensemble_grpc_stream_pipelined", e2e,
                 "infer/sec", None,
                 p50_usec=round(lat[len(lat) // 2] * 1e6, 1))
    # bound analysis: encoder MFU at the measured stage rate, and which
    # stage the ensemble rate tracks
    from tpuserver_torch.ops import perf

    spec = perf.chip_spec()
    enc_flops = perf.bert_encoder_flops()
    stage_mfu = (
        round(perf.mfu(enc_flops * enc_rate, 1.0, spec), 4)
        if spec else None
    )
    bounds = {"tokenizer": tok_rate, "encoder": enc_rate}
    bound = min(bounds, key=lambda k: bounds[k])
    if e2e < 0.6 * min(tok_rate, enc_rate):
        # the ensemble runs far below BOTH stages: per-request dispatch/
        # stream overhead dominates, not either stage's compute
        bound = "dispatch"
    print(json.dumps({
        "config": 4, "metric": "bert_ensemble_bound_analysis",
        "value": round(e2e, 2), "unit": "infer/sec", "vs_baseline": None,
        "tokenizer_only": round(tok_rate, 2),
        "encoder_only": round(enc_rate, 2),
        "encoder_mfu_at_stage_rate": stage_mfu,
        "bound": bound,
    }), flush=True)
    return line


# ---------------------------------------------------------------------------
# config 5: llama decoupled generation, tokens/sec, KV parked in CUDA shm
# ---------------------------------------------------------------------------

def llama_config(name, attn_impl="kernel"):
    """The llama preset ``name`` (``tiny`` at the zoo's vocab 2048) with
    prefill attention ``attn_impl``."""
    from tpuserver_torch.models import llama

    cfg = (llama.PRESETS[name]() if name != "tiny"
           else llama.tiny(vocab=2048))
    return dataclasses.replace(cfg, attn_impl=attn_impl)


def llama_kv_bytes(cfg, max_seq=LLAMA_MAX_SEQ):
    """Bytes of the KV park of one sequence: the export layout
    ``[L, 2, 1, max_seq, Hkv, D]`` in the model's dtype."""
    import torch

    return (cfg.n_layers * 2 * max_seq * cfg.n_kv_heads * cfg.head_dim
            * torch.empty((), dtype=cfg.dtype).element_size())


def bench_llama_direct(cfg_name, windows, prefill_len=2048, chunk=32,
                       decode_ctx=512, max_seq=3072, attn_impl="kernel",
                       quantize=False, device=None, params=None):
    """Model-level llama numbers on the card: prefill wall-clock + MFU,
    steady-state decode tokens/sec + MFU + MBU (roofline accounting in
    ``tpuserver_torch/ops/perf.py``): real model dims, one prefill a
    prompt through the flash kernel, decode chunks through the decode
    kernel (the host syncs once a chunk), and utilization reported
    against the card's published peaks rather than bare rates.
    ``params`` serves weights the caller holds (else they are drawn from
    seed 0 on ``device``)."""
    import torch

    from tpuserver_torch.models import llama
    from tpuserver_torch.ops import perf, quant

    dev = resolve_device(device)
    cfg = llama_config(cfg_name, attn_impl)
    spec = perf.chip_spec(dev)
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(0)
        params = llama.init_params(cfg, gen, dev)
    if quantize and not quant.is_quantized(params["lm_head"]):
        params = llama.quantize_params(params)
    n_params = perf.param_count(cfg)
    weight_bytes = 1 if quantize else 2

    def prompt(seed, n):
        return torch.from_numpy(np.random.RandomState(seed).randint(
            0, cfg.vocab, (1, n)).astype(np.int64)).to(dev)

    # Measurement hygiene: (1) every timed iteration uses DISTINCT inputs,
    # and (2) the clock stops only after fetching result VALUES to the
    # host — values cannot lie.  An MFU/MBU above 1.0 is physically
    # impossible; emit would mean the guards failed.
    with torch.inference_mode():
        # prefill: K chained dispatches with distinct prompts; each
        # prompt's first token depends on the previous prefill's logits,
        # so one value fence at the end proves every dispatch completed
        cache = llama.init_kv_cache(cfg, 1, max_seq, dev)
        tokens0 = prompt(42, prefill_len)
        logits, cache = llama.prefill(params, cache, tokens0, cfg)  # warm
        logits.cpu()
        n_prefills = max(windows, 3)
        prompts = [prompt(i, prefill_len) for i in range(n_prefills)]
        lg = logits
        # warm the chain's own ops (argmax, the index write) too
        warm = tokens0.clone()
        warm[0, 0] = torch.argmax(lg[0]) % cfg.vocab
        lg, cache = llama.prefill(params, cache, warm, cfg)
        lg.cpu()
        t0 = time.perf_counter()
        for toks_i in prompts:
            toks_i[0, 0] = torch.argmax(lg[0]) % cfg.vocab
            lg, cache = llama.prefill(params, cache, toks_i, cfg)
        lg.cpu()  # single value fence for the chain
        t_prefill = (time.perf_counter() - t0) / n_prefills
        del cache
        pf = perf.prefill_flops(cfg, prefill_len)
        mfu_val = perf.mfu(pf, t_prefill, spec) if spec else None
        _emit(5, "{}_prefill_T{}".format(cfg_name, prefill_len),
              t_prefill * 1e3, "ms", None,
              mfu=round(mfu_val, 4) if mfu_val is not None else None,
              suspect=bool(mfu_val and mfu_val > 1.0),
              attn=cfg.attn_impl,
              params=n_params, chip=spec.name if spec else None)

        # steady-state decode from decode_ctx: chain MANY chunks and stop
        # the clock once on the final tokens — the cache/logits chain
        # forces every earlier chunk to have completed
        cache = llama.init_kv_cache(cfg, 1, max_seq, dev)
        logits, cache = llama.prefill(params, cache,
                                      prompt(7, decode_ctx), cfg)
        toks, _, logits, cache = llama.decode_chunk(
            params, cache, logits, decode_ctx, cfg, chunk)
        toks.cpu()  # first use + settle
        pos = decode_ctx + chunk
        n_chunks = max(2 * windows, 4)
        n_chunks = min(n_chunks, (max_seq - pos) // chunk)
        if n_chunks < 1:
            raise ValueError(
                "max_seq {} leaves no room to decode any {}-token chunk "
                "past context {}".format(max_seq, chunk, pos))
        t0 = time.perf_counter()
        for _ in range(n_chunks):
            toks, _, logits, cache = llama.decode_chunk(
                params, cache, logits, pos, cfg, chunk)
            pos += chunk
        toks.cpu()  # single value fence for the whole chain
        dt = time.perf_counter() - t0
        del cache
    rate = n_chunks * chunk / dt
    ctx_mid = decode_ctx + chunk * (n_chunks // 2)
    fpt = perf.decode_flops_per_token(cfg, ctx_mid)
    bpt = perf.decode_bytes_per_token(
        cfg, ctx_mid, weight_bytes_per_param=weight_bytes)
    mbu_val = perf.mbu(bpt * rate, 1.0, spec) if spec else None
    _emit(5, "{}_decode_ctx{}".format(cfg_name, ctx_mid), rate,
          "tokens/sec", None,
          mfu=round(perf.mfu(fpt * rate, 1.0, spec), 4) if spec else None,
          mbu=round(mbu_val, 4) if mbu_val is not None else None,
          suspect=bool(mbu_val and mbu_val > 1.0),
          chunk=chunk, params=n_params,
          weights="int8" if quantize else "bf16",
          chip=spec.name if spec else None)


def _generation_inputs(seed, max_tokens):
    # rule 1/4: a distinct prompt per call — an identical prompt would
    # make the whole greedy generation an identical (model, values)
    # replay a transport could cache
    return {"PROMPT_IDS": np.random.RandomState(seed).randint(
                1, 2000, (8,)).astype(np.int32),
            "MAX_TOKENS": np.array([max_tokens], dtype=np.int32)}


def bench_llama_stream(grpc_url, windows, max_tokens=64, kv_bytes=8 << 20,
                       device=None):
    """Single decoupled streams over gRPC; each timed one parks its KV
    cache in a CUDA region of ``kv_bytes`` (the export's size) through
    ``parameters={"kv_cache_region": ...}``.  A stream must yield
    ``max_tokens`` tokens."""
    from tpuserver_torch import cuda_shared_memory as csm
    from tpuserver_torch.perfanalyzer.client_backend import GrpcBackend

    backend = GrpcBackend(grpc_url)
    kv = None
    registered = False

    def generate(park, seed):
        params = {"kv_cache_region": "bench_kv"} if park else None
        t0 = time.perf_counter()
        first = None
        n = 0
        for count in backend.generate_stream(
                "llama_generate", _generation_inputs(seed, max_tokens),
                params):
            if first is None:
                first = time.perf_counter() - t0
            n += count
        assert n == max_tokens, (n, max_tokens)
        return n / (time.perf_counter() - t0), first

    try:
        kv = csm.create_shared_memory_region("bench_kv", kv_bytes,
                                             device=device)
        backend.shm_register("bench_kv", "cuda",
                             raw_handle=csm.get_raw_handle(kv),
                             byte_size=kv_bytes, device_id=kv.device_id)
        registered = True
        generate(False, 0)  # warmup
        rates, ttfts = [], []
        for w in range(windows):
            r, ttft = generate(True, 1 + w)
            rates.append(r)
            ttfts.append(ttft)
    finally:
        if registered:
            try:
                backend.shm_unregister("bench_kv", "cuda")
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass
        if kv is not None:
            csm.destroy_shared_memory_region(kv)
        backend.release_thread_resources()
        backend.close()
    return _emit(5, "llama_decoupled_stream", statistics.median(rates),
                 "tokens/sec", None,
                 ttft_ms=round(statistics.median(ttfts) * 1e3, 1),
                 max_tokens=max_tokens)


def bench_llama_multistream(grpc_url, cfg_name, windows, stream_counts,
                            max_tokens=64, quantize=False):
    """Config-5 continuous-batching rows: sustained generation over N
    CONCURRENT decoupled streams (each on a channel of its own), against
    a server running the scheduler (``--llama-slots >= max(streams)``).

    Reports per concurrency level: **aggregate tok/s** (total tokens over
    the round's wall clock), per-stream p50 tok/s (what one client
    feels), median TTFT, and MBU with the weight stream amortized over
    the batch (one batched decode step reads the weights ONCE for all
    active slots: bytes/step = weights + N * kv_row, steps/sec =
    aggregate / N).

    Hygiene: every stream in every round carries a DISTINCT prompt (rule
    1/4); token counts are exact (each counted token arrived as a
    decoupled response's VALUES); one full warmup round at max
    concurrency runs before timing (rule 5).
    """
    from tpuserver_torch.ops import perf
    from tpuserver_torch.perfanalyzer.client_backend import GrpcBackend

    cfg = llama_config(cfg_name)
    spec = perf.chip_spec()
    seed_counter = [0]
    backend = GrpcBackend(grpc_url)

    def one_stream(seed, n_tokens, out, errors, barrier):
        try:
            inputs = _generation_inputs(seed, n_tokens)
            barrier.wait(timeout=600)
            t0 = time.perf_counter()
            n, first = 0, None
            for count in backend.generate_stream("llama_generate", inputs):
                if first is None:
                    first = time.perf_counter() - t0
                n += count
            out.append((n, time.perf_counter() - t0, first))
        except Exception as e:  # noqa: BLE001 — reported by the round
            errors.append(e)
        finally:
            backend.release_thread_resources()

    def run_round(conc, n_tokens):
        out, errors = [], []
        barrier = threading.Barrier(conc + 1)
        # seeds assigned BEFORE spawning: rule 1's distinct-prompt
        # guarantee must not depend on thread interleaving
        threads = []
        for _ in range(conc):
            seed_counter[0] += 1
            threads.append(threading.Thread(
                target=one_stream,
                args=(seed_counter[0], n_tokens, out, errors, barrier),
                daemon=True))
        for t in threads:
            t.start()
        barrier.wait(timeout=600)
        t0 = time.perf_counter()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        if errors:
            raise errors[0]
        assert len(out) == conc, "a stream died"
        total = sum(n for n, _, _ in out)
        assert total == conc * n_tokens, (total, conc, n_tokens)
        return total / wall, out

    lines = []
    try:
        # warmup at max concurrency: first uses (the prefill at this
        # prompt length, the batched step) land before any timed round
        run_round(max(stream_counts), min(8, max_tokens))
        for conc in stream_counts:
            rates, per_stream, ttfts = [], [], []
            for _ in range(windows):
                agg, out = run_round(conc, max_tokens)
                rates.append(agg)
                per_stream.extend(n / dt for n, dt, _ in out)
                ttfts.extend(f for _, _, f in out if f is not None)
            per_stream.sort()
            ttfts.sort()
            agg = statistics.median(rates)
            mbu_val = None
            if spec is not None:
                # one batched step serves `conc` tokens: weights stream
                # once
                wb = 1 if quantize else 2
                ctx = 8 + max_tokens // 2
                kv_per_tok = perf.decode_bytes_per_token(
                    cfg, ctx, weight_bytes_per_param=wb
                ) - perf.matmul_params(cfg) * wb
                bytes_per_sec = (
                    agg / conc * perf.matmul_params(cfg) * wb
                    + agg * kv_per_tok
                )
                mbu_val = perf.mbu(bytes_per_sec, 1.0, spec)
            lines.append(_emit(
                5, "llama_multistream_conc{}".format(conc), agg,
                "tokens/sec", None,
                streams=conc,
                per_stream_p50=round(per_stream[len(per_stream) // 2], 2),
                ttft_ms=round(ttfts[len(ttfts) // 2] * 1e3, 1)
                if ttfts else None,
                mbu=round(mbu_val, 4) if mbu_val is not None else None,
                max_tokens=max_tokens,
            ))
    finally:
        backend.close()
    if len(lines) > 1:
        print(json.dumps({
            "config": 5, "metric": "llama_multistream_scaling",
            "value": round(lines[-1]["value"] / lines[0]["value"], 3),
            "unit": "x", "vs_baseline": None,
            "streams": "{}->{}".format(
                lines[0]["streams"], lines[-1]["streams"]),
        }), flush=True)
    return lines


def bench_vision_core(window_s, windows, infers_per_window=128, device=None):
    """Config-2 data-plane comparison at the server core (no sockets):
    in-band numpy input vs CUDA-region inputs with outputs delivered into
    a CUDA region.  Isolates the host<->device traffic the CUDA plane
    exists to remove.  Hygiene: distinct inputs per iteration on both
    arms; the in-band arm materializes result values per request
    (self-fencing), the shm arm drains each window through a value fence
    on the last slot + sampled correctness checks."""
    from tpuserver_torch import cuda_shared_memory as csm
    from tpuserver_torch.core import (
        InferenceServer,
        InferRequest,
        RequestedOutput,
    )
    from tpuserver_torch.models import serving_models

    dev = resolve_device(device)
    core = InferenceServer(serving_models(
        include_bert=False, include_llama=False, device=dev))
    h_in = h_out = None
    try:
        core.warmup()
        imgs = [
            np.random.RandomState(s).rand(1, 224, 224, 3).astype(np.float32)
            for s in range(16)
        ]
        rate_in, p50_in = _measure(
            lambda i: _host(core.infer(InferRequest(
                "resnet50", inputs={"INPUT": imgs[i % len(imgs)]}
            )).outputs[0][1]),
            window_s, windows, warmup=5)
        _emit(2, "resnet50_core_inband", rate_in, "infer/sec", None,
              p50_usec=round(p50_in, 1))

        slots = infers_per_window
        img_bytes, out_bytes = imgs[0].nbytes, 4000
        h_in = csm.create_shared_memory_region(
            "core_cin", slots * img_bytes, device=dev)
        h_out = csm.create_shared_memory_region(
            "core_cout", slots * out_bytes, device=dev)
        core.register_cuda_shm("core_cin", csm.get_raw_handle(h_in),
                               h_in.device_id, slots * img_bytes)
        core.register_cuda_shm("core_cout", csm.get_raw_handle(h_out),
                               h_out.device_id, slots * out_bytes)
        rng = np.random.RandomState(77)

        def run_window(timed):
            pool = _park_distinct_pool(
                csm, h_in, rng, slots, (1, 224, 224, 3), img_bytes)
            sample = sorted({0, slots // 2, slots - 1})
            refs = {
                s: _host(core.infer(InferRequest(
                    "resnet50", inputs={"INPUT": pool[s]})).outputs[0][1])
                for s in sample
            } if timed else None
            shm_reqs = []
            for s in range(slots):
                arr = core.read_shm_input(
                    "core_cin", img_bytes, s * img_bytes, "FP32",
                    [1, 224, 224, 3])
                shm_reqs.append(InferRequest(
                    "resnet50", inputs={"INPUT": arr},
                    requested_outputs=[RequestedOutput(
                        "OUTPUT", shm_region="core_cout",
                        shm_byte_size=out_bytes,
                        shm_offset=s * out_bytes)]))
            t0 = time.perf_counter()
            for req in shm_reqs:
                core.infer(req)
            _fence_and_verify(
                csm, h_out, [1, 1000], out_bytes, slots, sample, refs)
            return slots / (time.perf_counter() - t0)

        run_window(timed=False)
        rates = [run_window(timed=True) for _ in range(windows)]
        rate_shm = statistics.median(rates)
        _emit(2, "resnet50_core_cuda_shm", rate_shm, "infer/sec", None,
              distinct_inputs_per_window=slots,
              value_fence="window drain + sampled check")
        print(json.dumps({
            "config": 2, "metric": "resnet50_core_cuda_vs_inband",
            "value": round(rate_shm / rate_in, 4), "unit": "ratio",
            "vs_baseline": None,
        }), flush=True)
    finally:
        core.unregister_cuda_shm()
        for h in (h_in, h_out):
            if h is not None:
                csm.destroy_shared_memory_region(h)
        core.close()


def build_parser():
    ap = argparse.ArgumentParser(
        prog="python -m tpuserver_torch.bench_full",
        description=__doc__.split("\n")[0])
    ap.add_argument("--configs", default="1,2,3,4,5")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--window-s", type=float, default=None,
                    help="seconds a window (default 2.0; 0.5 with --quick)")
    ap.add_argument("--windows", type=int, default=None,
                    help="windows a measurement (default 5; 2 with "
                         "--quick)")
    ap.add_argument("--device", default=None,
                    help="device of the models and CUDA regions (default: "
                         "the card; 'cpu' for a CPU run)")
    ap.add_argument(
        "--llama-attn", default="kernel", choices=["dense", "kernel"],
        help="config-5 prefill attention (kernel = the CUDA flash kernel, "
             "dense = plain masked softmax)")
    ap.add_argument(
        "--llama-stream-only", action="store_true",
        help="config 5: skip the model-level direct bench (rerun only "
             "the served decoupled-stream measurement)")
    ap.add_argument(
        "--llama-quantize", action="store_true",
        help="config-5 int8 weight-only quantization")
    ap.add_argument(
        "--llama-config", default="llama3_8b",
        help="config-5 model preset (llama3_8b fits one H100's 80 GB in "
             "bf16; llama3_1b / tiny for smoke runs)")
    ap.add_argument(
        "--llama-slots", type=int, default=1,
        help="config-5 continuous-batching slots (1 = the single-stream "
             "path; >1 serves generations through the batched decode "
             "scheduler and adds the multi-stream sustained-generation "
             "rows at 1/4/8 concurrent streams)")
    ap.add_argument(
        "--core-only", action="store_true",
        help="config-2 data-plane comparison at the server core "
             "(no sockets; isolates the host<->device traffic)")
    return ap


def build_core(args, wanted, device, llama_params=None):
    """The server the configs in ``wanted`` need, warmed: the fixture
    models, and the serving zoo's vision, BERT and llama models."""
    from tpuserver_torch.core import InferenceServer
    from tpuserver_torch.models import default_models, serving_models
    from tpuserver_torch.models.llama_serving import LlamaGenerateModel

    models = default_models()
    if wanted & {2, 3, 4}:
        models += serving_models(
            include_vision=bool(wanted & {2, 3}),
            include_bert=4 in wanted, include_llama=False, device=device)
    if 5 in wanted:
        models.append(LlamaGenerateModel(
            cfg=llama_config(args.llama_config, args.llama_attn),
            max_seq=LLAMA_MAX_SEQ,
            decode_chunk=8 if args.quick else 32, params=llama_params,
            device=device, quantize=args.llama_quantize,
            max_slots=args.llama_slots))
    core = InferenceServer(models)
    # the llama model draws (and for --llama-quantize quantizes) its
    # weights at its first use: warm everything before any clock runs
    core.warmup()
    return core


def main(argv=None, core=None, llama_params=None):
    """Run the configs; returns the exit code (1 when a config raised).
    ``core``: a server to benchmark (the caller's, closed by the caller);
    ``llama_params``: weights for config 5's direct rows (and for the
    served llama of a core this builds)."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    window_s = args.window_s or (0.5 if args.quick else 2.0)
    windows = args.windows or (2 if args.quick else 5)
    if args.core_only:
        bench_vision_core(window_s, windows, device=device)
        return 0
    wanted = {int(c) for c in args.configs.split(",")}

    from tpuserver_torch.grpc_server import GrpcServer
    from tpuserver_torch.http_server import HttpServer

    failures = []
    if 5 in wanted and not args.llama_stream_only:
        # model-level numbers first: the cache used here is freed before
        # the served model's pool is built
        try:
            bench_llama_direct(
                args.llama_config, windows,
                prefill_len=256 if args.quick else 2048,
                chunk=8 if args.quick else 32,
                decode_ctx=64 if args.quick else 512,
                max_seq=512 if args.quick else 3072,
                attn_impl=args.llama_attn,
                quantize=args.llama_quantize, device=device,
                params=llama_params)
        except Exception as e:
            failures.append((5, e))

    own_core = core is None
    if own_core:
        core = build_core(args, wanted, device, llama_params)
    http = HttpServer(core, port=0).start()
    grpc_f = GrpcServer(core, port=0).start()
    grpc_url = "127.0.0.1:{}".format(grpc_f.port)
    http_url = "127.0.0.1:{}".format(http.port)
    try:
        if 1 in wanted:
            try:
                bench_simple_http(http_url, window_s, windows)
            except Exception as e:
                failures.append((1, e))
        ipw = 32 if args.quick else 192
        if 2 in wanted:
            try:
                bench_vision(grpc_url, 2, "resnet50",
                             ["inband", "system_shm"],
                             window_s, windows)
            except Exception as e:  # keep later configs running
                failures.append((2, e))
            for batch, conc in ((1, 8), (4, 8)) if not args.quick else (
                    (1, 4),):
                try:
                    bench_vision_cuda_shm(
                        grpc_url, 2, "resnet50", windows, ipw,
                        concurrency=conc, batch=batch, device=device)
                except Exception as e:
                    failures.append((2, e))
            try:
                bench_vision_concurrent(grpc_url, 2, "resnet50",
                                        window_s, windows)
            except Exception as e:
                failures.append((2, e))
        if 3 in wanted:
            for batch, conc in ((1, 8), (4, 8)) if not args.quick else (
                    (1, 4),):
                try:
                    bench_vision_cuda_shm(
                        grpc_url, 3, "densenet121", windows, ipw,
                        concurrency=conc, batch=batch, device=device)
                except Exception as e:
                    failures.append((3, e))
            try:
                bench_vision_concurrent(grpc_url, 3, "densenet121",
                                        window_s, windows,
                                        sweep=((1, 8), (1, 16), (8, 4)))
            except Exception as e:
                failures.append((3, e))
        if 4 in wanted:
            try:
                bench_bert_stream(grpc_url, window_s, windows)
            except Exception as e:
                failures.append((4, e))
        if 5 in wanted:
            try:
                bench_llama_stream(
                    grpc_url, windows,
                    max_tokens=16 if args.quick else 64,
                    kv_bytes=llama_kv_bytes(llama_config(args.llama_config)),
                    device=device)
            except Exception as e:
                failures.append((5, e))
            if args.llama_slots > 1:
                # continuous-batching rows: aggregate tok/s at 1/4/8
                # concurrent streams (clipped to the slot count)
                try:
                    bench_llama_multistream(
                        grpc_url, args.llama_config,
                        2 if args.quick else 3,
                        stream_counts=[
                            c for c in (1, 4, 8) if c <= args.llama_slots
                        ],
                        max_tokens=16 if args.quick else 64,
                        quantize=args.llama_quantize)
                except Exception as e:
                    failures.append((5, e))
    finally:
        grpc_f.stop()
        http.stop()
        if own_core:
            core.close()
    for config, err in failures:
        print(json.dumps({
            "config": config,
            "error": "".join(
                traceback.format_exception(type(err), err,
                                           err.__traceback__)
            ),
        }), file=sys.stderr, flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    sys.stderr.flush()
    # hard exit: library threads (grpc teardown) must not stall the
    # interpreter's shutdown after all results are flushed
    os._exit(code)
