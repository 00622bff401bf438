"""The port's perf analyzer harness (``tpuserver_torch.perfanalyzer``)
against the JAX package's (``perfanalyzer``) on the same seeded inputs,
and against the port's core in-process.

Tolerances: none.  The measurement math (percentiles, summaries,
stability verdicts, schedules, stat deltas, window merges, ranges) is the
same arithmetic on the same numbers, so it must be exactly equal; the
synthesized inputs and prompts are bitwise equal (BF16 compared as its
bits); the report's CSV header and JSON keys are equal as strings."""

import csv
import glob
import json
import threading
import time

import numpy as np
import pytest

from perfanalyzer import metrics as jmetrics
from perfanalyzer import profiler as jprofiler
from perfanalyzer import report as jreport
from perfanalyzer import schedule as jschedule
from perfanalyzer import stability as jstability
from perfanalyzer.client_backend import build_input_pool as jax_input_pool
from tpuserver.core import InferenceServer as JaxServer
from tpuserver.models import default_models as jax_default_models
from tpuserver_torch import cuda_shared_memory as csm
from tpuserver_torch.core import InferenceServer, Model, TensorSpec
from tpuserver_torch.models import default_models
from tpuserver_torch.perf_analyzer import build_generation_pool
from tpuserver_torch.perfanalyzer import metrics as tmetrics
from tpuserver_torch.perfanalyzer import profiler as tprofiler
from tpuserver_torch.perfanalyzer import report as treport
from tpuserver_torch.perfanalyzer import schedule as tschedule
from tpuserver_torch.perfanalyzer import stability as tstability
from tpuserver_torch.perfanalyzer import system_shared_memory as sysshm
from tpuserver_torch.perfanalyzer.client_backend import (
    InProcessBackend,
    ShmInferDataManager,
    build_input_pool,
    create_backend,
)
from tpuserver_torch.perfanalyzer.load_manager import ConcurrencyManager

pytestmark = pytest.mark.torch_port

# -- the measurement math: exactly equal -----------------------------------

_RNG = np.random.RandomState(15)
_SAMPLE = [float(v) for v in _RNG.exponential(0.004, size=257)]


def _stats_payload(queue_ns, infer_ns, count, executions):
    return {"model_stats": [{
        "name": "m", "version": "1", "inference_count": count,
        "execution_count": executions,
        "inference_stats": {
            "success": {"count": count, "ns": queue_ns + infer_ns},
            "fail": {"count": 1, "ns": 7},
            "queue": {"count": count, "ns": queue_ns},
            "compute_input": {"count": count, "ns": 11 * count},
            "compute_infer": {"count": count, "ns": infer_ns},
            "compute_output": {"count": count, "ns": 13 * count},
        }}]}


def _delta(m):
    before = m.server_stats_snapshot(_stats_payload(1000, 4000, 10, 3), "m")
    after = m.server_stats_snapshot(_stats_payload(3500, 10400, 25, 7), "m")
    delta = m.server_stats_delta(before, after)
    return delta, m.server_breakdown(delta)


def _verdicts(s, windows, pct, check_latency):
    det = s.StabilityDetector(pct, 3, check_latency=check_latency)
    out = []
    for tput, lat in windows:
        det.add_window(tput, lat)
        out.append((det.stable(), det.windows()))
    return out


_WINDOWS = {
    "converging": [(100, 5), (150, 9), (101, 5.1), (99, 5.0), (100.5, 4.9)],
    "trending": [(10 * i, 1.0) for i in range(1, 8)],
    "transient": [(100, 5), (300, 5), (100, 5), (101, 5), (99, 5)],
    "zero": [(0, 0)] * 4,
    "latency_drift": [(100, 1), (100, 2), (100, 3), (100, 4)],
}

_MATH_CASES = {
    "percentile": lambda m, s, sch, p: [
        m.percentile(_SAMPLE, q) for q in (0, 1, 37.5, 50, 90, 99, 99.9,
                                           100)] + [m.percentile([3.0], 50)],
    "latency_summary": lambda m, s, sch, p: (
        m.latency_summary(_SAMPLE), m.latency_summary([])),
    "stability_verdicts": lambda m, s, sch, p: {
        (name, check): _verdicts(s, w, 10.0, check)
        for name, w in _WINDOWS.items() for check in (True, False)},
    "schedule_constant": lambda m, s, sch, p: sch.take_gaps(
        "constant", 250.0, 50),
    "schedule_poisson": lambda m, s, sch, p: sch.take_gaps(
        "poisson", 400.0, 200, seed=15),
    "server_stats_delta": lambda m, s, sch, p: _delta(m),
    "client_overhead_pct": lambda m, s, sch, p: [
        m.client_overhead_pct(a, b) for a, b in
        ((100.0, 40.0), (100.0, 140.0), (0, 10.0), (None, 1.0))],
    "merge_window_records": lambda m, s, sch, p: m.merge_window_records(
        [(1.0, _SAMPLE[:100], 2), (0.5, _SAMPLE[100:150], 0),
         (1.25, _SAMPLE[150:], 1)]),
    "parse_range": lambda m, s, sch, p: [
        p.parse_range(t) for t in ("4", "1:4", "1:8:7", "2:10:3", 16)],
}


@pytest.mark.parametrize("case", sorted(_MATH_CASES))
def test_measurement_math_equals_jax(case):
    fn = _MATH_CASES[case]
    ours = fn(tmetrics, tstability, tschedule, tprofiler)
    theirs = fn(jmetrics, jstability, jschedule, jprofiler)
    assert ours == theirs


@pytest.mark.parametrize("text", ["0:4", "4:2", "1:4:0", "1:2:3:4"])
def test_parse_range_rejects_what_jax_rejects(text):
    for mod in (tprofiler, jprofiler):
        with pytest.raises(ValueError):
            mod.parse_range(text)


@pytest.mark.parametrize("make", [
    lambda core: create_backend("http", core=core),
    lambda core: create_backend("grpc", core=core),
    lambda core: create_backend("inprocess"),
    lambda core: ShmInferDataManager(InProcessBackend(core), "xla"),
], ids=["http", "grpc", "no_core", "xla_region"])
def test_only_the_in_process_backend_and_its_regions_exist(make):
    """The port drives its core in-process only (the socket backends stay
    with ``tools/perf_analyzer.py``), and its regions are system or
    CUDA ones."""
    core = InferenceServer(default_models())
    try:
        with pytest.raises(ValueError):
            make(core)
        assert isinstance(create_backend("inprocess", core=core),
                          InProcessBackend)
    finally:
        core.close()


# -- synthesized inputs: bitwise equal -------------------------------------


@pytest.fixture(scope="module")
def servers():
    port = InferenceServer(default_models())
    jax_core = JaxServer(jax_default_models())
    yield port, jax_core
    port.close()
    jax_core.close()


@pytest.mark.parametrize("model,batch,shapes,consts", [
    ("simple", 1, None, None),
    ("simple", 4, None, None),
    ("simple_string", 2, None, None),
    ("identity_fp32", 1, {"INPUT0": [37]}, None),
    ("identity_bf16", 1, {"INPUT0": [64]}, None),
    ("delayed_identity", 1, {"INPUT0": [16]}, {"DELAY_US": 2000}),
])
def test_build_input_pool_bitwise_jax(servers, model, batch, shapes,
                                      consts):
    port, jax_core = servers
    kwargs = dict(pool_size=5, batch_size=batch, shape_overrides=shapes,
                  const_overrides=consts, seed=15)
    ours = build_input_pool(port.model_metadata(model),
                            port.model_config(model), **kwargs)
    theirs = jax_input_pool(jax_core.model_metadata(model),
                            jax_core.model_config(model), **kwargs)
    assert len(ours) == len(theirs) == 5
    for a, b in zip(ours, theirs):
        assert sorted(a) == sorted(b)
        for name in a:
            want = b[name]
            if want.dtype.name == "bfloat16":
                # the port's wire rule: BF16 travels as its bits
                assert a[name].dtype == np.uint16
                want = want.view(np.uint16)
            assert a[name].dtype == want.dtype, name
            assert a[name].shape == want.shape, name
            if want.dtype == np.object_:
                assert a[name].tolist() == want.tolist()
            else:
                assert a[name].tobytes() == want.tobytes(), name


class _Args:
    def __init__(self, **kw):
        self.__dict__.update(kw)


@pytest.mark.parametrize("prompt_len,shared,seed", [
    (8, 0, 0), (512, 0, 3), (16, 24, 7)])
def test_build_generation_pool_bitwise_jax(prompt_len, shared, seed):
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location(
        "jax_perf_analyzer_cli", os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "tools", "perf_analyzer.py"))
    jax_cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_cli)
    metadata = {"inputs": [
        {"name": "PROMPT_IDS", "datatype": "INT32", "shape": [-1]},
        {"name": "MAX_TOKENS", "datatype": "INT32", "shape": [1]}]}
    args = _Args(seed=seed, input_pool=6, max_tokens=32,
                 prompt_len=prompt_len, shared_prefix_tokens=shared)
    ours = build_generation_pool(metadata, args)
    theirs = jax_cli.build_generation_pool(metadata, args)
    assert len(ours) == len(theirs) == 6
    for a, b in zip(ours, theirs):
        assert sorted(a) == sorted(b)
        for name in a:
            assert a[name].dtype == b[name].dtype
            assert a[name].tobytes() == b[name].tobytes()
    assert len({a["PROMPT_IDS"].tobytes() for a in ours}) == 6


# -- the report: equal headers and keys ------------------------------------


def _rows(generation):
    if generation:
        base = dict(mode="generation_concurrency", tokens=320,
                    generations=10, gen_per_sec=3.5, resumed_streams=0,
                    resume_events=0, ttft_avg_ms=30.25, ttft_p50_ms=29.0,
                    ttft_p99_ms=41.0, itl_p50_ms=60.125, itl_p90_ms=61.0,
                    itl_p99_ms=70.0, prefix_hit_pct=None,
                    spec_accept_per_step=None)
    else:
        base = dict(mode="concurrency", completed=400, p50_usec=900.5,
                    p90_usec=1000.0, p95_usec=1100.0, p99_usec=1500.0,
                    avg_usec=950.0, queue_usec=120.0,
                    compute_infer_usec=700.0, client_overhead_pct=11.5)
    return [dict(base, level=level, stable=level == 1, trials=4, errors=0,
                 throughput=100.0 * level, duration_s=3.0,
                 interrupted=False) for level in (1, 8)]


@pytest.mark.parametrize("generation", [False, True])
def test_report_header_and_keys_equal_jax(tmp_path, generation):
    rows = [tprofiler.ProfileResult(r) for r in _rows(generation)]
    ours = treport.ReportWriter("m", "inprocess", {"early_exit": True})
    theirs = jreport.ReportWriter("m", "inprocess", {"early_exit": True})
    assert ours.table(rows) == theirs.table(rows)
    ours.write_csv(tmp_path / "t.csv", rows)
    theirs.write_csv(tmp_path / "j.csv", rows)
    with open(tmp_path / "t.csv") as ft, open(tmp_path / "j.csv") as fj:
        assert list(csv.reader(ft)) == list(csv.reader(fj))
    assert ours.json_rows(rows) == theirs.json_rows(rows)
    ours.write_json(tmp_path / "t.json", rows)
    with open(tmp_path / "t.json") as f:
        assert [json.loads(line) for line in f] == theirs.json_rows(rows)


# -- against the port's core in-process ------------------------------------


class _SleepyBatchModel(Model):
    """Dynamic-batching host model whose execute sleeps: concurrent
    requests spend real time in the batching window (the queue bucket)
    and share one execution."""

    name = "sleepy_batch"
    platform = "python"
    backend = "python"
    device_kind = "cpu"
    max_batch_size = 8
    dynamic_batching = True
    max_queue_delay_us = 30_000
    inputs = (TensorSpec("IN", "FP32", [4]),)
    outputs = (TensorSpec("OUT", "FP32", [4]),)

    def __init__(self):
        self.calls = 0

    def execute(self, inputs, request):
        self.calls += 1
        time.sleep(0.02)
        return {"OUT": np.asarray(inputs["IN"]) * 2.0}


def test_queue_compute_split_is_per_success_on_a_batch():
    """The counterpart of ``test_perfanalyzer.py``'s
    ``test_core_splits_queue_from_compute``: four concurrent requests
    through the port's batcher.  The port counts one execution per
    batch, so the per-request breakdown must divide by successes: each
    request's compute is one 20 ms execute, not four."""
    model = _SleepyBatchModel()
    core = InferenceServer([model])
    backend = InProcessBackend(core)
    try:
        prepared = backend.prepare("sleepy_batch", [
            {"IN": np.full((1, 4), i, np.float32)} for i in range(4)])
        before = backend.stats_snapshot("sleepy_batch")
        threads = [threading.Thread(target=backend.infer, args=(p,))
                   for p in prepared]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        delta = tmetrics.server_stats_delta(
            before, backend.stats_snapshot("sleepy_batch"))
        assert delta["success_count"] == 4
        assert delta["inference_count"] == 4
        # one execution per model call: a batch counts once
        assert delta["execution_count"] == model.calls < 4
        assert delta["queue_ns"] > 4 * 1_000_000
        ours = tmetrics.server_breakdown(delta)
        assert ours == jmetrics.server_breakdown(delta)
        assert 20_000 <= ours["compute_infer_usec"] < 100_000
        assert ours["queue_usec"] > 1_000
    finally:
        backend.close()
        core.close()


class _GateModel(Model):
    """A host model that holds every request until the test opens the
    gate: the in-flight count is observable exactly."""

    name = "gate"
    platform = "python"
    backend = "python"
    device_kind = "cpu"
    inputs = (TensorSpec("X", "INT32", [1]),)
    outputs = (TensorSpec("Y", "INT32", [1]),)

    def __init__(self):
        self.gate = threading.Event()

    def execute(self, inputs, request):
        self.gate.wait(30)
        return {"Y": np.asarray(inputs["X"])}


def _poll(predicate, timeout_s=10.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.005)
    return predicate()


@pytest.mark.parametrize("level", [1, 3])
def test_concurrency_manager_holds_n_inflight_in_the_core(level):
    model = _GateModel()
    core = InferenceServer([model])
    backend = InProcessBackend(core, max_inflight=8)
    manager = ConcurrencyManager(backend, "gate", backend.prepare(
        "gate", [{"X": np.array([i], np.int32)} for i in range(4)]))
    try:
        manager.change_level(level)
        assert _poll(lambda: core.inflight_count() == level)
        # nothing completes: no further dispatch reaches the core
        time.sleep(0.1)
        assert core.inflight_count() == level
        assert manager.inflight() == level
        # open the gate: requests flow, never more than the level
        manager.collector.start_window()
        model.gate.set()
        peak = 0
        deadline = time.monotonic() + 0.3
        while time.monotonic() < deadline:
            peak = max(peak, core.inflight_count())
        latencies, errors = manager.collector.end_window()
        assert peak <= level
        assert errors == 0 and len(latencies) > level
    finally:
        model.gate.set()
        manager.stop()
        backend.close()
        core.close()


@pytest.mark.parametrize("kind", ["system", "cuda"])
def test_shm_staging_in_process_equals_in_band(kind):
    """The pool staged once into regions (CUDA ones as CPU regions here,
    which an in-process core attaches), outputs into an output region:
    every request's outputs equal the in-band ones; a CUDA region is read
    as a view (one zero-copy read a request); ``close()`` leaves no
    region behind."""
    core = InferenceServer(default_models())
    backend = InProcessBackend(core)
    shm = ShmInferDataManager(backend, kind, tag="t", device="cpu")
    try:
        metadata = backend.model_metadata("simple")
        pool = build_input_pool(metadata, backend.model_config("simple"),
                                pool_size=4, batch_size=2, seed=15)
        refs = shm.stage_input_sets(
            pool, {t["name"]: t["datatype"] for t in metadata["inputs"]})
        out_name, out_handle = shm.create_region("out", 2 * 128)
        out_refs = [("OUTPUT0", out_name, 128, 0),
                    ("OUTPUT1", out_name, 128, 128)]
        before = core.shm_stats()["shm_zero_copy_reads"]
        for inputs, prepared in zip(
                pool, backend.prepare_shm("simple", refs, out_refs)):
            inband = backend.infer(backend.prepare("simple", [inputs])[0])
            backend.infer(prepared)
            for j, (spec, array) in enumerate(inband.outputs):
                got = shm.read(out_handle, np.int32, [2, 16],
                               offset=128 * j)
                np.testing.assert_array_equal(got, array)
        reads = core.shm_stats()["shm_zero_copy_reads"] - before
        # simple has two inputs: two views a request
        assert reads == (2 * len(pool) if kind == "cuda" else 0)
        status = (core.system_shm_status() if kind == "system"
                  else core.cuda_shm_status())
        assert len(status) == 3  # INPUT0, INPUT1, out
    finally:
        shm.close()
        backend.close()
        core.close()
    assert not core.system_shm_status() and not core.cuda_shm_status()
    assert not glob.glob("/dev/shm/pa_{}*".format(shm.tag))
    assert not [k for k in sysshm.mapped_shared_memory_regions()
                if k.startswith("/pa_{}".format(shm.tag))]
    assert not [h for h in csm.allocated_shared_memory_regions()
                if h.name.startswith("pa_{}".format(shm.tag))]
