"""The port's metrics plane on the CPU: ``tpuserver_torch.metrics``
against ``tpuserver.metrics`` on the same operations, the ``tpu_*``
families of the port's core against the JAX core's after the same
traffic (float32 ``tiny``, ``init_params(PRNGKey(0))`` bridged by
``params_from_jax``), ``GET /metrics`` against the gRPC
``ServerMetrics`` unary, and perf_analyzer's ``/metrics`` probes against
the port."""

import dataclasses
import http.client

import grpc
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perfanalyzer.client_backend import HttpBackend
from tpuserver import metrics as jax_metrics
from tpuserver import shm_ring as jax_shm_ring
from tpuserver.core import InferenceServer as JaxServer
from tpuserver.core import InferRequest as JaxRequest
from tpuserver.models import llama as jl
from tpuserver.models.llama_serving import LlamaGenerateModel as JaxLlama
from tpuserver_torch import metrics as port_metrics
from tpuserver_torch import shm_ring as port_shm_ring
from tpuserver_torch.core import InferenceServer, InferRequest
from tpuserver_torch.grpc_proto import grpc_service_pb2 as pb
from tpuserver_torch.grpc_proto import service
from tpuserver_torch.grpc_server import GrpcServer
from tpuserver_torch.http_server import HttpServer
from tpuserver_torch.models import llama as tl
from tpuserver_torch.models.llama_serving import LlamaGenerateModel

pytestmark = pytest.mark.torch_port

VOCAB = 512
MAX_SEQ = 64
PROMPTS = [np.array(p, np.int32) for p in (
    [3, 1, 4, 1, 5], [9, 8, 7], [2, 7, 1, 8, 2, 8])]
BUDGETS = [8, 6, 7]
#: the port's data-plane families, which the JAX core has no twin of
PORT_ONLY = {
    "tpu_shm_zero_copy_reads_total", "tpu_kv_exports_made_total",
    "tpu_kv_exports_attached_total", "tpu_kv_exports_dropped_total",
    "tpu_scheduler_attach_admissions_total",
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread per process: tiny steps stay short when
    several test processes share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- the registry, module against module -------------------------------------


def _counters(m):
    reg = m.MetricsRegistry()
    fam = reg.counter("tpu_requests_total", labelnames=("verb",))
    fam.labels(verb="infer").inc()
    fam.labels(verb="stream_infer").inc(3)
    reg.counter("tpu_shm_bytes_read_total").labels().inc(4096)
    return reg


def _gauges(m):
    reg = m.MetricsRegistry()
    g = reg.gauge("tpu_inflight_requests").labels()
    g.set(5)
    g.inc(2)
    g.dec()
    reg.gauge("tpu_scheduler_pending", labelnames=("model",)).labels(
        model="llama_generate").set(0.25)
    return reg


def _histograms(m):
    reg = m.MetricsRegistry()
    h = reg.histogram("tpu_request_seconds", labelnames=("verb",))
    for v in (0.00005, 0.003, 0.003, 0.7, 42.0):
        h.labels(verb="stream_infer").observe(v)
    return reg


def _single_writer(m):
    reg = m.MetricsRegistry()
    h = reg.histogram("tpu_scheduler_step_seconds", labelnames=("model",),
                      single_writer=True, buckets=(0.01, 0.1, 1.0))
    for v in (0.005, 0.05, 0.5, 5.0, 0.01):
        h.labels(model="m").observe(v)
    return reg


def _collectors(m):
    reg = m.MetricsRegistry()
    reg.counter("tpu_requests_total", labelnames=("verb",)).labels(
        verb="infer").inc()
    reg.register_collector(lambda: [
        ("tpu_scheduler_tokens_total", [({"model": "a"}, 7),
                                        ({"model": "b"}, 0)]),
        ("tpu_spec_accept_per_step", [({"model": "a"}, 1.375)]),
        ("tpu_requests_total", [({"verb": "dup"}, 1)]),  # owned wins
        ("not_declared", [({}, 1)]),                     # skipped
    ])

    def dying():
        raise RuntimeError("a collector that fails is skipped")

    reg.register_collector(dying)
    return reg


def _escaping(m):
    reg = m.MetricsRegistry()
    reg.counter("tpu_request_errors_total",
                labelnames=("verb", "code")).labels(
        verb='we"ird\\na\nme', code=429).inc()
    return reg


@pytest.mark.parametrize("ops", [_counters, _gauges, _histograms,
                                 _single_writer, _collectors, _escaping],
                         ids=lambda f: f.__name__.strip("_"))
def test_registry_renders_and_parses_as_jax_does(ops):
    """The same operations on each package's registry render the same
    exposition, and ``parse_prometheus_text`` reads it the same way."""
    ours, theirs = ops(port_metrics).render(), ops(jax_metrics).render()
    assert ours == theirs
    assert port_metrics.parse_prometheus_text(ours) == \
        jax_metrics.parse_prometheus_text(theirs)


def test_registry_rules_match_jax():
    """Unknown names, a wrong type and a re-registration with another
    shape are refused in both; ``is_cumulative`` agrees; the port's
    catalog is JAX's plus its own data-plane families."""
    for m in (port_metrics, jax_metrics):
        reg = m.MetricsRegistry()
        with pytest.raises(ValueError, match="not declared"):
            reg.counter("tpu_nope_total")
        with pytest.raises(ValueError, match="declared as a counter"):
            reg.gauge("tpu_requests_total")
        reg.counter("tpu_requests_total", labelnames=("verb",))
        with pytest.raises(ValueError, match="different shape"):
            reg.counter("tpu_requests_total", labelnames=("model",))
    for name, kind in (("a_total", None), ("a_count", None), ("a", None),
                       ("a", "counter"), ("a", "histogram"), ("a", "gauge")):
        assert port_metrics.is_cumulative(name, kind) == \
            jax_metrics.is_cumulative(name, kind)
    assert set(port_metrics.CATALOG) - set(jax_metrics.CATALOG) == PORT_ONLY
    assert {k: v for k, v in port_metrics.CATALOG.items()
            if k not in PORT_ONLY} == jax_metrics.CATALOG


# -- the cores after the same traffic ----------------------------------------


def _cfgs():
    return (dataclasses.replace(jl.tiny(vocab=VOCAB), dtype=jnp.float32),
            dataclasses.replace(tl.tiny(vocab=VOCAB), dtype=torch.float32))


def _drive(core, request_cls):
    """The same traffic on either core: three generations in turn, one
    resume of the last's completed tail, one request for an unknown
    model (a counted 404)."""
    def run(parameters, model="llama_generate", prompt=PROMPTS[0], n=2):
        req = request_cls(model, inputs={
            "PROMPT_IDS": prompt, "MAX_TOKENS": np.array([n], np.int32)},
            parameters=parameters)
        return list(core.infer_stream(req))

    for i, (p, n) in enumerate(zip(PROMPTS, BUDGETS)):
        assert len(run({"generation_id": "m{}".format(i)}, prompt=p,
                       n=n)) == n
    assert len(run({"resume_generation_id": "m2", "resume_from_seq": 4},
                   prompt=PROMPTS[2], n=BUDGETS[2])) == BUDGETS[2] - 4
    with pytest.raises(Exception) as info:
        run({}, model="nope")
    assert info.value.code == 404


def _families(text):
    """``{name: (type, label names, {labels: value})}`` of the ``tpu_*``
    families (histograms by their ``_count`` samples)."""
    out = {}
    for name, fam in port_metrics.parse_prometheus_text(text).items():
        if not name.startswith("tpu_"):
            continue
        labelnames = set()
        values = {}
        for sample, labels, value in fam["samples"]:
            labelnames.update(k for k in labels if k != "le")
            if fam["type"] == "histogram" and not sample.endswith("_count"):
                continue
            values[tuple(sorted(labels.items()))] = value
        out[name] = (fam["type"], tuple(sorted(labelnames)), values)
    return out


#: counted per process in both packages, so other tests that ran in the
#: same process (a torn-read fallback test) may already have moved it
PROCESS_WIDE = "tpu_shm_ring_torn_total"


@pytest.fixture(scope="module")
def torn_before():
    """Each package's process-wide torn-ring-read count before the
    traffic."""
    return {"port": port_shm_ring.torn_total(),
            "jax": jax_shm_ring.torn_total()}


@pytest.fixture(scope="module")
def cores_after_traffic(torn_before):
    """(the port's core, its model, the JAX core), each ``max_slots=3``
    on the same weights, after ``_drive``."""
    jcfg, tcfg = _cfgs()
    tparams = tl.params_from_jax(jax.tree_util.tree_map(
        np.asarray, jl.init_params(jax.random.PRNGKey(0), jcfg)), "cpu")
    jax_core = JaxServer([JaxLlama(cfg=jcfg, max_seq=MAX_SEQ, max_slots=3,
                                   spec_tokens=0)])
    model = LlamaGenerateModel(cfg=tcfg, max_seq=MAX_SEQ, max_slots=3,
                               params=tparams, device="cpu")
    core = InferenceServer([model])
    try:
        _drive(jax_core, JaxRequest)
        _drive(core, InferRequest)
        yield core, model, jax_core
    finally:
        core.close()
        jax_core.close()


def test_tpu_families_and_counters_match_jax(cores_after_traffic,
                                             torn_before):
    """Every ``tpu_*`` family the JAX core serves after the traffic, the
    port's core serves with the same type and label names (plus its own
    data-plane families), and every counter and histogram count holds
    the same values: requests and typed errors per verb, admissions,
    tokens, replay hits, restarts, sheds, prefix-cache tokens, the queue
    and step histograms (the process-wide torn-read count as what the
    traffic added)."""
    core, model, jax_core = cores_after_traffic
    ours = _families(core.metrics_text())
    theirs = _families(jax_core.metrics_text())
    for fams, side in ((ours, "port"), (theirs, "jax")):
        kind, labels, values = fams[PROCESS_WIDE]
        fams[PROCESS_WIDE] = (kind, labels, {
            k: v - torn_before[side] for k, v in values.items()})
    assert set(ours) - set(theirs) == PORT_ONLY
    assert set(theirs) <= set(ours)
    for name, (kind, labels, values) in theirs.items():
        assert ours[name][:2] == (kind, labels), name
        if kind in ("counter", "histogram"):
            assert ours[name][2] == values, name
    stats = model.scheduler_stats()
    key = (("model", "llama_generate"),)
    # a completed tail replays without an admission
    assert ours["tpu_scheduler_admissions_total"][2][key] == \
        stats["admitted"] == 3
    assert ours["tpu_scheduler_tokens_total"][2][key] == stats["tokens"]
    assert ours["tpu_scheduler_replay_hits_total"][2][key] == 1
    assert ours["tpu_scheduler_queue_wait_seconds"][2][key] == 3
    assert ours["tpu_request_errors_total"][2] == {
        (("code", "404"), ("verb", "stream_infer")): 1}


def test_model_statistics_and_nv_counts(cores_after_traffic):
    """The streaming verb records the model's statistics: one execution
    per completed generation, as the JAX core records them, and the
    ``nv_inference_*`` lines carry them."""
    core, _, jax_core = cores_after_traffic
    ours = core.model_statistics("llama_generate")["model_stats"][0]
    theirs = jax_core.model_statistics("llama_generate")["model_stats"][0]
    for key in ("name", "version", "inference_count", "execution_count"):
        assert ours[key] == theirs[key], key
    assert ours["inference_count"] == 4
    assert ours["inference_stats"]["success"]["count"] == 4
    text = core.metrics_text()
    assert 'nv_inference_count{model="llama_generate"} 4' in text
    assert 'nv_inference_exec_count{model="llama_generate"} 4' in text
    assert "nv_cpu_memory_used_bytes" in text
    with pytest.raises(Exception) as info:
        core.model_statistics("nope")
    assert info.value.code == 404


# -- the two transports, and perf_analyzer ------------------------------------


def test_http_metrics_and_grpc_server_metrics_agree(cores_after_traffic):
    """``GET /metrics`` and the gRPC ``ServerMetrics`` unary carry the
    same ``tpu_*`` samples; ``/v2/models/<m>/stats`` the statistics."""
    core = cores_after_traffic[0]
    http_server = HttpServer(core, port=0).start()
    grpc_server = GrpcServer(core, port=0).start()
    channel = grpc.insecure_channel(grpc_server.url)
    try:
        conn = http.client.HTTPConnection("127.0.0.1", http_server.port,
                                          timeout=30)
        conn.request("GET", "/metrics")
        resp = conn.getresponse()
        assert resp.status == 200
        assert resp.getheader("Content-Type").startswith("text/plain")
        over_http = resp.read().decode("utf-8")
        conn.request("GET", "/v2/models/llama_generate/stats")
        resp = conn.getresponse()
        assert resp.status == 200 and b'"inference_count": 4' in resp.read()
        conn.close()
        req_cls, resp_cls, _ = service.METHODS["ServerMetrics"]
        call = channel.unary_unary(
            service.method_path("ServerMetrics"),
            request_serializer=req_cls.SerializeToString,
            response_deserializer=resp_cls.FromString)
        over_grpc = call(pb.ServerMetadataRequest()).settings[
            "metrics"].string_param
    finally:
        channel.close()
        grpc_server.stop()
        http_server.stop()
    assert _families(over_http) == _families(over_grpc)
    assert "tpu_scheduler_tokens_total" in _families(over_grpc)


def test_perf_analyzer_probes_read_the_port(cores_after_traffic):
    """perf_analyzer's ``/metrics`` probes return numbers against the
    port (a non-200 would return None and leave their columns empty)."""
    core, model, _ = cores_after_traffic
    http_server = HttpServer(core, port=0).start()
    try:
        backend = HttpBackend("127.0.0.1:{}".format(http_server.port))
        stats = model.scheduler_stats()
        assert backend.prefix_cache_snapshot() == {
            "hits": stats["prefix_hits"], "misses": stats["prefix_misses"]}
        assert backend.spec_snapshot() == {"steps": 0, "proposed": 0,
                                           "accepted": 0}
    finally:
        http_server.stop()
