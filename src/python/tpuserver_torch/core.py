"""The port's serving core: model registry, readiness, metadata,
decoupled (streaming) execution, statistics and metrics, and the
shared-memory data plane — a slim copy of ``tpuserver/core.py``'s
``TensorSpec``, ``InferRequest``, ``InferResponse``, ``Model`` and the
``InferenceServer`` verbs the generation path uses.  Transport-agnostic:
``tpuserver_torch.http_server`` speaks HTTP and
``tpuserver_torch.grpc_server`` gRPC on top of it.

Metrics: ``metrics`` is the server's ``tpuserver_torch.metrics``
registry: request counts, latency histograms and typed-error counts per
verb, owned here, and scrape-time collectors over each model's
``scheduler_stats()`` and the data plane's :meth:`InferenceServer.
shm_stats`, which stay the one account of their events.
:meth:`InferenceServer.metrics_text` is the exposition both front ends
serve (``GET /metrics``, the gRPC ``ServerMetrics`` unary).  A server
built with ``fault_scope`` trips its fault points
(``tpuserver_torch.fault_points``) in that scope.

Shared memory: system (POSIX) regions, and CUDA regions backed by CUDA
IPC (``tpuserver_torch.cuda_shared_memory``) in the role the JAX core
gives XLA regions.  An input read from a CUDA region is a view of the
region's device memory (no host copy); outputs and token-ring slots are
written into it.  A region that an in-flight generation references is
pinned, and unregistering it is a typed 409.  A parked generation's KV
becomes a server-owned CUDA region ``kvexport/<generation_id>``, which a
resume on this server scatters back, and whose one-shot descriptor lets
a second server process attach it over CUDA IPC.
"""

import mmap
import os
import struct
import threading
import time

import numpy as np
import torch

from tpuserver_torch import cuda_shared_memory as csm
from tpuserver_torch import fault_points, shm_ring
from tpuserver_torch.errors import (
    BadRequest,
    KvExportClaimed,
    KvExportMissing,
    ModelNotFound,
    RegionPinned,
    RequestTimedOut,
    ServerUnavailable,
    TorchServeError,
)
from tpuserver_torch.metrics import MetricsRegistry

SERVER_NAME = "tpuserver-torch"
SERVER_VERSION = "0.1.0"

#: KServe-v2 wire datatype of each numpy dtype the port's models emit
_WIRE_DTYPES = {
    np.dtype(np.bool_): "BOOL",
    np.dtype(np.int8): "INT8",
    np.dtype(np.int16): "INT16",
    np.dtype(np.int32): "INT32",
    np.dtype(np.int64): "INT64",
    np.dtype(np.uint8): "UINT8",
    np.dtype(np.float16): "FP16",
    np.dtype(np.float32): "FP32",
    np.dtype(np.float64): "FP64",
}
_NP_DTYPES = {v: k for k, v in _WIRE_DTYPES.items()}

#: a model's response dict may carry per-response parameters under this
#: key (the scheduled path's ``generation_id`` and ``seq``); the core
#: moves them to ``InferResponse.parameters``
RESPONSE_PARAMS_KEY = "__response_parameters__"


def wire_to_np_dtype(datatype):
    """numpy dtype of a KServe-v2 wire datatype (BadRequest if unknown)."""
    try:
        return _NP_DTYPES[datatype]
    except KeyError:
        raise BadRequest("unsupported datatype '{}'".format(datatype))


class TensorSpec:
    """Declared input/output tensor: name, wire datatype, dims (-1 dynamic)."""

    def __init__(self, name, datatype, shape):
        self.name = name
        self.datatype = datatype
        self.shape = list(shape)

    def as_metadata(self):
        return {"name": self.name, "datatype": self.datatype,
                "shape": list(self.shape)}


class InferRequest:
    """Transport-agnostic inference request."""

    def __init__(self, model_name, model_version="", request_id="",
                 inputs=None, parameters=None):
        self.model_name = model_name
        self.model_version = model_version
        self.id = request_id
        self.inputs = inputs or {}  # name -> np.ndarray
        self.parameters = parameters or {}
        # time.monotonic() bound from the 'timeout' parameter, set by
        # InferenceServer.infer_stream; the scheduler expires by it
        self.deadline = None
        # the shared-memory regions the front end read inputs from: the
        # model pins them for the stream's lifetime
        self.shm_input_regions = ()


class InferResponse:
    """Transport-agnostic inference response; ``outputs`` is a list of
    (spec dict name/datatype/shape, np.ndarray); ``parameters`` the
    per-response parameters (``generation_id``, ``seq``)."""

    def __init__(self, model_name, model_version, request_id, outputs,
                 parameters=None):
        self.model_name = model_name
        self.model_version = model_version
        self.id = request_id
        self.outputs = outputs
        self.parameters = parameters or {}


class Model:
    """Base model: subclasses define specs and ``execute_stream(inputs,
    request)``, which yields ``dict name -> np.ndarray`` responses (the
    decoupled contract: zero or many)."""

    name = "model"
    platform = "pytorch"
    backend = "pytorch"
    max_batch_size = 0
    inputs = ()
    outputs = ()
    decoupled = False
    version = "1"
    instance_count = 1
    #: "gpu" for models that run on the card, "cpu" otherwise
    device_kind = "gpu"

    def config_dict(self):
        def tensors(specs):
            return [{"name": t.name, "data_type": "TYPE_" + t.datatype,
                     "dims": list(t.shape)} for t in specs]

        cfg = {
            "name": self.name,
            "platform": self.platform,
            "backend": self.backend,
            "max_batch_size": self.max_batch_size,
            "input": tensors(self.inputs),
            "output": tensors(self.outputs),
            "instance_group": [{
                "name": self.name + "_0",
                "kind": "KIND_GPU" if self.device_kind == "gpu"
                else "KIND_CPU",
                "count": self.instance_count,
            }],
            "version_policy": {"latest": {"num_versions": 1}},
        }
        if self.decoupled:
            cfg["model_transaction_policy"] = {"decoupled": True}
        return cfg

    def metadata_dict(self):
        return {
            "name": self.name,
            "versions": [self.version],
            "platform": self.platform,
            "inputs": [t.as_metadata() for t in self.inputs],
            "outputs": [t.as_metadata() for t in self.outputs],
        }

    def execute_stream(self, inputs, request):
        raise NotImplementedError

    def close(self):
        """Release what the model holds (optional)."""


def wall_clock_ms():
    """Epoch milliseconds, for the statistics protocol's
    ``last_inference`` field only: every deadline, timeout and liveness
    stamp in the port is ``time.monotonic()`` math."""
    return int(time.time() * 1000)  # tpulint: disable=R3


class _ModelStats:
    """A model's inference statistics (the KServe statistics extension),
    recorded by the streaming verb: one execution per completed
    generation, one failure per generation that raised."""

    def __init__(self):
        self.lock = threading.Lock()
        self.inference_count = 0     # guarded-by: lock
        self.execution_count = 0     # guarded-by: lock
        self.last_inference_ms = 0   # guarded-by: lock
        self.success_count = 0       # guarded-by: lock
        self.success_ns = 0          # guarded-by: lock
        self.fail_count = 0          # guarded-by: lock
        self.fail_ns = 0             # guarded-by: lock
        self.queue_ns = 0            # guarded-by: lock
        self.compute_input_ns = 0    # guarded-by: lock
        self.compute_infer_ns = 0    # guarded-by: lock
        self.compute_output_ns = 0   # guarded-by: lock

    def record(self, batch, queue_ns, ci_ns, cf_ns, co_ns, ok=True):
        with self.lock:
            if ok:
                self.inference_count += batch
                self.execution_count += 1
                self.last_inference_ms = wall_clock_ms()
                self.success_count += 1
                self.success_ns += queue_ns + ci_ns + cf_ns + co_ns
                self.queue_ns += queue_ns
                self.compute_input_ns += ci_ns
                self.compute_infer_ns += cf_ns
                self.compute_output_ns += co_ns
            else:
                self.fail_count += 1
                self.fail_ns += queue_ns + ci_ns + cf_ns + co_ns

    def as_dict(self, name, version):
        with self.lock:
            def sd(count, ns):
                return {"count": count, "ns": ns}

            return {
                "name": name,
                "version": version,
                "last_inference": self.last_inference_ms,
                "inference_count": self.inference_count,
                "execution_count": self.execution_count,
                "inference_stats": {
                    "success": sd(self.success_count, self.success_ns),
                    "fail": sd(self.fail_count, self.fail_ns),
                    "queue": sd(self.success_count, self.queue_ns),
                    "compute_input": sd(self.success_count,
                                        self.compute_input_ns),
                    "compute_infer": sd(self.success_count,
                                        self.compute_infer_ns),
                    "compute_output": sd(self.success_count,
                                         self.compute_output_ns),
                    "cache_hit": sd(0, 0),
                    "cache_miss": sd(0, 0),
                },
                "batch_stats": [],
            }


class _SystemShmRegion:
    """A registered POSIX shared-memory region, mapped into this
    process."""

    def __init__(self, name, key, offset, byte_size):
        self.name = name
        self.key = key
        self.offset = offset
        self.byte_size = byte_size
        path = "/dev/shm" + key if key.startswith("/") else "/dev/shm/" + key
        self._fd = os.open(path, os.O_RDWR)
        try:
            self._map = mmap.mmap(self._fd, offset + byte_size)
        except (OSError, ValueError):
            os.close(self._fd)
            raise

    def read(self, offset, nbytes):
        start = self.offset + offset
        return bytes(self._map[start:start + nbytes])

    def write(self, offset, data):
        start = self.offset + offset
        self._map[start:start + len(data)] = data

    def close(self):
        try:
            self._map.close()
        finally:
            os.close(self._fd)


class _CudaShmRegion:
    """Server-side view of a registered CUDA shared-memory region: its
    memory attached from the raw handle (an alias in the process that
    made it, a CUDA IPC mapping in another).  ``owner`` is set on the
    regions the server made itself (its KV exports)."""

    def __init__(self, name, raw_handle, device_id, byte_size):
        self.name = name
        self.device_id = int(device_id)
        self.byte_size = int(byte_size)
        self.handle = csm.attach_from_raw_handle(raw_handle, self.byte_size,
                                                 self.device_id)
        self.owner = None
        # offset -> (dtype, shape) of each tensor the server put there
        self._parked = {}

    def read(self, offset, nbytes):
        return self.handle.read_bytes(offset, nbytes)

    def write(self, offset, data):
        self.handle.write_bytes(offset, data)

    def get_device_tensor(self, offset, dtype, shape):
        """The region's memory at ``offset`` as a tensor: a view, no
        copy."""
        return self.handle.view(offset, dtype, shape)

    def parked_tensor(self, offset):
        """A view of the tensor the server last put at ``offset``, or
        None when it put none there."""
        entry = self._parked.get(offset)
        return None if entry is None else self.get_device_tensor(
            offset, *entry)

    def put_device_tensor(self, offset, tensor):
        """Copy ``tensor`` into the region at ``offset`` on the current
        stream, and wait for the copy: another process may read it
        next."""
        view = self.get_device_tensor(offset, tensor.dtype, tensor.shape)
        view.copy_(tensor)
        if view.device.type == "cuda":
            torch.cuda.current_stream(view.device).synchronize()
        self._parked[offset] = (tensor.dtype, tuple(tensor.shape))

    def close(self):
        self.handle.detach()


class InferenceServer:
    """Models by name, readiness, streaming execution and the
    shared-memory data plane.

    Lifecycle: ``ready`` until :meth:`close`, then ``stopped``; a
    stopped server answers not-ready and refuses inference, and its KV
    exports are released."""

    #: bytes per token-ring slot: one int32 TOKEN and one fp32 LOGPROB,
    #: little-endian, back to back
    SHM_RING_SLOT_BYTES = 8

    def __init__(self, models=None, fault_scope=None):
        # this server's scope at the fault points (per-server chaos in a
        # process that hosts several)
        self.fault_scope = fault_scope
        self._models = {}  # name -> Model
        self._ready = {}  # name -> bool
        self._stats = {}  # name -> _ModelStats
        self._lock = threading.Lock()
        self._closed = False  # guarded-by: _lock
        # started front ends (attach_frontend)  # guarded-by: _lock
        self._frontends = 0
        # requests executing in the core  # guarded-by: _lock
        self._inflight = 0
        # registered regions by name  # guarded-by: _shm_lock
        self._system_shm = {}
        self._cuda_shm = {}  # guarded-by: _shm_lock
        # region name -> in-flight generations and token rings that
        # reference it: unregistering it is a typed 409
        # guarded-by: _shm_lock
        self._shm_pins = {}
        # generation id -> (region name, valid position, shape, dtype
        # name, the export's copy-done event or None): the server-owned
        # KV exports  # guarded-by: _shm_lock
        self._kv_exports = {}
        # generation ids whose export descriptor was handed out (the
        # transfer is one-shot)  # guarded-by: _shm_lock
        self._kv_export_claims = set()
        # data-plane counts (shm_stats)  # guarded-by: _shm_lock
        self._shm_counts = dict.fromkeys((
            "shm_bytes_read", "shm_bytes_written", "shm_zero_copy_reads",
            "kv_exports_made", "kv_exports_attached",
            "kv_exports_dropped"), 0)
        self._shm_lock = threading.Lock()
        # the telemetry plane: owned per-verb instruments, plus
        # scrape-time collectors over the scheduler's and the data
        # plane's counters.  Verb children are bound once, so a request
        # costs two adds, never a family-lock lookup
        self.metrics = MetricsRegistry()
        requests_family = self.metrics.counter(
            "tpu_requests_total", labelnames=("verb",))
        seconds_family = self.metrics.histogram(
            "tpu_request_seconds", labelnames=("verb",))
        self._metric_errors = self.metrics.counter(
            "tpu_request_errors_total", labelnames=("verb", "code"))
        self._m_infer_count = requests_family.labels(verb="infer")
        self._m_infer_hist = seconds_family.labels(verb="infer")
        self._m_stream_count = requests_family.labels(verb="stream_infer")
        self._m_stream_hist = seconds_family.labels(verb="stream_infer")
        self.metrics.register_collector(self._collect_metrics)
        self.metrics.register_collector(self._collect_shm_ring)
        for m in models or []:
            self.register_model(m)

    def register_model(self, model, ready=True):
        with self._lock:
            self._models[model.name] = model
            self._ready[model.name] = ready
            self._stats.setdefault(model.name, _ModelStats())
        attach = getattr(model, "attach_server", None)
        if attach is not None:
            attach(self)

    def _get_model(self, name, version=""):
        with self._lock:
            model = self._models.get(name)
            ready = self._ready.get(name, False)
            closed = self._closed
        if model is None:
            raise ModelNotFound(
                "Request for unknown model: '{}' is not found".format(name))
        if version not in ("", model.version):
            raise ModelNotFound(
                "Request for unknown model version: '{}' version {}".format(
                    name, version))
        if closed or not ready:
            raise ServerUnavailable("Model '{}' is not ready".format(name))
        return model

    def requires_stream_order(self, name, version=""):
        """Whether stream requests to this model run in arrival order:
        a decoupled model's response bursts are contractual, unless it
        is ``concurrent_decoupled`` (the continuous-batching scheduler),
        whose generations run interleaved, each response carrying its
        request id."""
        model = self._get_model(name, version)
        if model.decoupled:
            return not getattr(model, "concurrent_decoupled", False)
        return False

    def is_concurrent_decoupled(self, name, version=""):
        """Whether this model runs decoupled requests interleaved.  Such
        requests limit themselves through the model's slots, so a stream
        front end must not cap them with its own in-flight bound."""
        with self._lock:
            model = self._models.get(name)
        return bool(model is not None and model.decoupled
                    and getattr(model, "concurrent_decoupled", False))

    def attach_frontend(self):
        """Front ends register when they start, and a server closed by
        its last detach opens again."""
        with self._lock:
            self._frontends += 1
            self._closed = False

    def detach_frontend(self):
        """The last detach closes the core to new requests (the port's
        core runs no background workers of its own to stop; each
        model's scheduler stops with :meth:`close`)."""
        with self._lock:
            self._frontends = max(0, self._frontends - 1)
            if self._frontends == 0:
                self._closed = True

    def model_statistics(self, name="", version=""):
        """The KServe statistics of every model (``name=""``) or of one;
        an unknown name is a typed 404."""
        with self._lock:
            items = sorted((n, m, self._stats[n])
                           for n, m in self._models.items()
                           if not name or n == name)
        if name and not items:
            raise ModelNotFound(
                "Request for unknown model: '{}' is not found".format(name))
        return {"model_stats": [st.as_dict(n, m.version)
                                for n, m, st in items]}

    # -- metrics -------------------------------------------------------------

    def _count_error(self, verb, code):
        self._metric_errors.labels(verb=verb, code=str(code)).inc()

    def _collect_metrics(self):
        """Scrape-time collector: the in-flight gauge, the region counts,
        the data plane's ``shm_stats()`` and every scheduler-backed
        model's ``scheduler_stats()``: one source of truth each, no
        second account."""
        with self._lock:
            inflight = self._inflight
            items = list(self._models.items())
        with self._shm_lock:
            regions = [({"kind": "system"}, len(self._system_shm)),
                       ({"kind": "cuda"}, len(self._cuda_shm)),
                       ({"kind": "xla"}, 0)]
        shm = self.shm_stats()
        families = [("tpu_inflight_requests", [({}, inflight)]),
                    ("tpu_shm_regions", regions)]
        for fam_name, key in (
                ("tpu_shm_bytes_read_total", "shm_bytes_read"),
                ("tpu_shm_bytes_written_total", "shm_bytes_written"),
                ("tpu_shm_zero_copy_reads_total", "shm_zero_copy_reads"),
                ("tpu_kv_exports_made_total", "kv_exports_made"),
                ("tpu_kv_exports_attached_total", "kv_exports_attached"),
                ("tpu_kv_exports_dropped_total", "kv_exports_dropped")):
            families.append((fam_name, [({}, shm[key])]))
        per_family = {
            "tpu_scheduler_admissions_total": "admitted",
            "tpu_scheduler_tokens_total": "tokens",
            "tpu_scheduler_restarts_total": "restarts",
            "tpu_scheduler_quarantined_total": "quarantined",
            "tpu_scheduler_replay_hits_total": "replay_hits",
            "tpu_scheduler_live_streams": "live_streams",
            "tpu_scheduler_pending": "pending",
            "tpu_scheduler_codel_sheds_total": "codel_sheds",
            "tpu_scheduler_codel_shedding": "codel_shedding",
            "tpu_scheduler_attach_admissions_total": "attach_admissions",
            "tpu_prefix_cache_hits_total": "prefix_hits",
            "tpu_prefix_cache_misses_total": "prefix_misses",
            "tpu_prefix_cache_evictions_total": "prefix_evictions",
            "tpu_kv_pages_total": "pages_total",
            "tpu_kv_pages_free": "pages_free",
            "tpu_kv_pages_cached": "pages_cached",
            "tpu_spec_tokens_proposed_total": "spec_proposed",
            "tpu_spec_tokens_accepted_total": "spec_accepted",
            "tpu_spec_rollbacks_total": "spec_rollbacks",
            "tpu_spec_steps_total": "spec_steps",
            "tpu_spec_accept_per_step": "spec_accept_per_step",
        }
        # the one family that is a mean, not a count or a 0/1 flag
        float_families = {"tpu_spec_accept_per_step"}
        samples = {name: [] for name in per_family}
        for model_name, model in items:
            stats_fn = getattr(model, "scheduler_stats", None)
            stats = stats_fn() if callable(stats_fn) else None
            if not isinstance(stats, dict):
                continue
            for fam_name, key in per_family.items():
                val = stats.get(key) or 0
                samples[fam_name].append(
                    ({"model": model_name},
                     float(val) if fam_name in float_families
                     else int(val)))
        families.extend(
            (name, rows) for name, rows in samples.items() if rows)
        return families

    @staticmethod
    def _collect_shm_ring():
        """The process-wide count of torn token-ring reads
        (``tpuserver_torch.shm_ring``): readers are client code with no
        server handle, so the module counter is the one account."""
        return [("tpu_shm_ring_torn_total", [({}, shm_ring.torn_total())])]

    def metrics_text(self):
        """The full ``/metrics`` exposition: the ``nv_*`` compatibility
        gauges that the reference server publishes and perf_analyzer
        ``--collect-metrics`` scrapes, then the ``tpu_*`` registry.  One
        snapshot for both transports."""
        lines = []
        try:
            # current RSS (/proc is authoritative on Linux)
            with open("/proc/self/statm") as f:
                rss_bytes = int(f.read().split()[1]) * os.sysconf(
                    "SC_PAGE_SIZE")
            lines.append(
                "# HELP nv_cpu_memory_used_bytes Server RSS.\n"
                "# TYPE nv_cpu_memory_used_bytes gauge\n"
                "nv_cpu_memory_used_bytes {}".format(rss_bytes))
        except (OSError, ValueError, IndexError):
            pass
        if torch.cuda.is_available():
            # the card's used bytes (total - free, as CUDA reports them):
            # CUDA-shm regions are cudaMalloc memory outside torch's
            # allocator, so this counts them, and KV exports, where
            # torch.cuda.memory_allocated would not
            for i in range(torch.cuda.device_count()):
                free, total = torch.cuda.mem_get_info(i)
                used = total - free
                label = '{{gpu="{}"}}'.format(i)
                lines.append("nv_gpu_memory_used_bytes{} {}".format(
                    label, used))
                lines.append("nv_gpu_memory_total_bytes{} {}".format(
                    label, total))
                if total:
                    # a memory fraction, not a compute duty cycle (which
                    # nv_gpu_utilization would mean)
                    lines.append("nv_gpu_memory_utilization{} {}".format(
                        label, used / total))
        for stat in self.model_statistics()["model_stats"]:
            label = '{{model="{}"}}'.format(stat["name"])
            lines.append("nv_inference_count{} {}".format(
                label, stat["inference_count"]))
            lines.append("nv_inference_exec_count{} {}".format(
                label, stat["execution_count"]))
        return ("\n".join(lines) + "\n" if lines else "") \
            + self.metrics.render()

    @staticmethod
    def _model_healthy(model):
        """A model may expose ``healthy()`` (the continuous-batching
        scheduler's state); absent means healthy."""
        probe = getattr(model, "healthy", None)
        return probe is None or bool(probe())

    def server_ready(self):
        """True while serving and every ready model is healthy."""
        with self._lock:
            if self._closed:
                return False
            models = [m for n, m in self._models.items()
                      if self._ready.get(n, False)]
        return all(self._model_healthy(m) for m in models)

    def model_ready(self, name, version=""):
        with self._lock:
            model = self._models.get(name)
            ready = (model is not None and not self._closed
                     and version in ("", model.version)
                     and self._ready.get(name, False))
        return ready and self._model_healthy(model)

    def server_metadata(self):
        return {"name": SERVER_NAME, "version": SERVER_VERSION,
                "extensions": ["model_configuration"]}

    def model_metadata(self, name, version=""):
        return self._get_model(name, version).metadata_dict()

    def model_config(self, name, version=""):
        return self._get_model(name, version).config_dict()

    # -- shared memory -----------------------------------------------------

    def register_system_shm(self, name, key, offset, byte_size):
        """Map the POSIX shared-memory object ``key`` as region ``name``
        (``byte_size`` bytes from ``offset``)."""
        try:
            region = _SystemShmRegion(name, key, int(offset), int(byte_size))
        except (OSError, ValueError) as e:
            raise BadRequest(
                "unable to open shared memory region '{}': {}".format(name, e))
        self._publish_region(region, system=True)

    def register_cuda_shm(self, name, raw_handle, device_id, byte_size):
        """Attach the CUDA region whose raw handle (the base64 of a
        64-byte ``cudaIpcMemHandle_t``) a client registered; a CUDA error
        of the attach is a typed 400 that carries it."""
        try:
            region = _CudaShmRegion(name, raw_handle, device_id, byte_size)
        except (csm.CudaSharedMemoryException, TypeError, ValueError) as e:
            raise BadRequest(
                "unable to attach CUDA shared memory region '{}': {}".format(
                    name, e))
        self._publish_region(region, system=False)

    def register_xla_shm(self, name, raw_handle, device_ordinal, byte_size):
        raise BadRequest(
            "failed to register XLA shared memory region '{}': there is no "
            "XLA device on a CUDA host (use CUDA shared memory)".format(name))

    def _publish_region(self, region, system):
        with self._shm_lock:  # atomically against pin and unregister
            taken = (region.name in self._system_shm
                     or region.name in self._cuda_shm)
            if not taken:
                registry = self._system_shm if system else self._cuda_shm
                registry[region.name] = region
        if taken:
            region.close()
            raise BadRequest(
                "shared memory region '{}' already in manager".format(
                    region.name))

    def unregister_system_shm(self, name=""):
        """Unregister one region (all with ``name=""``); a pinned one is a
        typed 409 and stays registered."""
        with self._shm_lock:
            regions = self._pop_regions_locked(self._system_shm, name)
        for region in regions:
            region.close()

    def unregister_cuda_shm(self, name=""):
        """As :meth:`unregister_system_shm`.  A client's region is closed
        (its IPC mapping unmapped), never freed; a server-owned KV export
        is freed, and its export record goes with it."""
        with self._shm_lock:
            regions = self._pop_regions_locked(self._cuda_shm, name)
            for region in regions:
                self._drop_export_entry_locked(region.name)
        self._release_regions(regions)

    def unregister_xla_shm(self, name=""):
        """No XLA regions exist on a CUDA host: nothing to unregister."""

    def _pop_regions_locked(self, registry, name):
        """Check the pins of ``name`` (every region when empty) and pop
        them, in one hold of ``_shm_lock``: a pin taken concurrently
        either lands first, and the unregister conflicts, or finds the
        region gone, a typed 400.  Called with ``_shm_lock`` held."""
        names = [name] if name else list(registry)
        for rname in names:
            pins = self._shm_pins.get(rname, 0)
            if pins > 0:
                raise RegionPinned(
                    "cannot unregister shared memory region '{}': {} "
                    "in-flight generation(s) or token ring(s) still "
                    "reference it; retry after they finish".format(
                        rname, pins))
        return [r for r in (registry.pop(n, None) for n in names)
                if r is not None]

    def system_shm_status(self, name=""):
        with self._shm_lock:
            return {n: {"name": n, "key": r.key, "offset": r.offset,
                        "byte_size": r.byte_size}
                    for n, r in self._system_shm.items()
                    if not name or n == name}

    def cuda_shm_status(self, name=""):
        with self._shm_lock:
            return {n: {"name": n, "device_id": r.device_id,
                        "byte_size": r.byte_size}
                    for n, r in self._cuda_shm.items()
                    if not name or n == name}

    def xla_shm_status(self, name=""):
        return {}

    def cuda_shm_region(self, name):
        """A registered CUDA region by name (for models that park device
        state in it, like a llama KV cache); a typed 400 when unknown."""
        with self._shm_lock:
            region = self._cuda_shm.get(name)
        if region is None:
            raise BadRequest(
                "Unable to find CUDA shared memory region: '{}'".format(name))
        return region

    def _shm_region(self, name):
        with self._shm_lock:
            region = self._system_shm.get(name) or self._cuda_shm.get(name)
        if region is None:
            raise BadRequest(
                "Unable to find shared memory region: '{}'".format(name))
        return region

    def shm_stats(self):
        """Counts of the data plane: shm bytes read and written, inputs
        read as zero-copy device views, and KV exports made, attached
        (by this server's resumes and by other servers' descriptor
        imports through this one) and dropped."""
        with self._shm_lock:
            return dict(self._shm_counts)

    def _count(self, **deltas):
        with self._shm_lock:
            for key, n in deltas.items():
                self._shm_counts[key] += n

    # -- region pins (the in-flight-reference contract) --------------------

    def pin_shm_region(self, name):
        """Mark ``name`` as referenced by an in-flight generation or a
        token ring: while pinned, unregister is a typed 409.  A region
        that is not registered is the usual typed 400.  Pins nest; pair
        each with :meth:`unpin_shm_region`."""
        with self._shm_lock:
            if name not in self._system_shm and name not in self._cuda_shm:
                raise BadRequest(
                    "Unable to find shared memory region: '{}'".format(name))
            self._shm_pins[name] = self._shm_pins.get(name, 0) + 1

    def unpin_shm_region(self, name):
        with self._shm_lock:
            count = self._shm_pins.get(name, 0) - 1
            if count > 0:
                self._shm_pins[name] = count
            else:
                self._shm_pins.pop(name, None)

    # -- server-owned KV exports (park, attach, handoff) -------------------

    @staticmethod
    def _kv_export_region_name(generation_id):
        return "kvexport/{}".format(generation_id)

    def export_kv_region(self, generation_id, cache, position):
        """Park a generation's gathered KV (a ``[L, 2, 1, max_seq, Hkv,
        D]`` tensor) as the server-owned CUDA region
        ``kvexport/<generation_id>``, valid up to ``position``.  The copy
        runs on the caller's stream; a descriptor fetch waits for it.  A
        reused id supersedes the earlier export.  A CUDA error (of the
        allocation or the handle) raises a typed 500."""
        name = self._kv_export_region_name(generation_id)
        nbytes = cache.numel() * cache.element_size()
        self.drop_kv_region(generation_id)
        try:
            owner = csm.create_shared_memory_region(name, nbytes,
                                                    device=cache.device)
        except csm.CudaSharedMemoryException as e:
            raise TorchServeError(
                "KV export of generation '{}' failed: {}".format(
                    generation_id, e), code=500)
        region = _CudaShmRegion(name, csm.get_raw_handle(owner),
                                owner.device_id, nbytes)
        region.owner = owner
        view = region.get_device_tensor(0, cache.dtype, cache.shape)
        view.copy_(cache)
        done = None
        if view.device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
        with self._shm_lock:
            self._cuda_shm[name] = region
            self._kv_exports[generation_id] = (
                name, int(position), tuple(cache.shape),
                str(cache.dtype).replace("torch.", ""), done)
            self._kv_export_claims.discard(generation_id)
            self._shm_counts["kv_exports_made"] += 1

    def import_kv_region(self, generation_id):
        """``(cache, valid position)`` of this server's export for
        ``generation_id``, or None when there is none (never exported,
        dropped, or unregistered).  The cache is a copy on the caller's
        stream, so the export may be dropped at once."""
        with self._shm_lock:
            entry = self._kv_exports.get(generation_id)
            region = self._cuda_shm.get(entry[0]) if entry else None
            if entry is not None and region is None:
                self._kv_exports.pop(generation_id, None)
        if region is None:
            return None
        _, position, shape, dtype, _ = entry
        cache = region.get_device_tensor(0, getattr(torch, dtype),
                                         shape).clone()
        self._count(kv_exports_attached=1)
        return cache, position

    def drop_kv_region(self, generation_id):
        """Release a generation's KV export: the region unregistered and
        freed (after the device's work in flight).  Idempotent."""
        with self._shm_lock:
            entry = self._kv_exports.pop(generation_id, None)
            self._kv_export_claims.discard(generation_id)
            region = self._cuda_shm.pop(entry[0], None) if entry else None
        self._release_regions([region] if region is not None else [])

    def _release_regions(self, regions):
        """Close unregistered regions; free those the server owns."""
        freed = 0
        for region in regions:
            region.close()
            if region.owner is not None:
                csm.destroy_shared_memory_region(region.owner)
                freed += 1
        if freed:
            self._count(kv_exports_dropped=freed)

    def _drop_export_entry_locked(self, region_name):
        """Forget the export record of ``region_name`` (being
        unregistered by the caller).  Called with ``_shm_lock`` held."""
        for gid, entry in list(self._kv_exports.items()):
            if entry[0] == region_name:
                del self._kv_exports[gid]
                self._kv_export_claims.discard(gid)

    def kv_export_descriptor(self, generation_id):
        """The wire descriptor of a live KV export, for a decode-side
        server to attach over CUDA IPC instead of prefilling.  One-shot:
        the first fetch claims the export, a second is a typed 409
        (:class:`KvExportClaimed`), and a generation with no live export
        is a typed 404 (:class:`KvExportMissing`).  Waits for the
        export's copy, so the other process reads complete bytes.
        Returns ``{"generation_id", "name", "raw_handle", "position",
        "shape", "dtype", "byte_size", "device_id"}``."""
        with self._shm_lock:
            entry = self._kv_exports.get(generation_id)
            region = self._cuda_shm.get(entry[0]) if entry else None
            if region is None:
                if entry is not None:
                    self._kv_exports.pop(generation_id, None)
                    self._kv_export_claims.discard(generation_id)
                raise KvExportMissing(
                    "no live KV export for generation '{}' (never "
                    "exported, released, or expired); fall back to "
                    "prefill".format(generation_id))
            if generation_id in self._kv_export_claims:
                raise KvExportClaimed(
                    "KV export for generation '{}' already claimed: the "
                    "transfer is one-shot".format(generation_id))
            self._kv_export_claims.add(generation_id)
        name, position, shape, dtype, done = entry
        if done is not None:
            done.synchronize()
        return {
            "generation_id": generation_id,
            "name": name,
            "raw_handle": csm.get_raw_handle(region.owner).decode("ascii"),
            "position": int(position),
            "shape": list(shape),
            "dtype": dtype,
            "byte_size": int(region.byte_size),
            "device_id": int(region.device_id),
        }

    def import_kv_descriptor(self, descriptor):
        """Attach a KV export, of this process or another, from its wire
        descriptor: ``(cache, valid position)`` for the scheduler's
        attach admission.  The export is copied on the caller's stream,
        the stream synchronized, and an IPC mapping closed before this
        returns, so the exporter may release it at once.  A malformed
        descriptor, or one naming a region this process has destroyed, is
        a typed 404 (:class:`KvExportMissing`: the caller prefills
        instead); a CUDA error of the attach is a typed 500."""
        try:
            raw = descriptor["raw_handle"]
            shape = tuple(int(d) for d in descriptor["shape"])
            dtype = getattr(torch, str(descriptor["dtype"]))
            if not isinstance(dtype, torch.dtype):
                raise ValueError("not a dtype: {}".format(dtype))
            position = int(descriptor["position"])
            device_id = int(descriptor.get("device_id", 0))
            nbytes = int(np.prod(shape, dtype=np.int64)) * torch.empty(
                (), dtype=dtype).element_size()
        except (AttributeError, KeyError, TypeError, ValueError) as e:
            raise KvExportMissing(
                "malformed kv-export descriptor: {}".format(e))
        try:
            handle = csm.attach_from_raw_handle(raw, nbytes, device_id)
        except csm.RegionGone as e:
            raise KvExportMissing(
                "kv export '{}' is gone: {}".format(
                    descriptor.get("name", "?"), e))
        except csm.CudaSharedMemoryException as e:
            raise TorchServeError(
                "kv export '{}' attach failed: {}".format(
                    descriptor.get("name", "?"), e), code=500)
        try:
            cache = handle.view(0, dtype, shape).clone()
            if cache.device.type == "cuda":
                torch.cuda.current_stream(cache.device).synchronize()
        finally:
            handle.detach()
        self._count(kv_exports_attached=1)
        return cache, position

    # -- shared-memory tensors ---------------------------------------------

    @staticmethod
    def _check_shm_bounds(region, byte_size, offset, direction):
        """Typed 400 for a shared-memory reference outside its registered
        region, at request time rather than deep inside a copy."""
        try:
            byte_size = int(byte_size)
            offset = int(offset)
        except (TypeError, ValueError):
            raise BadRequest(
                "shared-memory {} reference for region '{}' must carry "
                "integer byte_size/offset (got byte_size={!r}, "
                "offset={!r})".format(direction, region.name, byte_size,
                                      offset))
        if byte_size < 0 or offset < 0:
            raise BadRequest(
                "shared-memory {} reference for region '{}' must be "
                "non-negative (got byte_size={}, offset={})".format(
                    direction, region.name, byte_size, offset))
        if offset + byte_size > region.byte_size:
            raise BadRequest(
                "shared-memory {} reference out of bounds for region '{}': "
                "offset {} + byte_size {} exceeds the registered size "
                "{}".format(direction, region.name, offset, byte_size,
                            region.byte_size))
        return byte_size, offset

    def read_shm_input(self, region_name, byte_size, offset, datatype, shape):
        """An input tensor from a registered region.  From a CUDA region
        it is a view of the region's memory, with no host copy; from a
        system region, a numpy array."""
        # the shm-read failure point (scoped: one server of several)
        fault_points.trip("core.shm_read", self.fault_scope)
        region = self._shm_region(region_name)
        np_dtype = wire_to_np_dtype(datatype)
        shape = [int(s) for s in shape]
        want = int(np.prod(shape, dtype=np.int64)) * np_dtype.itemsize
        byte_size, offset = self._check_shm_bounds(
            region, byte_size or want, offset, "input")
        if byte_size != want:
            raise BadRequest(
                "shared_memory_byte_size {} of input in region '{}' does not "
                "match its shape {} of {} ({} bytes)".format(
                    byte_size, region_name, shape, datatype, want))
        if isinstance(region, _CudaShmRegion):
            view = region.get_device_tensor(
                offset, csm._torch_dtype(np_dtype), shape)
            self._count(shm_bytes_read=byte_size, shm_zero_copy_reads=1)
            return view
        self._count(shm_bytes_read=byte_size)
        return np.frombuffer(region.read(offset, byte_size),
                             dtype=np_dtype).reshape(shape)

    def write_shm_output(self, region_name, offset, array, datatype):
        """An output tensor into a registered region: a tensor on the
        card is copied device to device, anything else through the
        host."""
        region = self._shm_region(region_name)
        if isinstance(array, torch.Tensor) and isinstance(
                region, _CudaShmRegion):
            nbytes = array.numel() * array.element_size()
            _, offset = self._check_shm_bounds(region, nbytes, offset,
                                               "output")
            region.put_device_tensor(offset, array)
        else:
            if isinstance(array, torch.Tensor):
                array = csm.to_host(array)
            data = np.ascontiguousarray(np.asarray(
                array, dtype=wire_to_np_dtype(datatype))).tobytes()
            nbytes = len(data)
            _, offset = self._check_shm_bounds(region, nbytes, offset,
                                               "output")
            region.write(offset, data)
        self._count(shm_bytes_written=nbytes)

    def write_shm_ring_slot(self, region_name, offset, token, logprob):
        """One generation step into its token-ring slot: int32 token and
        fp32 logprob, little-endian, in one bounds-checked write that has
        reached the region's memory when this returns.  A slot past the
        region is a typed 400 on that step, never an overrun."""
        self._write_shm_bytes(region_name, offset,
                              struct.pack("<if", int(token), float(logprob)))

    def write_shm_ring_seq_word(self, region_name, offset, word):
        """Stamp one 4-byte seqlock word of a ring slot
        (``tpuserver_torch.shm_ring``), bounds-checked like the slot."""
        self._write_shm_bytes(region_name, offset, shm_ring.pack_word(word))

    def _write_shm_bytes(self, region_name, offset, data):
        region = self._shm_region(region_name)
        _, offset = self._check_shm_bounds(region, len(data), offset,
                                           "output")
        region.write(offset, data)
        self._count(shm_bytes_written=len(data))

    @staticmethod
    def _resolve_deadline(request):
        """One monotonic deadline per request on ``request.deadline``:
        the ``timeout`` parameter (microseconds) and any transport
        deadline a front end stamped there (the gRPC context's), the
        sooner winning."""
        t = request.parameters.get("timeout")
        if t:
            try:
                deadline = time.monotonic() + int(t) / 1e6
            except (TypeError, ValueError):
                raise BadRequest(
                    "request parameter 'timeout' must be an integer "
                    "microsecond count (got {!r})".format(t))
            if request.deadline is not None:
                deadline = min(deadline, request.deadline)
            request.deadline = deadline

    @staticmethod
    def _check_deadline(deadline, when):
        if deadline is not None and time.monotonic() >= deadline:
            raise RequestTimedOut(
                "request deadline expired {} execution".format(when))

    def _enter_inflight(self):
        with self._lock:
            self._inflight += 1

    def _exit_inflight(self):
        with self._lock:
            self._inflight -= 1

    def infer(self, request):
        """The unary verb.  A decoupled model answers JAX's typed 400 (it
        is served over the streaming endpoint only); the port's core
        serves decoupled models only, so any other is a typed 501."""
        t0 = time.monotonic()
        self._m_infer_count.inc()
        try:
            self._resolve_deadline(request)
            self._check_deadline(request.deadline, "before")
            model = self._get_model(request.model_name,
                                    request.model_version)
            if model.decoupled:
                raise BadRequest(
                    "model '{}' is a decoupled model: it can only be served "
                    "over the streaming endpoint".format(model.name))
            raise TorchServeError(
                "model '{}': unary inference is not served by this "
                "server yet".format(model.name), code=501)
        except TorchServeError as e:
            self._count_error("infer", e.code)
            raise
        finally:
            self._m_infer_hist.observe(time.monotonic() - t0)

    def infer_stream(self, request):
        """Execute a decoupled request; yields one InferResponse per
        response the model produces.  Failures inside the model surface
        as TorchServeError (a typed one, such as the scheduler's 429 shed
        or 503 shutdown, passes through, ValueError is a 400, anything
        else a 500).  A response produced past the request's
        deadline ends the stream with a 504.  With the
        ``triton_enable_empty_final_response`` request parameter every
        response is marked ``triton_final_response`` False and an empty
        one marked True ends the stream.  Counted per verb in
        :attr:`metrics` (typed errors by code; the latency covers the
        whole generation), and in the model's statistics."""
        t0 = time.monotonic()
        self._m_stream_count.inc()
        try:
            self._enter_inflight()
            try:
                yield from self._infer_stream_inner(request)
            finally:
                self._exit_inflight()
        except TorchServeError as e:
            self._count_error("stream_infer", e.code)
            raise
        finally:
            self._m_stream_hist.observe(time.monotonic() - t0)

    def _infer_stream_inner(self, request):
        model = self._get_model(request.model_name, request.model_version)
        if not model.decoupled:
            raise BadRequest(
                "model '{}' is not a decoupled model".format(model.name))
        self._resolve_deadline(request)
        self._check_deadline(request.deadline, "before")
        want_final = bool(
            request.parameters.get("triton_enable_empty_final_response"))
        declared = {t.name: t for t in model.outputs}
        stats = self._stats[model.name]
        t0 = time.monotonic_ns()
        try:
            for out in model.execute_stream(dict(request.inputs), request):
                # a token produced past the deadline belongs to a request
                # whose client has stopped waiting
                self._check_deadline(request.deadline, "during")
                params = None
                if RESPONSE_PARAMS_KEY in out:
                    out = dict(out)
                    params = out.pop(RESPONSE_PARAMS_KEY)
                outputs = []
                for name, array in out.items():
                    array = np.asarray(array)
                    spec = declared.get(name)
                    datatype = (spec.datatype if spec is not None
                                else _WIRE_DTYPES[array.dtype])
                    outputs.append(({"name": name, "datatype": datatype,
                                     "shape": list(array.shape)}, array))
                if want_final:
                    params = dict(params or {}, triton_final_response=False)
                yield InferResponse(model.name, model.version, request.id,
                                    outputs, params)
        except TorchServeError:
            stats.record(0, 0, 0, 0, 0, ok=False)
            raise
        except ValueError as e:
            stats.record(0, 0, 0, 0, 0, ok=False)
            raise BadRequest("model '{}': {}".format(model.name, e))
        except Exception as e:
            stats.record(0, 0, 0, 0, 0, ok=False)
            raise TorchServeError(
                "inference failed for model '{}': {}".format(model.name, e),
                code=500)
        stats.record(1, 0, 0, time.monotonic_ns() - t0, 0)
        if want_final:
            yield InferResponse(model.name, model.version, request.id, [],
                                {"triton_final_response": True})

    def close(self):
        """Stop serving, let every model release what it holds, and drop
        every server-owned KV export.  Safe to call twice."""
        with self._lock:
            self._closed = True
            models = list(self._models.values())
        for model in models:
            model.close()
        with self._shm_lock:
            export_ids = list(self._kv_exports)
        for gid in export_ids:
            self.drop_kv_region(gid)
