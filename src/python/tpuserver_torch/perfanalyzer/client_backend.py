"""Backend-neutral client abstraction for the load managers.

Role of the reference's ``client_backend/`` layer
(client_backend.h:250-620): the load managers and profiler speak one
small interface; three concrete backends map it onto the stack's entry
points:

- ``http``      — the KServe-v2 HTTP protocol over ``http.client``
                  against a live front end (``tpuserver_torch.
                  http_server`` or any KServe-v2 server)
- ``grpc``      — ``GRPCInferenceService`` over a raw ``grpc`` channel
                  and the port's own message classes
                  (``tpuserver_torch.grpc_proto``)
- ``inprocess`` — wraps ``tpuserver_torch.core.InferenceServer``
                  directly (the analogue of the reference's Triton C-API
                  backend: no sockets, so the client/transport overhead
                  is isolated from the model cost)

A backend hands out *prepared* requests (inputs built once, outside the
timed path), executes them synchronously (``infer``) or asynchronously
(``submit`` + completion callback — what the concurrency manager's
context free-list rides on), snapshots server statistics, and streams
generations token-by-token for the generation profiler.

The port's copy of ``perfanalyzer/client_backend.py``.  Its socket
backends speak the wire protocols with the standard library and the
port's own gRPC messages instead of ``tritonclient``, which the port does
not import; the replica pool backend stays with the client-side
``tools/perf_analyzer.py`` (it is built on ``tritonclient``'s endpoint
pool).  CUDA regions (``tpuserver_torch.cuda_shared_memory``) take the
place of XLA ones; on a CUDA region the server's resolve path hands the
model a view of the region's device memory, with no host copy.
"""

import base64
import http.client
import json
import socket
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from urllib.parse import quote

import numpy as np

from tpuserver_torch.resumable_stream import (
    Resumer,
    StreamError,
    sse_generation,
)


class BackendError(Exception):
    """A request failed inside a backend (wraps the core's or the
    transport's error, with the server's message)."""


def _coerce_int(value, default=0):
    try:
        return int(value)
    except (TypeError, ValueError):
        return default


class ClientBackend:
    """The interface the load managers and profiler consume.

    ``capacity`` is the backend's true in-flight ceiling (executor
    threads / pooled connections), or None when the transport
    multiplexes without a fixed bound (gRPC async).  Size it via
    ``max_inflight`` at construction: a load level above the capacity
    would silently measure the backend's own queueing, not the server.
    """

    kind = "?"
    supports_generation = False

    def __init__(self, max_inflight=None):
        self._executor = None
        self._executor_lock = threading.Lock()
        # an explicit bound is honored EXACTLY (a user capping
        # outstanding requests means it); only the unspecified case
        # gets the roomy default
        self._executor_workers = (max(1, int(max_inflight))
                                  if max_inflight else 64)
        self.capacity = self._executor_workers

    # -- metadata / statistics --------------------------------------------

    def model_metadata(self, model):
        raise NotImplementedError

    def model_config(self, model):
        raise NotImplementedError

    def server_statistics(self, model):
        """Cumulative stats dict ``{"model_stats": [...]}`` (KServe
        statistics extension shape)."""
        raise NotImplementedError

    def stats_snapshot(self, model):
        """Flat cumulative-counter snapshot for the profiler's window
        diffs (see :func:`tpuserver_torch.perfanalyzer.metrics.
        server_stats_snapshot`)."""
        from tpuserver_torch.perfanalyzer.metrics import (
            server_stats_snapshot,
        )

        return server_stats_snapshot(self.server_statistics(model), model)

    def router_snapshot(self):
        """Cumulative fleet-router counters (``failovers``,
        ``handoffs``, ``resumed_streams``, ``shed``) when the target is
        a ``tpuserver_torch.fleet_router.FleetRouter``, else None.  Only
        transports that can reach ``/router/stats`` override this — the
        profiler diffs the snapshot per load level so router-absorbed
        faults surface in the report next to ``resumed_streams``."""
        return None

    def prefix_cache_snapshot(self):
        """Cumulative radix prefix-cache counters ``{"hits": tokens,
        "misses": tokens}``, or None when the target has none."""
        return None

    def spec_snapshot(self):
        """Cumulative speculative-decoding counters ``{"steps": n,
        "proposed": tokens, "accepted": tokens}``, or None when the
        target has none."""
        return None

    # -- inference --------------------------------------------------------

    def prepare(self, model, input_sets):
        """Turn ``input_sets`` (list of name->np.ndarray dicts) into
        backend-native request handles.  Runs once per load level,
        OUTSIDE any measurement window — the timed path then only
        dispatches."""
        return [self._prepare_one(model, s) for s in input_sets]

    def _prepare_one(self, model, inputs):
        raise NotImplementedError

    def infer(self, prepared):
        """Synchronous inference of one prepared request; raises
        :class:`BackendError` on failure."""
        raise NotImplementedError

    def submit(self, prepared, on_done):
        """Non-blocking dispatch; ``on_done(error_or_None)`` fires on a
        completion thread.  Default implementation runs :meth:`infer` on
        a shared executor; backends with native async (gRPC) override."""
        executor = self._ensure_executor()

        def run():
            try:
                self.infer(prepared)
            except Exception as e:  # noqa: BLE001 — handed to on_done
                on_done(e)
                return
            on_done(None)

        executor.submit(run)

    def _ensure_executor(self):
        if self._executor is None:
            with self._executor_lock:
                if self._executor is None:
                    self._executor = ThreadPoolExecutor(
                        max_workers=self._executor_workers,
                        thread_name_prefix="perfanalyzer-" + self.kind,
                    )
        return self._executor

    # -- generation (decoupled streaming) ---------------------------------

    def generate_stream(self, model, inputs, parameters=None, stats=None):
        """Generator yielding the token count of each streamed response
        as it arrives (1 for the llama TOKEN-per-response contract).
        The generation profiler timestamps each yield: first yield =
        TTFT, gaps = inter-token latencies.

        ``stats`` (optional dict) receives per-stream bookkeeping the
        profiler folds into its report (``stats["resumes"]`` for a
        backend that reconnects a dropped stream)."""
        raise NotImplementedError(
            "backend '{}' does not support generation mode".format(
                self.kind))

    def release_thread_resources(self):
        """Called by a generation worker as it exits; backends that pin
        per-thread resources free them here."""

    # -- shared-memory data plane -----------------------------------------

    def shm_register(self, name, kind, key=None, raw_handle=None,
                     byte_size=0, device_id=0):
        """Register a client-created region (``kind`` 'system' or
        'cuda') with the serving target."""
        raise NotImplementedError(
            "backend '{}' does not support shared memory".format(self.kind))

    def shm_unregister(self, name, kind):
        raise NotImplementedError(
            "backend '{}' does not support shared memory".format(self.kind))

    def prepare_shm(self, model, input_refs, output_refs=None):
        """Prepared requests whose inputs are :func:`shm_input_ref`
        descriptors (one dict per input set) and whose outputs land in
        shared memory (``output_refs``: list of ``(name, region,
        byte_size, offset)``), for :meth:`infer`/``submit``."""
        raise NotImplementedError(
            "backend '{}' does not support shared memory".format(self.kind))

    def close(self):
        if self._executor is not None:
            self._executor.shutdown(wait=False)
            self._executor = None


def shm_input_ref(region, byte_size, offset, datatype, shape):
    """A shared-memory input reference: the value a prepared request
    carries instead of tensor bytes.  Understood by the backend's
    prepare and generate paths."""
    return {
        "shared_memory_region": region,
        "shared_memory_byte_size": int(byte_size),
        "shared_memory_offset": int(offset),
        "datatype": datatype,
        "shape": list(shape),
    }


def _is_shm_ref(value):
    return isinstance(value, dict) and "shared_memory_region" in value


def _response_token_count(outputs):
    """Tokens carried by one decoupled response, from its output list
    (dicts with name/shape).  Prefer a TOKEN/OUTPUT_IDS tensor's
    element count; fall back to 1 response = 1 step."""
    for entry in outputs or []:
        if entry.get("name") in ("TOKEN", "OUTPUT_IDS", "output_ids"):
            n = 1
            for d in entry.get("shape", []) or []:
                n *= max(1, _coerce_int(d, 1))
            data = entry.get("data")
            if isinstance(data, list) and data:
                n = len(data)
            return max(1, n)
    return 1


# -- in-process backend ----------------------------------------------------


class InProcessBackend(ClientBackend):
    """Drives ``tpuserver_torch.core.InferenceServer`` with no transport
    at all — the floor every socket client's overhead is measured
    against (the reference's C-API backend role)."""

    kind = "inprocess"
    supports_generation = True

    def __init__(self, core, max_inflight=None):
        super().__init__(max_inflight)
        self.core = core

    def model_metadata(self, model):
        return self.core.model_metadata(model)

    def model_config(self, model):
        return self.core.model_config(model)

    def server_statistics(self, model):
        return self.core.model_statistics(model)

    def _prepare_one(self, model, inputs):
        from tpuserver_torch.core import InferRequest

        return InferRequest(model, inputs=dict(inputs))

    def shm_register(self, name, kind, key=None, raw_handle=None,
                     byte_size=0, device_id=0):
        from tpuserver_torch.errors import TorchServeError

        try:
            if kind == "system":
                self.core.register_system_shm(name, key, 0, byte_size)
            else:
                self.core.register_cuda_shm(
                    name, raw_handle, device_id, byte_size)
        except TorchServeError as e:
            raise BackendError(str(e)) from e

    def shm_unregister(self, name, kind):
        from tpuserver_torch.errors import TorchServeError

        try:
            if kind == "system":
                self.core.unregister_system_shm(name)
            else:
                self.core.unregister_cuda_shm(name)
        except TorchServeError as e:
            raise BackendError(str(e)) from e

    def prepare_shm(self, model, input_refs, output_refs=None):
        return [("shm", model, dict(refs), list(output_refs or []))
                for refs in input_refs]

    def _resolve_refs(self, inputs):
        """Materialize shm references through the core's bounds-checked
        resolve path — for a CUDA region this returns a view of the
        region's device memory: the zero-copy plane.  Returns the inputs
        and the names of the regions they were read from."""
        out = {}
        regions = []
        for name, value in inputs.items():
            if _is_shm_ref(value):
                out[name] = self.core.read_shm_input(
                    value["shared_memory_region"],
                    value["shared_memory_byte_size"],
                    value.get("shared_memory_offset", 0),
                    value["datatype"],
                    value["shape"])
                regions.append(value["shared_memory_region"])
            else:
                out[name] = value
        return out, tuple(regions)

    def infer(self, prepared):
        """Run one prepared request; returns the core's
        ``InferResponse``."""
        from tpuserver_torch.core import InferRequest, RequestedOutput
        from tpuserver_torch.errors import TorchServeError

        try:
            if isinstance(prepared, tuple) and prepared[0] == "shm":
                _, model, refs, out_refs = prepared
                requested = None
                if out_refs:
                    requested = [
                        RequestedOutput(
                            n, binary_data=False, shm_region=region,
                            shm_byte_size=size, shm_offset=offset)
                        for n, region, size, offset in out_refs
                    ]
                inputs, regions = self._resolve_refs(refs)
                req = InferRequest(model, inputs=inputs,
                                   requested_outputs=requested)
                req.shm_input_regions = regions
                return self.core.infer(req)
            # a fresh request object per call: InferRequest carries
            # per-call deadline state the core stamps on it
            req = InferRequest(prepared.model_name,
                               inputs=prepared.inputs)
            return self.core.infer(req)
        except TorchServeError as e:
            raise BackendError(str(e)) from e

    def generate_stream(self, model, inputs, parameters=None, stats=None):
        from tpuserver_torch.core import InferRequest
        from tpuserver_torch.errors import TorchServeError

        try:
            resolved, regions = self._resolve_refs(inputs)
            req = InferRequest(model, inputs=resolved,
                               parameters=dict(parameters or {}))
            # the regions stay pinned while the stream lives, as the
            # front ends pin them
            req.shm_input_regions = regions
            for resp in self.core.infer_stream(req):
                yield _response_token_count(
                    [spec for spec, _ in resp.outputs])
        except TorchServeError as e:
            raise BackendError(str(e)) from e

    def _scheduler_stats(self):
        return [stats for stats in (self.core.health_snapshot().get("models")
                                    or {}).values()
                if isinstance(stats, dict)]

    def prefix_cache_snapshot(self):
        hits = misses = 0
        seen = False
        for stats in self._scheduler_stats():
            if "prefix_hits" in stats:
                seen = True
                hits += _coerce_int(stats.get("prefix_hits"))
                misses += _coerce_int(stats.get("prefix_misses"))
        return {"hits": hits, "misses": misses} if seen else None

    def spec_snapshot(self):
        steps = proposed = accepted = 0
        seen = False
        for stats in self._scheduler_stats():
            if "spec_steps" in stats:
                seen = True
                steps += _coerce_int(stats.get("spec_steps"))
                proposed += _coerce_int(stats.get("spec_proposed"))
                accepted += _coerce_int(stats.get("spec_accepted"))
        return ({"steps": steps, "proposed": proposed,
                 "accepted": accepted} if seen else None)


# -- socket-backend shared shm support --------------------------------------


def _split_url(url):
    """``(host, port)`` of a ``host:port`` url; a bare host is HTTP's
    port 80."""
    host, sep, port = url.rpartition(":")
    if not sep:
        return url, 80
    if not port.isdigit():
        raise ValueError("url must be host:port (got {!r})".format(url))
    return host, int(port)


def _declared_datatypes(metadata):
    return {t["name"]: t["datatype"] for t in metadata.get("inputs", [])}


def _wire_type(arr, declared):
    """An input's wire datatype: the model's declared one (which tells
    BF16, ``np.uint16`` bits on the host, from UINT16), else the
    array's."""
    from tpuserver_torch.tensor_io import wire_datatype

    return declared or wire_datatype(arr)


class _TritonClientShmMixin:
    """Shared-memory support for the socket backends, under the JAX
    tool's name: both transports carry Triton's register/unregister verbs
    and the same ``shared_memory_*`` tensor parameters, so the
    register/unregister/prepare/infer plumbing lives once here.  A
    backend supplies ``_register_region``, ``_unregister_region``,
    ``_build(model, inputs, output_refs)`` (one prepared request) and
    ``_send(prepared)`` (one synchronous request, returning its in-band
    outputs)."""

    def _input_datatypes(self, model):
        """The model's declared input datatypes, fetched once (at
        prepare time, outside the timed path)."""
        with self._declared_lock:
            got = self._declared.get(model)
        if got is None:
            got = _declared_datatypes(self.model_metadata(model))
            with self._declared_lock:
                self._declared[model] = got
        return got

    def shm_register(self, name, kind, key=None, raw_handle=None,
                     byte_size=0, device_id=0):
        if kind not in ("system", "cuda"):
            raise ValueError("shared-memory kind must be 'system' or "
                             "'cuda' (got {!r})".format(kind))
        self._register_region(name, kind, key, raw_handle, int(byte_size),
                              int(device_id))

    def shm_unregister(self, name, kind):
        if kind not in ("system", "cuda"):
            raise ValueError("shared-memory kind must be 'system' or "
                             "'cuda' (got {!r})".format(kind))
        self._unregister_region(name, kind)

    def _prepare_one(self, model, inputs):
        return self._build(model, inputs, None)

    def prepare_shm(self, model, input_refs, output_refs=None):
        return [self._build(model, refs, list(output_refs or []) or None)
                for refs in input_refs]

    def infer(self, prepared):
        """Run one prepared request; returns its in-band outputs as
        ``{name: np.ndarray}`` (BF16 as ``np.uint16`` bits, BYTES as
        ``np.object_``; an output delivered into a region is left out)."""
        return self._send(prepared)


# -- HTTP backend ----------------------------------------------------------

#: under-chaos reconnect budget for generation streams: the client
#: library's default 5-attempt budget backs off for ~1.5 s total,
#: which a supervised fleet's process-heal window outlasts when kill
#: faults COMPOSE (prefill + decode replica SIGKILLed in one campaign
#: cycle: two serial respawns + router re-admission).  Perf streams
#: must ride the heal out — the degradation is already reported as
#: resumed_streams/resume_events, never as a user-visible error.
GENERATION_MAX_RECONNECTS = 10


def _http_error(status, body):
    """The server's message of a failed HTTP call (its typed ``error``
    body when it sent one)."""
    try:
        message = json.loads(body).get("error")
    except (ValueError, AttributeError):
        message = None
    return BackendError(message or "HTTP {}: {}".format(
        status, body[:200].decode("utf-8", "replace")))


def _http_shm_params(ref):
    params = {"shared_memory_region": ref["shared_memory_region"],
              "shared_memory_byte_size": int(ref["shared_memory_byte_size"])}
    if ref.get("shared_memory_offset"):
        params["shared_memory_offset"] = int(ref["shared_memory_offset"])
    return params


def _http_outputs(header, binary):
    """``{name: array}`` of an ``/infer`` response's in-band outputs."""
    from tpuserver_torch.tensor_io import (
        array_from_binary,
        array_from_json_data,
    )

    out = {}
    offset = 0
    for entry in header.get("outputs", []):
        params = entry.get("parameters") or {}
        if "binary_data_size" in params:
            size = int(params["binary_data_size"])
            out[entry["name"]] = array_from_binary(
                binary[offset:offset + size], entry["datatype"],
                entry["shape"])
            offset += size
        elif "data" in entry:
            out[entry["name"]] = array_from_json_data(
                entry["data"], entry["datatype"], entry["shape"])
    return out


class HttpBackend(_TritonClientShmMixin, ClientBackend):
    """The KServe-v2 HTTP protocol over ``http.client``: ``/infer`` with
    the binary tensor extension (a JSON header, its length in
    ``Inference-Header-Content-Length``, then each tensor's raw
    little-endian bytes; BF16 as its bits, BYTES with 4-byte length
    prefixes), metadata, config and statistics as JSON; generation rides
    the ``/v2/models/{m}/generate_stream`` SSE endpoint.

    Every thread that sends (each executor worker) keeps one persistent
    connection of its own: fewer connections than workers and requests
    would queue inside the client, polluting the measured latency."""

    kind = "http"
    supports_generation = True

    def __init__(self, url, max_inflight=None, timeout=600.0):
        super().__init__(max_inflight)
        self.url = url
        self._host, self._port = _split_url(url)
        self._timeout = timeout
        self._local = threading.local()
        self._conns = []  # guarded-by: _conns_lock
        self._conns_lock = threading.Lock()
        self._declared = {}  # guarded-by: _declared_lock
        self._declared_lock = threading.Lock()
        # tri-state: None = not yet probed, False = target is a plain
        # replica (the 404 verdict is cached), True = fleet router
        self._is_router = None

    # -- transport --------------------------------------------------------

    def _connection(self):
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = http.client.HTTPConnection(self._host, self._port,
                                              timeout=self._timeout)
            self._local.conn = conn
            with self._conns_lock:
                self._conns.append(conn)
        if conn.sock is None:
            conn.connect()
            # one segment per request: the header and body writes must
            # not wait on delayed ACKs
            conn.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return conn

    def _call(self, method, path, body=None, headers=None):
        """One request on this thread's kept-alive connection: ``(status,
        response, body)``.  A transport failure closes the connection (the
        next request opens a new one) and is a :class:`BackendError`."""
        conn = self._connection()
        try:
            conn.request(method, path, body=body, headers=dict(headers or {}))
            resp = conn.getresponse()
            return resp.status, resp, resp.read()
        except (OSError, http.client.HTTPException) as e:
            conn.close()
            raise BackendError("HTTP {} {}: {}".format(method, path, e)) \
                from e

    def _get_json(self, path):
        status, _, data = self._call("GET", path)
        if status != 200:
            raise _http_error(status, data)
        return json.loads(data)

    def _post_json(self, path, obj):
        status, _, data = self._call(
            "POST", path, json.dumps(obj).encode("utf-8"),
            {"Content-Type": "application/json"})
        if status != 200:
            raise _http_error(status, data)
        return json.loads(data) if data else {}

    # -- metadata / statistics --------------------------------------------

    def _model_path(self, model):
        return "/v2/models/{}".format(quote(model, safe=""))

    def model_metadata(self, model):
        return self._get_json(self._model_path(model))

    def model_config(self, model):
        return self._get_json(self._model_path(model) + "/config")

    def server_statistics(self, model):
        return self._get_json(self._model_path(model) + "/stats")

    def router_snapshot(self):
        """``/router/stats`` counters when the url fronts a
        FleetRouter; a plain replica answers 404 once and is never
        probed again."""
        if self._is_router is False:
            return None
        if ":" not in self.url:
            # a port-less url can never reach a router: latch
            self._is_router = False
            return None
        try:
            status, _, data = self._call("GET", "/router/stats")
        except BackendError:
            # a transport error is transient: do not latch the verdict
            return None
        if status != 200:
            self._is_router = False
            return None
        try:
            snap = json.loads(data)
        except ValueError:
            return None
        self._is_router = True
        out = {
            "failovers": _coerce_int(snap.get("failovers")),
            "handoffs": _coerce_int(snap.get("handoffs")),
            "resumed_streams": _coerce_int(snap.get("resumed_streams")),
            "shed": _coerce_int(snap.get("shed")),
        }
        # tail-latency defense + router-HA counters: present only on
        # routers that carry them, so the delta attach can tell "zero
        # events" from "router predates the counters"
        for key in ("ejections", "hedges", "takeovers",
                    "recovered_generations"):
            if key in snap:
                out[key] = _coerce_int(snap.get(key))
        supervisor = snap.get("supervisor")
        if isinstance(supervisor, dict):
            # the router fronts a supervised fleet: its process-level
            # healing/scaling counters window-diff exactly like the
            # router's own, each presence-guarded so a supervisor
            # predating one never fabricates a delta
            from tpuserver_torch.perfanalyzer.metrics import (
                SUPERVISOR_COUNTERS,
            )

            for key in SUPERVISOR_COUNTERS:
                name = key[len("supervisor_"):]
                if name in supervisor:
                    out[key] = _coerce_int(supervisor[name])
        if isinstance(snap.get("disagg"), dict):
            # the phase-split plane's counters, nested as the router
            # serves them: metrics.attach_router_delta diffs them into
            # the generation report's prefill-queue and KV-transfer
            # columns (JAX's HTTP backend drops this dict, so those
            # columns stay empty there)
            out["disagg"] = snap["disagg"]
        return out

    def _metrics_counters(self, names):
        """The target's ``/metrics`` counters ``{key: family}`` summed
        across label sets, or None when the target has no such family."""
        from tpuserver_torch.metrics import parse_prometheus_text

        try:
            status, _, data = self._call("GET", "/metrics")
        except BackendError:
            return None
        if status != 200:
            return None
        families = parse_prometheus_text(data.decode("utf-8",
                                                     errors="replace"))
        out = {}
        for key, fam_name in names:
            fam = families.get(fam_name)
            if fam is None:
                return None
            out[key] = int(sum(v for _, _, v in fam["samples"]))
        return out

    def prefix_cache_snapshot(self):
        """The target's ``/metrics`` prefix-cache counters."""
        return self._metrics_counters(
            (("hits", "tpu_prefix_cache_hits_total"),
             ("misses", "tpu_prefix_cache_misses_total")))

    def spec_snapshot(self):
        """The target's ``/metrics`` speculative-decoding counters."""
        return self._metrics_counters(
            (("steps", "tpu_spec_steps_total"),
             ("proposed", "tpu_spec_tokens_proposed_total"),
             ("accepted", "tpu_spec_tokens_accepted_total")))

    # -- shared memory ----------------------------------------------------

    @staticmethod
    def _shm_path(kind, name, verb):
        return "/v2/{}sharedmemory/region/{}/{}".format(
            kind, quote(name, safe=""), verb)

    def _register_region(self, name, kind, key, raw_handle, byte_size,
                         device_id):
        if kind == "system":
            body = {"key": key, "offset": 0, "byte_size": byte_size}
        else:
            if isinstance(raw_handle, bytes):
                raw_handle = raw_handle.decode("ascii")
            body = {"raw_handle": {"b64": raw_handle},
                    "device_id": device_id, "byte_size": byte_size}
        self._post_json(self._shm_path(kind, name, "register"), body)

    def _unregister_region(self, name, kind):
        # no body: Triton's unregister carries none
        status, _, data = self._call(
            "POST", self._shm_path(kind, name, "unregister"), b"")
        if status != 200:
            raise _http_error(status, data)

    # -- inference --------------------------------------------------------

    def _build(self, model, inputs, output_refs):
        """``(path, body, headers)`` of one ``/infer`` request, serialized
        once."""
        from tpuserver_torch.tensor_io import binary_from_array

        declared = self._input_datatypes(model)
        header = {"inputs": []}
        parts = []
        for name, arr in inputs.items():
            if _is_shm_ref(arr):
                header["inputs"].append({
                    "name": name, "shape": list(arr["shape"]),
                    "datatype": arr["datatype"],
                    "parameters": _http_shm_params(arr)})
                continue
            datatype = _wire_type(arr, declared.get(name))
            raw = binary_from_array(arr, datatype)
            header["inputs"].append({
                "name": name, "shape": [int(d) for d in np.shape(arr)],
                "datatype": datatype,
                "parameters": {"binary_data_size": len(raw)}})
            parts.append(raw)
        if output_refs:
            header["outputs"] = [
                {"name": n, "parameters": _http_shm_params({
                    "shared_memory_region": region,
                    "shared_memory_byte_size": size,
                    "shared_memory_offset": offset})}
                for n, region, size, offset in output_refs]
        else:
            header["parameters"] = {"binary_data_output": True}
        head = json.dumps(header).encode("utf-8")
        return (self._model_path(model) + "/infer", head + b"".join(parts),
                {"Content-Type": "application/octet-stream",
                 "Inference-Header-Content-Length": str(len(head))})

    def _send(self, prepared):
        path, body, headers = prepared
        status, resp, data = self._call("POST", path, body, headers)
        if status != 200:
            raise _http_error(status, data)
        length = resp.getheader("Inference-Header-Content-Length")
        if length is None:
            return _http_outputs(json.loads(data), b"")
        n = int(length)
        return _http_outputs(json.loads(data[:n]), data[n:])

    # -- generation -------------------------------------------------------

    def generate_stream(self, model, inputs, parameters=None, stats=None):
        """Stream over ``/generate_stream`` SSE: a connection dropped
        mid-generation reconnects with ``Last-Event-ID`` and splices
        (same-endpoint resume), up to ``GENERATION_MAX_RECONNECTS``
        times; every reconnect is counted into ``stats["resumes"]``."""
        from tpuserver_torch.tensor_io import json_from_array

        declared = self._input_datatypes(model)
        body = {"inputs": [], "parameters": dict(parameters or {})}
        for name, arr in inputs.items():
            if _is_shm_ref(arr):
                body["inputs"].append({
                    "name": name, "shape": list(arr["shape"]),
                    "datatype": arr["datatype"],
                    "parameters": _http_shm_params(arr)})
                continue
            datatype = _wire_type(arr, declared.get(name))
            body["inputs"].append({
                "name": name, "datatype": datatype,
                "shape": [int(d) for d in np.shape(arr)],
                "data": json_from_array(arr, datatype)})

        def on_reconnect(attempt, exc):
            if stats is not None:
                stats["resumes"] = stats.get("resumes", 0) + 1

        try:
            for event in sse_generation(
                    ["{}:{}".format(self._host, self._port)], model,
                    json.dumps(body), max_reconnects=GENERATION_MAX_RECONNECTS,
                    read_timeout=self._timeout, on_reconnect=on_reconnect):
                yield _response_token_count(event.get("outputs"))
        except StreamError as e:
            raise BackendError(str(e)) from e

    def close(self):
        super().close()
        with self._conns_lock:
            conns, self._conns = self._conns, []
        for conn in conns:
            conn.close()


# -- gRPC backend ----------------------------------------------------------

#: channel options of every gRPC channel this backend opens: no message
#: size limit, as the server has none (a batch-8 ResNet-50 request is
#: 4.8 MB, over gRPC's default 4 MB)
GRPC_CHANNEL_OPTIONS = (("grpc.max_send_message_length", -1),
                        ("grpc.max_receive_message_length", -1))


def _grpc_channel(url):
    """(channel, {method name: callable}) over the port's own message
    classes: a raw channel, no client library."""
    import grpc

    from tpuserver_torch.grpc_proto import service

    channel = grpc.insecure_channel(url, options=list(GRPC_CHANNEL_OPTIONS))
    calls = {}
    for name, (req_cls, resp_cls, kind) in service.METHODS.items():
        make = (channel.unary_unary if kind == "unary"
                else channel.stream_stream)
        calls[name] = make(service.method_path(name),
                           request_serializer=req_cls.SerializeToString,
                           response_deserializer=resp_cls.FromString)
    return channel, calls


def _grpc_error(e):
    """A :class:`BackendError` with a gRPC status's details."""
    details = e.details() if hasattr(e, "details") else None
    code = e.code() if hasattr(e, "code") else None
    return BackendError(details or "gRPC {}".format(
        code.name if code is not None else e))


def _set_grpc_params(param_map, params):
    for key, value in (params or {}).items():
        if isinstance(value, bool):
            param_map[key].bool_param = value
        elif isinstance(value, int):
            param_map[key].int64_param = value
        else:
            param_map[key].string_param = str(value)


def _grpc_shm_params(param_map, region, size, offset):
    _set_grpc_params(param_map, {"shared_memory_region": region,
                                 "shared_memory_byte_size": int(size)})
    if offset:
        param_map["shared_memory_offset"].int64_param = int(offset)


def _grpc_outputs(resp):
    """``{name: array}`` of a ``ModelInferResponse``'s in-band outputs."""
    from tpuserver_torch.tensor_io import array_from_binary

    out = {}
    for i, tensor in enumerate(resp.outputs):
        if "shared_memory_region" in tensor.parameters:
            continue
        out[tensor.name] = array_from_binary(
            resp.raw_output_contents[i], tensor.datatype, list(tensor.shape))
    return out


def _as_dict(message):
    from google.protobuf import json_format

    return json_format.MessageToDict(message,
                                      preserving_proto_field_name=True)


class GrpcBackend(_TritonClientShmMixin, ClientBackend):
    """``GRPCInferenceService`` over a raw channel and the port's message
    classes; ``submit`` uses the channel's own futures with a done
    callback (no extra thread per in-flight request), and generation
    rides a decoupled ``ModelStreamInfer`` stream on a channel of the
    calling thread's own."""

    kind = "grpc"
    supports_generation = True

    def __init__(self, url, max_inflight=None):
        super().__init__(max_inflight)
        # native async callbacks: the channel multiplexes without a
        # fixed in-flight ceiling
        self.capacity = None
        self.url = url
        self._channel, self._calls = _grpc_channel(url)
        # generation streams are per-thread: generation workers run
        # concurrently, each on a channel of its own
        self._stream_local = threading.local()
        self._stream_channels = []  # guarded-by: _stream_channels_lock
        self._stream_channels_lock = threading.Lock()
        self._declared = {}  # guarded-by: _declared_lock
        self._declared_lock = threading.Lock()

    def _unary(self, name, request):
        import grpc

        try:
            return self._calls[name](request)
        except grpc.RpcError as e:
            raise _grpc_error(e) from e

    def model_metadata(self, model):
        from tpuserver_torch.grpc_proto import grpc_service_pb2 as pb

        return _as_dict(self._unary("ModelMetadata",
                                    pb.ModelMetadataRequest(name=model)))

    def model_config(self, model):
        from tpuserver_torch.grpc_proto import grpc_service_pb2 as pb

        cfg = _as_dict(self._unary("ModelConfig",
                                   pb.ModelConfigRequest(name=model)))
        return cfg.get("config", cfg)

    def server_statistics(self, model):
        from tpuserver_torch.grpc_proto import grpc_service_pb2 as pb

        return _as_dict(self._unary("ModelStatistics",
                                    pb.ModelStatisticsRequest(name=model)))

    def _register_region(self, name, kind, key, raw_handle, byte_size,
                         device_id):
        from tpuserver_torch.grpc_proto import grpc_service_pb2 as pb

        if kind == "system":
            self._unary("SystemSharedMemoryRegister",
                        pb.SystemSharedMemoryRegisterRequest(
                            name=name, key=key, offset=0,
                            byte_size=byte_size))
        else:
            # the proto carries the bare 64-byte handle
            self._unary("CudaSharedMemoryRegister",
                        pb.CudaSharedMemoryRegisterRequest(
                            name=name, raw_handle=base64.b64decode(raw_handle),
                            device_id=device_id, byte_size=byte_size))

    def _unregister_region(self, name, kind):
        from tpuserver_torch.grpc_proto import grpc_service_pb2 as pb

        if kind == "system":
            self._unary("SystemSharedMemoryUnregister",
                        pb.SystemSharedMemoryUnregisterRequest(name=name))
        else:
            self._unary("CudaSharedMemoryUnregister",
                        pb.CudaSharedMemoryUnregisterRequest(name=name))

    def _build(self, model, inputs, output_refs, parameters=None):
        """One ``ModelInferRequest``, serialized once: every tensor's raw
        bytes in ``raw_input_contents`` (a region reference instead, for
        a :func:`shm_input_ref`)."""
        from tpuserver_torch.grpc_proto import grpc_service_pb2 as pb
        from tpuserver_torch.tensor_io import binary_from_array

        declared = self._input_datatypes(model)
        req = pb.ModelInferRequest(model_name=model)
        for name, arr in inputs.items():
            if _is_shm_ref(arr):
                tensor = req.inputs.add(name=name, datatype=arr["datatype"])
                tensor.shape.extend(int(d) for d in arr["shape"])
                _grpc_shm_params(tensor.parameters,
                                 arr["shared_memory_region"],
                                 arr["shared_memory_byte_size"],
                                 arr.get("shared_memory_offset", 0))
                continue
            datatype = _wire_type(arr, declared.get(name))
            tensor = req.inputs.add(name=name, datatype=datatype)
            tensor.shape.extend(int(d) for d in np.shape(arr))
            req.raw_input_contents.append(binary_from_array(arr, datatype))
        for name, region, size, offset in output_refs or ():
            out = req.outputs.add(name=name)
            _grpc_shm_params(out.parameters, region, size, offset)
        _set_grpc_params(req.parameters, parameters)
        return req

    def _send(self, prepared):
        return _grpc_outputs(self._unary("ModelInfer", prepared))

    def submit(self, prepared, on_done):
        future = self._calls["ModelInfer"].future(prepared)

        def callback(fut):
            error = fut.exception()
            on_done(None if error is None else _grpc_error(error))

        future.add_done_callback(callback)

    def _thread_calls(self):
        calls = getattr(self._stream_local, "calls", None)
        if calls is None:
            channel, calls = _grpc_channel(self.url)
            self._stream_local.channel = channel
            self._stream_local.calls = calls
            with self._stream_channels_lock:
                self._stream_channels.append(channel)
        return calls

    def release_thread_resources(self):
        # a generation worker's thread-local channel dies with the
        # worker: a swept run would otherwise hold every past level's
        # channels open until close()
        channel = getattr(self._stream_local, "channel", None)
        if channel is None:
            return
        self._stream_local.channel = self._stream_local.calls = None
        with self._stream_channels_lock:
            try:
                self._stream_channels.remove(channel)
            except ValueError:
                pass
        channel.close()

    def generate_stream(self, model, inputs, parameters=None, stats=None):
        """One generation on a decoupled ``ModelStreamInfer`` stream of
        this thread's channel, ended by the response that carries
        ``triton_final_response`` (asked for with
        ``triton_enable_empty_final_response``; the empty final response
        counts no token).  A stream dropped mid-generation re-opens with
        ``resume_generation_id``/``resume_from_seq`` and splices, up to
        ``GENERATION_MAX_RECONNECTS`` times, counted into
        ``stats["resumes"]``; replayed duplicates (a seq already seen) are
        dropped.  An in-band ``error_message`` raises at once."""
        import grpc

        calls = self._thread_calls()
        base = dict(parameters or {})
        base["triton_enable_empty_final_response"] = True
        gen_id = base.get("generation_id")

        def on_reconnect(attempt, exc):
            if stats is not None:
                stats["resumes"] = stats.get("resumes", 0) + 1

        resumer = Resumer(GENERATION_MAX_RECONNECTS,
                          on_reconnect=on_reconnect)
        while True:
            params = dict(base)
            resuming = gen_id is not None and resumer.last_seq >= 0
            if resuming:
                params.pop("generation_id", None)
                params["resume_generation_id"] = gen_id
                params["resume_from_seq"] = resumer.last_seq + 1
            request = self._build(model, inputs, None, params)
            dropped = None
            try:
                for resp in calls["ModelStreamInfer"](iter([request])):
                    if resp.error_message:
                        if resuming and ("unknown or expired generation id"
                                         in resp.error_message):
                            dropped = BackendError(resp.error_message)
                            break
                        raise BackendError(resp.error_message)
                    out = resp.infer_response
                    final = out.parameters.get("triton_final_response")
                    if final is not None and final.bool_param \
                            and not out.outputs:
                        return
                    if "generation_id" in out.parameters:
                        gen_id = out.parameters["generation_id"].string_param
                    if "seq" in out.parameters and not resumer.fresh(
                            out.parameters["seq"].int64_param):
                        continue  # a replayed duplicate
                    resumer.yielded_any = True
                    yield _response_token_count([
                        {"name": t.name, "shape": list(t.shape)}
                        for t in out.outputs])
                    if final is not None and final.bool_param:
                        return
                else:
                    dropped = BackendError(
                        "stream ended without its final response")
            except grpc.RpcError as e:
                dropped = _grpc_error(e)
            resumer.reconnect(dropped, gen_id is not None
                              and resumer.last_seq >= 0)

    def close(self):
        super().close()
        with self._stream_channels_lock:
            channels, self._stream_channels = self._stream_channels, []
        for channel in channels:
            channel.close()
        self._channel.close()


# -- shared-memory infer-data manager ---------------------------------------


class ShmInferDataManager:
    """Client-side shared-memory staging for one perf analyzer run (role
    of the reference's ``InferDataManagerShm``): every input set of the
    rotation pool is written ONCE into a created-and-registered region
    outside any measurement window; the prepared requests then carry
    ``{region, offset}`` references, so the timed path moves descriptors
    while the tensors ride the shm data plane.  ``kind='cuda'`` regions
    live in device memory on ``device`` (``"cpu"`` makes host regions an
    in-process core attaches, for tests): the in-process resolve path
    hands the model a view of them, with no host copy.

    Region names are namespaced by a ``tag`` (default: the pid plus a
    random suffix), so two runs against one server never collide;
    :meth:`close` unregisters and destroys every region this manager
    created.
    """

    def __init__(self, backend, kind, tag=None, device=None):
        if kind not in ("system", "cuda"):
            raise ValueError(
                "shared-memory kind must be 'system' or 'cuda' "
                "(got {!r})".format(kind))
        import os as _os
        import uuid as _uuid

        self.backend = backend
        self.kind = kind
        self.device = device
        self.tag = "{}_{}".format(
            tag if tag is not None else _os.getpid(),
            _uuid.uuid4().hex[:6])
        self._regions = []  # (name, handle)

    # -- region lifecycle --------------------------------------------------

    def create_region(self, label, byte_size):
        """Create + register one region; returns ``(name, handle)``.
        The handle stays client-owned (this side reads rings / output
        regions through it)."""
        name = "pa_{}_{}".format(self.tag, label)
        if self.kind == "system":
            from tpuserver_torch.perfanalyzer import (
                system_shared_memory as sysshm,
            )

            key = "/" + name
            handle = sysshm.create_shared_memory_region(
                name, key, byte_size)
            try:
                self.backend.shm_register(
                    name, "system", key=key, byte_size=byte_size)
            except Exception:
                sysshm.destroy_shared_memory_region(handle)
                raise
        else:
            from tpuserver_torch import cuda_shared_memory as csm

            handle = csm.create_shared_memory_region(
                name, byte_size, device=self.device)
            try:
                self.backend.shm_register(
                    name, "cuda", raw_handle=csm.get_raw_handle(handle),
                    byte_size=byte_size, device_id=handle.device_id)
            except Exception:
                csm.destroy_shared_memory_region(handle)
                raise
        self._regions.append((name, handle))
        return name, handle

    def write(self, handle, arrays, offset=0):
        """Stage arrays at ``offset`` (into device memory for a CUDA
        region, one copy each)."""
        if self.kind == "system":
            from tpuserver_torch.perfanalyzer import (
                system_shared_memory as sysshm,
            )

            sysshm.set_shared_memory_region(handle, arrays, offset=offset)
            return
        from tpuserver_torch import cuda_shared_memory as csm

        csm.set_shared_memory_region(handle, arrays, offset=offset)

    def read(self, handle, datatype, shape, offset=0):
        """A tensor of numpy ``datatype`` and ``shape`` read back to the
        host from a region this manager created (an output slot)."""
        if self.kind == "system":
            from tpuserver_torch.perfanalyzer import (
                system_shared_memory as sysshm,
            )

            return sysshm.get_contents_as_numpy(handle, datatype, shape,
                                                offset=offset)
        from tpuserver_torch import cuda_shared_memory as csm

        return csm.get_contents_as_numpy(handle, datatype, shape,
                                         offset=offset)

    def close(self):
        """Unregister (server side) and destroy (client side) every
        region this manager created."""
        regions, self._regions = self._regions, []
        for name, handle in regions:
            try:
                self.backend.shm_unregister(name, self.kind)
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass
            try:
                if self.kind == "system":
                    from tpuserver_torch.perfanalyzer import (
                        system_shared_memory as sysshm,
                    )

                    sysshm.destroy_shared_memory_region(handle)
                else:
                    from tpuserver_torch import cuda_shared_memory as csm

                    csm.destroy_shared_memory_region(handle)
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass

    # -- staging -----------------------------------------------------------

    def stage_input_sets(self, input_sets, datatypes=None):
        """Write the whole rotation pool into per-input regions (one
        region per input name, one slot per set) and return the
        reference dicts ``prepare_shm`` consumes — one per set.
        ``datatypes`` (name -> wire datatype, from the model's metadata)
        names each input's wire type; without it the array's dtype does,
        which cannot tell BF16 (``np.uint16`` bits) from UINT16."""
        from tpuserver_torch.tensor_io import wire_datatype

        sets = list(input_sets)
        if not sets:
            return []
        datatypes = datatypes or {}
        refs = [dict() for _ in sets]
        for name in sets[0]:
            arrays = [np.ascontiguousarray(s[name]) for s in sets]
            first = arrays[0]
            if first.dtype == np.object_:
                raise ValueError(
                    "shared-memory mode needs fixed-size dtypes; input "
                    "'{}' is BYTES".format(name))
            nbytes = first.nbytes
            if any(a.nbytes != nbytes for a in arrays):
                raise ValueError(
                    "input '{}': every pool set must share one shape "
                    "in shared-memory mode".format(name))
            label = "in_" + "".join(
                c for c in name.lower() if c.isalnum())[:24]
            region, handle = self.create_region(
                label, nbytes * len(arrays))
            datatype = datatypes.get(name) or wire_datatype(first)
            for i, a in enumerate(arrays):
                self.write(handle, [a], offset=i * nbytes)
                refs[i][name] = shm_input_ref(
                    region, nbytes, i * nbytes, datatype, a.shape)
        return refs

    def stage_outputs(self, output_names, byte_size):
        """One output region with a ``byte_size`` slot per declared
        output; returns the ``(name, region, byte_size, offset)`` list
        ``prepare_shm`` consumes."""
        names = list(output_names)
        if not names:
            return []
        region, _ = self.create_region("out", byte_size * len(names))
        return [
            (n, region, byte_size, j * byte_size)
            for j, n in enumerate(names)
        ]


# -- factory ---------------------------------------------------------------


def create_backend(kind, url=None, core=None, max_inflight=None):
    """Build a backend by name (the CLI's ``--backend`` flag).

    ``http``/``grpc`` need ``url`` (``host:port``); ``inprocess`` needs
    ``core`` (an ``InferenceServer``).  ``max_inflight`` sizes the
    backend's executor/connection pool so the requested load level
    actually reaches the server.
    """
    if kind == "inprocess":
        if core is None:
            raise ValueError("inprocess backend needs core=")
        return InProcessBackend(core, max_inflight=max_inflight)
    if kind == "http":
        if not url:
            raise ValueError("http backend needs url=")
        return HttpBackend(url, max_inflight=max_inflight)
    if kind == "grpc":
        if not url:
            raise ValueError("grpc backend needs url=")
        return GrpcBackend(url, max_inflight=max_inflight)
    raise ValueError(
        "unknown backend '{}' (want http, grpc or inprocess)".format(kind))


# -- input synthesis -------------------------------------------------------


def build_input_pool(metadata, config, pool_size=16, batch_size=1,
                     shape_overrides=None, const_overrides=None, seed=0):
    """A rotating pool of DISTINCT random input sets for one model.

    Measurement hygiene: every context rotates through distinct inputs
    so no (model, values) pair repeats back-to-back.  Shapes come from
    the model metadata; dynamic dims (-1) must be pinned via
    ``shape_overrides`` (name -> dims).  ``const_overrides`` (name ->
    scalar) fills an input with one fixed value instead of random data —
    for control inputs like a ``DELAY_US`` knob that must not be
    randomized.  Models with ``max_batch_size > 0`` get a leading
    ``batch_size`` axis, matching Triton config semantics.  BF16 inputs
    are ``np.uint16`` bits (the port's wire rule), bit for bit the JAX
    tool's ``bfloat16`` values for the same seed (both round float64 to
    float32, then to nearest even).
    """
    from tpuserver_torch.errors import BadRequest
    from tpuserver_torch.tensor_io import bf16_bits, wire_to_np_dtype

    def np_dtype_of(datatype):
        try:
            return wire_to_np_dtype(datatype)
        except BadRequest:
            return None

    shape_overrides = shape_overrides or {}
    const_overrides = const_overrides or {}
    batched = _coerce_int(config.get("max_batch_size", 0)) > 0
    pool = []
    for i in range(pool_size):
        rng = np.random.RandomState(seed + i)
        inputs = {}
        for spec in metadata.get("inputs", []):
            name = spec["name"]
            dims = list(shape_overrides.get(name, spec["shape"]))
            dims = [_coerce_int(d) for d in dims]
            if any(d < 1 for d in dims):
                raise ValueError(
                    "input '{}' has dynamic dims {}; pin them with "
                    "--shape {}:d1,d2,...".format(name, dims, name))
            if batched:
                dims = [batch_size] + dims
            datatype = spec["datatype"]
            if name in const_overrides:
                value = const_overrides[name]
                if datatype == "BYTES":
                    inputs[name] = np.full(dims, str(value).encode("utf-8"),
                                           dtype=np.object_)
                elif datatype == "BF16":
                    inputs[name] = np.full(dims, bf16_bits(np.float64(value)),
                                           dtype=np.uint16)
                else:
                    inputs[name] = np.full(dims, value,
                                           dtype=np_dtype_of(datatype))
            elif datatype == "BYTES":
                flat = np.array(
                    ["req{}-{}".format(i, j).encode("utf-8")
                     for j in range(int(np.prod(dims)))],
                    dtype=np.object_)
                inputs[name] = flat.reshape(dims)
            elif datatype == "BF16":
                inputs[name] = bf16_bits(rng.rand(*dims))
            else:
                np_dtype = np_dtype_of(datatype)
                if np_dtype is None:
                    raise ValueError(
                        "cannot synthesize datatype '{}' for input "
                        "'{}'".format(datatype, name))
                if np.issubdtype(np_dtype, np.integer):
                    inputs[name] = rng.randint(
                        0, 100, size=dims).astype(np_dtype)
                elif np_dtype == np.bool_:
                    inputs[name] = rng.randint(
                        0, 2, size=dims).astype(np.bool_)
                else:
                    inputs[name] = rng.rand(*dims).astype(np_dtype)
        pool.append(inputs)
    return pool
