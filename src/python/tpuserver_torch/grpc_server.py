"""gRPC front end of the port: the KServe-v2 ``GRPCInferenceService`` on
a ``grpc.server``, over the port's own copies of the service's messages
(``tpuserver_torch.grpc_proto``), delegating to
``tpuserver_torch.core.InferenceServer`` — the port of
``tpuserver/grpc_frontend.py`` for the verbs the port's core has.

Served: the health, metadata and config verbs, ``ModelStatistics``,
``ServerMetrics`` (the ``/metrics`` exposition in a
``LogSettingsResponse`` string param ``metrics``), the system, CUDA and
XLA shared-memory register/status/unregister verbs (a CUDA
``raw_handle`` is the bare 64-byte ``cudaIpcMemHandle_t``; an XLA
register is a typed 400, as over HTTP), ``ModelInfer`` (a decoupled
model answers a typed 400) and ``ModelStreamInfer``.  The repository
and trace/log settings verbs answer ``UNIMPLEMENTED``.

``ModelStreamInfer`` runs the requests of a ``concurrent_decoupled``
model (llama with ``max_slots > 1``) side by side and unbounded, so
several generations on one bidi stream decode interleaved, each response
carrying its request id; other decoupled models run in arrival order.
A request's failure arrives in-band as ``error_message``, and the
response beside it carries the request id and the typed error's gRPC
status name (``grpc_status``) and, for a shed, its ``retry-after``
seconds as parameters: a status would end the whole RPC, and with it the
stream's other generations.  Responses pass through a bounded queue, so
a slow reader slows the producers; a client that goes away ends its
generations (which parks them for a resume).  Shared-memory input
regions stay pinned until their request's stream ends.  Resume
(``resume_generation_id``/``resume_from_seq`` in, ``generation_id``/
``seq`` out), ``kv_park``, KV descriptors and ``kv_attach`` travel as
request and response parameters.  The ``grpc.stream_infer`` fault point
trips before each response is yielded.

Unary verbs map typed errors to status codes (404 NOT_FOUND, 409
ABORTED, 400/422 INVALID_ARGUMENT, 429 RESOURCE_EXHAUSTED with a
``retry-after`` trailing-metadata entry, 501 UNIMPLEMENTED, 503
UNAVAILABLE, 504 DEADLINE_EXCEEDED); the client's gRPC deadline becomes
the request's deadline.
"""

import base64
import logging
import queue
import threading
import time
from concurrent import futures

import grpc
import numpy as np
from google.protobuf import json_format

from tpuserver_torch import fault_points
from tpuserver_torch.core import InferRequest, wire_to_np_dtype
from tpuserver_torch.errors import BadRequest, TorchServeError
from tpuserver_torch.grpc_proto import grpc_service_pb2 as pb
from tpuserver_torch.grpc_proto import model_config_pb2
from tpuserver_torch.grpc_proto.service import METHODS, SERVICE
from tpuserver_torch.tensor_io import array_from_binary, binary_from_array

_log = logging.getLogger(__name__)

#: the typed-contents field of each datatype of the port's wire map
_TYPED_FIELDS = {
    "BOOL": "bool_contents",
    "INT8": "int_contents",
    "INT16": "int_contents",
    "INT32": "int_contents",
    "INT64": "int64_contents",
    "UINT8": "uint_contents",
    "FP32": "fp32_contents",
    "FP64": "fp64_contents",
}

#: verbs of the service whose core counterparts the port lacks
_UNIMPLEMENTED = ("RepositoryIndex", "RepositoryModelLoad",
                  "RepositoryModelUnload", "TraceSetting", "LogSettings")


def _param_value(p):
    field = p.WhichOneof("parameter_choice")
    return getattr(p, field) if field else None


def _params_dict(param_map):
    return {k: _param_value(v) for k, v in param_map.items()}


def _status_code(http_code):
    return {
        400: grpc.StatusCode.INVALID_ARGUMENT,
        404: grpc.StatusCode.NOT_FOUND,
        409: grpc.StatusCode.ABORTED,  # shm region still referenced
        422: grpc.StatusCode.INVALID_ARGUMENT,  # quarantined slot
        429: grpc.StatusCode.RESOURCE_EXHAUSTED,
        500: grpc.StatusCode.INTERNAL,
        501: grpc.StatusCode.UNIMPLEMENTED,
        503: grpc.StatusCode.UNAVAILABLE,
        504: grpc.StatusCode.DEADLINE_EXCEEDED,
    }.get(http_code, grpc.StatusCode.UNKNOWN)


class _CoreBridge:
    """Protobuf <-> core translation and the RPC method implementations."""

    # concurrent in-flight requests per stream of a model that is not
    # concurrent_decoupled (clients pipeline on one bidi stream)
    STREAM_CONCURRENCY = 8

    def __init__(self, core):
        self._core = core

    # -- conversion --------------------------------------------------------

    def _request_from_proto(self, request, pinned):
        """The core request of ``request``; each shared-memory region an
        input is read from is pinned first and appended to ``pinned``
        (the caller unpins them when the request's stream ends)."""
        inputs = {}
        raw_cursor = 0  # shm inputs do not consume raw_input_contents
        for tensor in request.inputs:
            shape = list(tensor.shape)
            tparams = _params_dict(tensor.parameters)
            region = tparams.get("shared_memory_region")
            if region is not None:
                self._core.pin_shm_region(region)
                pinned.append(region)
                inputs[tensor.name] = self._core.read_shm_input(
                    region, tparams.get("shared_memory_byte_size", 0),
                    tparams.get("shared_memory_offset", 0), tensor.datatype,
                    shape)
            elif raw_cursor < len(request.raw_input_contents):
                inputs[tensor.name] = array_from_binary(
                    request.raw_input_contents[raw_cursor], tensor.datatype,
                    shape)
                raw_cursor += 1
            else:
                field = _TYPED_FIELDS.get(tensor.datatype)
                if field is None:
                    raise BadRequest("input '{}' of datatype {} has no "
                                     "data".format(tensor.name,
                                                   tensor.datatype))
                try:
                    inputs[tensor.name] = np.array(
                        list(getattr(tensor.contents, field)),
                        dtype=wire_to_np_dtype(tensor.datatype)
                    ).reshape(shape)
                except ValueError as e:
                    raise BadRequest("input '{}': {}".format(tensor.name, e))
        core_request = InferRequest(request.model_name,
                                    request.model_version, request.id,
                                    inputs, _params_dict(request.parameters))
        core_request.shm_input_regions = tuple(pinned)
        return core_request

    @staticmethod
    def _set_params(param_map, params):
        for key, value in (params or {}).items():
            if isinstance(value, bool):
                param_map[key].bool_param = value
            elif isinstance(value, int):
                param_map[key].int64_param = value
            else:
                param_map[key].string_param = str(value)

    def _response_to_proto(self, resp):
        out = pb.ModelInferResponse(model_name=resp.model_name,
                                    model_version=resp.model_version,
                                    id=resp.id)
        self._set_params(out.parameters, resp.parameters)
        for spec, array in resp.outputs:
            tensor = out.outputs.add()
            tensor.name = spec["name"]
            tensor.datatype = spec["datatype"]
            tensor.shape.extend(int(s) for s in spec["shape"])
            out.raw_output_contents.append(
                binary_from_array(array, spec["datatype"]))
        return out

    @staticmethod
    def _stamp_deadline(core_request, context):
        """The client's gRPC deadline as the request's monotonic bound
        (None when it set none); the core combines it with the
        ``timeout`` parameter."""
        remaining = context.time_remaining()
        if remaining is not None:
            core_request.deadline = time.monotonic() + remaining
        return core_request

    # -- health, metadata, statistics, metrics -----------------------------

    def ServerLive(self, request, context):
        return pb.ServerLiveResponse(live=True)

    def ServerReady(self, request, context):
        return pb.ServerReadyResponse(ready=self._core.server_ready())

    def ModelReady(self, request, context):
        return pb.ModelReadyResponse(
            ready=self._core.model_ready(request.name, request.version))

    def ServerMetadata(self, request, context):
        md = self._core.server_metadata()
        return pb.ServerMetadataResponse(name=md["name"],
                                         version=md["version"],
                                         extensions=md["extensions"])

    def ServerMetrics(self, request, context):
        """The ``GET /metrics`` exposition (``core.metrics_text()``), in
        the response's ``metrics`` string param."""
        resp = pb.LogSettingsResponse()
        resp.settings["metrics"].string_param = self._core.metrics_text()
        return resp

    def ModelMetadata(self, request, context):
        md = self._core.model_metadata(request.name, request.version)
        resp = pb.ModelMetadataResponse(name=md["name"],
                                        versions=md["versions"],
                                        platform=md["platform"])
        for t in md["inputs"]:
            resp.inputs.add(name=t["name"], datatype=t["datatype"],
                            shape=t["shape"])
        for t in md["outputs"]:
            resp.outputs.add(name=t["name"], datatype=t["datatype"],
                             shape=t["shape"])
        return resp

    def ModelConfig(self, request, context):
        config = json_format.ParseDict(
            self._core.model_config(request.name, request.version),
            model_config_pb2.ModelConfig(), ignore_unknown_fields=True)
        return pb.ModelConfigResponse(config=config)

    def ModelStatistics(self, request, context):
        return json_format.ParseDict(
            self._core.model_statistics(request.name, request.version),
            pb.ModelStatisticsResponse(), ignore_unknown_fields=True)

    # -- shared memory -----------------------------------------------------

    def SystemSharedMemoryStatus(self, request, context):
        resp = pb.SystemSharedMemoryStatusResponse()
        for name, region in self._core.system_shm_status(
                request.name).items():
            entry = resp.regions[name]
            entry.name = region["name"]
            entry.key = region["key"]
            entry.offset = region["offset"]
            entry.byte_size = region["byte_size"]
        return resp

    def SystemSharedMemoryRegister(self, request, context):
        self._core.register_system_shm(request.name, request.key,
                                       request.offset, request.byte_size)
        return pb.SystemSharedMemoryRegisterResponse()

    def SystemSharedMemoryUnregister(self, request, context):
        self._core.unregister_system_shm(request.name)
        return pb.SystemSharedMemoryUnregisterResponse()

    def CudaSharedMemoryStatus(self, request, context):
        resp = pb.CudaSharedMemoryStatusResponse()
        for name, region in self._core.cuda_shm_status(request.name).items():
            entry = resp.regions[name]
            entry.name = region["name"]
            entry.device_id = region["device_id"]
            entry.byte_size = region["byte_size"]
        return resp

    def CudaSharedMemoryRegister(self, request, context):
        # the proto carries the bare 64-byte handle; the core takes the
        # base64 text HTTP's body carries (a handle already in base64
        # passes through, and the core checks it)
        raw = request.raw_handle
        handle = base64.b64encode(raw) if len(raw) == 64 else raw
        self._core.register_cuda_shm(request.name, handle,
                                     request.device_id, request.byte_size)
        return pb.CudaSharedMemoryRegisterResponse()

    def CudaSharedMemoryUnregister(self, request, context):
        self._core.unregister_cuda_shm(request.name)
        return pb.CudaSharedMemoryUnregisterResponse()

    def XlaSharedMemoryStatus(self, request, context):
        return pb.XlaSharedMemoryStatusResponse()  # none on a CUDA host

    def XlaSharedMemoryRegister(self, request, context):
        self._core.register_xla_shm(request.name, request.raw_handle,
                                    request.device_ordinal,
                                    request.byte_size)
        return pb.XlaSharedMemoryRegisterResponse()

    def XlaSharedMemoryUnregister(self, request, context):
        self._core.unregister_xla_shm(request.name)
        return pb.XlaSharedMemoryUnregisterResponse()

    def unimplemented(self, name):
        def handler(request, context):
            raise TorchServeError(
                "{} is not served by this server".format(name), code=501)
        return handler

    # -- inference ---------------------------------------------------------

    def ModelInfer(self, request, context):
        pinned = []
        try:
            core_request = self._stamp_deadline(
                self._request_from_proto(request, pinned), context)
            return self._response_to_proto(self._core.infer(core_request))
        finally:
            for name in pinned:
                self._core.unpin_shm_region(name)

    def _error_response(self, request_id, error):
        """The in-band error of one request: the message, and the
        request's id with the typed status (and a shed's retry-after)."""
        out = pb.ModelStreamInferResponse(error_message=str(error))
        out.infer_response.id = request_id
        params = {"grpc_status": _status_code(
            getattr(error, "code", 500)).name}
        retry_after = getattr(error, "retry_after", None)
        if retry_after is not None:
            params["retry-after"] = int(retry_after)
        self._set_params(out.infer_response.parameters, params)
        return out

    def ModelStreamInfer(self, request_iterator, context):
        """The bidi stream: each request yields zero or more responses.
        A ``feed`` thread reads the requests and runs each in a thread of
        its own (a model that needs stream order runs inline, in order);
        this generator yields what they put on the bounded ``out``
        queue until the last request finished after the client closed
        its side."""
        out = queue.Queue(maxsize=self.STREAM_CONCURRENCY * 4)
        inflight = threading.Semaphore(self.STREAM_CONCURRENCY)
        cancelled = threading.Event()
        done = object()  # the sentinel: every request finished
        lock = threading.Lock()
        # under ``lock``: requests started and not finished, whether the
        # request side has ended, and whether the sentinel was claimed
        state = {"pending": 0, "fed": False, "ended": False}

        def emit(item):
            """Put with cancellation: a gone client must not wedge the
            producers on a full queue."""
            while not cancelled.is_set():
                try:
                    out.put(item, timeout=0.25)
                    return True
                except queue.Full:
                    continue
            return False

        def claim_end():
            """True for the one caller that sees the stream's work end
            (called with ``lock`` held)."""
            if state["pending"] == 0 and state["fed"] and not state["ended"]:
                state["ended"] = True
                return True
            return False

        def run_one(core_request, pinned, bounded):
            responses = self._core.infer_stream(core_request)
            try:
                for resp in responses:
                    if cancelled.is_set() or not context.is_active():
                        break  # stop generating for a gone client
                    if not emit(pb.ModelStreamInferResponse(
                            infer_response=self._response_to_proto(resp))):
                        break
            except TorchServeError as e:
                emit(self._error_response(core_request.id, e))
            except Exception as e:  # noqa: BLE001 — in-band, as a 500
                emit(self._error_response(core_request.id, TorchServeError(
                    "unexpected error: {}".format(e), code=500)))
            finally:
                # a client gone mid-stream ends its generation now (which
                # parks it for a resume), not when the frame is collected
                responses.close()
                for name in pinned:
                    self._core.unpin_shm_region(name)
                if bounded:
                    inflight.release()
                with lock:
                    state["pending"] -= 1
                    last = claim_end()
                # the sentinel goes out after the lock is released
                if last:
                    emit(done)

        def feed():
            try:
                for request in request_iterator:
                    if cancelled.is_set():
                        break
                    pinned = []
                    try:
                        core_request = self._stamp_deadline(
                            self._request_from_proto(request, pinned),
                            context)
                        ordered = self._core.requires_stream_order(
                            core_request.model_name,
                            core_request.model_version)
                    except Exception as e:  # noqa: BLE001 — in-band
                        for name in pinned:
                            self._core.unpin_shm_region(name)
                        emit(self._error_response(request.id, e))
                        continue
                    unbounded = self._core.is_concurrent_decoupled(
                        core_request.model_name)
                    if not unbounded:
                        # scheduler-backed generations limit themselves
                        # through their slots; holding a permit for a
                        # whole generation would cap a stream below
                        # max_slots
                        inflight.acquire()
                    with lock:
                        state["pending"] += 1
                    if ordered:
                        run_one(core_request, pinned, True)
                    else:
                        threading.Thread(
                            target=run_one,
                            args=(core_request, pinned, not unbounded),
                            name="grpc-stream-request", daemon=True).start()
            except grpc.RpcError:
                pass  # the client cancelled or went away
            finally:
                with lock:
                    state["fed"] = True
                    last = claim_end()
                if last:
                    emit(done)

        threading.Thread(target=feed, name="grpc-stream-feed",
                         daemon=True).start()
        try:
            while True:
                item = out.get()
                if item is done:
                    return
                # kill the bidi stream mid-flight (FaultInjected aborts
                # the RPC); skip=N drops it after the Nth response
                fault_points.trip("grpc.stream_infer", self._core.fault_scope)
                yield item
        finally:
            # reader gone (cancel, deadline, end): release the producers,
            # which stop their generations
            cancelled.set()
            while True:
                try:
                    out.get_nowait()
                except queue.Empty:
                    break


def _wrap_unary(method):
    def handler(request, context):
        try:
            return method(request, context)
        except TorchServeError as e:
            retry_after = getattr(e, "retry_after", None)
            if retry_after is not None:
                # the twin of HTTP's Retry-After header
                context.set_trailing_metadata(
                    (("retry-after", str(int(retry_after))),))
            context.abort(_status_code(e.code), str(e))
        except Exception as e:  # noqa: BLE001 — an INTERNAL status
            context.abort(grpc.StatusCode.INTERNAL, str(e))

    return handler


class GrpcServer:
    """A ``grpc.server`` hosting the ``GRPCInferenceService`` over an
    ``InferenceServer``: ``start()`` / ``stop()``; ``port`` is known once
    started (pass 0 for a free one).  Keep a reference to a started
    server: grpc-python shuts down a server that is collected."""

    def __init__(self, core, host="127.0.0.1", port=0, max_workers=32):
        self._core = core
        self._host = host
        self._requested_port = port
        self._max_workers = max_workers
        self._server = None
        self._port = None

    def start(self):
        bridge = _CoreBridge(self._core)
        handlers = {}
        for name, (req_cls, resp_cls, kind) in METHODS.items():
            if kind == "unary":
                method = (bridge.unimplemented(name)
                          if name in _UNIMPLEMENTED
                          else getattr(bridge, name))
                handlers[name] = grpc.unary_unary_rpc_method_handler(
                    _wrap_unary(method),
                    request_deserializer=req_cls.FromString,
                    response_serializer=resp_cls.SerializeToString)
            else:
                handlers[name] = grpc.stream_stream_rpc_method_handler(
                    getattr(bridge, name),
                    request_deserializer=req_cls.FromString,
                    response_serializer=resp_cls.SerializeToString)
        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=self._max_workers),
            options=[
                ("grpc.max_send_message_length", -1),
                ("grpc.max_receive_message_length", -1),
                # tolerate client keepalive pings
                ("grpc.http2.max_ping_strikes", 0),
                ("grpc.http2.min_recv_ping_interval_without_data_ms", 10),
                ("grpc.keepalive_permit_without_calls", 1),
            ])
        self._server.add_generic_rpc_handlers(
            (grpc.method_handlers_generic_handler(SERVICE, handlers),))
        self._port = self._server.add_insecure_port(
            "{}:{}".format(self._host, self._requested_port))
        self._server.start()
        self._core.attach_frontend()
        return self

    @property
    def port(self):
        return self._port

    @property
    def url(self):
        return "{}:{}".format(self._host, self._port)

    def stop(self, grace=None):
        if self._server is None:
            return
        # bounded: a handler wedged in model code cannot be interrupted
        if not self._server.stop(grace).wait(timeout=10):
            _log.warning("grpc server did not stop within 10 s (a handler "
                         "is still running)")
        self._server = None
        self._core.detach_frontend()
