"""The port's serving core: model registry, the lifecycle (readiness,
drain, the in-flight cap) and the health snapshot a fleet router
probes, metadata, unary and decoupled (streaming) execution, the
dynamic batcher, sequences and ensembles, statistics and metrics, the
repository and the log and trace settings, and the shared-memory data
plane — the port of ``tpuserver/core.py``.  ``TorchModel`` is the
counterpart of its ``JaxModel``.  Transport-agnostic:
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

import logging
import mmap
import os
import struct
import threading
import time

import numpy as np
import torch

from tpuserver_torch import cuda_shared_memory as csm
from tpuserver_torch import fault_points, resolve_device, shm_ring
from tpuserver_torch.errors import (
    BadRequest,
    KvExportClaimed,
    KvExportMissing,
    ModelNotFound,
    RegionPinned,
    RequestTimedOut,
    ServerUnavailable,
    TooManyRequests,
    TorchServeError,
)
from tpuserver_torch.metrics import MetricsRegistry
from tpuserver_torch.tensor_io import (
    bf16_bits,
    binary_from_array,
    deserialize_bytes_tensor,
    serialized_byte_size,
    wire_datatype,
    wire_to_np_dtype,
)

_log = logging.getLogger(__name__)

SERVER_NAME = "tpuserver-torch"
SERVER_VERSION = "0.1.0"
#: the KServe-v2 extensions the port serves (the JAX package's, with
#: CUDA shared memory in the place of XLA's)
SERVER_EXTENSIONS = [
    "classification",
    "sequence",
    "model_repository",
    "model_repository(unload_dependents)",
    "schedule_policy",
    "model_configuration",
    "system_shared_memory",
    "cuda_shared_memory",
    "binary_tensor_data",
    "parameters",
    "statistics",
    "trace",
    "logging",
]

#: a model's response dict may carry per-response parameters under this
#: key (the scheduled path's ``generation_id`` and ``seq``); the core
#: moves them to ``InferResponse.parameters``
RESPONSE_PARAMS_KEY = "__response_parameters__"


class TensorSpec:
    """Declared input/output tensor: name, wire datatype, dims (-1 dynamic)."""

    def __init__(self, name, datatype, shape):
        self.name = name
        self.datatype = datatype
        self.shape = list(shape)

    def as_metadata(self):
        return {"name": self.name, "datatype": self.datatype,
                "shape": list(self.shape)}


class RequestedOutput:
    """Server-side view of one requested output and its delivery options:
    in-band (``binary_data`` or JSON), as ``class_count`` top-k
    classification strings, or into a shared-memory region."""

    def __init__(self, name, binary_data=True, class_count=0,
                 shm_region=None, shm_byte_size=0, shm_offset=0):
        self.name = name
        self.binary_data = binary_data
        self.class_count = class_count
        self.shm_region = shm_region
        self.shm_byte_size = shm_byte_size
        self.shm_offset = shm_offset


class InferRequest:
    """Transport-agnostic inference request."""

    def __init__(self, model_name, model_version="", request_id="",
                 inputs=None, parameters=None, requested_outputs=None):
        self.model_name = model_name
        self.model_version = model_version
        self.id = request_id
        # name -> np.ndarray (BYTES as np.object_, BF16 as np.uint16 bits)
        # or a torch.Tensor view of a CUDA region
        self.inputs = inputs or {}
        self.parameters = parameters or {}
        # list[RequestedOutput], or None for every output in-band
        self.requested_outputs = requested_outputs
        # time.monotonic() bound from the 'timeout' parameter, set by
        # InferenceServer.infer_stream; the scheduler expires by it
        self.deadline = None
        # the shared-memory regions the front end read inputs from: the
        # model pins them for the stream's lifetime
        self.shm_input_regions = ()

    @property
    def sequence_id(self):
        return self.parameters.get("sequence_id", 0)

    @property
    def sequence_start(self):
        return bool(self.parameters.get("sequence_start", False))

    @property
    def sequence_end(self):
        return bool(self.parameters.get("sequence_end", False))


#: the delivery of an output that travels in-band as binary data
DEFAULT_DELIVERY = {"binary_data": True, "shm_region": None,
                    "shm_byte_size": 0, "shm_offset": 0}


class InferResponse:
    """Transport-agnostic inference response; ``outputs`` is a list of
    (spec dict name/datatype/shape, array or None), the array a numpy
    array (BYTES as ``np.object_``, BF16 as ``np.uint16`` bits) and None
    for an output delivered into shared memory; ``deliveries`` maps an
    output's name to its delivery options when a request asked for any
    (:data:`DEFAULT_DELIVERY` otherwise); ``parameters`` the
    per-response parameters (``generation_id``, ``seq``)."""

    def __init__(self, model_name, model_version, request_id, outputs,
                 parameters=None, deliveries=None):
        self.model_name = model_name
        self.model_version = model_version
        self.id = request_id
        self.outputs = outputs
        self.parameters = parameters or {}
        self.deliveries = deliveries or {}

    def delivery(self, name):
        return self.deliveries.get(name, DEFAULT_DELIVERY)


class Model:
    """Base model: subclasses define specs and ``execute(inputs,
    request)``, which returns ``dict name -> array``; a decoupled model
    instead implements ``execute_stream(inputs, request)``, which yields
    such dicts (zero or many), and a sequence model
    ``execute_sequence(inputs, state, request)``, which returns
    ``(outputs, new_state)``.  An ensemble names its steps in
    ``ensemble_steps``.  ``request`` is None inside a dynamic batch."""

    name = "model"
    platform = "pytorch"
    backend = "pytorch"
    max_batch_size = 0
    inputs = ()
    outputs = ()
    decoupled = False
    sequence = False
    ensemble_steps = None  # list of step dicts for an ensemble
    labels = None  # output name -> classification labels
    version = "1"
    #: dynamic batching (the model-config ``dynamic_batching`` block):
    #: concurrent requests coalesce into one ``execute`` over the stacked
    #: batch, padded to a power of two up to ``max_batch_size``
    dynamic_batching = False
    max_queue_delay_us = 2000
    #: executor threads of the batcher (the ``instance_group`` count)
    instance_count = 1
    #: idle time after which a sequence's state is dropped
    max_sequence_idle_us = 60_000_000
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
        if self.dynamic_batching and self.max_batch_size > 1:
            cfg["dynamic_batching"] = {
                "preferred_batch_size": [self.max_batch_size],
                "max_queue_delay_microseconds": self.max_queue_delay_us,
            }
        if self.sequence:
            cfg["sequence_batching"] = {
                "max_sequence_idle_microseconds": 60000000,
                "control_input": [
                    {"name": "START",
                     "control": [{"kind": "CONTROL_SEQUENCE_START",
                                  "int32_false_true": [0, 1]}]},
                    {"name": "END",
                     "control": [{"kind": "CONTROL_SEQUENCE_END",
                                  "int32_false_true": [0, 1]}]},
                ],
            }
        if self.ensemble_steps is not None:
            cfg["platform"] = "ensemble"
            cfg["ensemble_scheduling"] = {"step": self.ensemble_steps}
        return cfg

    def metadata_dict(self):
        return {
            "name": self.name,
            "versions": [self.version],
            "platform": self.platform,
            "inputs": [t.as_metadata() for t in self.inputs],
            "outputs": [t.as_metadata() for t in self.outputs],
        }

    def execute(self, inputs, request):
        raise NotImplementedError

    def execute_stream(self, inputs, request):
        raise NotImplementedError

    def execute_sequence(self, inputs, state, request):
        raise NotImplementedError

    def warmup(self):
        """Run representative shapes once before serving (optional)."""

    def close(self):
        """Release what the model holds (optional)."""


class TorchModel(Model):
    """A model whose compute is PyTorch on ``device`` (the card unless the
    caller asks for the CPU), the counterpart of ``JaxModel``.

    ``forward(**inputs)`` gets tensors on ``device`` and returns ``dict
    name -> tensor``; it runs under ``torch.inference_mode()``.  A host
    input moves to the device in one copy (a BF16 input's ``np.uint16``
    bits become a ``torch.bfloat16`` tensor); a tensor already there (a
    CUDA region's view) is used where it lies.  Outputs stay on the device
    until a response needs their host bytes."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._bf16_inputs = {t.name for t in self.inputs
                             if t.datatype == "BF16"}

    def forward(self, **inputs):
        raise NotImplementedError

    def to_device(self, name, array):
        if not isinstance(array, torch.Tensor):
            array = np.asarray(array)
            if name in self._bf16_inputs:
                array = array.view(np.int16)
            array = torch.from_numpy(array)
            if name in self._bf16_inputs:
                array = array.view(torch.bfloat16)
        return array.to(self.device)

    def execute(self, inputs, request):
        with torch.inference_mode():
            return dict(self.forward(**{
                name: self.to_device(name, array)
                for name, array in inputs.items()}))


def wall_clock_ms():
    """Epoch milliseconds, for the statistics protocol's
    ``last_inference`` field only: every deadline, timeout and liveness
    stamp in the port is ``time.monotonic()`` math."""
    return int(time.time() * 1000)  # tpulint: disable=R3


class _ModelStats:
    """A model's inference statistics (the KServe statistics extension):
    one execution per model call (a dynamic batch counts once, however
    many requests it served), one success per request, one failure per
    request or generation that raised."""

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

    def record(self, batch, queue_ns, ci_ns, cf_ns, co_ns, ok=True,
               executions=1):
        with self.lock:
            if ok:
                self.inference_count += batch
                self.execution_count += executions
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


class _BatchSlot:
    """One queued request inside the dynamic batcher."""

    __slots__ = ("inputs", "rows", "event", "outputs", "error",
                 "enqueue_ns", "queue_ns", "executions")

    def __init__(self, inputs, rows):
        self.inputs = inputs
        self.rows = rows
        self.event = threading.Event()
        self.outputs = None
        self.error = None
        # the model calls this slot accounts for: 1 for the first slot of
        # a batch, 0 for the others
        self.executions = 0
        # the KServe queue bucket: from the enqueue to the start of the
        # batch this slot landed in
        self.enqueue_ns = time.monotonic_ns()
        self.queue_ns = 0


class _DynamicBatcher:
    """Coalesces concurrent requests for one model into batched calls
    (``tpuserver/core.py``'s, on torch).  Each of ``instance_count``
    executor threads drains the queue: the first waiting request opens a
    window of ``model.max_queue_delay_us``; every compatible request
    (same input names, dtypes and trailing dims) that arrives inside it
    is stacked along the batch axis, padded to a bucket by copies of row
    0, executed as one call, and the outputs split back per request.
    Requests left over (another signature, or past ``max_batch_size``)
    seed the next batch.

    Host parts are stacked on the host, so the model moves the batch to
    the device in one copy; parts already on the device (CUDA-region
    views) are stacked there with ``torch.cat``.  On the card each
    executor runs on a CUDA stream of its own, which first waits for the
    work queued on the device's default stream (a region write, a
    previous response's copy), and is synchronized before the batch's
    outputs are split and handed back: a request's outputs are complete
    device tensors, which its response copies where they go.

    PyTorch keeps cuDNN's execution plans per thread, so on the card each
    executor first runs ``model.warmup()`` on its stream: the first
    request it serves builds no plan.  The batcher is ready (``submit``
    waits for it) once every executor has."""

    def __init__(self, model):
        self._model = model
        self._cond = threading.Condition()
        self._queue = []   # of _BatchSlot  # guarded-by: _cond
        self._stop = False  # guarded-by: _cond
        device = getattr(model, "device", None)
        self._cuda = device if (device is not None
                                and device.type == "cuda") else None
        self._threads = [
            threading.Thread(target=self._run,
                             name="batcher-{}-{}".format(model.name, i),
                             daemon=True)
            for i in range(max(1, model.instance_count))]
        # executors that finished their warm-up  # guarded-by: _cond
        self._warm = 0
        for t in self._threads:
            t.start()

    def wait_warm(self):
        """Block until every executor has run its warm-up."""
        with self._cond:
            while self._warm < len(self._threads) and not self._stop:
                self._cond.wait()

    @staticmethod
    def _signature(inputs):
        return tuple(sorted(
            (name, str(arr.dtype), tuple(arr.shape[1:]))
            for name, arr in inputs.items()))

    def submit(self, inputs, rows):
        """Queue one request's inputs and wait for its batch: returns
        ``(outputs, queue_ns, executions)``, the request's slice of the
        batch's outputs, the nanoseconds it waited in the batching window
        and the model calls it accounts for (1 for one request of each
        batch, 0 for the rest); raises the batch's error when its
        execution failed."""
        slot = _BatchSlot(inputs, rows)
        self.wait_warm()
        with self._cond:
            if self._stop:
                raise ServerUnavailable(
                    "model '{}' is unloading".format(self._model.name))
            self._queue.append(slot)
            self._cond.notify_all()
        slot.event.wait()
        if slot.error is not None:
            raise slot.error
        return slot.outputs, slot.queue_ns, slot.executions

    def stop(self):
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        for t in self._threads:
            t.join(timeout=5)
        # an executor that outlived the join completes the slots it took;
        # the ones still queued fail
        with self._cond:
            pending, self._queue = self._queue, []
        for slot in pending:
            slot.error = ServerUnavailable(
                "model '{}' is unloading".format(self._model.name))
            slot.event.set()

    def _take_batch_locked(self):
        """One compatible batch.  Called with ``_cond`` held."""
        max_rows = self._model.max_batch_size
        sig = self._signature(self._queue[0].inputs)
        batch, rest, rows = [], [], 0
        for slot in self._queue:
            if rows + slot.rows <= max_rows and \
                    self._signature(slot.inputs) == sig:
                batch.append(slot)
                rows += slot.rows
            else:
                rest.append(slot)
        if not batch:
            # an oversized request runs alone: the model's own shape
            # checks decide its fate
            batch, rest = [rest[0]], rest[1:]
            rows = batch[0].rows
        self._queue = rest
        return batch, rows

    def _run(self):
        stream = (torch.cuda.Stream(self._cuda)
                  if self._cuda is not None else None)
        if stream is not None:
            try:
                with torch.cuda.stream(stream):
                    self._model.warmup()
                stream.synchronize()
            except Exception:  # noqa: BLE001 — requests will report it
                _log.exception("warm-up of an executor of model '%s' "
                               "failed", self._model.name)
        with self._cond:
            self._warm += 1
            self._cond.notify_all()
        delay_s = self._model.max_queue_delay_us / 1e6
        while True:
            with self._cond:
                while not self._queue and not self._stop:
                    self._cond.wait()
                if self._stop:
                    return
                # the batching window: wait for companions until the
                # delay passes or a full batch is queued
                deadline = time.monotonic() + delay_s
                while (sum(s.rows for s in self._queue)
                       < self._model.max_batch_size and not self._stop):
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cond.wait(remaining)
                if self._stop:
                    return
                if not self._queue:
                    continue  # a sibling executor took the queue
                batch, rows = self._take_batch_locked()
            if stream is None:
                self._execute(batch, rows)
            else:
                stream.wait_stream(torch.cuda.default_stream(self._cuda))
                with torch.cuda.stream(stream):
                    self._execute(batch, rows, stream)

    def _bucket(self, rows):
        """The least power of two of at least ``rows``, up to
        ``max_batch_size``: a model sees a few batch shapes only."""
        b = 1
        while b < rows:
            b <<= 1
        return min(b, max(self._model.max_batch_size, rows))

    def _stack(self, batch, rows, padded):
        """The batched inputs: host parts concatenated on the host (one
        copy to the device later), device parts with ``torch.cat``; the
        padding rows replicate row 0."""
        stacked = {}
        for name in batch[0].inputs:
            parts = [s.inputs[name] for s in batch]
            if all(isinstance(p, np.ndarray) for p in parts):
                if padded > rows:
                    parts = parts + [np.repeat(parts[0][:1], padded - rows,
                                               axis=0)]
                stacked[name] = (np.concatenate(parts, axis=0)
                                 if len(parts) > 1 else parts[0])
                continue
            # device parts come to TorchModels only (_batchable)
            parts = [p if isinstance(p, torch.Tensor)
                     else self._model.to_device(name, p) for p in parts]
            x = torch.cat(parts, dim=0) if len(parts) > 1 else parts[0]
            if padded > rows:
                x = torch.cat([x, x[:1].expand(
                    (padded - rows,) + tuple(x.shape[1:]))], dim=0)
            stacked[name] = x
        return stacked

    def _execute(self, batch, rows, stream=None):
        t_start = time.monotonic_ns()
        for slot in batch:
            slot.queue_ns = max(0, t_start - slot.enqueue_ns)
        batch[0].executions = 1
        try:
            padded = self._bucket(rows)
            outputs = self._model.execute(self._stack(batch, rows, padded),
                                          None)
            if stream is not None:
                stream.synchronize()
            # a batching model's declared outputs carry the batch dim, so
            # they split by declaration; an undeclared output splits when
            # its first dim is the padded batch, and is handed whole to
            # every request otherwise
            declared = {t.name for t in self._model.outputs}
            for name, arr in outputs.items():
                if name in declared and (
                        getattr(arr, "ndim", 0) < 1
                        or arr.shape[0] not in (rows, padded)):
                    # a misdeclared unbatched output would be cut into
                    # wrong per-request rows: fail loudly instead
                    raise ValueError(
                        "declared output '{}' of model '{}' must carry "
                        "the batch dim (shape[0] in ({}, {})), got shape "
                        "{}".format(name, self._model.name, rows, padded,
                                    tuple(getattr(arr, "shape", ()))))
            offset = 0
            for slot in batch:
                slot.outputs = {}
                for name, arr in outputs.items():
                    ndim = getattr(arr, "ndim", 0)
                    if ndim >= 1 and (name in declared
                                      or arr.shape[0] == padded):
                        slot.outputs[name] = (
                            arr if len(batch) == 1
                            and arr.shape[0] == slot.rows
                            else arr[offset:offset + slot.rows])
                    else:
                        slot.outputs[name] = arr
                offset += slot.rows
        except Exception as e:  # noqa: BLE001 — the failure fans out
            # one error instance per slot: concurrent raises of one
            # instance would race on its __traceback__
            code = getattr(e, "code",
                           400 if isinstance(e, ValueError) else 500)
            for slot in batch:
                slot.error = TorchServeError(
                    "batched execution failed for model '{}': {}".format(
                        self._model.name, e), code=code)
        finally:
            for slot in batch:
                slot.event.set()


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

    Lifecycle (``tpuserver/core.py``'s): ``starting`` (constructed with
    ``ready=False``, while the warm-up runs) -> ``ready``
    (:meth:`mark_ready`) -> ``draining`` (:meth:`begin_drain`,
    :meth:`drain`) -> ``stopped``
    (:meth:`close`, or the last front end's :meth:`detach_frontend`).
    Only a ``ready`` server admits requests: otherwise a request is a
    typed 503, and at ``max_inflight`` requests in flight a typed 429 with
    ``Retry-After``.  A stopped server answers not-ready, and
    :meth:`close` releases its KV exports.  :meth:`health_snapshot` is
    the routing signal a fleet router probes (``/v2/health/stats``);
    ``role`` (``"prefill"``, ``"decode"`` or None for fused) and
    ``spawn_nonce`` are echoed in it."""

    #: bytes per token-ring slot: one int32 TOKEN and one fp32 LOGPROB,
    #: little-endian, back to back
    SHM_RING_SLOT_BYTES = 8

    def __init__(self, models=None, max_inflight=None, ready=True,
                 fault_scope=None, role=None, spawn_nonce=None):
        # this server's scope at the fault points (per-server chaos in a
        # process that hosts several)
        self.fault_scope = fault_scope
        # the disaggregated-serving phase this replica serves, and the
        # spawner's identity nonce: both echoed by health_snapshot
        self.role = role
        self.spawn_nonce = spawn_nonce
        self._models = {}  # name -> Model
        self._ready = {}  # name -> bool
        self._stats = {}  # name -> _ModelStats
        self._lock = threading.Lock()
        # started front ends (attach_frontend)  # guarded-by: _lock
        self._frontends = 0
        # the lifecycle state, the in-flight cap and the requests
        # executing in the core; drain() waits on the condition
        self._inflight_cond = threading.Condition()
        # starting | ready | draining | stopped  # guarded-by: _inflight_cond
        self._state = "ready" if ready else "starting"
        self._max_inflight = max_inflight  # guarded-by: _inflight_cond
        self._inflight = 0  # guarded-by: _inflight_cond
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
        # name -> _DynamicBatcher, made at a model's first batched
        # request  # guarded-by: _lock
        self._batchers = {}
        # set by close() and the last front end's detach: no batcher is
        # made again until a front end attaches  # guarded-by: _lock
        self._closed = False
        # (model, sequence id) -> (state, last touch)  # guarded-by: _seq_lock
        self._sequence_state = {}
        self._last_sequence_sweep = 0.0  # guarded-by: _seq_lock
        self._seq_lock = threading.Lock()
        self._trace_settings = {
            "trace_file": [""],
            "trace_level": ["OFF"],
            "trace_rate": ["1000"],
            "trace_count": ["-1"],
            "log_frequency": ["0"],
        }
        self._log_settings = {
            "log_file": "",
            "log_info": True,
            "log_warning": True,
            "log_error": True,
            "log_verbose_level": 0,
            "log_format": "default",
        }
        self._settings_lock = threading.Lock()
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
        if model is None:
            raise ModelNotFound(
                "Request for unknown model: '{}' is not found".format(name))
        if version not in ("", model.version):
            raise ModelNotFound(
                "Request for unknown model version: '{}' version {}".format(
                    name, version))
        if not ready or self.server_state() == "stopped":
            raise ServerUnavailable("Model '{}' is not ready".format(name))
        return model

    def requires_stream_order(self, name, version=""):
        """Whether stream requests to this model run in arrival order: a
        sequence model's steps, and a decoupled model's response bursts,
        which are contractual, unless it
        is ``concurrent_decoupled`` (the continuous-batching scheduler),
        whose generations run interleaved, each response carrying its
        request id."""
        model = self._get_model(name, version)
        if model.sequence:
            return True  # a sequence's state depends on its step order
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
        """Front ends register when they start, and a stopped server
        opens again (a ``starting`` one stays starting)."""
        with self._lock:
            self._frontends += 1
            self._closed = False
        with self._inflight_cond:
            if self._state == "stopped":
                self._state = "ready"

    def detach_frontend(self):
        """The last detach stops the core to new requests and stops its
        dynamic batchers (each model's scheduler stops with
        :meth:`close`)."""
        to_stop = []
        with self._lock:
            self._frontends = max(0, self._frontends - 1)
            last = self._frontends == 0
            if last:
                # decided and marked under one hold: an attach runs
                # wholly before or after, never under a stop
                self._closed = True
                to_stop, self._batchers = list(self._batchers.values()), {}
        if last:
            with self._inflight_cond:
                self._state = "stopped"
                self._inflight_cond.notify_all()
        for batcher in to_stop:
            batcher.stop()

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
        with self._inflight_cond:
            inflight = self._inflight
        with self._lock:
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

    # -- lifecycle -----------------------------------------------------------

    def server_state(self):
        """``starting`` | ``ready`` | ``draining`` | ``stopped``."""
        with self._inflight_cond:
            return self._state

    def server_ready(self):
        """True only in ``ready`` with every ready model healthy (a
        tripped scheduler reports here), so a prober sees a warm-up, a
        drain and a trip."""
        if self.server_state() != "ready":
            return False
        with self._lock:
            models = [m for n, m in self._models.items()
                      if self._ready.get(n, False)]
        return all(self._model_healthy(m) for m in models)

    def model_ready(self, name, version=""):
        with self._lock:
            model = self._models.get(name)
            ready = (model is not None
                     and version in ("", model.version)
                     and self._ready.get(name, False))
        return (ready and self.server_state() == "ready"
                and self._model_healthy(model))

    def health_snapshot(self):
        """The routing signal a fleet router's prober polls
        (``/v2/health/stats``), in the shape of ``tpuserver/core.py``'s:
        ``state``, ``ready``, ``inflight``, ``max_inflight``, ``pid``,
        ``role``, ``spawn_nonce`` when the spawner passed one, and
        ``models``: each model's ``scheduler_stats()`` (None without a
        scheduler).  The router reads ``tripped``, ``closed``,
        ``live_streams`` and ``pending`` from them."""
        with self._inflight_cond:
            state = self._state
            inflight = self._inflight
            max_inflight = self._max_inflight
        with self._lock:
            items = list(self._models.items())
        models = {}
        for name, model in items:
            stats_fn = getattr(model, "scheduler_stats", None)
            models[name] = stats_fn() if callable(stats_fn) else None
        snap = {"state": state, "ready": self.server_ready(),
                "inflight": inflight, "max_inflight": max_inflight,
                "pid": os.getpid(), "role": self.role, "models": models}
        if self.spawn_nonce is not None:
            snap["spawn_nonce"] = self.spawn_nonce
        return snap

    def mark_ready(self, undrain=True):
        """``starting`` -> ``ready`` once warm, or cancel a drain in
        progress (the replica rejoins the fleet).  With ``undrain``
        False only a ``starting`` server turns ready, in one step under
        the lock, so a warm-up's end never cancels a drain that a
        SIGTERM has begun.  A stopped server stays stopped: only
        :meth:`attach_frontend` opens one again."""
        with self._inflight_cond:
            if self._state == "starting" or (
                    undrain and self._state == "draining"):
                self._state = "ready"
                # a drain() waiting for inflight == 0 sees the cancel
                self._inflight_cond.notify_all()

    def set_max_inflight(self, max_inflight):
        """Set the server-wide in-flight cap at run time (None lifts
        it)."""
        with self._inflight_cond:
            self._max_inflight = max_inflight
            self._inflight_cond.notify_all()

    def _enter_inflight(self):
        """Admit one request into the core, or refuse it typed: 503
        unless ``ready``, 429 with ``Retry-After`` at the cap (the
        messages of JAX's ``ShuttingDown`` and ``Overloaded``)."""
        with self._inflight_cond:
            if self._state != "ready":
                reason = {"starting": "starting and not yet ready",
                          "draining": "draining"}.get(self._state,
                                                      "shut down")
                raise ServerUnavailable(
                    "server is {}; not accepting new requests".format(
                        reason))
            if self._max_inflight is not None and \
                    self._inflight >= self._max_inflight:
                raise TooManyRequests(
                    "server is at its in-flight request cap ({}); retry "
                    "later".format(self._max_inflight))
            self._inflight += 1

    def _exit_inflight(self):
        with self._inflight_cond:
            self._inflight -= 1
            # the one waiter, drain(), waits only after the state left
            # ready: a ready-state exit wakes nobody
            if self._state != "ready":
                self._inflight_cond.notify_all()

    def begin_drain(self):
        """Stop admission and flip readiness; in-flight work goes on.
        The first half of :meth:`drain`."""
        with self._inflight_cond:
            if self._state != "stopped":
                self._state = "draining"

    def drain(self, timeout=30.0):
        """Graceful shutdown: stop admission (new requests get a typed
        503), let in-flight requests finish within ``timeout`` seconds
        (each model's scheduler drains first: its generations are the
        long-lived work), then :meth:`close`, failing whatever remains.
        A :meth:`mark_ready` during the wait cancels the drain, and the
        server is not closed."""
        self.begin_drain()
        deadline = time.monotonic() + timeout
        with self._lock:
            models = list(self._models.values())
        for model in models:
            drainer = getattr(model, "drain", None)
            if callable(drainer):
                try:
                    drainer(max(0.0, deadline - time.monotonic()))
                except Exception:  # noqa: BLE001 — close() must still run
                    _log.exception("draining model '%s' failed", model.name)
        with self._inflight_cond:
            while self._inflight > 0 and self._state == "draining":
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._inflight_cond.wait(remaining)
            if self._state == "ready":
                return  # undrained mid-wait: serving again
        self.close()

    def server_metadata(self):
        return {"name": SERVER_NAME, "version": SERVER_VERSION,
                "extensions": list(SERVER_EXTENSIONS)}

    def warmup(self):
        """Warm every model (``model.warmup()``) and start the dynamic
        batcher of each batching model, waiting until its executors are
        warm: the first requests then pay no first call."""
        with self._lock:
            models = list(self._models.values())
        for model in models:
            model.warmup()
            if model.dynamic_batching and model.max_batch_size > 1:
                self._batcher_of(model).wait_warm()

    # -- model repository and settings -------------------------------------

    def load_model(self, name):
        with self._lock:
            if name not in self._models:
                raise BadRequest(
                    "failed to load '{}', no such model".format(name))
            self._ready[name] = True

    def unload_model(self, name, unload_dependents=False):
        """Mark ``name`` unavailable (and with ``unload_dependents`` the
        models an ensemble's steps name)."""
        with self._lock:
            model = self._models.get(name)
            if model is None:
                raise BadRequest(
                    "failed to unload '{}', no such model".format(name))
            self._ready[name] = False
            if unload_dependents:
                for step in model.ensemble_steps or []:
                    if step["model_name"] in self._models:
                        self._ready[step["model_name"]] = False

    def repository_index(self, ready_only=False):
        with self._lock:
            items = sorted((n, m, self._ready.get(n, False))
                           for n, m in self._models.items())
        return [{"name": n, "version": m.version,
                 "state": "READY" if ready else "UNAVAILABLE", "reason": ""}
                for n, m, ready in items if ready or not ready_only]

    def get_trace_settings(self, model_name=None):
        with self._settings_lock:
            return {"settings": dict(self._trace_settings)}

    def update_trace_settings(self, model_name=None, settings=None):
        with self._settings_lock:
            for key, val in (settings or {}).items():
                if val is None:
                    continue
                self._trace_settings[key] = (
                    [str(v) for v in val] if isinstance(val, list)
                    else [str(val)])
        return self.get_trace_settings(model_name)

    def get_log_settings(self):
        with self._settings_lock:
            return dict(self._log_settings)

    def update_log_settings(self, settings):
        with self._settings_lock:
            for key, val in (settings or {}).items():
                if key not in self._log_settings:
                    raise BadRequest("unknown log setting '{}'".format(key))
                self._log_settings[key] = val
        return self.get_log_settings()

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
        if datatype == "BYTES":
            # length-prefixed elements: the reference names its own size,
            # and the tensor is decoded on the host
            byte_size, offset = self._check_shm_bounds(
                region, byte_size, offset, "input")
            array = deserialize_bytes_tensor(region.read(offset, byte_size))
            self._count(shm_bytes_read=byte_size)
            try:
                return array.reshape(shape)
            except ValueError as e:
                raise BadRequest(
                    "BYTES input of {} elements in region '{}' does not "
                    "match its shape {}: {}".format(array.size, region_name,
                                                    shape, e))
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
                offset, csm._torch_dtype(
                    "BF16" if datatype == "BF16" else np_dtype), shape)
            self._count(shm_bytes_read=byte_size, shm_zero_copy_reads=1)
            return view
        self._count(shm_bytes_read=byte_size)
        return np.frombuffer(region.read(offset, byte_size),
                             dtype=np_dtype).reshape(shape)

    def write_shm_output(self, region_name, offset, array, datatype):
        """An output tensor into a registered region: a tensor into a
        CUDA region is copied device to device, anything else through the
        host (BYTES length-prefixed, BF16 as its bits)."""
        region = self._shm_region(region_name)
        if isinstance(array, torch.Tensor) and isinstance(
                region, _CudaShmRegion):
            nbytes = array.numel() * array.element_size()
            _, offset = self._check_shm_bounds(region, nbytes, offset,
                                               "output")
            region.put_device_tensor(offset, array)
        else:
            data = binary_from_array(array, datatype)
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

    def infer(self, request):
        """The unary verb: execute one request and return its
        InferResponse.  A decoupled model answers a typed 400 (it is
        served over the streaming endpoint only); a result produced past
        the request's deadline is a typed 504."""
        t0 = time.monotonic()
        self._m_infer_count.inc()
        try:
            self._resolve_deadline(request)
            self._check_deadline(request.deadline, "before")
            model = self._get_model(request.model_name,
                                    request.model_version)
            self._enter_inflight()
            try:
                if model.decoupled:
                    raise BadRequest(
                        "model '{}' is a decoupled model: it can only be "
                        "served over the streaming endpoint".format(
                            model.name))
                return self._execute(model, request)
            finally:
                self._exit_inflight()
        except TorchServeError as e:
            self._count_error("infer", e.code)
            raise
        finally:
            self._m_infer_hist.observe(time.monotonic() - t0)

    @staticmethod
    def _batch_of(model, inputs):
        if model.max_batch_size > 0 and inputs:
            shape = getattr(next(iter(inputs.values())), "shape", ())
            return int(shape[0]) if len(shape) > 0 else 1
        return 1

    def _execute(self, model, request):
        """Run a request that is not decoupled: check its inputs against
        the model's, dispatch it (ensemble, sequence, dynamic batcher or
        the model itself) and build its response.  Records the model's
        statistics."""
        stats = self._stats[model.name]
        t_queue0 = time.monotonic_ns()
        inputs = dict(request.inputs)
        declared = {t.name for t in model.inputs}
        for t in model.inputs:
            if t.name not in inputs:
                raise BadRequest(
                    "expected {} inputs but got {} inputs for model '{}': "
                    "missing '{}'".format(len(model.inputs), len(inputs),
                                          model.name, t.name))
        for name in inputs:
            if declared and name not in declared:
                raise BadRequest(
                    "unexpected inference input '{}' for model '{}'".format(
                        name, model.name))
        if not isinstance(model, TorchModel) and model.ensemble_steps is None:
            # a host model reads a CUDA region's view from the host
            inputs = {name: self._host_array(
                arr, "BF16" if arr.dtype == torch.bfloat16 else None)
                if isinstance(arr, torch.Tensor) else arr
                for name, arr in inputs.items()}
        t_cf0 = time.monotonic_ns()
        batch_queue_ns = 0
        executions = 1
        try:
            if model.ensemble_steps is not None:
                outputs = self._execute_ensemble(model, inputs, request)
            elif model.sequence:
                outputs = self._execute_sequence(model, inputs, request)
            elif self._batchable(model, inputs, request):
                # the batching window's wait goes to the queue bucket
                outputs, batch_queue_ns, executions = self._batcher_of(
                    model).submit(inputs,
                                  int(next(iter(inputs.values())).shape[0]))
            else:
                outputs = model.execute(inputs, request)
        except TorchServeError:
            stats.record(0, 0, 0, 0, 0, ok=False)
            raise
        except Exception as e:
            stats.record(0, 0, 0, 0, 0, ok=False)
            # a malformed tensor surfaces as ValueError from the model's
            # array ops: a client error, as on the batched path
            raise TorchServeError(
                "inference failed for model '{}': {}".format(model.name, e),
                code=400 if isinstance(e, ValueError) else 500)
        t_co0 = time.monotonic_ns()
        if request.deadline is not None and \
                time.monotonic() >= request.deadline:
            stats.record(0, 0, 0, 0, 0, ok=False)
            raise RequestTimedOut(
                "request deadline expired during execution")
        resp = self._make_response(model, request, outputs)
        t_end = time.monotonic_ns()
        stats.record(self._batch_of(model, inputs),
                     batch_queue_ns, t_cf0 - t_queue0,
                     max(0, (t_co0 - t_cf0) - batch_queue_ns),
                     t_end - t_co0, executions=executions)
        return resp

    @staticmethod
    def _batchable(model, inputs, request):
        """Through the dynamic batcher? The model opts in; every input has
        a leading batch dim with one row count, on the host or (for a
        TorchModel) on the device; and the request carries no parameter
        but its deadline and priority (a batch sees no request)."""
        if not (model.dynamic_batching and model.max_batch_size > 1):
            return False
        if set(request.parameters) - {"timeout", "priority"} or not inputs:
            return False
        on_device = isinstance(model, TorchModel)
        rows = None
        for arr in inputs.values():
            ok = isinstance(arr, np.ndarray) or (
                on_device and isinstance(arr, torch.Tensor))
            if not ok or arr.ndim < 1:
                return False
            if rows is None:
                rows = arr.shape[0]
            elif arr.shape[0] != rows:
                return False
        return True

    def _batcher_of(self, model):
        with self._lock:
            if self._closed:
                # a request racing close() must not make a batcher anew
                raise ServerUnavailable(
                    "server is shut down; not accepting new requests")
            batcher = self._batchers.get(model.name)
            if batcher is None:
                batcher = _DynamicBatcher(model)
                self._batchers[model.name] = batcher
        return batcher

    def _execute_sequence(self, model, inputs, request):
        if request.sequence_id == 0:
            raise BadRequest(
                "inference request to model '{}' must specify a non-zero "
                "sequence id".format(model.name))
        self._expire_idle_sequences(model)
        key = (model.name, request.sequence_id)
        with self._seq_lock:
            entry = self._sequence_state.get(key)
        if request.sequence_start:
            state = None
        elif entry is None:
            raise BadRequest(
                "inference request for sequence {} to model '{}' must "
                "specify the START flag on the first request of the "
                "sequence".format(request.sequence_id, model.name))
        else:
            state = entry[0]
        outputs, new_state = model.execute_sequence(inputs, state, request)
        with self._seq_lock:
            if request.sequence_end:
                self._sequence_state.pop(key, None)
            else:
                self._sequence_state[key] = (new_state, time.monotonic())
        return outputs

    def _expire_idle_sequences(self, model):
        """Drop the sequences, of every model, idle past their model's
        ``max_sequence_idle_us`` (abandoned without an END), sweeping at
        most once per half the triggering model's window (at least 50
        ms)."""
        now = time.monotonic()
        gap = max(model.max_sequence_idle_us / 1e6 / 2.0, 0.05)
        with self._lock:
            idle_s = {n: m.max_sequence_idle_us / 1e6
                      for n, m in self._models.items()}
        with self._seq_lock:
            if now - self._last_sequence_sweep < gap:
                return
            self._last_sequence_sweep = now
            for key, (_, touched) in list(self._sequence_state.items()):
                if touched < now - idle_s.get(key[0], 0.0):
                    del self._sequence_state[key]

    def _execute_ensemble(self, model, inputs, request):
        """Run an ensemble's steps in order, each step's outputs mapped
        into the next one's inputs; tensors stay where a step left them
        (on the device between two TorchModels).  A step whose model
        batches goes through its dynamic batcher."""
        tensors = dict(inputs)
        for step in model.ensemble_steps:
            sub = self._get_model(step["model_name"])
            sub_inputs = {model_in: tensors[ens_name]
                          for model_in, ens_name in step["input_map"].items()}
            sub_req = InferRequest(sub.name, "", request.id, sub_inputs,
                                   request.parameters)
            if self._batchable(sub, sub_inputs, sub_req):
                # a batching step runs on its model's executors, whose
                # cuDNN plans are warm (they are kept per thread)
                sub_out = self._batcher_of(sub).submit(
                    sub_inputs,
                    int(next(iter(sub_inputs.values())).shape[0]))[0]
            else:
                sub_out = sub.execute(sub_inputs, sub_req)
            for model_out, ens_name in step["output_map"].items():
                tensors[ens_name] = sub_out[model_out]
        return {t.name: tensors[t.name] for t in model.outputs}

    @staticmethod
    def _host_array(array, datatype):
        """An output's host array for the wire: a tensor is copied off
        the device here (BF16 as its bits), and BF16 floats round to
        bits."""
        if datatype == "BF16":
            return bf16_bits(array)
        if isinstance(array, torch.Tensor):
            return csm.to_host(array)
        return np.asarray(array)

    @staticmethod
    def _classify(array, class_count, labels):
        """Top-k classification strings ``value:index[:label]`` per batch
        row (``np.object_`` bytes)."""
        arr = (csm.to_host(array.float()) if isinstance(array, torch.Tensor)
               else np.asarray(array))
        squeeze = arr.ndim == 1
        mat = arr.reshape(1, -1) if squeeze else arr.reshape(arr.shape[0], -1)
        k = min(class_count, mat.shape[-1])
        idx = np.argsort(-mat, axis=-1)[:, :k]
        rows = []
        for r in range(mat.shape[0]):
            row = []
            for i in idx[r]:
                entry = "{:f}:{}".format(float(mat[r, i]), int(i))
                if labels is not None and int(i) < len(labels):
                    entry += ":" + labels[int(i)]
                row.append(entry.encode("utf-8"))
            rows.append(row)
        out = np.array(rows, dtype=np.object_)
        return out.reshape(-1) if squeeze else out

    def _make_response(self, model, request, outputs):
        """The response of ``outputs``: every output in-band when the
        request named none; otherwise the requested ones, each as
        classification strings, into its shared-memory region (a tensor
        into a CUDA region device to device) or in-band."""
        declared = {t.name: t for t in model.outputs}
        requested = request.requested_outputs

        def datatype_of(name, array):
            spec = declared.get(name)
            return spec.datatype if spec is not None and spec.datatype \
                else wire_datatype(array)

        resp_outputs = []
        if not requested:
            for name, array in outputs.items():
                datatype = datatype_of(name, array)
                host = self._host_array(array, datatype)
                resp_outputs.append(({"name": name, "datatype": datatype,
                                      "shape": list(host.shape)}, host))
            return InferResponse(model.name, model.version, request.id,
                                 resp_outputs)
        for ro in requested:
            if ro.name not in outputs:
                raise BadRequest(
                    "unexpected inference output '{}' for model "
                    "'{}'".format(ro.name, model.name))
        deliveries = {}
        for ro in requested:
            array = outputs[ro.name]
            if ro.class_count > 0:
                array = self._classify(array, ro.class_count,
                                       (model.labels or {}).get(ro.name))
                datatype = "BYTES"
            else:
                datatype = datatype_of(ro.name, array)
            spec = {"name": ro.name, "datatype": datatype,
                    "shape": list(array.shape)}
            deliveries[ro.name] = {
                "binary_data": ro.binary_data, "shm_region": ro.shm_region,
                "shm_byte_size": ro.shm_byte_size,
                "shm_offset": ro.shm_offset}
            if ro.shm_region is None:
                resp_outputs.append(
                    (spec, self._host_array(array, datatype)))
                continue
            if datatype == "BYTES":
                expected = serialized_byte_size(array)
            elif isinstance(array, torch.Tensor):
                expected = array.numel() * array.element_size()
            else:
                expected = int(np.prod(array.shape, dtype=np.int64)) * (
                    2 if datatype == "BF16"
                    else wire_to_np_dtype(datatype).itemsize)
            if expected > int(ro.shm_byte_size):
                raise BadRequest(
                    "shared memory size specified with the request for "
                    "output '{}' ({} bytes) should be at least {} "
                    "bytes".format(ro.name, ro.shm_byte_size, expected))
            self.write_shm_output(ro.shm_region, ro.shm_offset, array,
                                  datatype)
            resp_outputs.append((spec, None))
        return InferResponse(model.name, model.version, request.id,
                             resp_outputs, deliveries=deliveries)

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
            self._resolve_deadline(request)
            self._check_deadline(request.deadline, "before")
            model = self._get_model(request.model_name,
                                    request.model_version)
            self._enter_inflight()
            try:
                yield from self._infer_stream_inner(model, request)
            finally:
                self._exit_inflight()
        except TorchServeError as e:
            self._count_error("stream_infer", e.code)
            raise
        finally:
            self._m_stream_hist.observe(time.monotonic() - t0)

    def _infer_stream_inner(self, model, request):
        want_final = bool(
            request.parameters.get("triton_enable_empty_final_response"))
        if not model.decoupled:
            # one response, as the unary verb gives it
            resp = self._execute(model, request)
            if want_final:
                resp.parameters["triton_final_response"] = True
            yield resp
            return
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
                                else wire_datatype(array))
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
        with self._inflight_cond:
            self._state = "stopped"
            self._inflight_cond.notify_all()
        with self._lock:
            self._closed = True
            batchers, self._batchers = list(self._batchers.values()), {}
            models = list(self._models.values())
        for batcher in batchers:
            batcher.stop()
        for model in models:
            model.close()
        with self._shm_lock:
            export_ids = list(self._kv_exports)
        for gid in export_ids:
            self.drop_kv_region(gid)


def install_sigterm_drain(server, drain_timeout=30.0):
    """Install a SIGTERM handler that drains ``server`` gracefully:
    admission stops and readiness flips at once (a prober routes away),
    in-flight generations finish within ``drain_timeout`` seconds, and
    the rest fail.  The drain runs on a daemon thread, since a signal
    handler must return promptly.  Returns the previous handler.  Main
    thread only, as all signal installation is."""
    import signal

    def _handler(signum, frame):
        threading.Thread(target=server.drain, args=(drain_timeout,),
                         name="sigterm-drain", daemon=True).start()

    return signal.signal(signal.SIGTERM, _handler)
