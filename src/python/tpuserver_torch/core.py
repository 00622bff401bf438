"""The port's serving core: model registry, readiness, metadata,
decoupled (streaming) execution and the shared-memory data plane — a
slim copy of ``tpuserver/core.py``'s ``TensorSpec``, ``InferRequest``,
``InferResponse``, ``Model`` and the ``InferenceServer`` verbs the
generation path uses.  Transport-agnostic: ``tpuserver_torch.http_server``
speaks HTTP on top of it.

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
from tpuserver_torch import shm_ring
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

    def __init__(self, models=None):
        self._models = {}  # name -> Model
        self._ready = {}  # name -> bool
        self._lock = threading.Lock()
        self._closed = False  # guarded-by: _lock
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
        for m in models or []:
            self.register_model(m)

    def register_model(self, model, ready=True):
        with self._lock:
            self._models[model.name] = model
            self._ready[model.name] = ready
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
        """The request's ``timeout`` parameter (microseconds) as a
        ``time.monotonic()`` deadline on ``request.deadline``."""
        t = request.parameters.get("timeout")
        if t:
            try:
                request.deadline = time.monotonic() + int(t) / 1e6
            except (TypeError, ValueError):
                raise BadRequest(
                    "request parameter 'timeout' must be an integer "
                    "microsecond count (got {!r})".format(t))

    @staticmethod
    def _check_deadline(deadline, when):
        if deadline is not None and time.monotonic() >= deadline:
            raise RequestTimedOut(
                "request deadline expired {} execution".format(when))

    def infer_stream(self, request):
        """Execute a decoupled request; yields one InferResponse per
        response the model produces.  Failures inside the model surface
        as TorchServeError (a typed one, such as the scheduler's 429 shed
        or 503 shutdown, passes through, ValueError is a 400, anything
        else a 500).  A response produced past the request's
        deadline ends the stream with a 504."""
        model = self._get_model(request.model_name, request.model_version)
        if not model.decoupled:
            raise BadRequest(
                "model '{}' is not a decoupled model".format(model.name))
        self._resolve_deadline(request)
        self._check_deadline(request.deadline, "before")
        declared = {t.name: t for t in model.outputs}
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
                yield InferResponse(model.name, model.version, request.id,
                                    outputs, params)
        except TorchServeError:
            raise
        except ValueError as e:
            raise BadRequest("model '{}': {}".format(model.name, e))
        except Exception as e:
            raise TorchServeError(
                "inference failed for model '{}': {}".format(model.name, e),
                code=500)

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
