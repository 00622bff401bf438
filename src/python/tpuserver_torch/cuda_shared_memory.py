"""CUDA shared memory for the port: the counterpart of
``tritonclient/utils/xla_shared_memory`` with the API kept (and
``get_contents_as_tensor`` in place of ``get_contents_as_jax``).

A region is a flat ``uint8`` tensor on one device.  On the card its
memory comes from ``cudaMalloc`` (``csrc/cuda_ipc.cu``), never from
PyTorch's caching allocator, whose blocks a CUDA IPC handle cannot name
apart; ``torch.as_tensor`` wraps it without a copy, and the region object
keeps it alive until :func:`destroy_shared_memory_region`.  The raw
handle is the base64 of the allocation's 64-byte ``cudaIpcMemHandle_t``
and nothing more, which is Triton's own CUDA-shm wire format, so
Triton's C++ and Python clients and this module interoperate.

Attaching from a raw handle:

- in the process that made the region, through a registry keyed by the
  64 handle bytes (``cudaIpcOpenMemHandle`` fails in the process that
  made the handle): the attached handle aliases the owner's memory;
- in another process, by ``cudaIpcOpenMemHandle``; detaching closes the
  mapping and never frees the memory, which stays its owner's.

On the CPU (``device="cpu"``, for tests) a region is a host tensor whose
handle only an in-process attach accepts; from another process it is a
:class:`CudaSharedMemoryException`.

Host transfers into and out of a CUDA region (``set_shared_memory_region``,
``get_contents_as_numpy``, :func:`to_host`) run on a copy stream of their
own and have completed when the call returns: they neither wait for nor
delay the model's work on the device's default stream.  Every CUDA error
of these calls raises a :class:`CudaSharedMemoryException`.
"""

import base64
import ctypes
import functools
import threading
import uuid
from collections import OrderedDict

import numpy as np
import torch

from tpuserver_torch import resolve_device

__all__ = [
    "CudaSharedMemoryException",
    "RegionGone",
    "CudaShmHandle",
    "create_shared_memory_region",
    "get_raw_handle",
    "attach_from_raw_handle",
    "set_shared_memory_region",
    "get_contents_as_numpy",
    "get_contents_as_tensor",
    "allocated_shared_memory_regions",
    "destroy_shared_memory_region",
    "to_host",
]

#: bytes of a ``cudaIpcMemHandle_t``, the whole raw handle
HANDLE_BYTES = 64
# a CPU region's handle: this prefix, then a random id, zero-padded
_CPU_PREFIX = b"tpuserver_torch cpu region\0"

# the KServe-v2 wire datatypes a region's contents are read as
_WIRE_DTYPES = {
    "BOOL": torch.bool, "INT8": torch.int8, "INT16": torch.int16,
    "INT32": torch.int32, "INT64": torch.int64, "UINT8": torch.uint8,
    "FP16": torch.float16, "FP32": torch.float32, "FP64": torch.float64,
    "BF16": torch.bfloat16,
}

# handle bytes -> owner CudaShmHandle: the in-process attach path
_LOCAL_REGIONS = {}
# the handles of regions this process destroyed, newest last (at most
# _RETIRED_KEPT): attaching one is RegionGone, not an IPC call on freed
# memory
_RETIRED = OrderedDict()
_RETIRED_KEPT = 4096
_REGIONS_LOCK = threading.Lock()  # guards both


class CudaSharedMemoryException(Exception):
    """A CUDA shared-memory error (a bad handle, a CUDA IPC call that
    failed, an access out of the region's bounds)."""


class RegionGone(CudaSharedMemoryException):
    """The handle names a region this process made and has destroyed
    (or a CPU region of another process, which cannot be attached)."""


def _lib():
    from tpuserver_torch.ops import _build

    return _build.load_library()


def _check(rc, what):
    if rc != 0:
        msg = _lib().tt_ipc_error_string(rc).decode(errors="replace")
        raise CudaSharedMemoryException(
            "{} failed: CUDA error {} ({})".format(what, rc, msg))


@functools.lru_cache(maxsize=None)
def _io_stream(device):
    """The copy stream of a device's shm host transfers."""
    return torch.cuda.Stream(device)


class _DeviceMemory:
    """A device allocation as the CUDA array interface describes it, for
    ``torch.as_tensor``; the tensor keeps this object, and through it the
    region handle, alive."""

    def __init__(self, ptr, byte_size, handle):
        self.__cuda_array_interface__ = {
            "shape": (byte_size,), "typestr": "|u1", "data": (ptr, False),
            "strides": None, "version": 2}
        self.handle = handle


class CudaShmHandle:
    """A shared-memory region: ``tensor`` is its flat ``uint8`` memory on
    ``device``.  Owner handles come from
    :func:`create_shared_memory_region`; attached ones from
    :func:`attach_from_raw_handle` (``mapped`` when the attach opened a
    CUDA IPC mapping, else an in-process alias of the owner)."""

    def __init__(self, name, byte_size, device, raw, ptr=None,
                 tensor=None, owner=False, mapped=False):
        self.name = name
        self.byte_size = int(byte_size)
        self.device = device
        self.raw = raw  # the 64 handle bytes
        self._ptr = ptr
        self.owner = owner
        self.mapped = mapped
        self.closed = False
        if tensor is None:
            tensor = torch.as_tensor(_DeviceMemory(ptr, self.byte_size, self))
        self.tensor = tensor

    @property
    def device_id(self):
        if self.device.type != "cuda":
            return 0
        return self.device.index or 0

    def _view(self, offset, nbytes):
        if self.closed:
            raise CudaSharedMemoryException(
                "region '{}' is closed".format(self.name))
        if offset < 0 or nbytes < 0 or offset + nbytes > self.byte_size:
            raise CudaSharedMemoryException(
                "{} bytes at offset {} exceed region '{}' of {} bytes".format(
                    nbytes, offset, self.name, self.byte_size))
        return self.tensor[offset:offset + nbytes]

    def read_bytes(self, offset, nbytes):
        """``nbytes`` at ``offset`` as host bytes."""
        return to_host(self._view(offset, nbytes)).tobytes()

    def write_bytes(self, offset, data):
        """Host bytes into the region at ``offset``; complete on return."""
        data = bytes(data)
        view = self._view(offset, len(data))
        if not data:
            return
        src = torch.frombuffer(bytearray(data), dtype=torch.uint8)
        if view.device.type == "cuda":
            with torch.cuda.stream(_io_stream(view.device)):
                view.copy_(src)  # from pageable memory: synchronous
        else:
            view.copy_(src)

    def view(self, offset, dtype, shape):
        """The region's memory at ``offset`` as a ``dtype`` tensor of
        ``shape``: a view, no copy."""
        shape = [int(s) for s in shape]
        itemsize = torch.empty((), dtype=dtype).element_size()
        nbytes = int(np.prod(shape, dtype=np.int64)) * itemsize
        if offset % itemsize:
            raise CudaSharedMemoryException(
                "offset {} is not a multiple of the {}-byte element".format(
                    offset, itemsize))
        return self._view(offset, nbytes).view(dtype).reshape(shape)

    def detach(self):
        """Release an attached handle: close its IPC mapping (the memory
        stays its owner's); an in-process alias holds nothing.  An owner
        is released by :func:`destroy_shared_memory_region` instead."""
        if self.closed or self.owner:
            return
        self.closed = True
        if self.mapped:
            _check(_lib().tt_ipc_close(self._ptr, self.device_id),
                   "cudaIpcCloseMemHandle")


def _torch_dtype(datatype):
    """A wire datatype string ('INT32'), numpy dtype or torch dtype as a
    torch dtype."""
    if isinstance(datatype, torch.dtype):
        return datatype
    if isinstance(datatype, str) and datatype in _WIRE_DTYPES:
        return _WIRE_DTYPES[datatype]
    try:
        return torch.from_numpy(np.empty(0, dtype=np.dtype(datatype))).dtype
    except TypeError as e:
        raise CudaSharedMemoryException(
            "unsupported datatype {!r}: {}".format(datatype, e))


def to_host(tensor):
    """A tensor's contents as a numpy array.  From the card the copy runs
    on the device's shm copy stream, so it does not wait behind the
    model's queued work; it has completed on return."""
    if tensor.device.type != "cuda":
        return tensor.detach().clone().numpy()
    with torch.cuda.stream(_io_stream(tensor.device)):
        return tensor.to("cpu").numpy()


def create_shared_memory_region(triton_shm_name, byte_size, device_id=0,
                                device=None):
    """A region of ``byte_size`` zeroed bytes on the card ``device_id``
    (``device`` overrides it; ``"cpu"`` makes a host region, for tests).
    Returns the owner :class:`CudaShmHandle`."""
    byte_size = int(byte_size)
    if byte_size <= 0:
        raise CudaSharedMemoryException(
            "region '{}' needs a positive byte size (got {})".format(
                triton_shm_name, byte_size))
    dev = resolve_device(device if device is not None
                         else "cuda:{}".format(int(device_id)))
    if dev.type == "cpu":
        raw = (_CPU_PREFIX + uuid.uuid4().bytes).ljust(HANDLE_BYTES, b"\0")
        handle = CudaShmHandle(
            triton_shm_name, byte_size, dev, raw,
            tensor=torch.zeros(byte_size, dtype=torch.uint8), owner=True)
    else:
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        lib = _lib()
        ptr = ctypes.c_void_p()
        _check(lib.tt_ipc_malloc(byte_size, dev.index, ctypes.byref(ptr)),
               "cudaMalloc of {} bytes".format(byte_size))
        try:
            buf = ctypes.create_string_buffer(HANDLE_BYTES)
            _check(lib.tt_ipc_get_handle(ptr, dev.index, buf),
                   "cudaIpcGetMemHandle")
            handle = CudaShmHandle(triton_shm_name, byte_size, dev,
                                   buf.raw, ptr=ptr.value, owner=True)
        except BaseException:
            _check(lib.tt_ipc_free(ptr, dev.index), "cudaFree")
            raise
    with _REGIONS_LOCK:
        # cudaMalloc may give a new allocation the handle bytes of one
        # this process destroyed (the same address reused): it is live
        # again
        _RETIRED.pop(handle.raw, None)
        _LOCAL_REGIONS[handle.raw] = handle
    return handle


def get_raw_handle(handle):
    """The base64 of the region's 64-byte handle: what the CUDA-shm
    register call carries as ``raw_handle.b64``."""
    return base64.b64encode(handle.raw)


def attach_from_raw_handle(raw_handle, byte_size=None, device_id=0):
    """Attach a region from its raw handle (the server side of the
    register call).  In the process that made it, the attach aliases the
    owner (``byte_size``, when given, may not exceed the owner's); in
    another, it opens the handle over CUDA IPC on card ``device_id`` and
    needs ``byte_size``, since the handle does not carry it."""
    if isinstance(raw_handle, str):
        raw_handle = raw_handle.encode("ascii")
    try:
        raw = base64.b64decode(raw_handle, validate=True)
    except ValueError as e:
        raise CudaSharedMemoryException(
            "invalid CUDA shared-memory raw handle: {}".format(e))
    if len(raw) != HANDLE_BYTES:
        raise CudaSharedMemoryException(
            "a CUDA shared-memory raw handle is {} bytes (got {})".format(
                HANDLE_BYTES, len(raw)))
    with _REGIONS_LOCK:
        owner = _LOCAL_REGIONS.get(raw)
        retired = raw in _RETIRED
    if retired:
        raise RegionGone("the handle names a region this process destroyed")
    if owner is not None:
        size = owner.byte_size if byte_size is None else int(byte_size)
        if not 0 < size <= owner.byte_size:
            raise CudaSharedMemoryException(
                "byte size {} does not fit region '{}' of {} bytes".format(
                    size, owner.name, owner.byte_size))
        return CudaShmHandle(owner.name, size, owner.device, raw,
                             tensor=owner.tensor[:size])
    if raw.startswith(_CPU_PREFIX):
        raise RegionGone(
            "the handle names a CPU region, which only the process that "
            "made it can attach (or the region was destroyed)")
    if byte_size is None or int(byte_size) <= 0:
        raise CudaSharedMemoryException(
            "attaching a region of another process needs its byte size")
    dev = torch.device("cuda", int(device_id))
    ptr = ctypes.c_void_p()
    _check(_lib().tt_ipc_open(raw, dev.index, ctypes.byref(ptr)),
           "cudaIpcOpenMemHandle")
    return CudaShmHandle("attached", int(byte_size), dev, raw,
                         ptr=ptr.value, mapped=True)


def set_shared_memory_region(handle, input_values, offset=0):
    """Write arrays (numpy arrays or tensors) one after another into the
    region from ``offset``; complete on return."""
    if not isinstance(input_values, (list, tuple)):
        raise CudaSharedMemoryException(
            "input_values must be specified as a list/tuple of arrays")
    cur = int(offset)
    for value in input_values:
        if isinstance(value, torch.Tensor):
            src = value.detach().contiguous().reshape(-1).view(torch.uint8)
            view = handle._view(cur, src.numel())
            if src.device.type == "cpu" and view.device.type == "cuda":
                with torch.cuda.stream(_io_stream(view.device)):
                    view.copy_(src)
            else:
                view.copy_(src)
                if view.device.type == "cuda":
                    torch.cuda.current_stream(view.device).synchronize()
            cur += src.numel()
        else:
            data = np.ascontiguousarray(np.asarray(value)).tobytes()
            handle.write_bytes(cur, data)
            cur += len(data)


def get_contents_as_numpy(handle, datatype, shape, offset=0):
    """The region's contents at ``offset`` as a numpy array (one copy to
    the host).  ``datatype`` is a numpy dtype or a wire datatype string."""
    return to_host(get_contents_as_tensor(handle, datatype, shape, offset))


def get_contents_as_tensor(handle, datatype, shape, offset=0):
    """The region's contents at ``offset`` as a tensor on the region's
    device: a view of the region's memory, no copy."""
    return handle.view(int(offset), _torch_dtype(datatype), shape)


def allocated_shared_memory_regions():
    """The owner handles of the regions this process made and has not
    destroyed."""
    with _REGIONS_LOCK:
        return list(_LOCAL_REGIONS.values())


def destroy_shared_memory_region(handle):
    """Free an owner's region (its memory waits for the device's work in
    flight first).  Views of it must not be used after.  Idempotent."""
    if not handle.owner:
        raise CudaSharedMemoryException(
            "only the handle create_shared_memory_region returned can "
            "destroy region '{}'".format(handle.name))
    with _REGIONS_LOCK:
        if handle.closed:
            return
        handle.closed = True
        _LOCAL_REGIONS.pop(handle.raw, None)
        _RETIRED[handle.raw] = None
        while len(_RETIRED) > _RETIRED_KEPT:
            _RETIRED.popitem(last=False)
    if handle.device.type == "cuda":
        _check(_lib().tt_ipc_free(handle._ptr, handle.device_id), "cudaFree")
