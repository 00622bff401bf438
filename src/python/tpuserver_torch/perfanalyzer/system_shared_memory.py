"""Client-side system (POSIX) shared memory for the perf analyzer: the
port's copy of the five region functions of
``tritonclient/utils/shared_memory`` (create, set, get as numpy, list,
destroy), over ``/dev/shm`` with ``os`` and ``mmap`` instead of that
module's native shim.  A region made here is what the core's
``register_system_shm(name, key, offset, byte_size)`` maps.  Fixed-size
tensors need neither torch nor the core: only BYTES ones import the
port's wire serializer.
"""

import mmap
import os

import numpy as np


class SharedMemoryException(Exception):
    """A system shared-memory error."""


class SharedMemoryRegionHandle:
    """A created region: its key (``/name`` under ``/dev/shm``), its
    mapping and its size."""

    def __init__(self, triton_shm_name, shm_key, shm_fd, mapping,
                 byte_size):
        self.triton_shm_name = triton_shm_name
        self.shm_key = shm_key
        self.shm_fd = shm_fd
        self.mapping = mapping
        self.byte_size = byte_size
        self.closed = False


# shm key -> handle of the regions this process made
_mapped_regions = {}


def _path(shm_key):
    return "/dev/shm/" + shm_key.lstrip("/")


def create_shared_memory_region(triton_shm_name, shm_key, byte_size):
    """Create (or open an existing) region ``shm_key`` of ``byte_size``
    bytes and map it; returns its handle."""
    try:
        fd = os.open(_path(shm_key), os.O_RDWR | os.O_CREAT, 0o600)
    except OSError as e:
        raise SharedMemoryException(
            "unable to open/create shared memory region '{}': {}".format(
                shm_key, e))
    try:
        os.ftruncate(fd, byte_size)
        mapping = mmap.mmap(fd, byte_size)
    except (OSError, ValueError) as e:
        os.close(fd)
        raise SharedMemoryException(
            "unable to size or map shared memory region '{}': {}".format(
                shm_key, e))
    handle = SharedMemoryRegionHandle(triton_shm_name, shm_key, fd, mapping,
                                      byte_size)
    _mapped_regions[shm_key] = handle
    return handle


def set_shared_memory_region(shm_handle, input_values, offset=0):
    """Write the arrays one after another into the region from
    ``offset``; BYTES tensors in their serialized form."""
    if not isinstance(input_values, (list, tuple)):
        raise SharedMemoryException(
            "input_values must be specified as a list/tuple of numpy arrays")
    cur = offset
    for value in input_values:
        value = np.asarray(value)
        if value.dtype == np.object_ or value.dtype.type in (np.bytes_,
                                                             np.str_):
            from tpuserver_torch.tensor_io import serialize_byte_tensor

            data = serialize_byte_tensor(value)
        else:
            data = np.ascontiguousarray(value).tobytes()
        if cur + len(data) > shm_handle.byte_size:
            raise SharedMemoryException(
                "unable to set shared memory region: data exceeds region "
                "size")
        shm_handle.mapping[cur:cur + len(data)] = data
        cur += len(data)


def get_contents_as_numpy(shm_handle, datatype, shape, offset=0):
    """A tensor of numpy ``datatype`` and ``shape`` read out of the
    region at ``offset`` (a copy)."""
    np_dtype = np.dtype(datatype)
    if np_dtype == np.object_:
        from tpuserver_torch.tensor_io import deserialize_bytes_tensor

        raw = bytes(shm_handle.mapping[offset:])
        return deserialize_bytes_tensor(raw)[:int(np.prod(shape))].reshape(
            shape)
    nbytes = int(np.prod(shape, dtype=np.int64)) * np_dtype.itemsize
    if offset + nbytes > shm_handle.byte_size:
        raise SharedMemoryException(
            "unable to read {} bytes at offset {} of a {}-byte region".format(
                nbytes, offset, shm_handle.byte_size))
    return np.frombuffer(bytes(shm_handle.mapping[offset:offset + nbytes]),
                         dtype=np_dtype).reshape(shape)


def mapped_shared_memory_regions():
    """The keys of the regions this process made and has not
    destroyed."""
    return list(_mapped_regions)


def destroy_shared_memory_region(shm_handle):
    """Unmap and unlink the region.  Idempotent."""
    if shm_handle.closed:
        return
    shm_handle.closed = True
    _mapped_regions.pop(shm_handle.shm_key, None)
    try:
        shm_handle.mapping.close()
        os.close(shm_handle.shm_fd)
        os.unlink(_path(shm_handle.shm_key))
    except OSError as e:
        raise SharedMemoryException(
            "unable to unmap/unlink shared memory region '{}': {}".format(
                shm_handle.shm_key, e))
