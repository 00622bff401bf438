"""Wire-tensor (de)serialization shared by the HTTP and gRPC front ends:
numpy <-> raw bytes for every KServe-v2 datatype, BYTES and BF16
included, and the port's wire map (:func:`wire_to_np_dtype`) — the port
of ``tpuserver/tensor_io.py``.

BYTES tensors are ``np.object_`` arrays of ``bytes``; on the wire each
element is a little-endian uint32 length and then its bytes, in C order
(the port's own copies of ``serialize_byte_tensor`` and
``deserialize_bytes_tensor``).  BF16 is bits: a BF16 tensor on the host
is an ``np.uint16`` array of its bit patterns, and on the device a
``torch.bfloat16`` tensor (``Tensor.view``).  Floats become BF16 bits by
round-to-nearest-even, the conversion the JAX package's ``ml_dtypes``
makes, so the bytes on the wire equal the JAX package's for the same
values."""

import struct

import numpy as np
import torch

from tpuserver_torch import cuda_shared_memory as csm
from tpuserver_torch.errors import BadRequest

#: KServe-v2 wire datatype of each numpy dtype the port's models emit
_WIRE_DTYPES = {
    np.dtype(np.bool_): "BOOL",
    np.dtype(np.int8): "INT8",
    np.dtype(np.int16): "INT16",
    np.dtype(np.int32): "INT32",
    np.dtype(np.int64): "INT64",
    np.dtype(np.uint8): "UINT8",
    np.dtype(np.uint16): "UINT16",
    np.dtype(np.uint32): "UINT32",
    np.dtype(np.uint64): "UINT64",
    np.dtype(np.float16): "FP16",
    np.dtype(np.float32): "FP32",
    np.dtype(np.float64): "FP64",
    np.dtype(np.object_): "BYTES",
}
#: the numpy dtype of each wire datatype; BF16 travels as its bits
_NP_DTYPES = dict({v: k for k, v in _WIRE_DTYPES.items()},
                  BF16=np.dtype(np.uint16))
#: wire datatype of each torch dtype a model's tensor may carry
_TORCH_WIRE = {
    torch.bool: "BOOL", torch.int8: "INT8", torch.int16: "INT16",
    torch.int32: "INT32", torch.int64: "INT64", torch.uint8: "UINT8",
    torch.float16: "FP16", torch.float32: "FP32", torch.float64: "FP64",
    torch.bfloat16: "BF16",
}


def wire_to_np_dtype(datatype):
    """numpy dtype of a KServe-v2 wire datatype (BadRequest if unknown);
    BF16 is ``np.uint16``, its bits."""
    try:
        return _NP_DTYPES[datatype]
    except KeyError:
        raise BadRequest("unsupported datatype '{}'".format(datatype))


def wire_datatype(array):
    """The wire datatype of an array or tensor an undeclared output
    carries (a typed 400 when it has none)."""
    if isinstance(array, torch.Tensor):
        datatype = _TORCH_WIRE.get(array.dtype)
    else:
        datatype = _WIRE_DTYPES.get(np.asarray(array).dtype)
    if datatype is None:
        raise BadRequest("no wire datatype for {}".format(array.dtype))
    return datatype


def serialize_byte_tensor(array):
    """A BYTES tensor as its wire bytes: each element's 4-byte
    little-endian length, then the element (``str`` as UTF-8), in C
    order."""
    parts = []
    for obj in np.asarray(array, dtype=np.object_).reshape(-1):
        b = obj if isinstance(obj, bytes) else str(obj).encode("utf-8")
        parts.append(struct.pack("<I", len(b)))
        parts.append(b)
    return b"".join(parts)


def deserialize_bytes_tensor(raw):
    """The inverse of :func:`serialize_byte_tensor`: a 1-D ``np.object_``
    array of ``bytes`` (a typed 400 for a truncated buffer)."""
    items = []
    offset = 0
    raw = bytes(raw)
    try:
        while offset < len(raw):
            (length,) = struct.unpack_from("<I", raw, offset)
            offset += 4
            if offset + length > len(raw):
                raise struct.error("element runs past the buffer")
            items.append(raw[offset:offset + length])
            offset += length
    except struct.error as e:
        raise BadRequest("malformed BYTES tensor: {}".format(e))
    return np.array(items, dtype=np.object_)


def serialized_byte_size(array):
    """The bytes a BYTES tensor takes on the wire."""
    return sum(4 + len(obj if isinstance(obj, bytes)
                       else str(obj).encode("utf-8"))
               for obj in np.asarray(array, dtype=np.object_).reshape(-1))


def bf16_bits(array):
    """BF16 bit patterns (``np.uint16``) of ``array``: ``np.uint16`` bits
    pass through; floats round to nearest even; a ``torch.bfloat16``
    tensor is reinterpreted (copied to the host when on the card)."""
    if isinstance(array, torch.Tensor):
        if array.dtype != torch.bfloat16:
            array = array.to(torch.bfloat16)
        return csm.to_host(array.contiguous().view(torch.int16)).view(
            np.uint16)
    array = np.asarray(array)
    if array.dtype == np.uint16:
        return array
    if array.dtype.kind != "f":
        raise BadRequest(
            "cannot convert {} values to BF16".format(array.dtype))
    t = torch.from_numpy(np.ascontiguousarray(array, dtype=np.float32))
    return t.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def binary_from_array(array, datatype):
    """The raw wire bytes of ``array`` as ``datatype``."""
    if datatype == "BYTES":
        return serialize_byte_tensor(array)
    if datatype == "BF16":
        return np.ascontiguousarray(bf16_bits(array)).astype("<u2").tobytes()
    if isinstance(array, torch.Tensor):
        array = csm.to_host(array)
    return np.ascontiguousarray(
        np.asarray(array, dtype=wire_to_np_dtype(datatype))).tobytes()


def array_from_binary(raw, datatype, shape):
    """The array of raw wire bytes: BYTES as ``np.object_``, BF16 as
    ``np.uint16`` bits, everything else a read-only view of ``raw``."""
    shape = [int(s) for s in shape]
    if datatype == "BYTES":
        array = deserialize_bytes_tensor(raw)
        try:
            return array.reshape(shape)
        except ValueError as e:
            raise BadRequest("BYTES input of {} elements does not match its "
                             "shape {}: {}".format(array.size, shape, e))
    np_dtype = wire_to_np_dtype(datatype)
    want = int(np.prod(shape, dtype=np.int64)) * np_dtype.itemsize
    if len(raw) != want:
        raise BadRequest(
            "raw input of {} bytes does not match its shape {} of {} ({} "
            "bytes)".format(len(raw), shape, datatype, want))
    return np.frombuffer(raw, dtype=np_dtype).reshape(shape)


def array_from_json_data(data, datatype, shape):
    """An input's JSON ``data`` as an array: BYTES from (nested) strings,
    BF16 from numbers (rounded to BF16 bits), anything else by the wire
    map.  A typed 400 when the data does not fit."""
    try:
        if datatype == "BYTES":
            flat = []
            stack = [data]
            while stack:
                item = stack.pop()
                if isinstance(item, list):
                    stack.extend(reversed(item))
                else:
                    flat.append(item.encode("utf-8")
                                if isinstance(item, str) else item)
            return np.array(flat, dtype=np.object_).reshape(shape)
        if datatype == "BF16":
            return bf16_bits(np.asarray(data, dtype=np.float32)).reshape(
                shape)
        return np.asarray(data, dtype=wire_to_np_dtype(datatype)).reshape(
            shape)
    except (TypeError, ValueError) as e:
        raise BadRequest("input data of {} with shape {}: {}".format(
            datatype, shape, e))


def json_from_array(array, datatype):
    """An output's JSON ``data``: BYTES as strings, numbers as a flat
    list.  BF16 has no JSON form (a typed 400: ask for binary data)."""
    if datatype == "BYTES":
        return [v.decode("utf-8", errors="replace")
                if isinstance(v, bytes) else str(v)
                for v in np.asarray(array, dtype=np.object_).reshape(-1)]
    if datatype == "BF16":
        raise BadRequest("BF16 outputs require binary_data=true")
    if isinstance(array, torch.Tensor):
        array = csm.to_host(array)
    return np.asarray(array).reshape(-1).tolist()
