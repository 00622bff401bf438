"""Wire-tensor (de)serialization of the gRPC front end: numpy <-> raw
bytes for every datatype of the port's wire map
(``tpuserver_torch.core.wire_to_np_dtype``).  The port of
``tpuserver/tensor_io.py``, which also carries BYTES (4-byte length
prefixes) and BF16; the port's map has neither yet, so a raw BYTES or
BF16 tensor is a typed 400."""

import numpy as np

from tpuserver_torch.core import wire_to_np_dtype
from tpuserver_torch.errors import BadRequest

#: datatypes of the KServe-v2 wire that the port does not carry yet
UNSUPPORTED = ("BYTES", "BF16")


def _refuse(datatype):
    if datatype in UNSUPPORTED:
        raise BadRequest(
            "datatype {} is not supported by this server (no {} tensors "
            "on its wire yet)".format(datatype, datatype))


def binary_from_array(array, datatype):
    _refuse(datatype)
    return np.ascontiguousarray(
        np.asarray(array, dtype=wire_to_np_dtype(datatype))).tobytes()


def array_from_binary(raw, datatype, shape):
    _refuse(datatype)
    np_dtype = wire_to_np_dtype(datatype)
    shape = [int(s) for s in shape]
    want = int(np.prod(shape, dtype=np.int64)) * np_dtype.itemsize
    if len(raw) != want:
        raise BadRequest(
            "raw input of {} bytes does not match its shape {} of {} ({} "
            "bytes)".format(len(raw), shape, datatype, want))
    return np.frombuffer(raw, dtype=np_dtype).reshape(shape)
