"""The fixture models, copies of ``tpuserver/models/simple.py``: the
`simple` add/sub model of the Triton quick-start (2xINT32[16] ->
sum/diff), identity models (BF16 as its ``np.uint16`` bits), a delayed
identity, a stateful sequence model and a decoupled repeat model.

They stay plain numpy on the host, as the JAX package's do: a request's
round trip costs far more than their arithmetic, so a host-to-device copy
per request would only add to it.  Their ``device_kind`` is ``"cpu"``
(``KIND_CPU`` in their config)."""

import time

import numpy as np

from tpuserver_torch.core import Model, TensorSpec


class _HostModel(Model):
    """A fixture model that runs in numpy on the host."""

    platform = "python"
    backend = "python"
    device_kind = "cpu"


class SimpleModel(_HostModel):
    """INPUT0+INPUT1 -> OUTPUT0, INPUT0-INPUT1 -> OUTPUT1 (INT32[1,16]).

    Plain numpy on the host (see the module's docstring)."""

    name = "simple"
    max_batch_size = 8
    inputs = (
        TensorSpec("INPUT0", "INT32", [16]),
        TensorSpec("INPUT1", "INT32", [16]),
    )
    outputs = (
        TensorSpec("OUTPUT0", "INT32", [16]),
        TensorSpec("OUTPUT1", "INT32", [16]),
    )

    def execute(self, inputs, request):
        in0 = np.asarray(inputs["INPUT0"])
        in1 = np.asarray(inputs["INPUT1"])
        return {"OUTPUT0": in0 + in1, "OUTPUT1": in0 - in1}


class SimpleStringModel(_HostModel):
    """BYTES add/sub model: string-encoded int32s in, string sums out
    (mirror of the reference's simple_string fixture)."""

    name = "simple_string"
    max_batch_size = 8
    inputs = (
        TensorSpec("INPUT0", "BYTES", [16]),
        TensorSpec("INPUT1", "BYTES", [16]),
    )
    outputs = (
        TensorSpec("OUTPUT0", "BYTES", [16]),
        TensorSpec("OUTPUT1", "BYTES", [16]),
    )

    def execute(self, inputs, request):
        in0 = np.array(
            [int(v) for v in inputs["INPUT0"].reshape(-1)], dtype=np.int64
        ).reshape(inputs["INPUT0"].shape)
        in1 = np.array(
            [int(v) for v in inputs["INPUT1"].reshape(-1)], dtype=np.int64
        ).reshape(inputs["INPUT1"].shape)
        add = in0 + in1
        sub = in0 - in1
        return {
            "OUTPUT0": np.array(
                [str(v).encode() for v in add.reshape(-1)], dtype=np.object_
            ).reshape(add.shape),
            "OUTPUT1": np.array(
                [str(v).encode() for v in sub.reshape(-1)], dtype=np.object_
            ).reshape(sub.shape),
        }


class IdentityFP32Model(_HostModel):
    name = "identity_fp32"
    max_batch_size = 0
    inputs = (TensorSpec("INPUT0", "FP32", [-1, -1]),)
    outputs = (TensorSpec("OUTPUT0", "FP32", [-1, -1]),)

    def execute(self, inputs, request):
        return {"OUTPUT0": inputs["INPUT0"]}


class IdentityBF16Model(_HostModel):
    """BF16 passthrough: the bits come back unchanged."""

    name = "identity_bf16"
    max_batch_size = 0
    inputs = (TensorSpec("INPUT0", "BF16", [-1, -1]),)
    outputs = (TensorSpec("OUTPUT0", "BF16", [-1, -1]),)

    def execute(self, inputs, request):
        return {"OUTPUT0": inputs["INPUT0"]}


class IdentityStringModel(_HostModel):
    name = "identity_string"
    max_batch_size = 0
    inputs = (TensorSpec("INPUT0", "BYTES", [-1]),)
    outputs = (TensorSpec("OUTPUT0", "BYTES", [-1]),)

    def execute(self, inputs, request):
        return {"OUTPUT0": inputs["INPUT0"]}


class SequenceAccumulateModel(_HostModel):
    """Stateful sequence model: running int32 sum per sequence id.

    Exercises the sequence_id/sequence_start/sequence_end request controls
    (reference common.h:177-194) end-to-end.
    """

    name = "sequence_accumulate"
    max_batch_size = 0
    sequence = True
    inputs = (TensorSpec("INPUT", "INT32", [1]),)
    outputs = (TensorSpec("OUTPUT", "INT32", [1]),)

    def execute_sequence(self, inputs, state, request):
        acc = state if state is not None else np.zeros([1], dtype=np.int32)
        acc = acc + inputs["INPUT"].astype(np.int32)
        return {"OUTPUT": acc}, acc


class DelayedIdentityModel(_HostModel):
    """INT32 passthrough that sleeps DELAY_US[0] microseconds (or the
    ``delay_us`` request parameter) before responding — fixture for
    client-timeout / cancellation paths (role of the reference's delayed
    custom_identity_int32 used by client_timeout_test.cc)."""

    name = "delayed_identity"
    max_batch_size = 0
    inputs = (
        TensorSpec("INPUT0", "INT32", [-1]),
        TensorSpec("DELAY_US", "UINT32", [1]),
    )
    outputs = (TensorSpec("OUTPUT0", "INT32", [-1]),)

    def execute(self, inputs, request):
        delay_us = int(np.asarray(inputs["DELAY_US"]).reshape(-1)[0])
        delay_us = max(delay_us, int(request.parameters.get("delay_us", 0)))
        if delay_us:
            time.sleep(delay_us / 1e6)
        return {"OUTPUT0": inputs["INPUT0"]}


class RepeatModel(_HostModel):
    """Decoupled model: one request with IN int32[N] produces N streamed
    responses of one element each, the i-th delayed by DELAY[i] usec; WAIT
    delays stream start (mirror of the reference's repeat_int32 model driven
    by simple_grpc_custom_repeat.py:78-105)."""

    name = "repeat_int32"
    max_batch_size = 0
    decoupled = True
    inputs = (
        TensorSpec("IN", "INT32", [-1]),
        TensorSpec("DELAY", "UINT32", [-1]),
        TensorSpec("WAIT", "UINT32", [1]),
    )
    outputs = (TensorSpec("OUT", "INT32", [1]),)

    def execute_stream(self, inputs, request):
        values = np.asarray(inputs["IN"]).reshape(-1)
        delays = np.asarray(inputs["DELAY"]).reshape(-1)
        wait_us = int(np.asarray(inputs["WAIT"]).reshape(-1)[0])
        if wait_us:
            time.sleep(wait_us / 1e6)
        for i, value in enumerate(values):
            delay_us = int(delays[i]) if i < len(delays) else 0
            if delay_us:
                time.sleep(delay_us / 1e6)
            yield {"OUT": np.array([value], dtype=np.int32)}
