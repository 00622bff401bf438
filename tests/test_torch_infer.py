"""The port's unary KServe-v2 verb (``/infer`` and ``ModelInfer``) on the
CPU, held against the JAX package's front ends on the same requests: the
fixture models (``tpuserver_torch.models.default_models``) beside the
JAX package's, each behind an HTTP and a gRPC front end.

Covered: ``simple`` as JSON and binary, BYTES (``simple_string``,
``identity_string``), BF16 (``identity_bf16``: the response bytes equal
JAX's), classification strings, sequences (START/END, a missing START,
idle expiry), the deadline's 504, system shared memory in and out and
CPU "CUDA" regions (``create_shared_memory_region(..., device="cpu")``)
with the 400 for an output larger than its region, the dynamic batcher
(concurrent ``simple`` requests, exact, fewer executions than
inferences), the typed errors, and the repository, log and trace verbs.
The example clients run against both servers in
``test_torch_examples.py``."""

import base64
import gzip
import http.client
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import uuid
import zlib

import grpc
import numpy as np
import pytest

import tritonclient.grpc as grpcclient
import tritonclient.http as httpclient
from tpuserver.core import InferenceServer as JaxServer
from tpuserver.grpc_frontend import GrpcFrontend
from tpuserver.http_frontend import HttpFrontend
from tpuserver.models import default_models as jax_default_models
from tpuserver.models import serving_models as jax_serving_models
from tpuserver.models.simple import SimpleModel as JaxSimple
from tpuserver_torch import cuda_shared_memory as csm
from tpuserver_torch.core import InferenceServer
from tpuserver_torch.grpc_server import GrpcServer
from tpuserver_torch.http_server import HttpServer
from tpuserver_torch.models import default_models, serving_models
from tpuserver_torch.models.simple import SimpleModel
from torch_port_helpers import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

IN0 = np.arange(16, dtype=np.int32).reshape(1, 16)
IN1 = np.ones((1, 16), dtype=np.int32)


class _Side:
    """One server: its core, HTTP port and gRPC url."""

    def __init__(self, core, http_fe, grpc_fe):
        self.core = core
        self.http_fe = http_fe
        self.grpc_fe = grpc_fe
        self.port = http_fe.port
        self.grpc_url = "127.0.0.1:{}".format(grpc_fe.port)
        self.url = "127.0.0.1:{}".format(self.port)


@pytest.fixture(scope="module")
def sides():
    """(JAX, port): the fixture models of each package behind HTTP and
    gRPC front ends."""
    jax_core = JaxServer(jax_default_models())
    jax_side = _Side(jax_core, HttpFrontend(jax_core, port=0).start(),
                     GrpcFrontend(jax_core, port=0).start())
    core = InferenceServer(default_models())
    port_side = _Side(core, HttpServer(core, port=0).start(),
                      GrpcServer(core, port=0).start())
    yield jax_side, port_side
    for side in (jax_side, port_side):
        side.grpc_fe.stop()
        side.http_fe.stop()
    core.close()
    jax_core.close()


def _http(port, method, path, body=None, headers=None):
    """(status, headers, body) of one raw HTTP request."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, {k.lower(): v for k, v in resp.getheaders()}, \
            resp.read()
    finally:
        conn.close()


def _infer(port, model, request_json, binary=b"", headers=None):
    """POST ``/infer``: (status, the JSON header, the binary tail)."""
    body = json.dumps(request_json).encode("utf-8")
    hdrs = dict(headers or {})
    if binary:
        hdrs["Inference-Header-Content-Length"] = str(len(body))
        body += binary
    status, rhdrs, data = _http(port, "POST",
                                "/v2/models/{}/infer".format(model), body,
                                hdrs)
    if rhdrs.get("content-encoding") == "gzip":
        data = gzip.decompress(data)
    n = int(rhdrs.get("inference-header-content-length") or len(data))
    return status, json.loads(data[:n]), data[n:]


def _both(sides, fn):
    """``fn(side)`` on the JAX side and the port's."""
    return fn(sides[0]), fn(sides[1])


def _same_answer(a, b):
    """Two ``_infer`` answers agree: status, JSON (model_name aside from
    nothing: both packages name the model alike) and binary tail."""
    assert a[0] == b[0], (a, b)
    if a[0] == 200:
        assert a[1] == b[1]
        assert a[2] == b[2]


def _simple_json():
    return {"inputs": [
        {"name": "INPUT0", "datatype": "INT32", "shape": [1, 16],
         "data": IN0.reshape(-1).tolist()},
        {"name": "INPUT1", "datatype": "INT32", "shape": [1, 16],
         "data": IN1.reshape(-1).tolist()}]}


def test_simple_json_and_binary_equal_jax(sides):
    req = _simple_json()
    a, b = _both(sides, lambda s: _infer(s.port, "simple", req))
    _same_answer(a, b)
    assert b[1]["outputs"][0]["data"] == (IN0 + IN1).reshape(-1).tolist()
    req = {"inputs": [
        {"name": n, "datatype": "INT32", "shape": [1, 16],
         "parameters": {"binary_data_size": 64}} for n in ("INPUT0",
                                                           "INPUT1")],
        "outputs": [{"name": "OUTPUT0", "parameters": {"binary_data": True}},
                    {"name": "OUTPUT1"}]}
    binary = IN0.tobytes() + IN1.tobytes()
    for headers in ({}, {"Accept-Encoding": "gzip"}):
        a, b = _both(sides, lambda s: _infer(s.port, "simple", req, binary,
                                             headers))
        _same_answer(a, b)
        assert np.frombuffer(b[2], np.int32).tolist() == (
            IN0 + IN1).reshape(-1).tolist()
        assert b[1]["outputs"][1]["data"] == (IN0 - IN1).reshape(-1).tolist()
    # gzip- and deflate-compressed request bodies, and a deflate answer
    body = json.dumps(_simple_json()).encode("utf-8")
    for encoding, packed in (("gzip", gzip.compress(body)),
                             ("deflate", zlib.compress(body))):
        a, b = _both(sides, lambda s: _http(
            s.port, "POST", "/v2/models/simple/infer", packed,
            {"Content-Encoding": encoding, "Accept-Encoding": "deflate"}))
        assert a[0] == b[0] == 200
        assert a[1]["content-encoding"] == b[1]["content-encoding"] == \
            "deflate"
        assert json.loads(zlib.decompress(a[2])) == json.loads(
            zlib.decompress(b[2]))


@pytest.mark.parametrize("model", ["simple_string", "identity_string"])
def test_bytes_equal_jax_over_http_and_grpc(sides, model):
    values = np.array([str(v).encode() for v in range(16)],
                      dtype=np.object_)
    names = ("INPUT0", "INPUT1") if model == "simple_string" else ("INPUT0",)
    shape = [1, 16] if model == "simple_string" else [16]
    arrays = [values.reshape(shape),
              np.array([b"7"] * 16, dtype=np.object_).reshape(shape)]
    json_req = {"inputs": [
        {"name": n, "datatype": "BYTES", "shape": shape,
         "data": [v.decode() for v in a.reshape(-1)]}
        for n, a in zip(names, arrays)]}
    a, b = _both(sides, lambda s: _infer(s.port, model, json_req))
    _same_answer(a, b)
    bin_req = {"inputs": [
        {"name": n, "datatype": "BYTES", "shape": shape,
         "parameters": {"binary_data_size": len(_ser(a))}}
        for n, a in zip(names, arrays)],
        "parameters": {"binary_data_output": True}}
    binary = b"".join(_ser(a) for a in arrays[:len(names)])
    a, b = _both(sides, lambda s: _infer(s.port, model, bin_req, binary))
    _same_answer(a, b)

    def grpc_call(side):
        client = grpcclient.InferenceServerClient(side.grpc_url)
        try:
            inputs = []
            for n, arr in zip(names, arrays):
                inp = grpcclient.InferInput(n, shape, "BYTES")
                inp.set_data_from_numpy(arr)
                inputs.append(inp)
            resp = client.infer(model, inputs).get_response()
            return list(resp.raw_output_contents), [
                (o.name, o.datatype, list(o.shape)) for o in resp.outputs]
        finally:
            client.close()

    ga, gb = _both(sides, grpc_call)
    assert ga == gb


def _ser(arr):
    from tpuserver_torch.tensor_io import serialize_byte_tensor

    return serialize_byte_tensor(arr)


def test_bf16_bytes_identical_to_jax(sides):
    import ml_dtypes

    values = np.array([[1.5, -2.25, 3.0e-3, 65504.0, 1e-8, -0.0, 7.1, 0.1]],
                      dtype=np.float32)
    bits = values.astype(ml_dtypes.bfloat16)
    req = {"inputs": [{"name": "INPUT0", "datatype": "BF16",
                       "shape": [1, 8],
                       "parameters": {"binary_data_size": 16}}],
           "parameters": {"binary_data_output": True}}
    a, b = _both(sides, lambda s: _infer(s.port, "identity_bf16", req,
                                         bits.tobytes()))
    _same_answer(a, b)
    assert b[2] == bits.tobytes()
    # JSON numbers in: the same round-to-nearest-even bits out
    req = {"inputs": [{"name": "INPUT0", "datatype": "BF16",
                       "shape": [1, 8], "data": values.reshape(-1).tolist()}],
           "outputs": [{"name": "OUTPUT0",
                        "parameters": {"binary_data": True}}]}
    a, b = _both(sides, lambda s: _infer(s.port, "identity_bf16", req))
    _same_answer(a, b)
    assert b[2] == bits.tobytes()
    # a BF16 output has no JSON form on either side
    req["outputs"] = [{"name": "OUTPUT0"}]
    a, b = _both(sides, lambda s: _infer(s.port, "identity_bf16", req))
    assert a[0] == b[0] == 400

    def grpc_call(side):
        client = grpcclient.InferenceServerClient(side.grpc_url)
        try:
            inp = grpcclient.InferInput("INPUT0", [1, 8], "BF16")
            inp.set_data_from_numpy(bits)
            return client.infer("identity_bf16", [inp]).get_response(
            ).raw_output_contents[0]
        finally:
            client.close()

    ga, gb = _both(sides, grpc_call)
    assert ga == gb == bits.tobytes()


def test_classification_strings_equal_jax(sides):
    req = _simple_json()
    req["outputs"] = [{"name": "OUTPUT0",
                       "parameters": {"classification": 3}},
                      {"name": "OUTPUT1",
                       "parameters": {"classification": 2,
                                      "binary_data": True}}]
    a, b = _both(sides, lambda s: _infer(s.port, "simple", req))
    _same_answer(a, b)
    assert b[1]["outputs"][0]["datatype"] == "BYTES"
    assert b[1]["outputs"][0]["data"][0] == "{:f}:15".format(16.0)


def _seq_req(value, seq_id, start=False, end=False):
    params = {"sequence_id": seq_id}
    if start:
        params["sequence_start"] = True
    if end:
        params["sequence_end"] = True
    return {"inputs": [{"name": "INPUT", "datatype": "INT32", "shape": [1],
                        "data": [value]}], "parameters": params}


def test_sequences_start_end_and_missing_start(sides):
    for side in sides:
        got = []
        for i, v in enumerate((3, 4, 5)):
            status, body, _ = _infer(side.port, "sequence_accumulate",
                                     _seq_req(v, 41, start=i == 0,
                                              end=i == 2))
            assert status == 200
            got.append(body["outputs"][0]["data"][0])
        assert got == [3, 7, 12]
        # ended: the next request without START is refused
        status, body, _ = _infer(side.port, "sequence_accumulate",
                                 _seq_req(1, 41))
        assert status == 400 and "START" in body["error"]
        # sequence id 0 is refused
        status, _, _ = _infer(side.port, "sequence_accumulate",
                              _seq_req(1, 0, start=True))
        assert status == 400

    def grpc_seq(side):
        client = grpcclient.InferenceServerClient(side.grpc_url)
        try:
            out = []
            for i, v in enumerate((2, 9)):
                inp = grpcclient.InferInput("INPUT", [1], "INT32")
                inp.set_data_from_numpy(np.array([v], np.int32))
                out.append(int(client.infer(
                    "sequence_accumulate", [inp], sequence_id=77,
                    sequence_start=i == 0, sequence_end=i == 1).as_numpy(
                    "OUTPUT")[0]))
            return out
        finally:
            client.close()

    assert _both(sides, grpc_seq) == ([2, 11], [2, 11])


def test_idle_sequence_expires(sides):
    for side in sides:
        model = side.core._models["sequence_accumulate"]
        model.max_sequence_idle_us = 100_000
        try:
            assert _infer(side.port, "sequence_accumulate",
                          _seq_req(1, 501, start=True))[0] == 200
            time.sleep(0.3)
            # another sequence's request sweeps the idle one away
            assert _infer(side.port, "sequence_accumulate",
                          _seq_req(1, 502, start=True, end=True))[0] == 200
            status, body, _ = _infer(side.port, "sequence_accumulate",
                                     _seq_req(1, 501))
            assert status == 400 and "START" in body["error"]
        finally:
            del model.max_sequence_idle_us


def test_deadline_is_504(sides):
    req = {"inputs": [
        {"name": "INPUT0", "datatype": "INT32", "shape": [4],
         "data": [1, 2, 3, 4]},
        {"name": "DELAY_US", "datatype": "UINT32", "shape": [1],
         "data": [300000]}], "parameters": {"timeout": 50000}}
    a, b = _both(sides, lambda s: _infer(s.port, "delayed_identity", req))
    assert a[0] == b[0] == 504
    req["parameters"] = {"timeout": 5000000}
    a, b = _both(sides, lambda s: _infer(s.port, "delayed_identity", req))
    _same_answer(a, b)

    def grpc_call(side):
        client = grpcclient.InferenceServerClient(side.grpc_url)
        try:
            inputs = [grpcclient.InferInput("INPUT0", [4], "INT32"),
                      grpcclient.InferInput("DELAY_US", [1], "UINT32")]
            inputs[0].set_data_from_numpy(np.arange(4, dtype=np.int32))
            inputs[1].set_data_from_numpy(np.array([300000], np.uint32))
            with pytest.raises(Exception) as err:
                client.infer("delayed_identity", inputs,
                             parameters={"timeout": 50000})
            return err.value.status()
        finally:
            client.close()

    assert _both(sides, grpc_call) == ("StatusCode.DEADLINE_EXCEEDED",) * 2


def _system_region(nbytes):
    key = "/tt_infer_{}".format(uuid.uuid4().hex[:12])
    fd = os.open("/dev/shm" + key, os.O_CREAT | os.O_RDWR, 0o600)
    os.ftruncate(fd, nbytes)
    os.close(fd)
    return key


def test_system_shm_in_and_out_equal_jax(sides):
    key_in, key_out = _system_region(128), _system_region(128)
    with open("/dev/shm" + key_in, "r+b") as f:
        f.write(IN0.tobytes() + IN1.tobytes())
    try:
        results = []
        for side in sides:
            for name, key in (("in", key_in), ("out", key_out)):
                assert _http(side.port, "POST",
                             "/v2/systemsharedmemory/region/{}/register"
                             .format(name), json.dumps(
                                 {"key": key, "offset": 0,
                                  "byte_size": 128}).encode())[0] == 200
            req = {"inputs": [
                {"name": n, "datatype": "INT32", "shape": [1, 16],
                 "parameters": {"shared_memory_region": "in",
                                "shared_memory_byte_size": 64,
                                "shared_memory_offset": off}}
                for n, off in (("INPUT0", 0), ("INPUT1", 64))],
                "outputs": [
                    {"name": "OUTPUT0", "parameters": {
                        "shared_memory_region": "out",
                        "shared_memory_byte_size": 64}},
                    {"name": "OUTPUT1", "parameters": {
                        "shared_memory_region": "out",
                        "shared_memory_byte_size": 64,
                        "shared_memory_offset": 64}}]}
            status, body, tail = _infer(side.port, "simple", req)
            with open("/dev/shm" + key_out, "rb") as f:
                results.append((status, body, tail, f.read()))
            # an output reference smaller than the output: 400
            req["outputs"][0]["parameters"]["shared_memory_byte_size"] = 32
            small = _infer(side.port, "simple", req)
            assert small[0] == 400 and "at least 64" in small[1]["error"]
            for name in ("in", "out"):
                _http(side.port, "POST",
                      "/v2/systemsharedmemory/region/{}/unregister".format(
                          name))
            with open("/dev/shm" + key_out, "r+b") as f:
                f.write(bytes(128))
        assert results[0] == results[1]
        assert np.frombuffer(results[1][3], np.int32).tolist() == (
            np.concatenate([IN0 + IN1, IN0 - IN1], axis=1)
            .reshape(-1).tolist())
        assert results[1][1]["outputs"][1]["parameters"] == {
            "shared_memory_region": "out", "shared_memory_byte_size": 64,
            "shared_memory_offset": 64}
    finally:
        for key in (key_in, key_out):
            os.unlink("/dev/shm" + key)


def test_cuda_region_in_and_out_on_the_cpu(sides):
    """A CPU "CUDA" region (in-process handle): inputs read as views of
    it, outputs written into it, equal to JAX's in-band answer; the 400
    for an output larger than its reference; BYTES through a region."""
    jax_side, side = sides
    region = csm.create_shared_memory_region("cuda_io", 256, device="cpu")
    try:
        csm.set_shared_memory_region(region, [IN0, IN1])
        raw = csm.get_raw_handle(region).decode()
        assert _http(side.port, "POST",
                     "/v2/cudasharedmemory/region/cuda_io/register",
                     json.dumps({"raw_handle": {"b64": raw}, "device_id": 0,
                                 "byte_size": 256}).encode())[0] == 200
        reads = side.core.shm_stats()["shm_zero_copy_reads"]
        req = {"inputs": [
            {"name": n, "datatype": "INT32", "shape": [1, 16],
             "parameters": {"shared_memory_region": "cuda_io",
                            "shared_memory_byte_size": 64,
                            "shared_memory_offset": off}}
            for n, off in (("INPUT0", 0), ("INPUT1", 64))],
            "outputs": [{"name": "OUTPUT0", "parameters": {
                "shared_memory_region": "cuda_io",
                "shared_memory_byte_size": 64,
                "shared_memory_offset": 128}}, {"name": "OUTPUT1"}]}
        status, body, _ = _infer(side.port, "simple", req)
        assert status == 200
        assert side.core.shm_stats()["shm_zero_copy_reads"] == reads + 2
        ref = _infer(jax_side.port, "simple", _simple_json())[1]
        got = csm.get_contents_as_numpy(region, np.int32, [16], offset=128)
        assert got.tolist() == ref["outputs"][0]["data"]
        assert body["outputs"][1]["data"] == ref["outputs"][1]["data"]
        req["outputs"][0]["parameters"]["shared_memory_byte_size"] = 60
        status, body, _ = _infer(side.port, "simple", req)
        assert status == 400 and "at least 64" in body["error"]
        # an output reference past the region's end: 400
        req["outputs"][0]["parameters"].update(
            shared_memory_byte_size=64, shared_memory_offset=224)
        assert _infer(side.port, "simple", req)[0] == 400
        # BYTES through the region: length-prefixed on both sides
        strings = np.array([b"a", b"bc", b"", b"def"], dtype=np.object_)
        data = _ser(strings)
        csm.set_shared_memory_region(region, [np.frombuffer(data, np.uint8)])
        req = {"inputs": [{"name": "INPUT0", "datatype": "BYTES",
                           "shape": [4], "parameters": {
                               "shared_memory_region": "cuda_io",
                               "shared_memory_byte_size": len(data)}}],
               "outputs": [{"name": "OUTPUT0", "parameters": {
                   "shared_memory_region": "cuda_io",
                   "shared_memory_byte_size": 64,
                   "shared_memory_offset": 128}}]}
        status, body, _ = _infer(side.port, "identity_string", req)
        assert status == 200
        assert bytes(csm.get_contents_as_numpy(
            region, np.uint8, [len(data)], offset=128)) == data
    finally:
        _http(side.port, "POST",
              "/v2/cudasharedmemory/region/cuda_io/unregister")
        csm.destroy_shared_memory_region(region)


def test_dynamic_batcher_coalesces_concurrent_requests():
    """N concurrent ``simple`` requests through a batching copy of it on
    each package: every answer exact, and on the port the executions
    fewer than the inferences (a batch is one model call; the JAX
    package counts one execution per request, a deliberate difference)."""

    # a wide window: the requests of a loaded machine still meet in it
    # (a full batch of 8 closes it at once)
    class PortBatched(SimpleModel):
        dynamic_batching = True
        max_queue_delay_us = 500_000

    class JaxBatched(JaxSimple):
        dynamic_batching = True
        max_queue_delay_us = 500_000

    n = 8
    for server_cls, model, fe_cls in (
            (InferenceServer, PortBatched(), HttpServer),
            (JaxServer, JaxBatched(), HttpFrontend)):
        core = server_cls([model])
        fe = fe_cls(core, port=0).start()
        try:
            answers = [None] * n

            def call(i, port=fe.port):
                req = {"inputs": [
                    {"name": "INPUT0", "datatype": "INT32", "shape": [1, 16],
                     "data": (IN0 * i).reshape(-1).tolist()},
                    {"name": "INPUT1", "datatype": "INT32", "shape": [1, 16],
                     "data": IN1.reshape(-1).tolist()}]}
                answers[i] = _infer(port, "simple", req)

            threads = [threading.Thread(target=call, args=(i,))
                       for i in range(n)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(60)
            for i, (status, body, _) in enumerate(answers):
                assert status == 200
                assert body["outputs"][0]["data"] == (
                    IN0 * i + IN1).reshape(-1).tolist()
                assert body["outputs"][1]["data"] == (
                    IN0 * i - IN1).reshape(-1).tolist()
            stats = json.loads(_http(fe.port, "GET",
                                     "/v2/models/simple/stats")[2])
            st = stats["model_stats"][0]
            assert st["inference_count"] == n
            if server_cls is InferenceServer:
                assert st["execution_count"] < st["inference_count"]
            else:
                assert st["execution_count"] == st["inference_count"]
            assert json.loads(_http(fe.port, "GET",
                                    "/v2/models/simple/config")[2])[
                "dynamic_batching"] == {"preferred_batch_size": [8],
                                        "max_queue_delay_microseconds":
                                            500000}
        finally:
            fe.stop()
            core.close()


def test_typed_errors_equal_jax(sides):
    missing = {"inputs": [_simple_json()["inputs"][0]]}
    extra = _simple_json()
    extra["inputs"].append(dict(extra["inputs"][0], name="INPUT9"))
    for model, req, code in (("simple", missing, 400),
                             ("simple", extra, 400),
                             ("no_such_model", _simple_json(), 404),
                             ("repeat_int32", _simple_json(), 400)):
        a, b = _both(sides, lambda s: _infer(s.port, model, req))
        assert a[0] == b[0] == code, (model, a, b)

    def grpc_code(side):
        client = grpcclient.InferenceServerClient(side.grpc_url)
        try:
            inp = grpcclient.InferInput("INPUT0", [1, 16], "INT32")
            inp.set_data_from_numpy(IN0)
            codes = []
            for model in ("simple", "no_such_model"):
                try:
                    client.infer(model, [inp])
                    codes.append(None)
                except Exception as e:  # noqa: BLE001
                    codes.append(e.status())
            return codes
        finally:
            client.close()

    assert _both(sides, grpc_code) == (
        ["StatusCode.INVALID_ARGUMENT", "StatusCode.NOT_FOUND"],) * 2


def test_repository_log_and_trace_verbs_equal_jax(sides):
    def http_json(side, method, path, body=None):
        status, _, data = _http(side.port, method, path,
                                None if body is None
                                else json.dumps(body).encode())
        return status, json.loads(data) if data else None

    for method, path, body in (
            ("POST", "/v2/repository/index", {}),
            ("GET", "/v2/logging", None),
            ("POST", "/v2/logging", {"log_verbose_level": 1}),
            ("POST", "/v2/logging", {"no_such_setting": 1}),
            ("GET", "/v2/trace/setting", None),
            ("POST", "/v2/trace/setting", {"trace_rate": "7"}),
            ("GET", "/v2/models/simple/trace/setting", None),
            ("POST", "/v2/repository/models/identity_fp32/unload", {}),
            ("POST", "/v2/repository/index", {}),
            ("POST", "/v2/repository/models/identity_fp32/load", {}),
            ("POST", "/v2/repository/models/no_such_model/load", {})):
        a, b = _both(sides, lambda s: http_json(s, method, path, body))
        assert a[0] == b[0], (path, a, b)
        if a[0] == 200:
            assert a[1] == b[1], (path, a, b)

    def grpc_verbs(side):
        client = grpcclient.InferenceServerClient(side.grpc_url)
        try:
            index = client.get_model_repository_index(as_json=True)
            client.unload_model("identity_fp32")
            ready = client.is_model_ready("identity_fp32")
            client.load_model("identity_fp32")
            logs = client.get_log_settings(as_json=True)
            trace = client.update_trace_settings(
                settings={"trace_level": ["TIMESTAMPS"]}, as_json=True)
            return (index, ready, client.is_model_ready("identity_fp32"),
                    logs, trace)
        finally:
            client.close()

    a, b = _both(sides, grpc_verbs)
    assert a == b
    assert a[1] is False and a[2] is True


def test_grpc_unimplemented_is_gone(sides):
    """No verb of the service answers UNIMPLEMENTED on the port."""
    from tpuserver_torch.grpc_proto import grpc_service_pb2 as pb
    from tpuserver_torch.grpc_proto.service import METHODS, SERVICE

    channel = grpc.insecure_channel(sides[1].grpc_url)
    try:
        for name, (req_cls, resp_cls, kind) in METHODS.items():
            if kind != "unary" or name == "ModelInfer":
                continue
            call = channel.unary_unary(
                "/{}/{}".format(SERVICE, name),
                request_serializer=req_cls.SerializeToString,
                response_deserializer=resp_cls.FromString)
            try:
                call(req_cls(), timeout=30)
            except grpc.RpcError as e:
                assert e.code() != grpc.StatusCode.UNIMPLEMENTED, name
        assert isinstance(pb.ModelInferRequest(), pb.ModelInferRequest)
    finally:
        channel.close()


def test_http_client_infer_equals_jax(sides):
    """tritonclient.http's ``infer`` (binary inputs, binary and JSON
    outputs) on both servers."""

    def call(side):
        client = httpclient.InferenceServerClient(side.url)
        try:
            inputs = [httpclient.InferInput("INPUT0", [1, 16], "INT32"),
                      httpclient.InferInput("INPUT1", [1, 16], "INT32")]
            inputs[0].set_data_from_numpy(IN0)
            inputs[1].set_data_from_numpy(IN1, binary_data=False)
            outputs = [httpclient.InferRequestedOutput("OUTPUT0"),
                       httpclient.InferRequestedOutput(
                           "OUTPUT1", binary_data=False)]
            result = client.infer("simple", inputs, outputs=outputs,
                                  request_id="r1")
            return (result.as_numpy("OUTPUT0").tolist(),
                    result.as_numpy("OUTPUT1").tolist(),
                    result.get_response()["id"],
                    client.get_server_metadata()["extensions"])
        finally:
            client.close()

    a, b = _both(sides, call)
    assert a[:3] == b[:3]
    # the port serves CUDA shared memory where JAX serves XLA's
    assert set(a[3]) - {"xla_shared_memory"} == set(b[3])


def test_base64_handle_over_grpc_registers_a_cpu_region(sides):
    """A CPU region registered over gRPC by its raw 64 handle bytes, then
    used for a ``ModelInfer`` output."""
    side = sides[1]
    region = csm.create_shared_memory_region("grpc_out", 64, device="cpu")
    client = grpcclient.InferenceServerClient(side.grpc_url)
    try:
        client.register_cuda_shared_memory(
            "grpc_out", base64.b64decode(csm.get_raw_handle(region)), 0, 64)
        inputs = [grpcclient.InferInput("INPUT0", [1, 16], "INT32"),
                  grpcclient.InferInput("INPUT1", [1, 16], "INT32")]
        inputs[0].set_data_from_numpy(IN0)
        inputs[1].set_data_from_numpy(IN1)
        out = grpcclient.InferRequestedOutput("OUTPUT1")
        out.set_shared_memory("grpc_out", 64)
        resp = client.infer("simple", inputs, outputs=[out]).get_response()
        assert resp.raw_output_contents[0] == b""
        assert resp.outputs[0].parameters[
            "shared_memory_region"].string_param == "grpc_out"
        assert csm.get_contents_as_numpy(region, np.int32, [16]).tolist() \
            == (IN0 - IN1).reshape(-1).tolist()
    finally:
        client.unregister_cuda_shared_memory("grpc_out")
        client.close()
        csm.destroy_shared_memory_region(region)


def test_batchers_stop_with_the_last_front_end():
    """The last front end's stop stops the dynamic batchers (their
    threads end); a front end's start opens the core again, and a new
    batcher serves."""

    class PortBatched(SimpleModel):
        dynamic_batching = True
        max_queue_delay_us = 1000

    core = InferenceServer([PortBatched()])
    fe = HttpServer(core, port=0).start()
    try:
        assert _infer(fe.port, "simple", _simple_json())[0] == 200
        batcher = core._batchers["simple"]
        threads = list(batcher._threads)
        assert all(t.is_alive() for t in threads)
    finally:
        fe.stop()
    assert core._batchers == {}
    assert not any(t.is_alive() for t in threads)
    assert core.server_state() == "stopped"
    fe = HttpServer(core, port=0).start()
    try:
        status, body, _ = _infer(fe.port, "simple", _simple_json())
        assert status == 200
        assert body["outputs"][0]["data"] == (IN0 + IN1).reshape(-1).tolist()
    finally:
        fe.stop()
        core.close()


def test_serving_zoo_names_match_jax():
    """``serving_models`` names the JAX package's vision zoo (BERT is a
    later slice), with the same specs and batching configuration."""
    port = {m.name: m for m in serving_models(include_llama=False,
                                              device="cpu")}
    jax_zoo = {m.name: m for m in jax_serving_models(
        include_bert=False, include_llama=False)}
    assert set(port) == set(jax_zoo)
    for name, model in port.items():
        ref = jax_zoo[name]
        assert [t.as_metadata() for t in model.inputs] == [
            t.as_metadata() for t in ref.inputs]
        assert [t.as_metadata() for t in model.outputs] == [
            t.as_metadata() for t in ref.outputs]
        cfg, ref_cfg = model.config_dict(), ref.config_dict()
        for key in ("max_batch_size", "dynamic_batching",
                    "ensemble_scheduling", "input", "output"):
            assert cfg.get(key) == ref_cfg.get(key), (name, key)
        # the deliberate difference: the card's kind where JAX has TPU
        assert ref_cfg["instance_group"][0]["kind"] == "KIND_TPU"
        assert cfg["instance_group"][0]["kind"] == "KIND_GPU"


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_serve_models_flag_serves_the_fixtures():
    """``serve.py --models fixtures`` on the CPU: the fixture models over
    HTTP and gRPC, no llama; SIGINT stops it."""
    http_port, grpc_port = _free_port(), _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpuserver_torch.serve", "--models",
         "fixtures", "--device", "cpu", "--port", str(http_port),
         "--grpc-port", str(grpc_port)],
        env=dict(os.environ, PYTHONPATH=os.path.join(REPO, "src", "python")),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    # a server that never comes up is killed, which ends the read below
    watchdog = threading.Timer(120, proc.kill)
    watchdog.start()
    try:
        line = proc.stdout.readline()
        while line and "serving" not in line:
            line = proc.stdout.readline()
        assert "simple" in line and "llama" not in line, line
        status, body, _ = _infer(http_port, "simple", _simple_json())
        assert status == 200
        assert body["outputs"][1]["data"] == (IN0 - IN1).reshape(-1).tolist()
        client = grpcclient.InferenceServerClient(
            "127.0.0.1:{}".format(grpc_port))
        try:
            names = [m["name"] for m in client.get_model_repository_index(
                as_json=True)["models"]]
        finally:
            client.close()
        assert "llama_generate" not in names and "simple_string" in names
        assert _http(http_port, "GET",
                     "/v2/models/llama_generate")[0] == 404
    finally:
        watchdog.cancel()
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def test_batcher_pads_with_row_zero_and_refuses_a_misdeclared_output():
    """The batcher's padding rows copy row 0 (host parts on the host,
    tensor parts with ``torch.cat``), and a declared output without the
    batch dim fails its batch loudly (400)."""
    import torch

    from tpuserver_torch.core import _DynamicBatcher, _BatchSlot

    class Echo(SimpleModel):
        dynamic_batching = True

    batcher = _DynamicBatcher(Echo())
    try:
        host = [_BatchSlot({"X": np.full((1, 2), i, np.int32)}, 1)
                for i in (3, 5, 7)]
        stacked = batcher._stack(host, 3, batcher._bucket(3))["X"]
        assert stacked.tolist() == [[3, 3], [5, 5], [7, 7], [3, 3]]
        device = [_BatchSlot({"X": torch.full((1, 2), i)}, 1)
                  for i in (3, 5, 7)]
        stacked = batcher._stack(device, 3, 4)["X"]
        assert stacked.tolist() == [[3, 3], [5, 5], [7, 7], [3, 3]]
    finally:
        batcher.stop()

    class Misdeclared(SimpleModel):
        dynamic_batching = True
        max_queue_delay_us = 1000

        def execute(self, inputs, request):
            return {"OUTPUT0": np.zeros(16, np.int32),
                    "OUTPUT1": np.zeros(16, np.int32)}

    core = InferenceServer([Misdeclared()])
    fe = HttpServer(core, port=0).start()
    try:
        req = _simple_json()
        for tin in req["inputs"]:
            tin["shape"], tin["data"] = [2, 16], tin["data"] * 2
        status, body, _ = _infer(fe.port, "simple", req)
        assert status == 400 and "must carry the batch dim" in body["error"]
    finally:
        fe.stop()
        core.close()
