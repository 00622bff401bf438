"""The port's gRPC front end (``tpuserver_torch.grpc_server``) on the CPU,
driven by ``tritonclient.grpc`` and by a raw channel over the port's own
pb2 copies: ``ModelStreamInfer`` against the JAX ``GrpcFrontend`` and the
port's own ``/generate_stream`` on the same weights (float32 ``tiny``,
``init_params(PRNGKey(0))`` bridged by ``params_from_jax``), several
generations on one bidi stream, the client's auto-resume after a
``grpc.stream_infer`` drop (with and without ``kv_park``), the typed
error map, CUDA-region registration by raw bytes, the pb2 copies, and
the repo's llama streaming example against the port.

A test that drops a stream mid-generation holds the decode loop in a
step call until the drop was seen (``_StepHold``), so the generation is
still live when its consumer goes, however loaded the machine."""

import base64
import dataclasses
import http.client
import importlib.util
import json
import os
import subprocess
import sys
import threading
import time

import grpc
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tritonclient.grpc as grpcclient
from tpuserver.core import InferenceServer as JaxServer
from tpuserver.grpc_frontend import GrpcFrontend
from tpuserver.models import llama as jl
from tpuserver.models.llama_serving import LlamaGenerateModel as JaxLlama
from tritonclient.grpc import _service as jax_service
from tritonclient.grpc import grpc_service_pb2 as client_pb
from tritonclient.grpc import model_config_pb2 as client_config_pb
from tpuserver_torch import cuda_shared_memory as csm
from tpuserver_torch import fault_points
from tpuserver_torch.core import InferenceServer
from tpuserver_torch.grpc_proto import grpc_service_pb2 as pb
from tpuserver_torch.grpc_proto import model_config_pb2 as config_pb
from tpuserver_torch.grpc_proto import service
from tpuserver_torch.grpc_server import GrpcServer
from tpuserver_torch.http_server import HttpServer
from tpuserver_torch.models import llama as tl
from tpuserver_torch.models.llama_serving import LlamaGenerateModel
from torch_port_helpers import StepHold as _StepHold
from torch_port_helpers import parked_since as _parked_since

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = 512
MAX_SEQ = 64
PROMPTS = [np.array(p, np.int32) for p in (
    [3, 1, 4, 1, 5], [9, 8, 7], [2, 7, 1, 8, 2, 8])]
BUDGETS = [8, 6, 7]
# a drop test's generation: long enough that the drop lands mid-way
LONG_PROMPT = np.arange(1, 11, dtype=np.int32)
LONG_BUDGET = 40
SCOPE = "port-grpc"
WAIT_S = 60.0


def _cfgs():
    return (dataclasses.replace(jl.tiny(vocab=VOCAB), dtype=jnp.float32),
            dataclasses.replace(tl.tiny(vocab=VOCAB), dtype=torch.float32))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread per process: tiny steps stay short when
    several test processes share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tparams():
    jcfg, _ = _cfgs()
    return tl.params_from_jax(jax.tree_util.tree_map(
        np.asarray, jl.init_params(jax.random.PRNGKey(0), jcfg)), "cpu")


@pytest.fixture(autouse=True)
def _clean_faults():
    fault_points.clear()
    yield
    fault_points.clear()


class _Port:
    """The port's model, core (scope ``SCOPE``), HTTP and gRPC servers."""

    def __init__(self, tparams, max_slots, **kwargs):
        self.model = LlamaGenerateModel(
            cfg=_cfgs()[1], max_seq=MAX_SEQ, max_slots=max_slots,
            params=tparams, device="cpu", decode_chunk=4,
            fault_scope=SCOPE, **kwargs)
        self.core = InferenceServer([self.model], fault_scope=SCOPE)
        self.http = HttpServer(self.core, port=0).start()
        self.grpc = GrpcServer(self.core, port=0).start()

    def client(self):
        return grpcclient.InferenceServerClient(self.grpc.url)

    def close(self):
        self.grpc.stop()
        self.http.stop()
        self.core.close()


@pytest.fixture(scope="module", params=[1, 3], ids=["slots1", "slots3"])
def stacks(request, tparams):
    """(the port's stack, the JAX package's GrpcFrontend url and its
    tokens for PROMPTS) at ``max_slots`` 1 and 3."""
    jcfg, _ = _cfgs()
    jax_core = JaxServer([JaxLlama(cfg=jcfg, max_seq=MAX_SEQ,
                                   max_slots=request.param, spec_tokens=0)])
    frontend = GrpcFrontend(jax_core, port=0).start()
    port = _Port(tparams, request.param)
    try:
        client = grpcclient.InferenceServerClient(frontend.url)
        reference = [[t for t, _ in _generate(client, p, n)]
                     for p, n in zip(PROMPTS, BUDGETS)]
        client.close()
        yield port, reference
    finally:
        port.close()
        frontend.stop()
        jax_core.close()


@pytest.fixture
def port3(tparams):
    port = _Port(tparams, 3)
    yield port
    port.close()


def _inputs(prompt, max_tokens):
    p = grpcclient.InferInput("PROMPT_IDS", [len(prompt)], "INT32")
    p.set_data_from_numpy(np.asarray(prompt, np.int32))
    m = grpcclient.InferInput("MAX_TOKENS", [1], "INT32")
    m.set_data_from_numpy(np.array([max_tokens], np.int32))
    return [p, m]


def _generate(client, prompt, max_tokens, parameters=None, **kwargs):
    """(token, seq or None) of each response of ``generate_stream``."""
    out = []
    for result in client.generate_stream(
            "llama_generate", _inputs(prompt, max_tokens),
            parameters=parameters, **kwargs):
        params = result.get_response().parameters
        seq = params["seq"].int64_param if "seq" in params else None
        out.append((int(result.as_numpy("TOKEN")[0]), seq))
    return out


def _http_tokens(port, prompt, max_tokens):
    body = json.dumps({"inputs": [
        {"name": "PROMPT_IDS", "datatype": "INT32", "shape": [len(prompt)],
         "data": [int(t) for t in prompt]},
        {"name": "MAX_TOKENS", "datatype": "INT32", "shape": [1],
         "data": [max_tokens]}]})
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=WAIT_S)
    try:
        conn.request("POST", "/v2/models/llama_generate/generate_stream",
                     body, {"Content-Type": "application/json"})
        text = conn.getresponse().read().decode("utf-8")
    finally:
        conn.close()
    events = [json.loads(line[len("data: "):]) for line in text.splitlines()
              if line.startswith("data: ")]
    assert events[-1] == {"final": True}
    return [ev["outputs"][0]["data"][0] for ev in events[:-1]]


# -- tokens against the JAX GrpcFrontend and the port's HTTP ------------------


def test_stream_tokens_match_jax_grpc_and_port_http(stacks):
    """``ModelStreamInfer`` through ``generate_stream`` streams the JAX
    ``GrpcFrontend``'s tokens and the port's own ``/generate_stream``
    tokens, at ``max_slots`` 1 and 3; the batched path numbers its
    responses 0..n-1 by ``seq``."""
    port, reference = stacks
    client = port.client()
    try:
        for prompt, n, ref in zip(PROMPTS, BUDGETS, reference):
            got = _generate(client, prompt, n)
            assert [t for t, _ in got] == ref
            assert _http_tokens(port.http.port, prompt, n) == ref
            if port.model._max_slots > 1:
                assert [s for _, s in got] == list(range(n))
    finally:
        client.close()


def test_three_generations_on_one_bidi_stream(port3, tparams):
    """Three requests on one stream of a ``concurrent_decoupled`` model
    decode interleaved: responses are told apart by request id, and each
    id's tokens are the model's tokens for its prompt."""
    client = port3.client()
    reference = [[t for t, _ in _generate(client, p, n)]
                 for p, n in zip(PROMPTS, BUDGETS)]
    sched = port3.model._scheduler
    # the first step waits for all three: they decode side by side
    hold = _StepHold(port3.model, 1, lambda: len(sched._streams) == 3,
                     lambda: True)
    got = {str(i): [] for i in range(3)}
    finished = threading.Event()
    errors = []
    order = []

    def callback(result, error):
        if error is not None:
            errors.append(error)
            finished.set()
            return
        resp = result.get_response()
        if resp.parameters["triton_final_response"].bool_param:
            if all(len(got[k]) == n for k, n in zip(sorted(got), BUDGETS)):
                finished.set()
            return
        got[resp.id].append(int(result.as_numpy("TOKEN")[0]))
        order.append(resp.id)

    client.start_stream(callback)
    try:
        for i, (prompt, n) in enumerate(zip(PROMPTS, BUDGETS)):
            client.async_stream_infer(
                "llama_generate", _inputs(prompt, n), request_id=str(i),
                enable_empty_final_response=True)
        assert finished.wait(WAIT_S) and not errors, errors
    finally:
        client.stop_stream()
        client.close()
    assert not hold.timed_out
    assert [got[str(i)] for i in range(3)] == reference
    # interleaved: every two ids' responses overlap in arrival order
    spans = {k: (order.index(k), len(order) - 1 - order[::-1].index(k))
             for k in got}
    assert all(spans[a][0] < spans[b][1] and spans[b][0] < spans[a][1]
               for a in got for b in got if a != b)


# -- auto-resume after a stream drop -----------------------------------------


@pytest.mark.parametrize("kv_park", [False, True],
                         ids=["replay", "kv_park_attach"])
def test_generate_stream_resumes_after_a_stream_drop(port3, kv_park):
    """``grpc.stream_infer`` armed with ``skip=4`` for this server's scope
    drops the stream after 4 responses; ``generate_stream`` resumes
    (``resume_generation_id``/``resume_from_seq``) once, and the tokens
    and ``seq``s equal an undisturbed run.  With ``kv_park`` the resume
    attaches the parked KV instead of prefilling (one attach
    admission)."""
    client = port3.client()
    try:
        reference = _generate(client, LONG_PROMPT, LONG_BUDGET,
                              {"generation_id": "undisturbed"})
        reconnects = []
        stats0 = port3.model.scheduler_stats()
        hold = _StepHold(port3.model, 4 + 4, lambda: bool(reconnects),
                         lambda: _parked_since(port3.model, "dropped",
                                               stats0["replay_hits"]))
        fault_points.install("grpc.stream_infer", skip=4, scope=SCOPE)
        params = {"generation_id": "dropped"}
        if kv_park:
            params["kv_park"] = True
        got = _generate(client, LONG_PROMPT, LONG_BUDGET, params,
                        on_reconnect=lambda a, e: reconnects.append(a))
    finally:
        client.close()
    assert not hold.timed_out
    assert reconnects == [1]
    assert fault_points.fired("grpc.stream_infer", SCOPE) == 1
    assert got == reference
    assert [s for _, s in got] == list(range(LONG_BUDGET))
    stats = port3.model.scheduler_stats()
    assert stats["replay_hits"] - stats0["replay_hits"] == 1
    assert stats["attach_admissions"] - stats0["attach_admissions"] == (
        1 if kv_park else 0)


# -- the typed error map ------------------------------------------------------


def _raw_stub(url):
    channel = grpc.insecure_channel(url)
    calls = {}
    for name, (req_cls, resp_cls, kind) in service.METHODS.items():
        make = channel.unary_unary if kind == "unary" else \
            channel.stream_stream
        calls[name] = make(service.method_path(name),
                           request_serializer=req_cls.SerializeToString,
                           response_deserializer=resp_cls.FromString)
    return channel, calls


def _raw_request(prompt, max_tokens, request_id="r"):
    req = pb.ModelInferRequest(model_name="llama_generate", id=request_id)
    for name, arr in (("PROMPT_IDS", np.asarray(prompt, np.int32)),
                      ("MAX_TOKENS", np.array([max_tokens], np.int32))):
        t = req.inputs.add(name=name, datatype="INT32")
        t.shape.extend(arr.shape)
        req.raw_input_contents.append(arr.tobytes())
    return req


def _case_not_found(port, calls):
    calls["ModelMetadata"](pb.ModelMetadataRequest(name="nope"))


def _case_pinned(port, calls):
    handle = csm.create_shared_memory_region("pinned", 64, device="cpu")
    try:
        calls["CudaSharedMemoryRegister"](pb.CudaSharedMemoryRegisterRequest(
            name="pinned", raw_handle=base64.b64decode(
                csm.get_raw_handle(handle)), device_id=0, byte_size=64))
        port.core.pin_shm_region("pinned")  # an in-flight reference
        try:
            calls["CudaSharedMemoryUnregister"](
                pb.CudaSharedMemoryUnregisterRequest(name="pinned"))
        finally:
            port.core.unpin_shm_region("pinned")
            port.core.unregister_cuda_shm("pinned")
    finally:
        csm.destroy_shared_memory_region(handle)


def _case_shed(port, calls):
    """A shed generation: in-band (a status would end the stream's other
    generations), with its typed status and retry-after beside it."""
    sched = port.model._ensure_scheduler()
    with sched._cond:  # the controller in its shedding state
        sched._pending.append(object())
        sched._shed_ctl.above_since = time.monotonic() - 60.0
    try:
        responses = list(calls["ModelStreamInfer"](
            iter([_raw_request(PROMPTS[0], 2, "shed")]), timeout=WAIT_S))
    finally:
        with sched._cond:
            sched._pending.clear()
    (resp,) = responses
    params = resp.infer_response.parameters
    return (resp.error_message, resp.infer_response.id,
            params["grpc_status"].string_param,
            params["retry-after"].int64_param)


def _case_closed(port, calls):
    port.core.close()
    calls["ModelInfer"](_raw_request(PROMPTS[0], 2))


def _case_deadline(port, calls):
    # every step of this server sleeps past the client's deadline
    fault_points.install("scheduler.step", mode="sleep", times=-1,
                         delay=0.5, scope=SCOPE)
    list(calls["ModelStreamInfer"](
        iter([_raw_request(PROMPTS[0], 4)]), timeout=0.3))


def _case_xla(port, calls):
    calls["XlaSharedMemoryRegister"](pb.XlaSharedMemoryRegisterRequest(
        name="x", raw_handle=b"\0" * 8, device_ordinal=0, byte_size=8))


def _case_decoupled_infer(port, calls):
    calls["ModelInfer"](_raw_request(PROMPTS[0], 2))


def _case_bytes(port, calls):
    """A raw BYTES tensor: the port's wire has no BYTES yet."""
    req = _raw_request(PROMPTS[0], 2)
    req.inputs[0].datatype = "BYTES"
    calls["ModelInfer"](req)


@pytest.mark.parametrize("case,http_code,status", [
    (_case_not_found, 404, grpc.StatusCode.NOT_FOUND),
    (_case_pinned, 409, grpc.StatusCode.ABORTED),
    (_case_shed, 429, grpc.StatusCode.RESOURCE_EXHAUSTED),
    (_case_closed, 503, grpc.StatusCode.UNAVAILABLE),
    (_case_deadline, 504, grpc.StatusCode.DEADLINE_EXCEEDED),
    (_case_xla, 400, grpc.StatusCode.INVALID_ARGUMENT),
    (_case_decoupled_infer, 400, grpc.StatusCode.INVALID_ARGUMENT),
    (_case_bytes, 400, grpc.StatusCode.INVALID_ARGUMENT),
], ids=["404", "409", "429", "503", "504", "400_xla", "400_decoupled",
        "400_bytes"])
def test_typed_errors_map_to_jax_status_codes(tparams, case, http_code,
                                             status):
    port = _Port(tparams, 2, target_queue_ms=10, shed_interval_ms=7000.0)
    channel, calls = _raw_stub(port.grpc.url)
    try:
        if http_code == 429:
            message, request_id, name, retry_after = case(port, calls)
            assert "sojourn" in message and request_id == "shed"
            assert name == status.name
            assert retry_after == 7  # ceil(the 7 s control interval)
            assert port.model.scheduler_stats()["codel_sheds"] == 1
            return
        with pytest.raises(grpc.RpcError) as info:
            case(port, calls)
        assert info.value.code() == status, info.value.details()
        if http_code == 400 and case is _case_decoupled_infer:
            # JAX's own message
            assert info.value.details() == (
                "model 'llama_generate' is a decoupled model: it can only "
                "be served over the streaming endpoint")
    finally:
        channel.close()
        port.close()


def test_jax_frontend_sheds_with_the_same_retry_after():
    """The JAX scheduler's shed that ``test_typed_errors_...[429]``
    mirrors: the same controller state gives the same typed 429 and
    ``Retry-After`` there (its gRPC stream delivers it in-band too)."""
    from tpuserver.scheduler import AdmissionQueueFull, DecodeScheduler

    sched = DecodeScheduler({}, None, 2, 64, target_queue_ms=10,
                            shed_interval_ms=7000.0)
    with sched._cond:
        sched._pending.append(object())
        sched._shed_ctl.above_since = time.monotonic() - 60.0
    try:
        with pytest.raises(AdmissionQueueFull) as info:
            sched.submit([3, 1], 2)
        assert info.value.retry_after == 7
    finally:
        with sched._cond:
            sched._pending.clear()
        sched.close(join_timeout=0.1)


# -- shared memory by raw bytes ------------------------------------------------


def test_cuda_region_registers_by_raw_handle_bytes(port3):
    """A CUDA-shm region (here a CPU one, which an in-process attach
    accepts) registers over gRPC with the bare 64-byte handle; a
    generation reads its prompt from it by reference and streams the
    in-band tokens; status and unregister follow."""
    client = port3.client()
    handle = csm.create_shared_memory_region("grpc_plane", 256, device="cpu")
    try:
        reference = [t for t, _ in _generate(client, PROMPTS[2], BUDGETS[2])]
        csm.set_shared_memory_region(handle, [PROMPTS[2]])
        raw = base64.b64decode(csm.get_raw_handle(handle))
        assert len(raw) == 64
        client.register_cuda_shared_memory("grpc_plane", raw, 0, 256)
        status = client.get_cuda_shared_memory_status()
        assert [r.byte_size for r in status.regions.values()] == [256]
        inputs = _inputs(PROMPTS[2], BUDGETS[2])
        inputs[0].set_shared_memory("grpc_plane", PROMPTS[2].nbytes, 0)
        got = [int(r.as_numpy("TOKEN")[0]) for r in client.generate_stream(
            "llama_generate", inputs)]
        assert got == reference
        assert port3.core.shm_stats()["shm_bytes_read"] == PROMPTS[2].nbytes
        client.unregister_cuda_shared_memory("grpc_plane")
        assert not client.get_cuda_shared_memory_status().regions
    finally:
        client.close()
        csm.destroy_shared_memory_region(handle)


# -- the protocol copies ------------------------------------------------------


def test_pb2_copies_share_the_clients_descriptors():
    """The port's pb2 modules are byte-for-byte copies: their serialized
    descriptors equal tritonclient's (so both load into protobuf's one
    default pool), and the method table is the client's, ServerMetrics'
    reuse of ServerMetadataRequest and LogSettingsResponse included."""
    assert pb.DESCRIPTOR.serialized_pb == client_pb.DESCRIPTOR.serialized_pb
    assert config_pb.DESCRIPTOR.serialized_pb == \
        client_config_pb.DESCRIPTOR.serialized_pb
    for name in ("grpc_service_pb2.py", "model_config_pb2.py"):
        with open(os.path.join(REPO, "src", "python", "tritonclient", "grpc",
                               name), "rb") as f:
            theirs = f.read()
        with open(os.path.join(REPO, "src", "python", "tpuserver_torch",
                               "grpc_proto", name), "rb") as f:
            assert f.read() == theirs
    assert service.SERVICE == jax_service.SERVICE
    assert {k: (a.DESCRIPTOR.full_name, b.DESCRIPTOR.full_name, kind)
            for k, (a, b, kind) in service.METHODS.items()} == {
        k: (a.DESCRIPTOR.full_name, b.DESCRIPTOR.full_name, kind)
        for k, (a, b, kind) in jax_service.METHODS.items()}
    assert service.METHODS["ServerMetrics"][:2] == (
        pb.ServerMetadataRequest, pb.LogSettingsResponse)


# -- the repo's example client --------------------------------------------------


def test_llama_streaming_example_generates_against_the_port(stacks):
    """``src/python/examples/llama_streaming_client.py``'s ``generate``
    (the auto-resuming in-band path; its main path parks the KV in an
    XLA region, which a CUDA host refuses) streams the reference tokens
    from the port."""
    port, reference = stacks
    path = os.path.join(REPO, "src", "python", "examples",
                        "llama_streaming_client.py")
    spec = importlib.util.spec_from_file_location("llama_streaming_client",
                                                  path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    client = port.client()
    try:
        assert example.generate(client, PROMPTS[0], BUDGETS[0]) == \
            reference[0]
    finally:
        client.close()


def test_http_serving_starts_without_grpcio():
    """``tpuserver_torch.serve`` and the HTTP server import on a machine
    without grpcio (only ``--grpc-port`` imports the gRPC server), and
    the package's ``__init__`` imports no gRPC module."""
    script = (
        "import sys\n"
        "sys.modules['grpc'] = None  # an import of it raises\n"
        "import tpuserver_torch.serve, tpuserver_torch.http_server\n"
        "bad = sorted(m for m in sys.modules if 'grpc_server' in m)\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src", "python"))
    proc = subprocess.run([sys.executable, "-c", script], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
