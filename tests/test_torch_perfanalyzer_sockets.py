"""The port's socket backends (``HttpBackend`` on ``http.client``,
``GrpcBackend`` on a raw channel and the port's messages) across
packages on the CPU: against the JAX package's ``HttpFrontend`` and
``GrpcFrontend``, with the JAX perf analyzer's backends (on
``tritonclient``) against the port's ``HttpServer`` and ``GrpcServer``.

Both servers hold the fixture models and ``llama_generate`` at float32
``tiny`` (``init_params(PRNGKey(0))``, bridged to the port by
``params_from_jax``), ``max_slots`` 2.  Compared with no tolerance: the
answers of ``simple`` (INT32), ``identity_bf16`` (BF16 bits) and
``simple_string`` (BYTES) on the same seeded inputs, each backend on each
server; metadata; the tokens a stream yields.  Then a dropped stream's
resume, shared-memory regions over each socket, and the perf analyzer's
CLI over each socket."""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from perfanalyzer import client_backend as jax_backends
from tpuserver.core import InferenceServer as JaxServer
from tpuserver.grpc_frontend import GrpcFrontend
from tpuserver.http_frontend import HttpFrontend
from tpuserver.models import default_models as jax_default_models
from tpuserver.models import llama as jl
from tpuserver.models.llama_serving import LlamaGenerateModel as JaxLlama
from tpuserver_torch import cuda_shared_memory as csm
from tpuserver_torch import fault_points
from tpuserver_torch.core import InferenceServer
from tpuserver_torch.grpc_server import GrpcServer
from tpuserver_torch.http_server import HttpServer
from tpuserver_torch.models import default_models
from tpuserver_torch.models import llama as tl
from tpuserver_torch.models.llama_serving import LlamaGenerateModel
from tpuserver_torch.perfanalyzer.client_backend import (
    BackendError,
    GrpcBackend,
    HttpBackend,
    ShmInferDataManager,
    create_backend,
)
from tpuserver_torch.perfanalyzer.report import CONCURRENCY_ROW_KEYS
from torch_port_helpers import StepHold, one_torch_thread  # noqa: F401
from torch_port_helpers import parked_since

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = 512
MAX_SEQ = 64
SCOPE = "port-sockets"
PROTOS = ("http", "grpc")
PORT_BACKENDS = {"http": HttpBackend, "grpc": GrpcBackend}
JAX_BACKENDS = {"http": jax_backends.HttpBackend,
                "grpc": jax_backends.GrpcBackend}
# a drop test's generation: long enough that the drop lands mid-way
LONG_PROMPT = np.arange(1, 11, dtype=np.int32)
LONG_BUDGET = 24


def _cfgs():
    return (dataclasses.replace(jl.tiny(vocab=VOCAB), dtype=jnp.float32),
            dataclasses.replace(tl.tiny(vocab=VOCAB), dtype=torch.float32))


@pytest.fixture(scope="module")
def servers():
    """{"jax"|"port": {"http": url, "grpc": url}}, plus the port's core
    and llama model under "core" and "model"."""
    jcfg, pcfg = _cfgs()
    tparams = tl.params_from_jax(jax.tree_util.tree_map(
        np.asarray, jl.init_params(jax.random.PRNGKey(0), jcfg)), "cpu")
    jax_core = JaxServer(jax_default_models() + [JaxLlama(
        cfg=jcfg, max_seq=MAX_SEQ, max_slots=2, spec_tokens=0)])
    model = LlamaGenerateModel(cfg=pcfg, max_seq=MAX_SEQ, max_slots=2,
                               params=tparams, device="cpu", decode_chunk=4,
                               fault_scope=SCOPE)
    core = InferenceServer(default_models() + [model], fault_scope=SCOPE)
    fes = [HttpFrontend(jax_core, port=0).start(),
           GrpcFrontend(jax_core, port=0).start(),
           HttpServer(core, port=0).start(),
           GrpcServer(core, port=0).start()]
    urls = ["127.0.0.1:{}".format(fe.port) for fe in fes]
    yield {"jax": {"http": urls[0], "grpc": urls[1]},
           "port": {"http": urls[2], "grpc": urls[3]},
           "core": core, "model": model}
    for fe in reversed(fes):
        fe.stop()
    core.close()
    jax_core.close()


@pytest.fixture(autouse=True)
def _clean_faults():
    fault_points.clear()
    yield
    fault_points.clear()


def _inputs(model):
    """Seeded inputs of ``model``: (the port's form, the JAX tool's)."""
    rng = np.random.RandomState(7)
    if model == "simple":
        x = {"INPUT0": rng.randint(-100, 100, (1, 16)).astype(np.int32),
             "INPUT1": rng.randint(-100, 100, (1, 16)).astype(np.int32)}
        return x, x
    if model == "identity_bf16":
        bits = torch.from_numpy(rng.randn(2, 5).astype(np.float32)).to(
            torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
        return ({"INPUT0": bits},
                {"INPUT0": bits.view(ml_dtypes.bfloat16)})
    words = np.array([str(v).encode() for v in rng.randint(0, 999, 16)],
                     dtype=np.object_).reshape(1, 16)
    more = np.array([str(v).encode() for v in rng.randint(0, 999, 16)],
                    dtype=np.object_).reshape(1, 16)
    x = {"INPUT0": words, "INPUT1": more}
    return x, x


def _answer(side, proto, url, model):
    """``{output: array}`` from one package's backend on one server; BF16
    as its bits, BYTES as bytes."""
    port_in, jax_in = _inputs(model)
    if side == "port":
        backend = PORT_BACKENDS[proto](url)
        try:
            return backend.infer(backend.prepare(model, [port_in])[0])
        finally:
            backend.close()
    backend = JAX_BACKENDS[proto](url)
    try:
        prepared = backend.prepare(model, [jax_in])[0]
        result = backend.client.infer(prepared[0], prepared[1])
        names = [o["name"] for o in backend.model_metadata(model)["outputs"]]
        out = {}
        for name in names:
            arr = result.as_numpy(name)
            if arr.dtype == ml_dtypes.bfloat16:
                arr = arr.view(np.uint16)
            out[name] = arr
        return out
    finally:
        backend.close()


@pytest.mark.parametrize("model", ["simple", "identity_bf16",
                                   "simple_string"])
@pytest.mark.parametrize("proto", PROTOS)
def test_answers_identical_across_packages(servers, proto, model):
    """Each package's backend on each package's server: the same outputs,
    bit for bit (and ``simple``'s are a+b and a-b)."""
    answers = {(side, server): _answer(side, proto, servers[server][proto],
                                       model)
               for side in ("port", "jax") for server in ("port", "jax")}
    ref = answers[("jax", "jax")]
    for key, got in answers.items():
        assert sorted(got) == sorted(ref), key
        for name in ref:
            assert got[name].dtype == ref[name].dtype, (key, name)
            np.testing.assert_array_equal(got[name], ref[name], err_msg=str(
                (key, name)))
    if model == "simple":
        x, _ = _inputs(model)
        np.testing.assert_array_equal(ref["OUTPUT0"],
                                      x["INPUT0"] + x["INPUT1"])
        np.testing.assert_array_equal(ref["OUTPUT1"],
                                      x["INPUT0"] - x["INPUT1"])


@pytest.mark.parametrize("proto", PROTOS)
def test_metadata_and_config_agree(servers, proto):
    """On one server both packages' backends read the same metadata,
    config and statistics shape; across servers the fixture models'
    metadata agree, and their configs up to the instance kind (the port's
    fixtures say ``KIND_CPU``, ROADMAP queue C)."""
    got = {}
    for side in ("port", "jax"):
        for server in ("port", "jax"):
            make = (PORT_BACKENDS if side == "port" else JAX_BACKENDS)[proto]
            backend = make(servers[server][proto])
            try:
                got[(side, server)] = (
                    backend.model_metadata("simple"),
                    backend.model_config("simple"),
                    sorted(backend.server_statistics("simple")[
                        "model_stats"][0]))
            finally:
                backend.close()
    for server in ("port", "jax"):
        assert got[("port", server)] == got[("jax", server)]
    port_md, port_cfg, port_stats = got[("port", "port")]
    jax_md, jax_cfg, jax_stats = got[("jax", "jax")]
    assert port_md == jax_md
    assert port_stats == jax_stats
    strip = {"instance_group"}
    assert ({k: v for k, v in port_cfg.items() if k not in strip}
            == {k: v for k, v in jax_cfg.items() if k not in strip})


def _stream_counts(side, proto, url, stats=None, params=None,
                   prompt=(3, 1, 4, 1, 5), budget=7):
    inputs = {"PROMPT_IDS": np.asarray(prompt, np.int32),
              "MAX_TOKENS": np.array([budget], np.int32)}
    make = (PORT_BACKENDS if side == "port" else JAX_BACKENDS)[proto]
    backend = make(url)
    try:
        return list(backend.generate_stream("llama_generate", inputs,
                                            params, stats=stats))
    finally:
        backend.release_thread_resources()
        backend.close()


@pytest.mark.parametrize("proto", PROTOS)
def test_generate_stream_counts_equal_across_packages(servers, proto):
    """``generate_stream`` yields one count a token, no count for the
    stream's empty final response, the same in both packages' backends on
    both servers."""
    for side in ("port", "jax"):
        for server in ("port", "jax"):
            counts = _stream_counts(side, proto, servers[server][proto])
            assert counts == [1] * 7, (side, server)


@pytest.mark.parametrize("proto", PROTOS)
def test_dropped_stream_resumes_once(servers, proto):
    """The stream dropped by the server after 4 events (``http.
    generate_stream`` / ``grpc.stream_infer``, ``skip=4``) reconnects and
    resumes (``Last-Event-ID`` / ``resume_generation_id``): one
    ``resumes``, every token counted once."""
    model = servers["model"]
    stats = {}
    stats0 = model.scheduler_stats()
    gen_id = "dropped-" + proto
    hold = StepHold(model, 4 + 4, lambda: bool(stats.get("resumes")),
                    lambda: parked_since(model, gen_id,
                                         stats0["replay_hits"]))
    point = "http.generate_stream" if proto == "http" else "grpc.stream_infer"
    fault_points.install(point, skip=4, scope=SCOPE)
    counts = _stream_counts("port", proto, servers["port"][proto], stats,
                            {"generation_id": gen_id}, LONG_PROMPT,
                            LONG_BUDGET)
    assert not hold.timed_out
    assert fault_points.fired(point, SCOPE) == 1
    assert stats == {"resumes": 1}
    assert sum(counts) == LONG_BUDGET
    assert model.scheduler_stats()["replay_hits"] - \
        stats0["replay_hits"] == 1


@pytest.mark.parametrize("kind", ["system", "cuda"])
@pytest.mark.parametrize("proto", PROTOS)
def test_regions_over_each_socket_give_the_in_band_answer(servers, proto,
                                                          kind):
    """Inputs staged in a region (a system one, or a CPU "cuda" one that
    the server attaches in-process) and outputs delivered into one: the
    in-band answer; every region is gone after the manager closes."""
    core = servers["core"]
    backend = create_backend(proto, url=servers["port"][proto])
    shm = ShmInferDataManager(backend, kind, device="cpu")
    try:
        x, _ = _inputs("simple")
        inband = backend.infer(backend.prepare("simple", [x])[0])
        refs = shm.stage_input_sets([x])
        outs = shm.stage_outputs(["OUTPUT0", "OUTPUT1"], 64)
        reads0 = core.shm_stats()["shm_zero_copy_reads"]
        assert backend.infer(backend.prepare_shm("simple", refs, outs)[0]) \
            == {}
        reads = core.shm_stats()["shm_zero_copy_reads"] - reads0
        assert reads == (2 if kind == "cuda" else 0)
        _, handle = shm._regions[-1]
        for j, name in enumerate(("OUTPUT0", "OUTPUT1")):
            np.testing.assert_array_equal(
                shm.read(handle, np.int32, [1, 16], offset=64 * j),
                inband[name])
    finally:
        shm.close()
        backend.close()
    assert not core.cuda_shm_status() and not core.system_shm_status()
    assert not [h for h in csm.allocated_shared_memory_regions()
                if h.name.startswith("pa_")]


@pytest.mark.parametrize("proto", PROTOS)
def test_server_errors_carry_the_servers_message(servers, proto):
    """A request the server refuses is a ``BackendError`` with the
    server's own message (a typed HTTP error body, a gRPC status's
    details)."""
    backend = create_backend(proto, url=servers["port"][proto])
    try:
        with pytest.raises(BackendError, match="INPUT1"):
            backend.infer(backend.prepare(
                "simple", [{"INPUT0": np.zeros((1, 16), np.int32)}])[0])
        with pytest.raises(BackendError, match="nosuch"):
            backend.model_metadata("nosuch")
    finally:
        backend.close()


def _cli(argv):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src", "python"),
               JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1")
    return subprocess.Popen([sys.executable] + argv, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env,
                            cwd=REPO)


def test_perf_analyzer_cli_over_each_socket_rows_have_jax_keys(servers):
    """``python -m tpuserver_torch.perf_analyzer --backend http|grpc -u``
    against the port's server needs no device and prints rows with the
    JAX tool's keys (``tools/perf_analyzer.py`` on the same flags)."""
    flags = ["-m", "simple", "--concurrency-range", "1",
             "--measurement-interval", "250", "--max-trials", "6",
             "--warmup", "0.1"]
    procs = {proto: _cli(["-m", "tpuserver_torch.perf_analyzer",
                          "--backend", proto, "-u", servers["port"][proto]]
                         + flags) for proto in PROTOS}
    procs["jax"] = _cli([os.path.join(REPO, "tools", "perf_analyzer.py"),
                         "--backend", "http", "-u", servers["port"]["http"]]
                        + flags)
    rows = {}
    for key, proc in procs.items():
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, out + err
        rows[key] = [json.loads(ln) for ln in out.splitlines()
                     if ln.startswith('{"')]
    for proto in PROTOS:
        (row,) = rows[proto]
        assert set(row) == set(rows["jax"][0]) == CONCURRENCY_ROW_KEYS
        assert row["metric"] == "simple_{}_concurrency1".format(proto)
        assert row["errors"] == 0 and row["value"] > 0
