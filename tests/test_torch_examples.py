"""The repo's example clients and perf_analyzer against the port's server
on the CPU, beside the JAX package's server: each gives the same output
against both.

Both servers hold the fixture models and a ``resnet50``: a narrow
float32 ResNet (stages (1, 1, 1, 1), widths (32, 64, 128, 256), 224x224
input) whose weights are the JAX package's draw, bridged to the port by
``params_from_jax``.  float32 on both sides, so ``image_client.py``'s
top-3 classification strings (six decimals) agree; bf16 would round the
two frameworks' logits apart."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tritonclient.grpc as grpcclient
import tritonclient.http as httpclient
from tpuserver.core import InferenceServer as JaxServer
from tpuserver.grpc_frontend import GrpcFrontend
from tpuserver.http_frontend import HttpFrontend
from tpuserver.models import default_models as jax_default_models
from tpuserver.models import vision as jv
from tpuserver_torch.core import InferenceServer
from tpuserver_torch.grpc_server import GrpcServer
from tpuserver_torch.http_server import HttpServer
from tpuserver_torch.models import default_models
from tpuserver_torch.models import vision as tv
from torch_port_helpers import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "src", "python", "examples")


class JaxNarrowResNet(jv.ResNet50Model):
    """The JAX package's ResNet, narrow, in float32."""

    _STAGES = (1, 1, 1, 1)
    _WIDTHS = (32, 64, 128, 256)
    dynamic_batching = False

    def _init_params(self):
        params = super()._init_params()
        params["fc"]["w"] = params["fc"]["w"][:self._WIDTHS[-1]]
        return jax.tree_util.tree_map(lambda a: a.astype(jnp.float32),
                                      params)

    def jax_fn(self, INPUT):
        logits = self._apply(self._get_params(), INPUT.astype(jnp.float32))
        return {"OUTPUT": jax.nn.softmax(logits, axis=-1)}

    def warmup(self):
        pass


class PortNarrowResNet(tv.ResNet50Model):
    _STAGES = (1, 1, 1, 1)
    _WIDTHS = (32, 64, 128, 256)
    dynamic_batching = False


@pytest.fixture(scope="module")
def servers():
    """{"jax": (http url, grpc url), "port": (...)}."""
    jax_resnet = JaxNarrowResNet()
    np_tree = jax.tree_util.tree_map(np.asarray, jax_resnet._get_params())
    port_resnet = PortNarrowResNet(
        device="cpu", dtype=torch.float32,
        params=PortNarrowResNet.params_from_jax(np_tree, "cpu"))
    jax_core = JaxServer(jax_default_models() + [jax_resnet])
    core = InferenceServer(default_models() + [port_resnet])
    fes = {"jax": (HttpFrontend(jax_core, port=0).start(),
                   GrpcFrontend(jax_core, port=0).start()),
           "port": (HttpServer(core, port=0).start(),
                    GrpcServer(core, port=0).start())}
    yield {k: ("127.0.0.1:{}".format(h.port), "127.0.0.1:{}".format(g.port))
           for k, (h, g) in fes.items()}
    for h, g in fes.values():
        g.stop()
        h.stop()
    core.close()
    jax_core.close()


def _run(argv):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src", "python"),
               JAX_PLATFORMS="cpu")
    result = subprocess.run([sys.executable] + argv, capture_output=True,
                            text=True, timeout=300, env=env)
    assert result.returncode == 0, result.stdout + result.stderr
    return result.stdout


CASES = [
    ("simple_http_infer_client.py", 0, []),
    ("simple_grpc_shm_client.py", 1, []),
    ("image_client.py", 0, ["--synthetic", "2", "-c", "3"]),
    ("image_client.py", 1, ["-i", "grpc", "--synthetic", "2", "-c", "3"]),
]


@pytest.mark.parametrize("script,proto,extra", CASES,
                         ids=["simple_http", "simple_grpc_shm", "image_http",
                              "image_grpc"])
def test_example_output_equals_jax(servers, script, proto, extra):
    outs = {side: _run([os.path.join(EXAMPLES, script), "-u",
                        servers[side][proto]] + extra)
            for side in ("jax", "port")}
    assert outs["port"] == outs["jax"]
    assert "PASS" in outs["port"]
    if script == "image_client.py":
        assert outs["port"].count("(class_") == 6


def test_perf_analyzer_system_shm_equals_jax(servers):
    """``perf_analyzer -m simple --shared-memory system``: both runs
    succeed through system shared memory, with the same report rows
    (their measured numbers aside)."""
    rows = {}
    for side in ("jax", "port"):
        out = _run([os.path.join(REPO, "tools", "perf_analyzer.py"),
                    "-m", "simple", "--backend", "http", "-u",
                    servers[side][0], "--shared-memory", "system",
                    "--output-shared-memory-size", "64",
                    "--concurrency-range", "2", "--measurement-interval",
                    "250", "--max-trials", "3", "--warmup", "0.1"])
        assert "*** perf_analyzer" in out
        row = json.loads([line for line in out.splitlines()
                          if line.startswith("{")][-1])
        rows[side] = row
    assert rows["port"].keys() == rows["jax"].keys()
    for key in ("unit", "mode", "model", "concurrency"):
        if key in rows["jax"]:
            assert rows["port"][key] == rows["jax"][key], key
    assert rows["port"]["value"] > 0


# -- the CUDA-region clients ----------------------------------------------------
#
# ``simple_grpc_cudashm_client.py`` and ``llama_streaming_cudashm_client.py``
# make their regions on the card.  Here, without one, their argument
# parsing and their typed exit are tested as processes; a CPU region
# attaches only in the process that made it, so their region paths run
# here only in-process, with ``create_shared_memory_region`` made to give
# CPU regions.  Over CUDA IPC from a process of their own they run on the
# card alone (``chip_smoke.py`` phase 9 (e)).

CUDASHM_CLIENTS = ("simple_grpc_cudashm_client.py",
                   "llama_streaming_cudashm_client.py",
                   "simple_http_cudashm_client.py")


def _example(script):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        script[:-3], os.path.join(EXAMPLES, script))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


ARGV_CASES = [
    ("simple_grpc_cudashm_client.py", [],
     {"url": "localhost:8001", "device_id": 0, "verbose": False}),
    ("simple_grpc_cudashm_client.py", ["-u", "h:9", "--device-id", "1", "-v"],
     {"url": "h:9", "device_id": 1, "verbose": True}),
    ("llama_streaming_cudashm_client.py", [],
     {"url": "localhost:8001", "mode": "kv-park", "max_tokens": 8,
      "kv_bytes": 512 << 20}),
    ("llama_streaming_cudashm_client.py",
     ["--mode", "ring", "-n", "5", "--kv-bytes", "4096"],
     {"mode": "ring", "max_tokens": 5, "kv_bytes": 4096}),
    ("llama_streaming_cudashm_client.py", ["--mode", "xla"], None),
    ("llama_streaming_cudashm_client.py", ["--kv-bytes", "0"], None),
    ("llama_streaming_cudashm_client.py", ["-n", "-1"], None),
    ("simple_http_cudashm_client.py", [],
     {"url": "localhost:8000", "device_id": 0, "verbose": False}),
    ("simple_http_cudashm_client.py", ["-u", "h:9", "--device-id", "1", "-v"],
     {"url": "h:9", "device_id": 1, "verbose": True}),
    ("simple_http_cudashm_client.py", ["--device-id", "x"], None),
]


@pytest.mark.parametrize("script,argv,want", ARGV_CASES,
                         ids=["simple_default", "simple_set", "llama_default",
                              "llama_set", "llama_bad_mode",
                              "llama_zero_kv_bytes", "llama_negative_n",
                              "simple_http_default", "simple_http_set",
                              "simple_http_bad_device_id"])
def test_cudashm_client_arguments(script, argv, want):
    module = _example(script)
    if want is None:
        with pytest.raises(SystemExit) as exc:
            module.parse_args(argv)
        assert exc.value.code == 2
        return
    args = vars(module.parse_args(argv))
    assert {k: args[k] for k in want} == want


@pytest.mark.parametrize("script", CUDASHM_CLIENTS)
def test_cudashm_client_without_a_card_exits_typed(servers, script):
    """Without a card each client prints a FAILED line naming the missing
    card and exits ``NO_CARD`` (2), leaving no region registered."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src", "python"),
               CUDA_VISIBLE_DEVICES="")
    http = "_http_" in script
    result = subprocess.run(
        [sys.executable, os.path.join(EXAMPLES, script), "-u",
         servers["port"][0 if http else 1]], capture_output=True, text=True,
        timeout=300, env=env)
    assert result.returncode == _example(script).NO_CARD == 2, \
        result.stdout + result.stderr
    assert "FAILED: CUDA shared memory needs a CUDA card" in result.stdout
    assert "Traceback" not in result.stderr
    if http:
        client = httpclient.InferenceServerClient(servers["port"][0])
        try:
            assert len(client.get_cuda_shared_memory_status()) == 0
        finally:
            client.close()
        return
    client = grpcclient.InferenceServerClient(servers["port"][1])
    try:
        assert len(client.get_cuda_shared_memory_status().regions) == 0
    finally:
        client.close()


@pytest.fixture
def cpu_regions(monkeypatch):
    """``create_shared_memory_region`` giving CPU regions (in-process
    attach only)."""
    from tpuserver_torch import cuda_shared_memory as csm

    make = csm.create_shared_memory_region
    monkeypatch.setattr(
        csm, "create_shared_memory_region",
        lambda name, size, device_id=0: make(name, size, device="cpu"))
    return csm


def test_simple_cudashm_client_in_process(servers, cpu_regions, capsys):
    module = _example("simple_grpc_cudashm_client.py")
    module.main(["-u", servers["port"][1]])
    out = capsys.readouterr().out
    assert "PASS: cuda shared memory" in out and "0 + 1 = 1" in out
    assert cpu_regions.allocated_shared_memory_regions() == []


def test_simple_http_cudashm_client_in_process(servers, cpu_regions, capsys):
    """The HTTP client's regions registered over HTTP: OUTPUT0 and
    OUTPUT1 right in the output region, no region left registered or
    allocated."""
    module = _example("simple_http_cudashm_client.py")
    assert module.main(["-u", servers["port"][0]]) == 0
    out = capsys.readouterr().out
    assert "PASS: cuda shared memory" in out
    assert "0 + 1 = 1" in out and "15 - 1 = 14" in out
    assert cpu_regions.allocated_shared_memory_regions() == []
    client = httpclient.InferenceServerClient(servers["port"][0])
    try:
        assert len(client.get_cuda_shared_memory_status()) == 0
    finally:
        client.close()


@pytest.fixture(scope="module")
def llama_port():
    """A float32 ``tiny`` llama behind the port's gRPC front end."""
    import dataclasses

    from tpuserver_torch.models import llama as tl
    from tpuserver_torch.models.llama_serving import LlamaGenerateModel

    model = LlamaGenerateModel(
        cfg=dataclasses.replace(tl.tiny(vocab=512), dtype=torch.float32),
        max_seq=64, device="cpu", decode_chunk=4)
    core = InferenceServer([model])
    grpc_fe = GrpcServer(core, port=0).start()
    yield "127.0.0.1:{}".format(grpc_fe.port)
    grpc_fe.stop()
    core.close()


@pytest.mark.parametrize("mode", ["ring", "kv-park"])
def test_llama_cudashm_client_in_process(llama_port, cpu_regions, capsys,
                                         mode):
    """Ring mode: the ring's tokens equal the in-band ones; kv-park mode:
    both generations complete from a parked cache."""
    module = _example("llama_streaming_cudashm_client.py")
    module.main(["-u", llama_port, "--mode", mode, "-n", "6",
                 "--kv-bytes", str(1 << 20)])
    out = capsys.readouterr().out
    assert "PASS: llama streaming (cuda shared memory" in out, out
    assert cpu_regions.allocated_shared_memory_regions() == []
