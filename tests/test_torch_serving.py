"""The port's serving stack (tpuserver_torch.core, http_server,
models.llama_serving) on the CPU: its HTTP ``/generate_stream`` and
``/generate`` against the JAX package's ``LlamaGenerateModel`` on the
same weights and config; the package's isolation from JAX and from
``tpuserver``; and its device rule (the card unless the caller asks for
the CPU)."""

import dataclasses
import http.client
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuserver.core import InferenceServer as JaxServer
from tpuserver.core import InferRequest as JaxRequest
from tpuserver.models import llama as jl
from tpuserver.models.llama_serving import LlamaGenerateModel as JaxLlama
import tpuserver_torch
from tpuserver_torch.core import InferenceServer, InferRequest
from tpuserver_torch.errors import BadRequest
from tpuserver_torch.http_server import HttpServer
from tpuserver_torch.models import llama as tl
from tpuserver_torch.models.llama_serving import LlamaGenerateModel

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_PY = os.path.join(REPO, "src", "python")
MAX_SEQ = 256


def _cfgs():
    jcfg = dataclasses.replace(jl.tiny(vocab=512), dtype=jnp.float32)
    tcfg = dataclasses.replace(tl.tiny(vocab=512), dtype=torch.float32)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def served():
    """The port's server on port 0 over HTTP, serving float32 ``tiny``
    with the weights the JAX model draws (``init_params(PRNGKey(0))``)."""
    jcfg, tcfg = _cfgs()
    np_params = jax.tree_util.tree_map(
        np.asarray, jl.init_params(jax.random.PRNGKey(0), jcfg))
    model = LlamaGenerateModel(
        cfg=tcfg, max_seq=MAX_SEQ, decode_chunk=4,
        params=tl.params_from_jax(np_params, "cpu"), device="cpu")
    core = InferenceServer([model])
    http_server = HttpServer(core, port=0).start()
    yield http_server.port
    http_server.stop()
    core.close()


def _body(prompt, max_tokens, parameters=None):
    body = {"inputs": [
        {"name": "PROMPT_IDS", "datatype": "INT32", "shape": [len(prompt)],
         "data": [int(t) for t in prompt]},
        {"name": "MAX_TOKENS", "datatype": "INT32", "shape": [1],
         "data": [max_tokens]}]}
    if parameters:
        body["parameters"] = parameters
    return json.dumps(body)


def _post(port, path, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", path, body, {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read().decode("utf-8")
    finally:
        conn.close()


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read().decode("utf-8")
    finally:
        conn.close()


def _events(text):
    return [json.loads(line[len("data: "):]) for line in text.splitlines()
            if line.startswith("data: ")]


def _jax_tokens(prompt, max_tokens):
    jcfg, _ = _cfgs()
    server = JaxServer([JaxLlama(cfg=jcfg, max_seq=MAX_SEQ)])
    try:
        req = JaxRequest("llama_generate", inputs={
            "PROMPT_IDS": np.asarray(prompt, np.int32),
            "MAX_TOKENS": np.array([max_tokens], np.int32)})
        out = []
        for resp in server.infer_stream(req):
            arrays = {spec["name"]: a for spec, a, _ in resp.outputs}
            out.append((int(arrays["TOKEN"][0]), float(arrays["LOGPROB"][0])))
        return out
    finally:
        server.close()


@pytest.mark.parametrize("prompt_len,max_tokens", [(128, 10), (77, 9)],
                         ids=["flash_length", "dense_length"])
def test_generate_stream_matches_jax_model(served, prompt_len, max_tokens):
    prompt = np.random.RandomState(prompt_len).randint(0, 512, prompt_len)
    ref = _jax_tokens(prompt, max_tokens)
    status, text = _post(served, "/v2/models/llama_generate/generate_stream",
                         _body(prompt, max_tokens))
    assert status == 200
    events = _events(text)
    assert events[-1] == {"final": True}
    got = []
    for ev in events[:-1]:
        out = {o["name"]: o for o in ev["outputs"]}
        assert out["TOKEN"]["datatype"] == "INT32"
        got.append((out["TOKEN"]["data"][0], out["LOGPROB"]["data"][0]))
    assert [t for t, _ in got] == [t for t, _ in ref]
    np.testing.assert_allclose([lp for _, lp in got], [lp for _, lp in ref],
                               rtol=1e-4, atol=1e-4)

    status, text = _post(served, "/v2/models/llama_generate/generate",
                         _body(prompt, max_tokens))
    assert status == 200
    merged = {o["name"]: o for o in json.loads(text)["outputs"]}
    assert merged["TOKEN"]["shape"] == [max_tokens, 1]
    assert merged["TOKEN"]["data"] == [t for t, _ in ref]


def test_eos_id_ends_the_stream_after_the_eos_token(served):
    prompt = np.arange(1, 21)
    _, text = _post(served, "/v2/models/llama_generate/generate",
                    _body(prompt, 8))
    tokens = json.loads(text)["outputs"][0]["data"]
    _, text = _post(served, "/v2/models/llama_generate/generate_stream",
                    _body(prompt, 8, {"eos_id": tokens[2]}))
    events = _events(text)
    got = [ev["outputs"][0]["data"][0] for ev in events[:-1]]
    assert got == tokens[:tokens.index(tokens[2]) + 1]
    assert events[-1] == {"final": True}


def test_health_metadata_and_config(served):
    assert _get(served, "/v2/health/live")[0] == 200
    assert _get(served, "/v2/health/ready")[0] == 200
    assert _get(served, "/v2/models/llama_generate/ready")[0] == 200
    status, text = _get(served, "/v2/models/llama_generate")
    meta = json.loads(text)
    assert status == 200 and meta["platform"] == "pytorch"
    assert [t["name"] for t in meta["inputs"]] == ["PROMPT_IDS", "MAX_TOKENS"]
    status, text = _get(served, "/v2/models/llama_generate/config")
    cfg = json.loads(text)
    assert cfg["backend"] == "pytorch"
    assert cfg["model_transaction_policy"] == {"decoupled": True}
    # served on the CPU here, so the instance group says so
    assert cfg["instance_group"][0]["kind"] == "KIND_CPU"


@pytest.mark.parametrize("path,method,code", [
    ("/v2/models/nope/config", "GET", 404),
    ("/v2/models/nope/generate_stream", "POST", 404),
    ("/v2/nothing", "GET", 404)])
def test_unknown_models_and_routes_are_404(served, path, method, code):
    if method == "GET":
        status, text = _get(served, path)
    else:
        status, text = _post(served, path, _body([1, 2], 2))
    assert status == code and "error" in json.loads(text)


@pytest.mark.parametrize("parameters,code", [
    ({"kv_cache_region": "r"}, 400),
    ({"shm_ring_region": "r", "shm_ring_slots": 4}, 400)])
def test_later_slice_parameters_are_typed_errors(served, parameters, code):
    """The data-plane parameters were a later slice (501); they serve now,
    and naming a region that is not registered is a typed 400."""
    status, text = _post(served, "/v2/models/llama_generate/generate_stream",
                         _body([1, 2, 3], 2, parameters))
    assert status == code and "Unable to find" in json.loads(text)["error"]


def test_bad_requests_are_400(served):
    status, _ = _post(served, "/v2/models/llama_generate/generate",
                      _body([1, 2, 3], MAX_SEQ))
    assert status == 400
    status, _ = _post(served, "/v2/models/llama_generate/generate", "{oops")
    assert status == 400


def test_config_reports_gpu_instance_group_for_the_card():
    model = LlamaGenerateModel.__new__(LlamaGenerateModel)
    model.device_kind = "gpu"
    assert model.config_dict()["instance_group"][0]["kind"] == "KIND_GPU"


def test_max_slots_above_one_is_a_later_slice(served):
    """``max_slots>1`` was a later slice of the port and now serves: on
    the CPU, ``max_slots=4`` streams the single-stream path's tokens (and
    the JAX model's: the ``served`` fixture is held against it above).
    The data-plane request parameters, a later slice too, now serve
    there: a ``kv_cache_region`` that is not registered is a typed 400
    (``tests/test_torch_shm.py`` holds the rest against JAX)."""
    jcfg, tcfg = _cfgs()
    np_params = jax.tree_util.tree_map(
        np.asarray, jl.init_params(jax.random.PRNGKey(0), jcfg))
    model = LlamaGenerateModel(
        cfg=tcfg, max_seq=MAX_SEQ, max_slots=4,
        params=tl.params_from_jax(np_params, "cpu"), device="cpu")
    core = InferenceServer([model])
    prompt = np.arange(1, 21)
    try:
        req = InferRequest("llama_generate", inputs={
            "PROMPT_IDS": prompt.astype(np.int32),
            "MAX_TOKENS": np.array([8], np.int32)})
        tokens = [int(dict((s["name"], a) for s, a in r.outputs)["TOKEN"][0])
                  for r in core.infer_stream(req)]
        req.parameters = {"kv_cache_region": "r"}
        with pytest.raises(BadRequest, match="Unable to find") as err:
            list(core.infer_stream(req))
        assert err.value.code == 400
    finally:
        core.close()
    _, text = _post(served, "/v2/models/llama_generate/generate",
                    _body(prompt, 8))
    assert tokens == json.loads(text)["outputs"][0]["data"]
    assert model.scheduler_stats() is None  # closed with the core


def test_closed_server_refuses_inference():
    _, tcfg = _cfgs()
    core = InferenceServer([LlamaGenerateModel(cfg=tcfg, max_seq=64,
                                               device="cpu")])
    assert core.server_ready() and core.model_ready("llama_generate")
    core.close()
    assert not core.server_ready()
    req = InferRequest("llama_generate", inputs={
        "PROMPT_IDS": np.array([1, 2], np.int32),
        "MAX_TOKENS": np.array([1], np.int32)})
    with pytest.raises(Exception, match="not ready"):
        list(core.infer_stream(req))


# -- device rule -------------------------------------------------------------


def test_default_device_is_the_card_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpuserver_torch.resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LlamaGenerateModel()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpuserver_torch.resolve_device("cuda")
    assert tpuserver_torch.resolve_device("cpu") == torch.device("cpu")


# -- isolation ---------------------------------------------------------------


def test_port_imports_neither_jax_nor_tpuserver():
    """Import every module of the port in a fresh interpreter: no jax, no
    tpuserver.* (``tpuserver_torch`` itself is not ``tpuserver``), no
    tritonclient, no ml_dtypes (the port's BF16 is bits)."""
    script = (
        "import pkgutil, sys\n"
        "import tpuserver_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    tpuserver_torch.__path__, 'tpuserver_torch.')]\n"
        "for n in names:\n"
        "    __import__(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'tpuserver', 'tritonclient', 'ml_dtypes'))\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=SRC_PY)
    proc = subprocess.run([sys.executable, "-c", script], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    count = int(proc.stdout.split()[0])
    assert count >= 10  # every module was walked, serve and ops included
