"""Int8 weight serving in the port (``llama.quantize_params`` and
``LlamaGenerateModel(quantize=True)``) held against the JAX package's on
the CPU, float32 ``tiny``, with the same weights (``init_params(
PRNGKey(0))`` bridged by ``params_from_jax``).

Tolerances: the quantized trees bit for bit; logits within 1e-3 of JAX's
(both sides compute in float32, in another order; the w8a8 product
quantizes each activation row, and a last-bit difference upstream can
move one element's int8 rounding by a step, about 1/127 of one term);
greedy tokens identical.

Which product a path takes follows JAX's rule: the single-stream path
prefills at the prompt's exact length, so a 4-token prompt takes the
weight-only product and a 12-token one the w8a8 product; the scheduler
pads every prompt to at least 8 tokens (``prefill_bucket``), so its
prefill always takes w8a8.  Under int8 the two paths need not agree with
each other; each must agree with its JAX counterpart."""

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
from tpuserver_torch.core import InferenceServer, InferRequest
from tpuserver_torch.models import llama as tl
from tpuserver_torch.models.llama_serving import LlamaGenerateModel
from tpuserver_torch.ops import quant

TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, TESTS)
from fleet_stub import free_port  # noqa: E402
from torch_port_helpers import (  # noqa: E402,F401 (fixtures)
    WAIT_S, one_torch_thread, sse_events, tiny_cfgs, tparams, wait_for)

pytestmark = pytest.mark.torch_port

MAX_SEQ = 64
TOL = 1e-3
SHORT = [5, 3, 7, 1]                       # weight-only prefill
LONG = [9, 2, 44, 17, 3, 3, 100, 8, 61, 5, 12, 7]  # w8a8 prefill
PROMPTS = [SHORT, LONG, [1, 2, 3], [7, 9] * 5, [300, 11, 4, 4, 250]]
BUDGETS = [10, 8, 12, 9, 7]


@pytest.fixture(scope="module")
def jparams():
    return jl.init_params(jax.random.PRNGKey(0), tiny_cfgs()[0])


@pytest.fixture(scope="module")
def jquant(jparams):
    """JAX's quantized tree, and the same bridged to the port."""
    q = jl.quantize_params(jparams)
    return q, tl.params_from_jax(jax.tree_util.tree_map(np.asarray, q),
                                 "cpu")


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("quantize_embed", [False, True])
def test_quantize_params_matches_jax_leaf_for_leaf(jparams, tparams,
                                                   quantize_embed):
    ref = list(_leaves(jl.quantize_params(jparams,
                                          quantize_embed=quantize_embed)))
    got = list(_leaves(tl.quantize_params(tparams,
                                          quantize_embed=quantize_embed)))
    assert [p for p, _ in got] == [p for p, _ in ref]
    for (path, g), (_, r) in zip(got, ref):
        assert g.dtype == {np.dtype("int8"): torch.int8,
                           np.dtype("float32"): torch.float32}[
                               np.asarray(r).dtype], path
        np.testing.assert_array_equal(_np(g), np.asarray(r), err_msg=str(
            path))


def test_params_from_jax_carries_quantized_leaves_bitwise(jquant):
    q, bridged = jquant
    for (path, g), (_, r) in zip(_leaves(bridged), _leaves(q)):
        r = np.asarray(r)
        assert _np(g).dtype == r.dtype, path
        np.testing.assert_array_equal(_np(g), r, err_msg=str(path))
    assert bridged["lm_head"]["q"].dtype == torch.int8
    assert bridged["layers"][0]["wq"]["s"].dtype == torch.float32


def _close(got, ref):
    got, ref = got.numpy(), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= TOL * max(1.0, np.abs(ref).max())


def test_forward_prefill_decode_match_jax_on_the_quantized_tree(jquant):
    """``forward`` (T 12: w8a8 throughout), ``prefill`` at T 4
    (weight-only) and T 12 (w8a8), then three ``decode_step``s, all on
    JAX's quantized tree, bridged."""
    q, bridged = jquant
    jcfg, tcfg = tiny_cfgs()
    toks = np.array([LONG], np.int32)
    _close(tl.forward(bridged, torch.from_numpy(toks).long(), tcfg),
           jl.forward(q, jnp.asarray(toks), jcfg))
    for prompt in (SHORT, LONG):
        toks = np.array([prompt], np.int32)
        jcache = jl.init_kv_cache(jcfg, 1, MAX_SEQ)
        tcache = tl.init_kv_cache(tcfg, 1, MAX_SEQ, "cpu")
        jlog, jcache = jl.prefill(q, jcache, jnp.asarray(toks), jcfg)
        tlog, tcache = tl.prefill(bridged, tcache,
                                  torch.from_numpy(toks).long(), tcfg)
        _close(tlog, jlog)
        pos = len(prompt)
        for _ in range(3):
            tok = int(np.argmax(np.asarray(jlog)[0]))
            assert int(torch.argmax(tlog[0])) == tok
            jlog, jcache = jl.decode_step(q, jcache, jnp.array([tok]), pos,
                                          jcfg)
            tlog, tcache = tl.decode_step(bridged, tcache,
                                          torch.tensor([tok]), pos, tcfg)
            _close(tlog, jlog)
            pos += 1


def _generate(core, prompt, n):
    req = InferRequest("llama_generate", inputs={
        "PROMPT_IDS": np.asarray(prompt, np.int32),
        "MAX_TOKENS": np.array([n], np.int32)})
    out = []
    for resp in core.infer_stream(req):
        arrays = {spec["name"]: a for spec, a in resp.outputs}
        out.append(int(arrays["TOKEN"][0]))
    return out


def _generate_jax(core, prompt, n):
    req = JaxRequest("llama_generate", inputs={
        "PROMPT_IDS": np.asarray(prompt, np.int32),
        "MAX_TOKENS": np.array([n], np.int32)})
    return [int(a[0]) for resp in core.infer_stream(req)
            for spec, a, _ in resp.outputs if spec["name"] == "TOKEN"]


def _port_tokens(tparams, prompts, budgets, **kwargs):
    """Greedy tokens of the port's ``quantize=True`` model, each prompt in
    turn; its weights are the bridged float32 tree, which the model
    quantizes."""
    port = LlamaGenerateModel(cfg=tiny_cfgs()[1], max_seq=MAX_SEQ,
                              params=tparams, device="cpu", quantize=True,
                              **kwargs)
    core = InferenceServer([port])
    try:
        assert quant.is_quantized(port._ensure_params()["lm_head"])
        return [_generate(core, p, n) for p, n in zip(prompts, budgets)]
    finally:
        core.close()


def _jax_tokens(prompts, budgets, **kwargs):
    """The same from JAX's ``quantize=True`` model (its own init of
    ``PRNGKey(0)``, quantized on load)."""
    core = JaxServer([JaxLlama(cfg=tiny_cfgs()[0], max_seq=MAX_SEQ,
                               quantize=True, **kwargs)])
    try:
        return [_generate_jax(core, p, n) for p, n in zip(prompts, budgets)]
    finally:
        core.close()


def test_single_stream_int8_tokens_match_jax(tparams):
    """``max_slots=1``: a 4-token prompt (weight-only prefill) and a
    12-token one (w8a8 prefill), decode weight-only."""
    got = _port_tokens(tparams, [SHORT, LONG], [12, 10])
    assert got == _jax_tokens([SHORT, LONG], [12, 10])
    assert [len(t) for t in got] == [12, 10]


def test_batched_int8_tokens_match_jax(tparams):
    """``max_slots=3`` with 5 prompts (w8a8 prefill at the bucket, decode
    steps weight-only over all 3 rows)."""
    got = _port_tokens(tparams, PROMPTS, BUDGETS, max_slots=3)
    assert got == _jax_tokens(PROMPTS, BUDGETS, max_slots=3)
    assert [len(t) for t in got] == BUDGETS


def test_spec_int8_tokens_match_plain_and_jax(tparams):
    """``spec_tokens=4`` under int8 streams the tokens of
    ``spec_tokens=0``, and JAX's ``spec_tokens=4``."""
    spec = _port_tokens(tparams, PROMPTS, BUDGETS, max_slots=3,
                        spec_tokens=4)
    assert spec == _port_tokens(tparams, PROMPTS, BUDGETS, max_slots=3,
                                spec_tokens=0)
    assert spec == _jax_tokens(PROMPTS, BUDGETS, max_slots=3,
                               spec_tokens=4)


def test_quantized_params_are_served_as_given(jquant):
    """An already-quantized tree is served as it is (not quantized again);
    the KV cache stays in ``cfg.dtype``."""
    _, bridged = jquant
    _, tcfg = tiny_cfgs()
    model = LlamaGenerateModel(cfg=tcfg, max_seq=MAX_SEQ, params=bridged,
                               device="cpu", quantize=True)
    served = model._ensure_params()
    assert served["lm_head"]["q"] is bridged["lm_head"]["q"]
    core = InferenceServer([model])
    try:
        assert len(_generate(core, SHORT, 3)) == 3
    finally:
        core.close()


def test_serve_quantize_flag_serves_int8_tokens(tmp_path):
    """``serve.py --quantize`` as a process (``tiny``, bf16, on the CPU):
    its startup line names int8 weights, and a stream's tokens equal an
    in-process ``LlamaGenerateModel(quantize=True)`` on the same seed."""
    port = free_port()
    log = tmp_path / "serve.log"
    src = os.path.join(os.path.dirname(TESTS), "src", "python")
    with open(log, "wb") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "tpuserver_torch.serve", "--device",
             "cpu", "--config", "tiny", "--max-seq", str(MAX_SEQ),
             "--quantize", "--port", str(port)],
            env=dict(os.environ, PYTHONPATH=src, OMP_NUM_THREADS="1"),
            stdout=out, stderr=subprocess.STDOUT)
    try:
        wait_for(lambda: b"int8 weights" in log.read_bytes()
                 or proc.poll() is not None, "serve.py to start", WAIT_S)
        assert b"int8 weights" in log.read_bytes(), log.read_text()[-2000:]
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=WAIT_S)
        conn.request("POST", "/v2/models/llama_generate/generate_stream",
                     json.dumps({"inputs": [
                         {"name": "PROMPT_IDS", "datatype": "INT32",
                          "shape": [len(SHORT)], "data": SHORT},
                         {"name": "MAX_TOKENS", "datatype": "INT32",
                          "shape": [1], "data": [6]}]}))
        tokens = [e["outputs"][0]["data"][0]
                  for _, e in sse_events(conn.getresponse())
                  if not e.get("final")]
        conn.close()
    finally:
        proc.kill()
        proc.wait(timeout=WAIT_S)
    model = LlamaGenerateModel(cfg=tl.tiny(), max_seq=MAX_SEQ, device="cpu",
                               quantize=True)
    core = InferenceServer([model])
    try:
        assert tokens == _generate(core, SHORT, 6) and len(tokens) == 6
    finally:
        core.close()
