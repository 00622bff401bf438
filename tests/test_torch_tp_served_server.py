"""A tensor-parallel ``LlamaGenerateModel`` of the port served through
its gRPC front end on the CPU (the counterpart of
``tests/test_tp_served_server.py``): a tp=4 model over 4 gloo ranks (the
test process is the driver; ``spmd.start`` spawns the followers) driven
over a real decoupled gRPC stream with ``tritonclient.grpc``, against the
port's unsharded model and the JAX package's tp=4 model behind its own
``GrpcFrontend`` on the 4-device virtual CPU mesh.

Weights: float32 ``tiny(vocab=512)`` on both sides, the JAX model's own
``init_params(PRNGKey(0))`` bridged to the port by ``params_from_jax``.
Also: a KV park at tp=4 resumed at tp=4 and by the unsharded model, int8
at tp=4 (deterministic, JAX's 0.7 agreement bar with the float32
tokens), ``max_slots=4`` streams interleaved against the same streams
run one by one and the unsharded scheduler, ``spec_tokens=4`` against
plain steps, a mesh without a ``tp`` axis refused, driver threads
sharing the mirror, a dropped handle freed on
every follower, a scheduler restart that frees its dead loop's pool on
every rank, and a follower's exception raised on the driver.
"""

import dataclasses
import importlib
import logging
import sys
import threading
import types

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
from tpuserver.parallel import MeshConfig as JaxMeshConfig
from tpuserver.parallel import make_mesh as jax_make_mesh
from tpuserver_torch import cuda_shared_memory as csm
from tpuserver_torch import fault_points
from tpuserver_torch.core import InferenceServer
from tpuserver_torch.grpc_server import GrpcServer
from tpuserver_torch.models import llama as tl
from tpuserver_torch.models.llama_serving import LlamaGenerateModel
from tpuserver_torch.parallel import spmd

pytestmark = pytest.mark.torch_port

VOCAB = 512
MAX_SEQ = 64
CHUNK = 4
TP = 4
PROMPT = np.array([3, 1, 4, 1, 5, 9, 2, 6], dtype=np.int32)
PROMPTS = [np.array(p, np.int32) for p in (
    [3, 1, 4, 1, 5], [9, 8, 7], [2, 7, 1, 8, 2, 8], [5, 5, 3], [1, 2])]
BUDGETS = [8, 6, 7, 5, 9]
SCOPE = "tp-served"


def _cfgs():
    return (dataclasses.replace(jl.tiny(vocab=VOCAB), dtype=jnp.float32),
            dataclasses.replace(tl.tiny(vocab=VOCAB), dtype=torch.float32))


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    store = tmp_path_factory.mktemp("tp_served") / "store"
    mesh, followers = spmd.start(TP, str(store), device="cpu", threads=1,
                                 timeout_s=60)
    yield mesh
    codes = spmd.shutdown(mesh, followers, timeout=30)
    torch.set_num_threads(threads)
    assert codes == [0] * (TP - 1)


@pytest.fixture(scope="module")
def full():
    """The JAX model's weights (``PRNGKey(0)``) as the port's params."""
    return tl.params_from_jax(jax.tree_util.tree_map(
        np.asarray, jl.init_params(jax.random.PRNGKey(0), _cfgs()[0])),
        "cpu")


@pytest.fixture(autouse=True)
def _clean_faults():
    fault_points.clear()
    yield
    fault_points.clear()


def _model(full, mesh=None, **kwargs):
    kwargs.setdefault("decode_chunk", CHUNK)
    return LlamaGenerateModel(cfg=_cfgs()[1], max_seq=MAX_SEQ, params=full,
                              device="cpu", mesh=mesh, **kwargs)


def _inputs(prompt, max_tokens):
    p = grpcclient.InferInput("PROMPT_IDS", [len(prompt)], "INT32")
    p.set_data_from_numpy(np.asarray(prompt, np.int32))
    m = grpcclient.InferInput("MAX_TOKENS", [1], "INT32")
    m.set_data_from_numpy(np.array([max_tokens], np.int32))
    return [p, m]


def _tokens(url, prompt, max_tokens, parameters=None):
    client = grpcclient.InferenceServerClient(url)
    try:
        return [int(r.as_numpy("TOKEN")[0]) for r in client.generate_stream(
            "llama_generate", _inputs(prompt, max_tokens),
            parameters=parameters)]
    finally:
        client.close()


class _Served:
    """A model behind the port's core and gRPC server."""

    def __init__(self, model):
        self.model = model
        self.core = InferenceServer([model], fault_scope=SCOPE)
        self.grpc = GrpcServer(self.core, port=0).start()

    def tokens(self, prompt, max_tokens, parameters=None):
        return _tokens(self.grpc.url, prompt, max_tokens, parameters)

    def close(self):
        self.grpc.stop()
        self.core.close()


def _serve(model, fn):
    served = _Served(model)
    try:
        return fn(served)
    finally:
        served.close()


@pytest.fixture(scope="module")
def reference(full):
    """The unsharded port model's 10 tokens for PROMPT."""
    return _serve(_model(full), lambda s: s.tokens(PROMPT, 10))


def test_tp_served_generation_matches_unsharded_and_jax(mesh, full,
                                                         reference):
    """tp=4 over gRPC: the unsharded port model's tokens and the JAX
    package's tp=4 served tokens (10 tokens: two chunks of 4 and a tail
    of 2, stepped one mirrored call a token)."""
    tokens = _serve(_model(full, mesh), lambda s: s.tokens(PROMPT, 10))
    jax_mesh = jax_make_mesh(JaxMeshConfig(dp=1, sp=1, tp=TP),
                             jax.devices()[:TP])
    jax_core = JaxServer([JaxLlama(cfg=_cfgs()[0], max_seq=MAX_SEQ,
                                   decode_chunk=CHUNK, mesh=jax_mesh)])
    frontend = GrpcFrontend(jax_core, port=0).start()
    try:
        jax_tokens = _tokens(frontend.url, PROMPT, 10)
    finally:
        frontend.stop()
        jax_core.close()
    assert len(tokens) == 10
    assert tokens == reference == jax_tokens


def _park_resume(served, resume_on=None):
    """4 tokens parked in a CPU region, then 4 more resumed from the park
    (by ``resume_on``, another served model on the same core's region,
    when given): the resume feeds the last token again at its own
    position, so it continues the generation exactly."""
    h = csm.create_shared_memory_region("park", 1 << 20, device="cpu")
    served.core.register_cuda_shm("park", csm.get_raw_handle(h), 0, 1 << 20)
    try:
        first = served.tokens(PROMPT, 4, {"kv_cache_region": "park"})
        parked = served.core.cuda_shm_region("park").parked_tensor(0)
        shape = tuple(parked.shape)
        resumer = resume_on or served
        if resume_on is not None:
            resumer.core.register_cuda_shm("park", csm.get_raw_handle(h), 0,
                                           1 << 20)
            resumer.core.cuda_shm_region("park").put_device_tensor(
                0, parked)
        second = resumer.tokens(first[-1:], 4, {
            "kv_cache_region": "park", "kv_cache_resume": True,
            "kv_cache_position": len(PROMPT) + 3})
        if resume_on is not None:
            resumer.core.unregister_cuda_shm("park")
        return first, second, shape
    finally:
        served.core.unregister_cuda_shm("park")
        csm.destroy_shared_memory_region(h)


def test_tp_served_kv_park_and_resume(mesh, full, reference):
    """A tp=4 park holds the full ``[L, 2, 1, max_seq, Hkv, D]`` layout
    (the kv heads gathered to the driver); resumed at tp=4 and by the
    unsharded model (tp=1) it continues as the unparked generation does:
    8 tokens of 10 equal to the reference's first 8."""
    cfg = _cfgs()[1]
    tp4 = _Served(_model(full, mesh))
    single = _Served(_model(full))
    try:
        first, second, shape = _park_resume(tp4)
        first1, second1, _ = _park_resume(tp4, resume_on=single)
    finally:
        tp4.close()
        single.close()
    assert shape == (cfg.n_layers, 2, 1, MAX_SEQ, cfg.n_kv_heads,
                     cfg.head_dim)
    assert first == first1 == reference[:4]
    assert second == second1 == reference[4:8]


def test_tp_served_quantized_generation(mesh, full, reference):
    """Int8 weights at tp=4 (quantized whole, then sharded): two requests
    on one server agree bit for bit, and agree with the float32 tokens at
    JAX's 0.7 bar."""
    tokens_a, tokens_b = _serve(
        _model(full, mesh, quantize=True),
        lambda s: (s.tokens(PROMPT, 10), s.tokens(PROMPT, 10)))
    assert tokens_a == tokens_b
    agree = np.mean(np.asarray(tokens_a) == np.asarray(reference))
    assert agree >= 0.7, (tokens_a, reference)


def _interleaved(served):
    results = [None] * len(PROMPTS)

    def one(i):
        results[i] = served.tokens(PROMPTS[i], BUDGETS[i])

    threads = [threading.Thread(target=one, args=(i,), daemon=True)
               for i in range(len(PROMPTS))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    return results


def test_tp_batched_streams_equal_sequential_and_unsharded(mesh, full):
    """``max_slots=4`` at tp=4: five streams at once over four slots give
    the tokens of the same five run one at a time, which are the
    unsharded scheduler's."""
    def rounds(served):
        sequential = [served.tokens(p, n) for p, n in zip(PROMPTS, BUDGETS)]
        return sequential, _interleaved(served)

    seq, inter = _serve(_model(full, mesh, max_slots=4), rounds)
    unsharded = _serve(_model(full, max_slots=4), lambda s: [
        s.tokens(p, n) for p, n in zip(PROMPTS, BUDGETS)])
    assert [len(t) for t in seq] == BUDGETS
    assert inter == seq == unsharded


def test_tp_spec_tokens_equal_plain_steps(mesh, full):
    """``spec_tokens=4`` at tp=4 (the verify chain mirrored as one call a
    step): the tokens of plain steps, on prompts that repeat so drafts
    are found and accepted."""
    prompts = [np.array([5, 6, 7, 5, 6, 7, 5, 6], np.int32),
               np.array([9, 1, 9, 1, 9, 1], np.int32)]

    def run(spec):
        return _serve(_model(full, mesh, max_slots=2, spec_tokens=spec),
                      lambda s: [s.tokens(p, 12) for p in prompts])

    assert run(4) == run(0)


def test_model_rejects_a_mesh_without_tp():
    class Mesh:
        mesh_dim_names = ("dp", "sp")

    with pytest.raises(ValueError, match="'tp' axis"):
        LlamaGenerateModel(cfg=_cfgs()[1], max_seq=MAX_SEQ, device="cpu",
                           mesh=Mesh())


def test_dropped_handle_is_freed_on_every_follower(mesh):
    """A cache dropped on the driver is freed on every rank: each
    rank's holdings grow by one shard and go back with the next call."""
    m = spmd.mirror(mesh)
    cfg = _cfgs()[1]
    before = m.handles()
    init_cache, _, _ = tl.make_tp_serving(mesh, cfg)
    cache = init_cache(1, MAX_SEQ)
    shard = cache.numel() * cache.element_size()
    during = m.handles()
    assert [d[0] - b[0] for b, d in zip(before, during)] == [1] * TP
    assert [d[1] - b[1] for b, d in zip(before, during)] == [shard] * TP
    del cache
    assert m.handles() == before


def test_scheduler_restart_frees_the_dead_loop_on_every_rank(
        mesh, full, monkeypatch):
    """A ``scheduler.step`` fault kills the tp=4 decode loop once: the
    supervisor restarts it, the stream completes with the undisturbed
    tokens, and once the model is closed every rank holds what it held
    before (the dead loop's page pool freed on the followers too)."""
    # pytest's log capture keeps each record, and the logged failure's
    # traceback would pin the dead loop's frames (and its pool) until the
    # test ends: the scheduler's records go to the last-resort handler
    monkeypatch.setattr(logging.getLogger("tpuserver_torch.scheduler"),
                        "propagate", False)
    m = spmd.mirror(mesh)
    model = _model(full, mesh, max_slots=2, fault_scope=SCOPE)
    model._ensure_params()
    before = m.handles()
    served = _Served(model)
    try:
        clean = served.tokens(PROMPTS[0], 8)
        fault_points.install("scheduler.step", "raise", times=1,
                             scope=SCOPE, skip=3)
        faulted = served.tokens(PROMPTS[0], 8)
        restarts = model.scheduler_stats()["restarts"]
    finally:
        served.close()
    assert restarts == 1
    assert faulted == clean
    assert m.handles() == before


def test_driver_threads_share_the_mirror(mesh, full):
    """Eight driver threads (the interpreter switching every 10 us) each
    make caches, prefill and drop them through the mirror at once: every prefill gives the lone
    prefill's logits, and afterwards every rank holds what it held
    before (no handle lost or freed twice)."""
    m = spmd.mirror(mesh)
    cfg = _cfgs()[1]
    params = tl.tp_params(mesh, cfg, full)
    init_cache, prefill, _ = tl.make_tp_serving(mesh, cfg)
    ref = prefill(params, init_cache(1, MAX_SEQ), PROMPT[None, :])[0]
    before = m.handles()
    errors = []

    def work():
        try:
            for _ in range(4):
                logits, cache = prefill(params, init_cache(1, MAX_SEQ),
                                        PROMPT[None, :])
                assert torch.equal(logits, ref)
                del logits, cache
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, daemon=True)
                   for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert m.handles() == before


def test_follower_error_surfaces_on_the_driver(mesh):
    """A call that raises on the followers alone (a module only the
    driver has) raises FollowerError on the driver at once, naming each
    follower; no collective was left behind, so the mirror goes on."""
    name = "_tp_driver_only_module"
    sys.modules[name] = types.ModuleType(name)
    m = spmd.mirror(mesh)
    try:
        with pytest.raises(spmd.FollowerError,
                           match="rank 1: ModuleNotFoundError") as err:
            m.call(importlib.import_module, name)
        assert "rank 3" in str(err.value) and "rank 0" not in str(err.value)
    finally:
        del sys.modules[name]
    assert m.broken is None
    init_cache, _, _ = tl.make_tp_serving(mesh, _cfgs()[1])
    assert tuple(init_cache(1, MAX_SEQ).shape)[4] == _cfgs()[1].n_kv_heads // TP
