"""Tensor-parallel serving of the port on the CPU (the counterpart of
``tests/test_tp_serving.py``): ``make_tp_serving``, ``make_tp_step`` and
``make_scheduler_fns(mesh=)`` over 4 gloo ranks, held against the JAX
package's single-device path and its ``make_tp_serving`` on the 4-device
virtual CPU mesh, and against the port's own unsharded path.

The test process is the driver (rank 0); ``spmd.start`` spawns ranks 1-3
as daemon processes that run ``spmd.follow`` (its module imports no
JAX) over a ``file://`` store under the module's temporary directory.
One pool serves the module; its teardown stops the followers, leaves the
group and joins them.

Weights: ``tiny(vocab=512)``, ``init_params(PRNGKey(7))`` of the JAX
package bridged by ``params_from_jax`` and sharded by ``tp_params``.
Tolerances: bfloat16 logits within JAX's own 6e-2; float32 logits within
1e-5 (the all-reduces sum the same products in another order).
"""

import dataclasses
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuserver.models import llama as jl
from tpuserver.parallel import MeshConfig as JaxMeshConfig
from tpuserver.parallel import make_mesh as jax_make_mesh
from tpuserver.parallel import mesh_factorize as jax_mesh_factorize
from tpuserver_torch.models import llama as tl
from tpuserver_torch.ops import quant
from tpuserver_torch.parallel import (
    MeshConfig,
    make_mesh,
    mesh_factorize,
    spmd,
)

pytestmark = pytest.mark.torch_port

VOCAB = 512
MAX_SEQ = 64
CHUNK = 4
TP = 4
PROMPT = np.array([[3, 1, 4, 1, 5, 9, 2, 6]], np.int64)
N_TOKENS = 12
TOL = {"bfloat16": 6e-2, "float32": 1e-5}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfgs(dtype, vocab=VOCAB, **port_kw):
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    return (dataclasses.replace(jl.tiny(vocab=vocab), dtype=jdt),
            dataclasses.replace(tl.tiny(vocab=vocab), dtype=tdt, **port_kw))


def _bridged(jcfg, seed=7):
    params = jl.init_params(jax.random.PRNGKey(seed), jcfg)
    return params, tl.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), "cpu")


def _np(t):
    return t.detach().float().numpy()


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    store = tmp_path_factory.mktemp("tp_serving") / "store"
    mesh, followers = spmd.start(TP, str(store), device="cpu", threads=1,
                                 timeout_s=60)
    yield mesh
    codes = spmd.shutdown(mesh, followers, timeout=30)
    torch.set_num_threads(threads)
    assert codes == [0] * (TP - 1)


@pytest.fixture(scope="module")
def jax_mesh():
    return jax_make_mesh(JaxMeshConfig(dp=1, sp=1, tp=TP), jax.devices()[:TP])


def _jax_generate(jcfg, params, mesh=None):
    """JAX prefill + chunked greedy decode, single-device or its
    ``make_tp_serving`` on ``mesh``: (prefill logits, tokens, last
    logits)."""
    if mesh is None:
        prefill = jax.jit(functools.partial(jl.prefill, cfg=jcfg))
        decode = jax.jit(functools.partial(jl.decode_chunk, cfg=jcfg,
                                           chunk=CHUNK))
        cache = jl.init_kv_cache(jcfg, 1, MAX_SEQ)
    else:
        init_cache, prefill, decode = jl.make_tp_serving(
            mesh, jcfg, chunk=CHUNK, donate=False)
        params = jax.device_put(params, jax.tree_util.tree_map(
            lambda s: jax.sharding.NamedSharding(mesh, s),
            jl.param_specs(jcfg)))
        cache = init_cache(1, MAX_SEQ)
    logits, cache = prefill(params, cache, jnp.asarray(PROMPT, jnp.int32))
    first, out, pos = np.asarray(logits), [], PROMPT.shape[1]
    for _ in range(N_TOKENS // CHUNK):
        toks, _, logits, cache = decode(params, cache, logits, pos)
        out.append(np.asarray(toks)[:, 0])
        pos += CHUNK
    return first, np.concatenate(out), np.asarray(logits)


def _port_generate(mesh, tcfg, params):
    init_cache, prefill, decode = tl.make_tp_serving(mesh, tcfg, chunk=CHUNK)
    cache = init_cache(1, MAX_SEQ)
    logits, cache = prefill(params, cache, PROMPT)
    first, out, pos = _np(logits), [], PROMPT.shape[1]
    for _ in range(N_TOKENS // CHUNK):
        toks, _, logits, cache = decode(params, cache, logits, pos)
        out.append(toks[:, 0].numpy())
        pos += CHUNK
    return first, np.concatenate(out), _np(logits), cache


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_tp_decode_matches_jax(mesh, jax_mesh, dtype):
    """Port tp=4 greedy tokens equal JAX's single-device tokens and JAX's
    tp=4 tokens; the logits (after the prefill and after 12 tokens)
    within the stated tolerance of JAX's single-device ones."""
    jcfg, tcfg = _cfgs(dtype)
    params, full = _bridged(jcfg)
    j_first, j_toks, j_last = _jax_generate(jcfg, params)
    _, jt_toks, jt_last = _jax_generate(jcfg, params, jax_mesh)
    sharded = tl.tp_params(mesh, tcfg, full)
    t_first, t_toks, t_last, _ = _port_generate(mesh, tcfg, sharded)
    np.testing.assert_array_equal(jt_toks, j_toks)
    np.testing.assert_array_equal(t_toks, j_toks)
    tol = TOL[dtype]
    np.testing.assert_allclose(t_first, j_first, rtol=tol, atol=tol)
    np.testing.assert_allclose(t_last, j_last, rtol=tol, atol=tol)
    np.testing.assert_allclose(t_last, jt_last, rtol=tol, atol=tol)


def test_tp_matches_the_unsharded_port_and_its_step(mesh):
    """float32: tp=4 against the port's unsharded prefill and chunked
    decode (tokens equal, logits within 1e-5); ``make_tp_step`` fed the
    same tokens reproduces the chunk's logits; the gathered cache is the
    unsharded one."""
    jcfg, tcfg = _cfgs("float32")
    _, full = _bridged(jcfg)
    cache = tl.init_kv_cache(tcfg, 1, MAX_SEQ, "cpu")
    ref, cache = tl.prefill(full, cache, torch.from_numpy(PROMPT), tcfg)
    ref_toks, _, ref_last, cache = tl.decode_chunk(
        full, cache, ref, PROMPT.shape[1], tcfg, N_TOKENS)
    sharded = tl.tp_params(mesh, tcfg, full)
    first, toks, last, tcache = _port_generate(mesh, tcfg, sharded)
    np.testing.assert_array_equal(toks, ref_toks[:, 0].numpy())
    np.testing.assert_allclose(first, _np(ref), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(last, _np(ref_last), atol=1e-5, rtol=1e-5)
    gathered = tl.tp_gather_cache(mesh, tcache)
    assert tuple(gathered.shape) == tuple(cache.shape)
    np.testing.assert_allclose(_np(gathered), _np(cache), atol=1e-5)
    # the step path: a fresh prefill, then one token at a time
    init_cache, prefill, _ = tl.make_tp_serving(mesh, tcfg, chunk=CHUNK)
    step = tl.make_tp_step(mesh, tcfg)
    c = init_cache(1, MAX_SEQ)
    logits, c = prefill(sharded, c, PROMPT)
    for i, tok in enumerate(toks):
        logits, c = step(sharded, c, np.array([tok]), PROMPT.shape[1] + i)
    np.testing.assert_allclose(_np(logits), last, atol=1e-6, rtol=1e-6)


def test_tp_cache_is_sharded_on_kv_heads(mesh):
    _, tcfg = _cfgs("bfloat16")
    init_cache, _, _ = tl.make_tp_serving(mesh, tcfg, chunk=CHUNK)
    cache = init_cache(1, MAX_SEQ)
    assert tuple(cache.shape) == (tcfg.n_layers, 2, 1, MAX_SEQ,
                                  tcfg.n_kv_heads // TP, tcfg.head_dim)
    assert tl.cache_spec(tcfg) == 4
    m = spmd.mirror(mesh)
    # every rank holds the same bytes for the driver's handles
    assert len(set(m.handles())) == 1


def test_tp_rejects_indivisible_heads(mesh):
    bad = tl.LlamaConfig(vocab=128, d_model=48, n_layers=1, n_heads=6,
                         n_kv_heads=3, d_ff=64)
    for make in (lambda: tl.make_tp_serving(mesh, bad),
                 lambda: tl.make_tp_step(mesh, bad),
                 lambda: tl.make_scheduler_fns(bad, MAX_SEQ, 2, mesh=mesh),
                 lambda: tl.serving_shardings(mesh, bad)):
        with pytest.raises(ValueError, match="must divide"):
            make()


def test_tp_scheduler_bundle_matches_unsharded(mesh):
    """``make_scheduler_fns(mesh=)``: a prefilled admission, six paged
    steps and a gather at tp=4 against the unsharded bundle (float32:
    tokens equal, logits within 1e-5), then a park in the full layout
    admitted back (the attach path) continuing as the unsharded bundle
    does."""
    jcfg, tcfg = _cfgs("float32")
    _, full = _bridged(jcfg)
    sharded = tl.tp_params(mesh, tcfg, full)
    runs = []
    for on_mesh, params in ((True, sharded), (False, full)):
        fns = tl.make_scheduler_fns(tcfg, MAX_SEQ, 3, device="cpu",
                                    mesh=mesh if on_mesh else None)
        ppseq, n_pages = fns["pages_per_seq"], fns["n_pages"]
        pages, logits = fns["init_cache"](), fns["init_logits"]()
        slot_logits, slot_cache = fns["prefill"](
            params, fns["init_slot_cache"](), PROMPT, PROMPT.shape[1])
        tables = np.full((3, ppseq), n_pages, np.int32)
        tables[1] = np.arange(ppseq, 2 * ppseq)
        pages, logits = fns["admit"](pages, logits, slot_cache, slot_logits,
                                     tables[1], 1)
        positions = np.full((3,), MAX_SEQ, np.int32)
        active = np.zeros((3,), bool)
        active[1] = True
        zero = np.zeros((3,), np.int32)
        toks = []
        for i in range(6):
            positions[1] = PROMPT.shape[1] + i
            t, _, logits, pages = fns["step"](params, pages, logits, tables,
                                              positions, active, zero,
                                              zero.astype(bool))
            toks.append(int(np.asarray(t)[1]))
        parked = fns["gather"](pages, tables[1])
        if on_mesh:
            parked = tl.tp_gather_cache(mesh, parked)
        # the park admitted into slot 2 (full layout: scattered to heads)
        tables[2] = np.arange(2 * ppseq, 3 * ppseq)
        pages, logits = fns["admit"](pages, logits, parked,
                                     logits[1:2].clone(), tables[2], 2)
        active[:] = [False, False, True]
        positions[2] = PROMPT.shape[1] + 6
        t, _, logits, pages = fns["step"](params, pages, logits, tables,
                                          positions, active, zero,
                                          zero.astype(bool))
        toks.append(int(np.asarray(t)[2]))
        runs.append((toks, _np(parked), _np(logits)))
    (tp_toks, tp_park, tp_logits), (toks, park, ref_logits) = runs
    assert tp_toks == toks
    assert tp_park.shape == park.shape
    np.testing.assert_allclose(tp_park, park, atol=1e-5)
    np.testing.assert_allclose(tp_logits, ref_logits, atol=1e-5, rtol=1e-5)


def test_tp_batched_row_bits_do_not_depend_on_the_slot(mesh):
    """bf16 at tp=4: one prompt admitted in slots 0 and 2 beside another
    in slot 1; four paged steps give both copies the same logits bit for
    bit (the all-reduces add the ranks' partials in one order for every
    element, wherever the row lies)."""
    jcfg, tcfg = _cfgs("bfloat16")
    _, full = _bridged(jcfg)
    params = tl.tp_params(mesh, tcfg, full)
    fns = tl.make_scheduler_fns(tcfg, MAX_SEQ, 3, device="cpu", mesh=mesh)
    ppseq, n_pages = fns["pages_per_seq"], fns["n_pages"]
    pages, logits = fns["init_cache"](), fns["init_logits"]()
    tables = np.full((3, ppseq), n_pages, np.int32)
    other = np.array([[7, 7, 1, 2, 9, 4, 4, 3]], np.int64)
    for slot, prompt in ((0, PROMPT), (1, other), (2, PROMPT)):
        slot_logits, slot_cache = fns["prefill"](
            params, fns["init_slot_cache"](), prompt, prompt.shape[1])
        tables[slot] = np.arange(slot * ppseq, (slot + 1) * ppseq)
        pages, logits = fns["admit"](pages, logits, slot_cache, slot_logits,
                                     tables[slot], slot)
    active = np.ones((3,), bool)
    zero = np.zeros((3,), np.int32)
    for i in range(4):
        positions = np.full((3,), PROMPT.shape[1] + i, np.int32)
        toks, _, logits, pages = fns["step"](params, pages, logits, tables,
                                             positions, active, zero,
                                             zero.astype(bool))
        assert np.asarray(toks)[0] == np.asarray(toks)[2]
        assert torch.equal(logits[0], logits[2])


def test_tp_w8a8_prefill_reduces_amax_and_int32(mesh):
    """Int8 at tp=4, float32 activations: an 8-token prefill runs the
    row-parallel w8a8 product (the row amax all-reduced by MAX before
    quantizing, the int32 partials summed before the rescale), so its
    logits match the unsharded int8 prefill to float32 rounding; without
    the amax reduction (each shard's own scale) they would not."""
    jcfg, tcfg = _cfgs("float32")
    _, full = _bridged(jcfg)
    qfull = tl.quantize_params(full)
    cache = tl.init_kv_cache(tcfg, 1, MAX_SEQ, "cpu")
    ref, _ = tl.prefill(qfull, cache, torch.from_numpy(PROMPT), tcfg)
    sharded = tl.tp_params(mesh, tcfg, full, quantize=True)
    assert quant.is_quantized(sharded["layers"][0]["wo"])
    # row-parallel scales stay whole (replicated); column-parallel shard
    assert tuple(sharded["layers"][0]["wo"]["s"].shape) == (tcfg.d_model,)
    assert tuple(sharded["layers"][0]["wq"]["s"].shape) == (
        tcfg.d_model // TP,)
    init_cache, prefill, _ = tl.make_tp_serving(mesh, tcfg, chunk=CHUNK,
                                                quantized=True)
    logits, _ = prefill(sharded, init_cache(1, MAX_SEQ), PROMPT)
    np.testing.assert_allclose(_np(logits), _np(ref), atol=1e-4, rtol=1e-4)
    # the weight format comes from the params: the same functions serve
    # bf16 shards as the unsharded bf16 model does
    plain_ref, _ = tl.prefill(full, tl.init_kv_cache(tcfg, 1, MAX_SEQ, "cpu"),
                              torch.from_numpy(PROMPT), tcfg)
    plain, _ = prefill(tl.tp_params(mesh, tcfg, full),
                       init_cache(1, MAX_SEQ), PROMPT)
    np.testing.assert_allclose(_np(plain), _np(plain_ref),
                               atol=TOL["float32"], rtol=TOL["float32"])


@pytest.mark.parametrize("prompt_len", [128, 77],
                         ids=["flash_prefill", "dense_prefill"])
def test_tp_kernel_route_matches_jax_pallas(mesh, prompt_len):
    """The kernel route at tp=4 (flash at local heads 2 and 1 for a
    128-token prompt, the decode kernel's plain version at every step)
    against JAX's single device with Pallas in interpret mode, as
    ``test_torch_llama.py`` holds the unsharded port: float32, max_seq
    256, 12 greedy tokens identical."""
    jcfg, tcfg = _cfgs("float32", vocab=128, attn_impl="kernel")
    jcfg = dataclasses.replace(jcfg, attn_impl="pallas",
                               decode_impl="pallas")
    params, full = _bridged(jcfg, seed=5)
    prompt = np.random.RandomState(9).randint(0, 128, prompt_len).astype(
        np.int64)
    prefill = jax.jit(functools.partial(jl.prefill, cfg=jcfg))
    decode = jax.jit(functools.partial(jl.decode_chunk, cfg=jcfg,
                                       chunk=CHUNK))
    cache = jl.init_kv_cache(jcfg, 1, 256)
    j_logits, cache = prefill(params, cache, jnp.asarray(prompt)[None, :])
    j_first, j_out, pos = np.asarray(j_logits), [], prompt_len
    for _ in range(N_TOKENS // CHUNK):
        toks, _, j_logits, cache = decode(params, cache, j_logits, pos)
        j_out.append(np.asarray(toks)[:, 0])
        pos += CHUNK
    sharded = tl.tp_params(mesh, tcfg, full)
    init_cache, prefill_fn, decode_fn = tl.make_tp_serving(mesh, tcfg,
                                                           chunk=CHUNK)
    c = init_cache(1, 256)
    logits, c = prefill_fn(sharded, c, prompt[None, :])
    t_first, t_out, pos = _np(logits), [], prompt_len
    for _ in range(N_TOKENS // CHUNK):
        toks, _, logits, c = decode_fn(sharded, c, logits, pos)
        t_out.append(toks[:, 0].numpy())
        pos += CHUNK
    np.testing.assert_allclose(t_first, j_first, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(np.concatenate(t_out),
                                  np.concatenate(j_out))
    np.testing.assert_allclose(_np(logits), np.asarray(j_logits), rtol=1e-4,
                               atol=1e-4)


def test_planted_fault_moves_the_logits(mesh):
    """The chip check's planted fault, layer 0's wo all-reduce dropped on
    every rank, moves the tp=4 prefill logits far beyond the float32
    tolerance; cleared, they return to the unsharded ones."""
    jcfg, tcfg = _cfgs("float32")
    _, full = _bridged(jcfg)
    sharded = tl.tp_params(mesh, tcfg, full)
    ref, _ = tl.prefill(full, tl.init_kv_cache(tcfg, 1, MAX_SEQ, "cpu"),
                        torch.from_numpy(PROMPT), tcfg)
    init_cache, prefill, _ = tl.make_tp_serving(mesh, tcfg)
    m = spmd.mirror(mesh)
    try:
        m.call(tl.tp_plant_fault, 0, tp=spmd.LOCAL)
        faulty, _ = prefill(sharded, init_cache(1, MAX_SEQ), PROMPT)
    finally:
        m.call(tl.tp_plant_fault, None, tp=spmd.LOCAL)
    clean, _ = prefill(sharded, init_cache(1, MAX_SEQ), PROMPT)
    assert np.abs(_np(faulty) - _np(ref)).max() > 1000 * TOL["float32"]
    np.testing.assert_allclose(_np(clean), _np(ref), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("rows,cols", [(15, 64), (1, 7), (2, 4096)],
                         ids=["rows", "odd", "decode_rows"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bfloat16", "float32"])
def test_tp_float_sum_forms_agree_bitwise(mesh, rows, cols, dtype):
    """Both forms of the float sum over tp (one all-gather, gloo's; a
    reduce-scatter by all_to_all and an all-gather, NCCL's, padded when
    the size does not divide), and ``all_reduce``, give the rank-order
    float32 sum of the ranks' tensors rounded once, bit for bit, wherever
    the element lies.  Each rank's tensor is its slice on dim 4 of one
    seeded array, scaled by 10**rank so that the order shows."""
    g = torch.Generator().manual_seed(11)
    full = (torch.randn((1, 1, 1, rows, TP, cols), generator=g)
            * 10.0 ** torch.arange(TP)[:, None]).to(dtype)
    ref = full[:, :, :, :, :1].to(torch.float32, copy=True)
    for r in range(1, TP):
        ref += full[:, :, :, :, r:r + 1]
    ref = ref.to(dtype)
    m = spmd.mirror(mesh)
    local = m.call(tl._local_heads, full, tp=spmd.LOCAL)
    for fn in (spmd.TPContext._sum_gathered, spmd.TPContext._sum_scattered,
               spmd.TPContext.all_reduce):
        out = m.call(fn, spmd.LOCAL, local, keep=False)
        assert out.dtype == dtype and out.shape == ref.shape
        assert torch.equal(out, ref), fn.__name__


def test_planted_fault_drops_the_wo_sum_of_an_int8_prefill(mesh):
    """At int8 an 8-token prefill's wo product is w8a8: an amax maximum,
    then the int32 sum.  The planted fault drops the sum and keeps the
    maximum, on every forward: the faulted int8 logits stay near the
    faulted float32 ones (quantization apart), far from the clean int8
    ones, and a second faulted prefill repeats the first bit for bit."""
    jcfg, tcfg = _cfgs("float32")
    _, full = _bridged(jcfg)
    init_cache, prefill, _ = tl.make_tp_serving(mesh, tcfg)
    m = spmd.mirror(mesh)
    out = {}
    for name, params in (("float", tl.tp_params(mesh, tcfg, full)),
                         ("int8", tl.tp_params(mesh, tcfg, full,
                                               quantize=True))):
        out[name] = _np(prefill(params, init_cache(1, MAX_SEQ), PROMPT)[0])
        try:
            m.call(tl.tp_plant_fault, 0, tp=spmd.LOCAL)
            faulty = [_np(prefill(params, init_cache(1, MAX_SEQ), PROMPT)[0])
                      for _ in range(2)]
        finally:
            m.call(tl.tp_plant_fault, None, tp=spmd.LOCAL)
        np.testing.assert_array_equal(faulty[0], faulty[1])
        out[name + "_faulty"] = faulty[0]
    moved = np.abs(out["int8_faulty"] - out["int8"]).max()
    quantization = np.abs(out["int8_faulty"] - out["float_faulty"]).max()
    assert moved > 10 * quantization


@pytest.mark.parametrize("k,n", [(4096, 1024), (4096, 256), (1024, 4096),
                                 (4096, 3584), (3584, 4096), (4096, 32064)])
def test_int8_splits_at_the_tp4_shard_shapes(k, n):
    """``int8_splits`` at Llama-3-8B's tp=4 shard shapes: splits of a
    multiple of 256 rows, at most 1024, covering K with no empty split
    (the kernel's contract), from the shape alone."""
    n_split, rows = quant.int8_splits(k, n)
    assert rows % 256 == 0 and 256 <= rows <= 1024
    assert (n_split - 1) * rows < k <= n_split * rows
    assert quant.int8_splits(k, n) == (n_split, rows)


def test_mesh_factorize_matches_jax():
    for n in range(1, 17):
        for want_sp in (True, False):
            ours, theirs = mesh_factorize(n, want_sp), jax_mesh_factorize(
                n, want_sp)
            assert (ours.dp, ours.sp, ours.tp) == (
                theirs.dp, theirs.sp, theirs.tp), n
            assert ours.size == n


def test_make_mesh_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: make_mesh() would use it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh(MeshConfig(tp=4))


def test_parallel_imports_no_jax():
    code = ("import sys; import tpuserver_torch.parallel, "
            "tpuserver_torch.parallel.spmd; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'tpuserver.', 'tritonclient'))]; "
            "assert not bad, bad; print('clean')")
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=os.path.join(REPO, "src", "python")),
        timeout=120)
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr
