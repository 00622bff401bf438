"""The port's continuous batching (tpuserver_torch.scheduler, the paged
and slotted steps of tpuserver_torch.models.llama, and
``LlamaGenerateModel(max_slots>1)``) on the CPU, held against the JAX
package on the same weights (``init_params(PRNGKey(0))`` bridged by
``params_from_jax``), with Pallas in interpret mode on the JAX side.

Tolerances: 1e-4 on float32 logits and K/V (both sides compute in
float32, in another order), 5e-2 in bfloat16.  Greedy tokens must be
identical on float32 ``tiny``; inside the port, paged and contiguous
steps must agree bit for bit, and chunked and one-shot prefill must
stream the same tokens."""

import dataclasses
import http.client
import json
import threading
import time

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
from tpuserver_torch.errors import (
    RequestTimedOut,
    ServerUnavailable,
    SlotPoisoned,
    TooManyRequests,
)
from tpuserver_torch.http_server import HttpServer
from tpuserver_torch.models import llama as tl
from tpuserver_torch.models.llama_serving import LlamaGenerateModel
from tpuserver_torch.scheduler import DecodeScheduler

pytestmark = pytest.mark.torch_port

CPU = torch.device("cpu")
VOCAB = 512
MAX_SEQ = 64
PAGE = 16
PPSEQ = MAX_SEQ // PAGE
PROMPTS = [np.array(p, np.int32) for p in (
    [3, 1, 4, 1, 5], [9, 8, 7], [2, 7, 1, 8, 2, 8], [1, 2, 3, 4], [42, 17])]
# varied budgets retire slots at different steps, so the last requests
# admit mid-flight into freed slots
MAX_TOKENS = [10, 7, 12, 6, 9]


def _configs(dtype="float32", kernel=False):
    """(JAX cfg, port cfg): tiny, with the kernels wired in on both sides
    (JAX: Pallas flash and decode; the port: its kernels' plain versions
    on the CPU) or both dense."""
    jcfg = dataclasses.replace(
        jl.tiny(vocab=VOCAB),
        dtype=jnp.float32 if dtype == "float32" else jnp.bfloat16)
    tcfg = dataclasses.replace(
        tl.tiny(vocab=VOCAB),
        dtype=torch.float32 if dtype == "float32" else torch.bfloat16)
    if kernel:
        jcfg = dataclasses.replace(jcfg, attn_impl="pallas",
                                   decode_impl="pallas")
        tcfg = dataclasses.replace(tcfg, attn_impl="kernel")
    else:
        tcfg = dataclasses.replace(tcfg, decode_impl="dense")
    return jcfg, tcfg


def _bridged(jcfg):
    params = jl.init_params(jax.random.PRNGKey(0), jcfg)
    return params, tl.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), CPU)


@pytest.fixture(scope="module")
def weights():
    jcfg, _ = _configs()
    return _bridged(jcfg)[1]


@pytest.fixture(scope="module")
def fns():
    _, tcfg = _configs()
    return tl.make_scheduler_fns(tcfg, MAX_SEQ, 2, device="cpu")


def _collect(sched, prompt, n):
    return [t for t, _ in sched.submit(np.asarray(prompt, np.int32), n)]


def _generate(core, prompt, n, parameters=None):
    req = InferRequest("llama_generate", inputs={
        "PROMPT_IDS": np.asarray(prompt, np.int32),
        "MAX_TOKENS": np.array([n], np.int32)}, parameters=parameters or {})
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


def _concurrently(fn, args):
    results = [None] * len(args)
    errors = []

    def worker(i):
        try:
            results[i] = fn(*args[i])
        except Exception as e:  # noqa: BLE001 — surfaced by the assert
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(args))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    return results


# -- the paged step against JAX's --------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_batched_decode_step_matches_jax(dtype):
    """One paged batched step at max_seq 256 on a pool of random K/V,
    rows at ragged positions (one inert at the sentinel), page tables
    scattered over the pool: logits and the written pool against JAX's
    step with its Pallas decode kernel."""
    jcfg, tcfg = _configs(dtype, kernel=True)
    params, tparams = _bridged(jcfg)
    max_seq, page, slots = 256, 16, 4
    ppseq = max_seq // page
    n_pages = slots * ppseq
    rng = np.random.RandomState(7)
    pool = rng.randn(jcfg.n_layers, 2, n_pages, page, jcfg.n_kv_heads,
                     jcfg.head_dim).astype(np.float32)
    tables = rng.permutation(n_pages).reshape(slots, ppseq).astype(np.int32)
    tables[2, 5:] = n_pages  # unreserved logical pages: the sentinel
    positions = np.array([200, 0, 77, max_seq], np.int32)  # row 3 inert
    tokens = rng.randint(0, VOCAB, slots).astype(np.int32)

    j_pages = jnp.asarray(pool, jcfg.dtype)
    j_logits, j_pages = jl.paged_batched_decode_step(
        params, j_pages, jnp.asarray(tokens), jnp.asarray(tables),
        jnp.asarray(positions), jcfg)
    t_pages = tl.init_paged_kv_cache(tcfg, n_pages, page, CPU)
    t_pages[:, :, :n_pages] = torch.from_numpy(np.array(
        jnp.asarray(pool, jcfg.dtype).astype(jnp.float32))).to(tcfg.dtype)
    t_logits, t_pages = tl.paged_batched_decode_step(
        tparams, t_pages, torch.from_numpy(tokens).long(),
        torch.from_numpy(tables), torch.from_numpy(positions), tcfg)
    tol = 1e-4 if dtype == "float32" else 5e-2
    assert t_logits.dtype == torch.float32 and tuple(t_logits.shape) == (
        slots, VOCAB)
    np.testing.assert_allclose(t_logits[:3].numpy(),
                               np.asarray(j_logits)[:3], rtol=tol, atol=tol)
    np.testing.assert_allclose(
        t_pages[:, :, :n_pages].float().numpy(),
        np.asarray(j_pages.astype(jnp.float32)), rtol=tol, atol=tol)


def test_batched_step_keeps_inert_rows_untouched():
    """The slotted step leaves an inert row's cache as it was (JAX drops
    its writes); the paged step sends the inert row's write to the trash
    page, leaving every real page but the live row's one untouched."""
    _, tcfg = _configs()
    params = tl.init_params(tcfg, torch.Generator().manual_seed(0), CPU)
    cache = torch.randn(tcfg.n_layers, 2, 2, MAX_SEQ, tcfg.n_kv_heads,
                        tcfg.head_dim, generator=torch.Generator()
                        .manual_seed(1))
    before = cache.clone()
    tl.batched_decode_step(params, cache, torch.tensor([5, 6]),
                           torch.tensor([3, MAX_SEQ]), tcfg)
    assert torch.equal(cache[:, :, 1], before[:, :, 1])
    changed = (cache[:, :, 0] != before[:, :, 0]).flatten(2).any(-1)
    assert changed.all() and torch.equal(cache[:, :, 0, 4:],
                                         before[:, :, 0, 4:])

    pages = tl.init_paged_kv_cache(tcfg, 2 * PPSEQ, PAGE, CPU)
    tables = torch.tensor([[0, 1, 2, 3], [8, 8, 8, 8]])
    tl.paged_batched_decode_step(params, pages, torch.tensor([5, 6]), tables,
                                 torch.tensor([17, MAX_SEQ]), tcfg)
    written = pages.flatten(3).abs().sum(-1).sum((0, 1)).nonzero()
    assert written[:, 0].tolist() == [1, 8]  # the live row's page, trash


# -- inside the port: paged == contiguous, bitwise ---------------------------


@pytest.mark.parametrize("decode_impl", ["auto", "dense"])
def test_paged_step_matches_contiguous_bitwise(weights, decode_impl):
    """Admit the same prefilled prompt into the slotted cache and the
    paged pool (identity page tables), run three batched steps each way:
    tokens, logprobs, next logits and the cache content agree bit for
    bit (the A/B of tests/test_paged_kv.py)."""
    _, tcfg = _configs()
    tcfg = dataclasses.replace(tcfg, decode_impl=decode_impl)
    prompt = torch.tensor([[3, 1, 4, 1, 5, 9, 2, 6]])
    true_len = prompt.shape[1]
    slots = 2
    slot_cache = tl.init_kv_cache(tcfg, 1, MAX_SEQ, CPU)
    row_logits, slot_cache = tl.prefill_to_length(weights, slot_cache,
                                                  prompt, true_len, tcfg)
    cache = tl.init_kv_cache(tcfg, slots, MAX_SEQ, CPU)
    logits_c = torch.zeros(slots, VOCAB)
    cache, logits_c = tl.scheduler_admit(cache, logits_c, slot_cache,
                                         row_logits, 0)
    pages = tl.init_paged_kv_cache(tcfg, slots * PPSEQ, PAGE, CPU)
    logits_p = torch.zeros(slots, VOCAB)
    pages, logits_p = tl.paged_admit(pages, logits_p, slot_cache, row_logits,
                                     np.arange(PPSEQ), 0)
    positions = torch.tensor([true_len, MAX_SEQ])
    active = torch.tensor([True, False])
    forced = torch.zeros(slots, dtype=torch.long)
    fmask = torch.zeros(slots, dtype=torch.bool)
    tables = torch.arange(slots * PPSEQ).view(slots, PPSEQ)
    for _ in range(3):
        t_c, lp_c, logits_c, cache = tl.scheduler_step(
            weights, cache, logits_c, positions, active, forced, fmask, tcfg)
        t_p, lp_p, logits_p, pages = tl.paged_scheduler_step(
            weights, pages, logits_p, tables, positions, active, forced,
            fmask, tcfg)
        assert torch.equal(t_c, t_p)
        assert torch.equal(lp_c, lp_p)
        assert torch.equal(logits_c, logits_p)
        positions[0] += 1
    assert torch.equal(tl.paged_gather(pages, tables[0]),
                       tl.scheduler_extract(cache, 0))


# -- the slice as a whole: served tokens against JAX and single-stream --------


KERNEL_PROMPTS = [np.random.RandomState(n).randint(0, VOCAB, n).astype(
    np.int32) for n in (128, 5, 77, 3, 128)]


@pytest.mark.parametrize("kernel", [True, False], ids=["kernel", "dense"])
def test_concurrent_streams_match_jax_and_single_stream(kernel):
    """5 concurrent prompts over 3 slots of the port's
    ``LlamaGenerateModel(max_slots=3)`` stream the same greedy tokens as
    the JAX ``LlamaGenerateModel(max_slots=3)`` and as the port's
    single-stream path.  The kernel config admits two 128-token prompts
    through the flash path (and prefills whole prompts: ``span_safe`` is
    False); the dense config buckets every prompt."""
    jcfg, tcfg = _configs(kernel=kernel)
    if kernel:
        tcfg = dataclasses.replace(tcfg, decode_impl="auto")
    _, tparams = _bridged(jcfg)
    max_seq = 256 if kernel else MAX_SEQ
    prompts = KERNEL_PROMPTS if kernel else PROMPTS
    fns = tl.make_scheduler_fns(tcfg, max_seq, 3, device="cpu")
    assert fns["span_safe"] is (not kernel)
    single = InferenceServer([LlamaGenerateModel(
        cfg=tcfg, max_seq=max_seq, decode_chunk=4, params=tparams,
        device="cpu")])
    reference = [_generate(single, p, n) for p, n in zip(prompts, MAX_TOKENS)]
    jax_core = JaxServer([JaxLlama(cfg=jcfg, max_seq=max_seq, max_slots=3,
                                   spec_tokens=0)])
    model = LlamaGenerateModel(cfg=tcfg, max_seq=max_seq, max_slots=3,
                               params=tparams, device="cpu")
    core = InferenceServer([model])
    try:
        jax_tokens = _concurrently(lambda p, n: _generate_jax(jax_core, p, n),
                                   list(zip(prompts, MAX_TOKENS)))
        ours = _concurrently(lambda p, n: _generate(core, p, n),
                             list(zip(prompts, MAX_TOKENS)))
        assert ours == jax_tokens == reference
        assert [len(t) for t in ours] == MAX_TOKENS
        stats = model.scheduler_stats()
        assert stats["admitted"] == 5 and stats["live_streams"] == 0
        assert stats["pages_free"] + stats["pages_cached"] == \
            stats["pages_total"]
    finally:
        core.close()
        jax_core.close()


def test_max_slots_model_rejects_overflow_and_bad_geometry():
    _, tcfg = _configs()
    model = LlamaGenerateModel(cfg=tcfg, max_seq=MAX_SEQ, max_slots=2,
                               device="cpu")
    core = InferenceServer([model])
    try:
        with pytest.raises(Exception, match="exceeds") as info:
            _generate(core, np.arange(40), 40)
        assert info.value.code == 400
    finally:
        core.close()
    with pytest.raises(ValueError, match="page_size"):
        LlamaGenerateModel(cfg=tcfg, max_seq=MAX_SEQ, max_slots=2,
                           page_size=24, device="cpu")
    with pytest.raises(ValueError, match="kv_pages"):
        LlamaGenerateModel(cfg=tcfg, max_seq=MAX_SEQ, max_slots=2,
                           kv_pages=PPSEQ - 1, device="cpu")


@pytest.mark.parametrize("kernel", [True, False], ids=["kernel", "dense"])
def test_bundle_and_buckets_match_jax(kernel):
    jcfg, tcfg = _configs(kernel=kernel)
    jfns = jl.make_scheduler_fns(jcfg, 512, 3, page_size=16)
    tfns = tl.make_scheduler_fns(tcfg, 512, 3, page_size=16, device="cpu")
    assert set(tfns) == set(jfns)
    for key in ("page_size", "pages_per_seq", "n_pages", "span_safe"):
        assert tfns[key] == jfns[key], key
    for n in (1, 3, 5, 8, 77, 100, 128, 200, 256, 300, 500, 512):
        assert tfns["prefill_bucket"](n) == jfns["prefill_bucket"](n), n


# -- scheduler contracts ------------------------------------------------------


def test_chunked_prefill_matches_one_shot(fns, weights):
    """A 20-token prompt prefilled in 8-token chunks, interleaved with
    the decode loop, streams the same tokens and logprobs as the one-shot
    bucketed prefill."""
    prompt = (np.arange(1, 21) * 7 % 500).astype(np.int32)
    one_shot = DecodeScheduler(fns, weights, 2, MAX_SEQ,
                               prefill_chunk_tokens=None, prefix_cache=False)
    chunked = DecodeScheduler(fns, weights, 2, MAX_SEQ,
                              prefill_chunk_tokens=8, prefix_cache=False)
    try:
        ref = list(one_shot.submit(prompt, 8))
        got = list(chunked.submit(prompt, 8))
        assert len(ref) == 8
        assert [t for t, _ in got] == [t for t, _ in ref]
        assert got == ref
    finally:
        one_shot.close()
        chunked.close()


def test_shared_prefix_is_served_from_the_radix_cache(fns, weights):
    """A prompt served again admits with its shared full pages from the
    radix cache (``prefix_hits`` counts the skipped prompt tokens) and
    streams the same tokens."""
    prompt = (np.arange(1, 25) * 3 % 500).astype(np.int32)  # 24 tokens
    sched = DecodeScheduler(fns, weights, 2, MAX_SEQ)
    try:
        cold = _collect(sched, prompt, 6)
        stats = sched.stats()
        assert stats["prefix_hits"] == 0 and stats["pages_cached"] >= 1
        warm = _collect(sched, prompt, 6)
        assert warm == cold and len(cold) == 6
        stats = sched.stats()
        assert stats["prefix_hits"] >= PAGE
        assert stats["prefix_misses"] >= len(prompt) + 1
    finally:
        sched.close()


def test_page_exhaustion_sheds_typed_429(weights):
    """A pool too small for one more admission sheds typed
    (``TooManyRequests``, a 429 with Retry-After over HTTP), while
    the live stream that pins the pages goes on undisturbed."""
    _, tcfg = _configs()
    model = LlamaGenerateModel(cfg=tcfg, max_seq=MAX_SEQ, max_slots=4,
                               kv_pages=PPSEQ, params=weights, device="cpu")
    core = InferenceServer([model])
    server = HttpServer(core, port=0).start()
    try:
        sched = model._ensure_scheduler()
        big = sched.submit(np.array([3, 1, 4, 1, 5], np.int32), 40)
        first = next(big)  # 3 of the 4 pages pinned by a live stream
        with pytest.raises(TooManyRequests, match="page pool") as shed:
            list(sched.submit(np.array([9, 8, 7], np.int32), 20))
        assert shed.value.retry_after == 1
        with pytest.raises(TooManyRequests) as info:
            _generate(core, [9, 8, 7], 20)
        assert info.value.code == 429 and info.value.retry_after == 1
        conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                          timeout=60)
        conn.request("POST", "/v2/models/llama_generate/generate_stream",
                     _body([9, 8, 7], 20))
        resp = conn.getresponse()
        assert resp.status == 429 and resp.getheader("Retry-After") == "1"
        assert "page pool" in json.loads(resp.read())["error"]
        conn.close()
        assert sched.stats()["live_streams"] == 1
        assert len([first] + list(big)) == 40
    finally:
        server.stop()
        core.close()


def test_eos_retires_early_and_the_slot_is_reused(weights):
    """A stream hitting its eos_id emits it and stops, freeing its slot
    for waiting requests; every stream still matches its single-stream
    tokens, cut at the eos where it appears."""
    _, tcfg = _configs()
    single = InferenceServer([LlamaGenerateModel(
        cfg=tcfg, max_seq=MAX_SEQ, decode_chunk=4, params=weights,
        device="cpu")])
    reference = [_generate(single, p, n) for p, n in zip(PROMPTS, MAX_TOKENS)]
    eos = reference[0][3]
    expected = [ref[:ref.index(eos) + 1] if eos in ref else ref
                for ref in reference]
    model = LlamaGenerateModel(cfg=tcfg, max_seq=MAX_SEQ, max_slots=3,
                               params=weights, device="cpu")
    core = InferenceServer([model])
    try:
        got = _concurrently(lambda p, n: _generate(core, p, n,
                                                   {"eos_id": eos}),
                            list(zip(PROMPTS, MAX_TOKENS)))
        assert got == expected and len(got[0]) == 4
        assert model.scheduler_stats()["admitted"] == 5
        assert model.scheduler_stats()["live_streams"] == 0
    finally:
        core.close()


def _counting(fns):
    """A copy of ``fns`` whose step counts its calls and, once armed,
    poisons one row's logits with NaN before a step where it is live."""
    fns = dict(fns)
    state = {"calls": 0, "poison_row": None}
    step = fns["step"]

    def wrapped(params, pages, logits, tables, positions, active, *rest):
        state["calls"] += 1
        row = state["poison_row"]
        if row is not None and active[row]:
            logits[row] = float("nan")
            state["poison_row"] = None
        return step(params, pages, logits, tables, positions, active, *rest)

    fns["step"] = wrapped
    return fns, state


def test_cancelled_stream_frees_its_slot(fns, weights):
    """Abandoning a token iterator retires its slot within a few steps
    instead of decoding the whole budget into a queue nobody reads."""
    counted, state = _counting(fns)
    sched = DecodeScheduler(counted, weights, 2, MAX_SEQ)
    try:
        stream = sched.submit(PROMPTS[0], 50)
        next(stream)
        stream.close()  # the consumer walks away
        assert len(_collect(sched, PROMPTS[1], 5)) == 5
        # a handful for the abandoned stream, ~5 for the second and the
        # pipeline's slack: far under the abandoned 50-token budget
        assert state["calls"] < 30, state["calls"]
        assert sched.stats()["live_streams"] == 0
    finally:
        sched.close()


def test_poisoned_row_is_quarantined_alone(weights):
    """A NaN-poisoned slot fails alone with the typed SlotPoisoned (422);
    co-batched streams stream exactly their unpoisoned tokens, and the
    loop lives on.  The poison goes into the victim's logits row through
    a wrapped step, at a step where the victim is live."""
    fns3 = tl.make_scheduler_fns(_configs()[1], MAX_SEQ, 3, device="cpu")
    clean = DecodeScheduler(fns3, weights, 3, MAX_SEQ)
    try:
        reference = [_collect(clean, p, n)
                     for p, n in zip(PROMPTS[1:3], MAX_TOKENS[1:3])]
    finally:
        clean.close()
    counted, state = _counting(fns3)
    sched = DecodeScheduler(counted, weights, 3, MAX_SEQ)
    try:
        victim = sched.submit(PROMPTS[0], 50)  # slot 0, long-lived
        next(victim)
        state["poison_row"] = 0
        survivors = _concurrently(lambda p, n: _collect(sched, p, n),
                                  list(zip(PROMPTS[1:3], MAX_TOKENS[1:3])))
        assert survivors == reference
        with pytest.raises(SlotPoisoned) as info:
            list(victim)
        assert info.value.code == 422 and state["poison_row"] is None
        stats = sched.stats()
        assert stats["quarantined"] == 1 and stats["healthy"]
        assert stats["live_streams"] == 0
        assert _collect(sched, PROMPTS[1], MAX_TOKENS[1]) == reference[0]
    finally:
        sched.close()


def test_deadlines_fail_typed_504(fns, weights):
    sched = DecodeScheduler(fns, weights, 2, MAX_SEQ)
    try:
        with pytest.raises(RequestTimedOut) as info:
            list(sched.submit(PROMPTS[0], 5, deadline=time.monotonic() - 1))
        assert info.value.code == 504
        assert sched.stats()["live_streams"] == 0
    finally:
        sched.close()
    _, tcfg = _configs()
    core = InferenceServer([LlamaGenerateModel(
        cfg=tcfg, max_seq=MAX_SEQ, max_slots=2, params=weights,
        device="cpu")])
    try:
        with pytest.raises(RequestTimedOut):
            _generate(core, PROMPTS[0], 5, {"timeout": 1})
        assert len(_generate(core, PROMPTS[0], 5,
                             {"timeout": 60_000_000})) == 5
    finally:
        core.close()


def test_close_is_503_and_a_failed_loop_is_unhealthy(weights):
    """A closed scheduler refuses with a 503; so does a closed core.  A
    step that always raises spends the supervisor's restart budget: the
    live stream fails with a 503, the scheduler trips and the model
    reports unhealthy until it is closed."""
    _, tcfg = _configs()
    # a short restart budget
    model = LlamaGenerateModel(cfg=tcfg, max_seq=MAX_SEQ, max_slots=2,
                               params=weights, device="cpu", max_restarts=2,
                               restart_backoff_s=0.01)
    core = InferenceServer([model])
    assert len(_generate(core, PROMPTS[1], 3)) == 3
    model._scheduler.close()
    with pytest.raises(ServerUnavailable, match="shut down") as info:
        _generate(core, PROMPTS[1], 3)
    assert info.value.code == 503
    assert not model.healthy() and not core.model_ready("llama_generate")
    model.close()  # a later request builds a fresh scheduler
    assert len(_generate(core, PROMPTS[1], 3)) == 3
    assert core.server_ready()

    def broken(*args):
        raise RuntimeError("device fault")

    model.close()
    sched = model._ensure_scheduler()  # its loop starts at the next submit
    sched._fns = dict(sched._fns, step=broken)
    with pytest.raises(ServerUnavailable,
                       match="restart budget exhausted") as info:
        _generate(core, PROMPTS[1], 3)
    assert info.value.code == 503
    assert sched.stats()["restarts"] == 2 and sched.stats()["tripped"]
    assert not model.healthy() and not core.server_ready()
    with pytest.raises(ServerUnavailable, match="tripped"):
        _generate(core, PROMPTS[1], 3)
    core.close()
    with pytest.raises(ServerUnavailable):
        _generate(core, PROMPTS[1], 3)


def _body(prompt, max_tokens):
    return json.dumps({"inputs": [
        {"name": "PROMPT_IDS", "datatype": "INT32", "shape": [len(prompt)],
         "data": [int(t) for t in prompt]},
        {"name": "MAX_TOKENS", "datatype": "INT32", "shape": [1],
         "data": [max_tokens]}]})


def test_http_generate_stream_carries_ids_and_matches(weights):
    """/generate_stream over 2 slots: three concurrent streams, each
    event with an ``id: <generation_id>/<seq>`` line (0-based, gap-free)
    and the same in its ``parameters``, tokens equal to the
    single-stream path's."""
    _, tcfg = _configs()
    single = InferenceServer([LlamaGenerateModel(
        cfg=tcfg, max_seq=MAX_SEQ, decode_chunk=4, params=weights,
        device="cpu")])
    reference = [_generate(single, p, n)
                 for p, n in zip(PROMPTS[:3], MAX_TOKENS[:3])]
    core = InferenceServer([LlamaGenerateModel(
        cfg=tcfg, max_seq=MAX_SEQ, max_slots=2, params=weights,
        device="cpu")])
    server = HttpServer(core, port=0).start()

    def stream(prompt, n):
        conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                          timeout=120)
        try:
            conn.request("POST", "/v2/models/llama_generate/generate_stream",
                         _body(prompt, n))
            resp = conn.getresponse()
            assert resp.status == 200
            return resp.read().decode("utf-8")
        finally:
            conn.close()

    try:
        texts = _concurrently(stream, list(zip(PROMPTS[:3], MAX_TOKENS[:3])))
    finally:
        server.stop()
        core.close()
    gen_ids = set()
    for text, ref in zip(texts, reference):
        ids, tokens = [], []
        for line in text.split("\n"):
            if line.startswith("id: "):
                ids.append(line[len("id: "):])
            elif line.startswith("data: "):
                event = json.loads(line[len("data: "):])
                if event.get("final"):
                    continue
                tokens.append(event["outputs"][0]["data"][0])
                params = event["parameters"]
                assert ids[-1] == "{}/{}".format(params["generation_id"],
                                                 params["seq"])
        assert tokens == ref
        assert [int(i.rsplit("/", 1)[1]) for i in ids] == list(
            range(len(ref)))
        assert len({i.rsplit("/", 1)[0] for i in ids}) == 1
        gen_ids.add(ids[0].rsplit("/", 1)[0])
        assert text.rstrip().endswith('data: {"final": true}')
    assert len(gen_ids) == 3
