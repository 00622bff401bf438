"""``LlamaGenerateModel``'s ``prefix_cache`` and ``prefill_chunk_tokens``
against the JAX package's on the CPU.

Both packages serve float32 ``tiny`` on the same weights (JAX's
``init_params(PRNGKey(0))``, bridged), ``max_slots=2``, the same prompts
one after another.  The tokens must be equal, and so must the radix
counters of ``scheduler_stats()`` and the prefill chunks run: the port's
``prefill_chunks`` counter against the JAX scheduler's ``prefill_span``
calls (with the prefix cache off, each is one chunk)."""

import dataclasses

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
from torch_port_helpers import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.torch_port

VOCAB = 512
MAX_SEQ = 128
RNG = np.random.RandomState(5)
# 70 and 45 tokens chunk at 32; the third shares the first's first 48
# tokens (three pages of 16) with another tail; the last is short
PROMPTS = [RNG.randint(1, VOCAB, size=(n,)).astype(np.int32)
           for n in (70, 45)]
PROMPTS.append(np.concatenate([PROMPTS[0][:48], RNG.randint(
    1, VOCAB, size=(14,)).astype(np.int32)]))
PROMPTS.append(RNG.randint(1, VOCAB, size=(9,)).astype(np.int32))
MAX_TOKENS = 8
RADIX_KEYS = ("prefix_hits", "prefix_misses", "prefix_evictions")


def _cfgs():
    return (dataclasses.replace(jl.tiny(vocab=VOCAB), dtype=jnp.float32),
            dataclasses.replace(tl.tiny(vocab=VOCAB), dtype=torch.float32))


@pytest.fixture(scope="module")
def tparams():
    return tl.params_from_jax(jax.tree_util.tree_map(
        np.asarray, jl.init_params(jax.random.PRNGKey(0), _cfgs()[0])), "cpu")


def _generate(core, request_cls):
    out = []
    for i, prompt in enumerate(PROMPTS):
        out.append([int(r.outputs[0][1][0]) for r in core.infer_stream(
            request_cls("llama_generate", inputs={
                "PROMPT_IDS": prompt,
                "MAX_TOKENS": np.array([MAX_TOKENS], np.int32)},
                parameters={"generation_id": "g{}".format(i)}))])
    return out


@pytest.mark.parametrize("kwargs", [
    {"prefix_cache": False, "prefill_chunk_tokens": 32},
    {},  # both defaults: the radix tree on, chunks of 256
], ids=["chunks_no_radix", "defaults"])
def test_tokens_and_counters_equal_jax(kwargs, tparams, monkeypatch):
    jcfg, tcfg = _cfgs()
    spans = []
    real_fns = jl.make_scheduler_fns

    def counted_fns(*args, **kw):
        fns = real_fns(*args, **kw)
        span = fns["prefill_span"]

        def prefill_span(*a, **k):
            spans.append(1)
            return span(*a, **k)

        fns["prefill_span"] = prefill_span
        return fns

    monkeypatch.setattr(jl, "make_scheduler_fns", counted_fns)
    jmodel = JaxLlama(cfg=jcfg, max_seq=MAX_SEQ, max_slots=2, **kwargs)
    jcore = JaxServer([jmodel])
    tmodel = LlamaGenerateModel(cfg=tcfg, max_seq=MAX_SEQ, max_slots=2,
                                params=tparams, device="cpu", **kwargs)
    tcore = InferenceServer([tmodel])
    try:
        want = _generate(jcore, JaxRequest)
        got = _generate(tcore, InferRequest)
        jstats, tstats = jmodel.scheduler_stats(), tmodel.scheduler_stats()
    finally:
        jcore.close()
        tcore.close()
    assert got == want
    assert all(len(t) == MAX_TOKENS for t in got)
    assert {k: tstats[k] for k in RADIX_KEYS} == {
        k: jstats[k] for k in RADIX_KEYS}
    if kwargs:
        # 70 tokens pad to 3 chunks of 32, 45 and 62 to 2 each
        assert tstats["prefill_chunks"] == len(spans) == 7
        assert tstats["prefix_hits"] == 0
    else:
        # no prompt reaches 256 tokens; the third reuses three pages
        assert tstats["prefill_chunks"] == 0
        assert tstats["prefix_hits"] == 48


def test_single_slot_takes_and_ignores_both(tparams):
    """``max_slots=1`` builds no scheduler: the keywords are accepted and
    the single-stream path serves as without them."""
    tcfg = _cfgs()[1]
    plain = LlamaGenerateModel(cfg=tcfg, max_seq=MAX_SEQ, params=tparams,
                               device="cpu")
    keyed = LlamaGenerateModel(cfg=tcfg, max_seq=MAX_SEQ, params=tparams,
                               device="cpu", prefix_cache=False,
                               prefill_chunk_tokens=32)
    streams = []
    for model in (plain, keyed):
        core = InferenceServer([model])
        try:
            streams.append(_generate(core, InferRequest))
            assert model.scheduler_stats() is None
        finally:
            core.close()
    assert streams[0] == streams[1]
