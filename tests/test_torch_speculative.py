"""The port's speculative decoding (tpuserver_torch.speculative,
``llama.paged_spec_step`` and ``DecodeScheduler(spec_tokens=K)``) on the
CPU, held against the JAX package on the same inputs: the same drafts
from the same trees and contexts, the same verify step on the same
weights (``init_params(PRNGKey(0))`` bridged by ``params_from_jax``,
float32 ``tiny``), and the same served tokens.

Tolerances: 1e-4 on float32 logits (both sides compute in float32, in
another order).  Tokens and accept counts must be equal.  Inside the
port the verify step must equal K+1 plain steps bit for bit, cache
included, and ``spec_tokens=4`` must stream the tokens of
``spec_tokens=0``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuserver import paging as jax_paging
from tpuserver.models import llama as jl
from tpuserver.scheduler import DecodeScheduler as JaxScheduler
from tpuserver.speculative import NgramDrafter as JaxDrafter
from tpuserver_torch import paging as port_paging
from tpuserver_torch.models import llama as tl
from tpuserver_torch.scheduler import DecodeScheduler
from tpuserver_torch.speculative import NgramDrafter

pytestmark = pytest.mark.torch_port

CPU = torch.device("cpu")
VOCAB = 512
MAX_SEQ = 64
PAGE = 16
PPSEQ = MAX_SEQ // PAGE
TOL = 1e-4
#: a prompt whose continuation the tiny model keeps repeating, so the
#: self-context drafts are accepted
REPETITIVE = [7, 9] * 6
PLAIN = [3, 5, 11]


def _configs(decode_impl="auto"):
    jcfg = dataclasses.replace(jl.tiny(vocab=VOCAB), dtype=jnp.float32)
    tcfg = dataclasses.replace(tl.tiny(vocab=VOCAB), dtype=torch.float32,
                               decode_impl=decode_impl)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def bridged():
    jcfg, _ = _configs()
    params = jl.init_params(jax.random.PRNGKey(0), jcfg)
    return params, tl.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), CPU)


# -- the drafter ---------------------------------------------------------------


def _tree_pair(seed, n_seqs=6):
    """The same seeded sequences inserted into a JAX and a port radix
    tree (page 4), with a small alphabet so n-grams repeat."""
    rng = np.random.RandomState(seed)
    trees = (jax_paging.RadixPrefixCache(4), port_paging.RadixPrefixCache(4))
    next_page = 0
    for _ in range(n_seqs):
        seq = rng.randint(0, 6, 4 * rng.randint(2, 6)).tolist()
        ids = list(range(next_page, next_page + len(seq) // 4))
        next_page += len(ids)
        for radix in trees:
            radix.insert_tail([], seq, 0, ids, pin=False)
    return trees


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_drafter_matches_jax_on_seeded_trees_and_contexts(seed):
    """Exact continuation, tree index and self-context lookups: equal
    drafts for seeded contexts over seeded trees, the lazy index rebuild
    keyed on ``version`` in step, and the tree untouched."""
    jtree, ttree = _tree_pair(seed)
    rng = np.random.RandomState(100 + seed)
    for min_n, max_n, max_draft in ((2, 4, 5), (1, 3, 8)):
        jd = JaxDrafter(jtree, min_ngram=min_n, max_ngram=max_n,
                        max_draft=max_draft)
        td = NgramDrafter(ttree, min_ngram=min_n, max_ngram=max_n,
                          max_draft=max_draft)
        for _ in range(40):
            ctx = rng.randint(0, 6, rng.randint(1, 30)).tolist()
            k = int(rng.randint(0, 7))
            assert td.draft(ctx, k) == jd.draft(ctx, k), (ctx, k)
        assert td.rebuilds == jd.rebuilds
    # a tree mutation moves the version: both rebuild once more
    for radix in (jtree, ttree):
        radix.insert_tail([], [9, 9, 8, 8, 7, 7, 6, 6], 0, [90, 91],
                          pin=False)
    ctx = [1, 9, 9, 8, 8, 7]
    assert td.draft(ctx, 3) == jd.draft(ctx, 3)
    assert td.rebuilds == jd.rebuilds
    assert ttree.version == jtree.version
    assert ttree.unreferenced == jtree.unreferenced


def test_drafter_self_context_and_knobs_match_jax():
    """Without a tree (the flash-prefill configuration builds none) only
    the stream's own context drafts; the knob checks are JAX's."""
    rng = np.random.RandomState(7)
    jd, td = JaxDrafter(max_draft=6), NgramDrafter(max_draft=6)
    for _ in range(60):
        ctx = rng.randint(0, 4, rng.randint(0, 40)).tolist()
        assert td.draft(ctx, 5) == jd.draft(ctx, 5)
    assert td.draft([1, 2, 3, 4, 9, 1, 2, 3, 4], 4) == [9, 1, 2, 3]
    for kwargs in ({"min_ngram": 0}, {"min_ngram": 4, "max_ngram": 2},
                   {"max_draft": 0}):
        with pytest.raises(ValueError):
            NgramDrafter(**kwargs)


# -- the verify step -----------------------------------------------------------

PROMPT = np.array([3, 1, 4, 1, 5, 9, 2, 6], np.int32)
K = 3
SLOTS = 3


def _port_pool(tparams, tcfg):
    """PROMPT prefilled and admitted into rows 0-2 of a paged pool, each
    row with its own pages."""
    slot_cache = tl.init_kv_cache(tcfg, 1, MAX_SEQ, CPU)
    row_logits, slot_cache = tl.prefill_to_length(
        tparams, slot_cache, torch.from_numpy(PROMPT).long()[None, :],
        len(PROMPT), tcfg)
    pages = tl.init_paged_kv_cache(tcfg, SLOTS * PPSEQ, PAGE, CPU)
    logits = torch.zeros(SLOTS, VOCAB)
    tables = np.arange(SLOTS * PPSEQ, dtype=np.int32).reshape(SLOTS, PPSEQ)
    for row in range(SLOTS):
        pages, logits = tl.paged_admit(pages, logits, slot_cache,
                                       row_logits, tables[row], row)
    return pages, logits, torch.from_numpy(tables)


def _jax_pool(params, jcfg):
    slot_cache = jl.init_kv_cache(jcfg, 1, MAX_SEQ)
    row_logits, slot_cache = jl.prefill_to_length(
        params, slot_cache, jnp.asarray(PROMPT)[None, :], len(PROMPT), jcfg)
    pages = jl.init_paged_kv_cache(jcfg, SLOTS * PPSEQ, PAGE)
    logits = jnp.zeros((SLOTS, VOCAB), jnp.float32)
    tables = np.arange(SLOTS * PPSEQ, dtype=np.int32).reshape(SLOTS, PPSEQ)
    for row in range(SLOTS):
        pages, logits = jl.paged_admit(pages, logits, slot_cache, row_logits,
                                       tables[row], row)
    return pages, logits


def _plain_chain(tparams, tcfg):
    """K+1 plain paged steps from the admitted pool: per step the
    tokens, logprobs and next logits, and the final pool."""
    pages, logits, tables = _port_pool(tparams, tcfg)
    positions = torch.full((SLOTS,), len(PROMPT))
    active = torch.ones(SLOTS, dtype=torch.bool)
    no_force = torch.zeros(SLOTS, dtype=torch.long)
    steps = []
    for j in range(K + 1):
        tok, lp, logits, pages = tl.paged_scheduler_step(
            tparams, pages, logits, tables, positions + j, active, no_force,
            no_force.bool(), tcfg)
        steps.append((tok, lp, logits.clone()))
    return steps, pages, tables


def _drafts(steps):
    """Row 0: the plain chain's own continuation (accepts K); row 1: the
    same, wrong at index 1 (accepts 1); row 2: no draft (accepts 0)."""
    ref = torch.stack([tok for tok, _, _ in steps])  # [K+1, S]
    draft = ref[1:].T.clone().int()
    draft[1, 1] = (draft[1, 1] + 1) % VOCAB
    return draft, torch.tensor([K, K, 0], dtype=torch.int32)


@pytest.mark.parametrize("decode_impl", ["auto", "dense"])
def test_spec_step_is_bitwise_the_plain_chain(bridged, decode_impl):
    """Inside the port: one ``paged_spec_step`` equals K+1 plain steps
    bit for bit at each row's acceptance depth (full, partial and zero
    acceptance in one batch): tokens, logprobs, the logits selected at
    that depth, and the fully accepted row's gathered cache."""
    _, tparams = bridged
    _, tcfg = _configs(decode_impl)
    steps, ref_pages, tables = _plain_chain(tparams, tcfg)
    draft, draft_len = _drafts(steps)
    pages, logits, _ = _port_pool(tparams, tcfg)
    no_force = torch.zeros(SLOTS, dtype=torch.long)
    toks, lps, accept, final, pages = tl.paged_spec_step(
        tparams, pages, logits, tables, torch.full((SLOTS,), len(PROMPT)),
        torch.ones(SLOTS, dtype=torch.bool), no_force, no_force.bool(),
        draft, draft_len, tcfg)
    assert accept.tolist() == [K, 1, 0] and accept.dtype == torch.int32
    assert toks.shape == lps.shape == (SLOTS, K + 1)
    for row, depth in enumerate(accept.tolist()):
        for j in range(depth + 1):
            assert toks[row, j] == steps[j][0][row]
            assert torch.equal(lps[row, j], steps[j][1][row])
        assert torch.equal(final[row], steps[depth][2][row])
    assert torch.equal(tl.paged_gather(pages, tables[0]),
                       tl.paged_gather(ref_pages, tables[0]))


def test_spec_step_matches_jax(bridged):
    """Against JAX's ``paged_spec_step`` on the same weights, pool and
    drafts: equal tokens and accept counts, logprobs and final logits
    within 1e-4."""
    params, tparams = bridged
    jcfg, tcfg = _configs()
    steps, _, tables = _plain_chain(tparams, tcfg)
    draft, draft_len = _drafts(steps)
    pages, logits, _ = _port_pool(tparams, tcfg)
    no_force = torch.zeros(SLOTS, dtype=torch.long)
    positions = np.full((SLOTS,), len(PROMPT), np.int32)
    toks, lps, accept, final, _ = tl.paged_spec_step(
        tparams, pages, logits, tables, torch.from_numpy(positions),
        torch.ones(SLOTS, dtype=torch.bool), no_force, no_force.bool(),
        draft, draft_len, tcfg)
    j_pages, j_logits = _jax_pool(params, jcfg)
    j_toks, j_lps, j_accept, j_final, _ = jl.paged_spec_step(
        params, j_pages, j_logits, tables.numpy(), positions,
        np.ones((SLOTS,), bool), np.zeros((SLOTS,), np.int32),
        np.zeros((SLOTS,), bool), draft.numpy(), draft_len.numpy(), jcfg)
    assert accept.tolist() == np.asarray(j_accept).tolist() == [K, 1, 0]
    assert toks.numpy().tolist() == np.asarray(j_toks).tolist()
    np.testing.assert_allclose(lps.numpy(), np.asarray(j_lps), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(final.numpy(), np.asarray(j_final), rtol=TOL,
                               atol=TOL)


# -- the scheduler -------------------------------------------------------------


def _collect(sched, prompt, n):
    return [t for t, _ in sched.submit(np.asarray(prompt, np.int32), n)]


def test_scheduler_spec_tokens_match_plain_and_jax(bridged):
    """``spec_tokens=4`` streams the tokens of ``spec_tokens=0`` and of
    JAX's ``spec_tokens=4`` scheduler on a repetitive and a plain prompt,
    and verifies more than one token a step on the repetitive one."""
    params, tparams = bridged
    jcfg, tcfg = _configs()
    fns = tl.make_scheduler_fns(tcfg, MAX_SEQ, 2, device="cpu")
    plain = DecodeScheduler(fns, tparams, 2, MAX_SEQ, spec_tokens=0)
    spec = DecodeScheduler(fns, tparams, 2, MAX_SEQ, spec_tokens=4)
    jax_spec = JaxScheduler(jl.make_scheduler_fns(jcfg, MAX_SEQ, 2), params,
                            2, MAX_SEQ, spec_tokens=4)
    try:
        for prompt, n in ((REPETITIVE, 20), (PLAIN, 10)):
            ref = _collect(plain, prompt, n)
            assert _collect(spec, prompt, n) == ref and len(ref) == n
            assert _collect(jax_spec, prompt, n) == ref
        # a zero budget emits nothing (JAX's speculative path emits one)
        assert _collect(spec, PLAIN, 0) == _collect(plain, PLAIN, 0) == []
        stats = spec.stats()
        assert stats["spec_tokens"] == 4 and stats["spec_proposed"] > 0
        assert 0 < stats["spec_accepted"] <= stats["spec_proposed"]
        assert stats["spec_accept_per_step"] > 1.0
        assert plain.stats()["spec_steps"] == 0
        assert stats["live_streams"] == 0
        assert stats["pages_free"] + stats["pages_cached"] == \
            stats["pages_total"]
    finally:
        plain.close()
        spec.close()
        jax_spec.close()


def _wrong_drafter(full):
    class WrongDrafter:
        """Drafts the exact future continuation, each token off by one:
        every candidate fails the greedy verify."""

        def __init__(self, *args, **kwargs):
            pass

        def draft(self, ctx, k):
            hist = len(ctx) - len(PLAIN)
            future = full[len(PLAIN) + hist:len(PLAIN) + hist + k]
            return [(t + 1) % VOCAB for t in future]

    return WrongDrafter


@pytest.mark.parametrize("throttle_after,probe,n", [(10 ** 9, 8, 12),
                                                    (2, 1000, 20)],
                         ids=["rollback", "throttle"])
def test_wrong_drafts_roll_back_and_throttle(bridged, monkeypatch,
                                             throttle_after, probe, n):
    """A drafter that is always wrong: every speculative step rolls back
    and the stream is unchanged; every page ends up free or cached (the
    rejected writes beyond the cursor leak nothing).  With the throttle
    at 2 missed tokens, one step's drafts are all that is wasted."""
    _, tparams = bridged
    _, tcfg = _configs()
    fns = tl.make_scheduler_fns(tcfg, MAX_SEQ, 2, device="cpu")
    plain = DecodeScheduler(fns, tparams, 2, MAX_SEQ)
    try:
        ref = _collect(plain, PLAIN, n)
    finally:
        plain.close()
    monkeypatch.setattr("tpuserver_torch.scheduler.NgramDrafter",
                        _wrong_drafter([int(t) for t in PLAIN] + ref))
    sched = DecodeScheduler(fns, tparams, 2, MAX_SEQ, spec_tokens=2,
                            spec_throttle_after=throttle_after,
                            spec_probe_interval=probe)
    try:
        assert _collect(sched, PLAIN, n) == ref
        stats = sched.stats()
        assert stats["spec_accepted"] == 0
        assert stats["spec_rollbacks"] == stats["spec_steps"] >= 1
        if throttle_after == 2:
            assert stats["spec_proposed"] == 2 and stats["spec_steps"] == 1
        assert stats["live_streams"] == 0
        assert stats["pages_free"] + stats["pages_cached"] == \
            stats["pages_total"]
    finally:
        sched.close()


def test_the_verify_chain_runs_to_the_longest_draft(bridged, monkeypatch):
    """With ``spec_tokens=4`` but every draft one token long (the exact
    continuation), each verify is a chain of two sub-steps, not five:
    ``spec_step`` gets drafts as wide as the step's longest, every draft
    lands, and the stream is the plain one."""
    _, tparams = bridged
    _, tcfg = _configs()
    fns = tl.make_scheduler_fns(tcfg, MAX_SEQ, 2, device="cpu")
    plain = DecodeScheduler(fns, tparams, 2, MAX_SEQ)
    try:
        ref = _collect(plain, PLAIN, 12)
    finally:
        plain.close()
    full = [int(t) for t in PLAIN] + ref

    class OneTokenDrafter:
        def __init__(self, *args, **kwargs):
            pass

        def draft(self, ctx, k):
            # the scheduler drops the first proposal (the base token)
            return full[len(ctx):len(ctx) + min(k, 2)]

    monkeypatch.setattr("tpuserver_torch.scheduler.NgramDrafter",
                        OneTokenDrafter)
    widths = []
    real = fns["spec_step"]

    def spec_step(*args):
        widths.append(np.asarray(args[-2]).shape[1])
        return real(*args)

    sched = DecodeScheduler(dict(fns, spec_step=spec_step), tparams, 2,
                            MAX_SEQ, spec_tokens=4)
    try:
        assert _collect(sched, PLAIN, 12) == ref
        stats = sched.stats()
        assert widths and set(widths) == {1}
        assert stats["spec_steps"] == len(widths)
        assert stats["spec_accepted"] == stats["spec_proposed"] == len(widths)
    finally:
        sched.close()
