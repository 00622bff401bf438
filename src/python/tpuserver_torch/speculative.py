"""Speculative decoding: n-gram drafts from the radix prefix cache (a
copy of ``tpuserver/speculative.py``).

Every decode iteration advances each slot by one token, and the card
streams the model's weights once per token per step.  Speculative
decoding *drafts* k candidate continuation tokens cheaply, feeds them
through one batched verify step (``llama.paged_spec_step``) and keeps
the longest prefix whose greedy argmax agrees.  Acceptance is exact:
the output token sequence is bitwise identical to single-token
decoding; only the number of steps per emitted token changes.  (The
verify step is a chain of k+1 single-token sub-steps, so on the card it
still streams the weights k+1 times; what it saves is host round
trips.)

The draft source costs no second model (prompt-lookup / n-gram
speculation): the scheduler's :class:`~tpuserver_torch.paging.
RadixPrefixCache` holds every prompt and emitted history this server
decoded.  :class:`NgramDrafter` proposes, in priority order:

1. the tree's EXACT continuation of the stream's full context
   (:meth:`~tpuserver_torch.paging.RadixPrefixCache.continuation`): the
   root-anchored walk is unambiguous where fixed-length n-grams collide
   (a run of one repeated token aliases every n-gram key to one entry);
2. an n-gram index derived from the radix tree's cached token sequences
   (rebuilt only when the tree's ``version`` moves: lookups are dict
   probes, never tree walks), then
3. the stream's own ``prompt + history`` (classic prompt-lookup).

Where the scheduler builds no radix tree (``span_safe`` is False, as
with the flash kernel's prefill), only the third source serves.

Lookups are read-only: the drafter never pins ref-counts, never stamps
LRU clocks and never mutates the tree, so a draft cannot change what
eviction may reclaim, and a wrong draft cannot change output (greedy
verify rejects it); it only wastes a sub-step.  Per-stream throttling in
the scheduler stops paying even that on streams whose acceptance is ~0.

Single-threaded by contract: the decode loop that owns the radix tree is
the only caller, so the drafter needs no locks (as ``paging``).
"""

__all__ = ["NgramDrafter"]

#: Longest suffix length the drafter matches on.  Longer suffixes are
#: tried first: a 4-gram match is far more predictive than a 1-gram.
DEFAULT_MAX_NGRAM = 4

#: Shortest suffix length worth matching.  2 keeps the 1-gram noise
#: floor out of the draft stream (a unigram match predicts little and
#: costs a verify sub-step per token drafted off it).
DEFAULT_MIN_NGRAM = 2

#: How far back the self-context scan looks for a prior occurrence of
#: the current suffix.  Bounds the per-step host cost on long
#: sequences; repetition beyond this window is rare enough to skip.
SELF_CONTEXT_WINDOW = 512


class NgramDrafter:
    """Read-only longest-suffix n-gram lookup over a radix prefix
    cache (plus the querying stream's own context).

    ``draft(tokens, k)`` proposes up to ``k`` continuation tokens for
    the sequence ending in ``tokens``: the tree's exact continuation
    of the full context when it is cached that deep, else the longest
    suffix of length ``max_ngram``..``min_ngram`` that has been seen
    before (in the tree, or earlier in ``tokens`` itself) contributes
    the tokens that followed it.  Returns ``[]`` when nothing matches
    — the scheduler then runs a plain single-token step for that
    slot.

    The tree-derived index is rebuilt lazily, keyed on the tree's
    ``version`` counter: a draft between tree mutations is a pure
    dict probe.
    """

    def __init__(self, radix=None, min_ngram=DEFAULT_MIN_NGRAM,
                 max_ngram=DEFAULT_MAX_NGRAM, max_draft=8):
        if min_ngram < 1 or max_ngram < min_ngram:
            raise ValueError(
                "need 1 <= min_ngram <= max_ngram (got {}..{})".format(
                    min_ngram, max_ngram))
        if max_draft < 1:
            raise ValueError(
                "max_draft must be >= 1 (got {})".format(max_draft))
        self._radix = radix
        self.min_ngram = int(min_ngram)
        self.max_ngram = int(max_ngram)
        self.max_draft = int(max_draft)
        self._index = {}
        self._version = None  # radix.version the index was built at
        # lifetime rebuild count (tests pin the lazy-rebuild contract)
        self.rebuilds = 0

    # -- tree index --------------------------------------------------------

    def _refresh(self):
        radix = self._radix
        if radix is None:
            return
        if self._version == radix.version:
            return
        index = {}
        lo, hi, cap = self.min_ngram, self.max_ngram, self.max_draft
        # deterministic iteration (dict order is insertion order and
        # the walk is structural), so two replicas with identical tree
        # histories build identical indices — the cross-replica twin
        # of the greedy-determinism contract
        for seq in radix.iter_sequences():
            length = len(seq)
            for end in range(lo, length):
                cont = seq[end:end + cap]
                if not cont:
                    continue
                for n in range(lo, hi + 1):
                    if n > end:
                        break
                    # last writer wins: later (more recently donated)
                    # sequences overwrite earlier continuations
                    index[tuple(seq[end - n:end])] = cont
        self._index = index
        self._version = radix.version
        self.rebuilds += 1

    @staticmethod
    def _self_lookup(tokens, n, cap):
        """PRIOR occurrence of the length-``n`` suffix inside
        ``tokens`` itself; returns the tokens that followed it (up to
        ``cap``), or None.  Prefers the most recent occurrence whose
        continuation is at least 2 tokens — occurrences near the end
        of the sequence truncate to a single token, and the caller
        drops the first proposal (its own next-token prediction), so
        a 1-token continuation drafts nothing."""
        suffix = tokens[-n:]
        hi = len(tokens) - n  # exclusive: skip the suffix's own match
        lo = max(0, len(tokens) - SELF_CONTEXT_WINDOW)
        short = None
        for i in range(hi - 1, lo - 1, -1):
            if tokens[i:i + n] == suffix:
                cont = tokens[i + n:i + n + cap]
                if len(cont) >= 2:
                    return cont
                if cont and short is None:
                    short = cont
        return short

    # -- the draft ---------------------------------------------------------

    def draft(self, tokens, k):
        """Up to ``k`` proposed continuation tokens for the sequence
        ending in ``tokens`` (any int iterable).  The tree's exact
        continuation of the full context outranks everything; below
        that the longest matching suffix wins, and the radix-tree
        index outranks self-context at equal length (fleet-served
        content covers more than one stream's history).  Pure lookup:
        no pinning, no mutation."""
        k = min(int(k), self.max_draft)
        if k <= 0:
            return []
        toks = [int(t) for t in tokens]
        if len(toks) < self.min_ngram:
            return []
        # exact-context continuation first: unambiguous where n-gram
        # keys collide (degenerate repetition), and exactly right for
        # regenerate/extend traffic whose context is a cached prefix
        if self._radix is not None:
            cont = self._radix.continuation(toks, k)
            if cont:
                return [int(t) for t in cont]
        self._refresh()
        best = None
        for n in range(min(self.max_ngram, len(toks)),
                       self.min_ngram - 1, -1):
            for cont in (self._index.get(tuple(toks[-n:])),
                         self._self_lookup(toks, n, self.max_draft)):
                if not cont:
                    continue
                if len(cont) >= 2:
                    return list(cont[:k])
                if best is None:
                    best = cont
        # nothing offered more than a single continuation token:
        # better than nothing (the verify step's bonus still rides)
        return list(best[:k]) if best else []
