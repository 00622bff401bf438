"""Continuous-batching decode scheduler: the port of
``tpuserver/scheduler.py``'s ``DecodeScheduler``.

A single-stream decode step streams the whole weight set from memory to
produce ONE token.  This module runs one background decode loop per
model that owns a block-paged KV pool (``[n_layers, 2, kv_pages + 1,
page_size, n_kv_heads, head_dim]``, see ``llama.init_paged_kv_cache``)
and runs **one batched decode step for all active slots per
iteration**, so the weight stream is paid once per step for every
in-flight generation.  Each generation's KV lives in fixed-size pages
named by a per-slot page table (``tpuserver_torch.paging``): admission
is bounded by free pages, shared prompt prefixes deduplicate into
ref-counted radix-cache pages, and long prefills chunk into bounded
steps interleaved with decode.

Lifecycle of a request:

1. **admit**: between decode steps, a waiting request takes a free
   slot row and reserves its whole page span, matches its prompt against
   the radix prefix cache (shared full pages restore via
   ``llama.paged_gather``; only the unique suffix prefills, in one
   bucketed pass or chunk by chunk interleaved with decode when it
   exceeds ``prefill_chunk_tokens``), and copies the prefilled single-row
   cache into its pages (``llama.paged_admit``).
2. **step**: every iteration runs ``llama.paged_scheduler_step``: a
   greedy token per slot from the slot's logits row, then one batched
   decode over every slot (always ``max_slots`` rows, so a row's numbers
   never depend on how many neighbours it has), each row writing its K/V
   at its own position.  Steps are pipelined one deep: step *i+1* is
   dispatched before step *i*'s tokens are fetched, and the fetch waits
   for step *i*'s own copy to the host, so it overlaps step *i+1*.
3. **retire**: a slot finishes on its max_tokens budget or its
   ``eos_id``; the slot and its pages free at once (full pages donate to
   the radix cache), so a waiting request joins **mid-flight** while the
   other slots keep decoding.

Because of the pipeline, retirement lags its trigger token by one step:
the slot rides one extra dispatch whose token is discarded.  The extra
write lands past the slot's valid prefix, rows with no live request
carry the sentinel position (their writes go to the pool's trash page),
and emission matches snapshot state by object identity and incarnation,
so a re-admitted slot never receives a predecessor's token.

A slot whose own step output is poisoned (a non-finite logprob) retires
with a typed :class:`~tpuserver_torch.errors.SlotPoisoned` (422) while
every co-batched slot keeps decoding: the batched step's math is
row-independent.

Left out of this port (``ROADMAP.md`` queue A): the supervisor, the
hung-step watchdog and its epochs; replay and resume of generations;
KV park, export and attach; the CoDel admission controller; speculative
decoding; latency histograms and fault-injection points.  Without a
supervisor, an exception that no single stream caused (a failed batched
step or fetch) ends the decode loop: every live and pending stream fails
with a typed 500, :attr:`DecodeScheduler.healthy` turns False, and later
submits raise :class:`~tpuserver_torch.errors.ServerUnavailable`.  That
is the JAX scheduler's behaviour before it had a supervisor.

Where the JAX scheduler raises its own ``SchedulerClosed`` and
``AdmissionQueueFull``, this one raises the typed errors the core passes
through: ``ServerUnavailable`` (503) once closed, draining or failed, and
``TooManyRequests`` (429, one-second ``Retry-After``) when the pending
queue is full or the KV page pool is exhausted.
"""

import contextlib
import logging
import queue
import threading
import time
from collections import deque

import numpy as np
import torch

from tpuserver_torch.errors import (
    RequestTimedOut,
    ServerUnavailable,
    SlotPoisoned,
    TooManyRequests,
    TorchServeError,
)
from tpuserver_torch.paging import PageAllocator, RadixPrefixCache, pages_for

_log = logging.getLogger(__name__)


class _Stream:
    """One in-flight generation bound to a cache slot."""

    __slots__ = (
        "prompt", "max_tokens", "eos_id", "queue", "pos", "emitted",
        "finished", "cancelled", "deadline", "history", "incarnation",
        # paged-KV state, owned by the decode loop: the np page-table
        # row, the pinned radix path (table[:len(radix_nodes)] are tree
        # pages, the rest up to span_pages are owned), and the reserved
        # span in pages
        "table", "radix_nodes", "span_pages",
    )

    def __init__(self, prompt, max_tokens, eos_id, deadline=None):
        self.prompt = prompt
        self.max_tokens = max_tokens
        self.eos_id = eos_id
        self.queue = queue.Queue()
        self.pos = 0
        self.emitted = 0
        self.finished = False   # terminal queue event delivered
        self.cancelled = False  # consumer abandoned the token iterator
        self.deadline = deadline  # time.monotonic() bound, or None
        self.history = []       # emitted tokens (radix donation key)
        # bumped on every admission: a pipelined step snapshot taken for
        # an earlier admission of this stream object never delivers
        self.incarnation = 0
        self.table = None
        self.radix_nodes = None
        self.span_pages = 0

    def expired(self, now):
        return self.deadline is not None and now >= self.deadline


class _PrefillTask:
    """A chunked admission in progress.

    The stream's slot is reserved (it sits in ``slots`` un-``ready``)
    while its padded prompt prefills ``chunk`` tokens per loop
    iteration, so a long prompt costs each co-batched decode stream one
    chunk's latency per step, never a whole-prompt stall.  ``dest`` is
    the page-copy vector for the final admit and ``full`` the token
    prefix the radix tree indexes on completion."""

    __slots__ = ("stream", "slot", "slot_cache", "padded", "start",
                 "logits_at", "chunk", "dest", "full", "done", "total")

    def __init__(self, stream, slot, slot_cache, padded, start, logits_at,
                 chunk, dest, full):
        self.stream = stream
        self.slot = slot
        self.slot_cache = slot_cache
        self.padded = padded        # np [pad_len] suffix token ids
        self.start = start          # absolute position of padded[0]
        self.logits_at = logits_at  # pad-relative last prompt token
        self.chunk = chunk
        self.dest = dest            # np [pages_per_seq] copy ids
        self.full = full            # np full token prefix (radix key)
        self.done = 0               # padded positions prefilled
        self.total = len(padded)


def _on_device(device):
    """The current-device context of the loop thread (thread-local)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class DecodeScheduler:
    """The per-model continuous-batching loop.

    ``fns`` is the bundle from ``llama.make_scheduler_fns`` and
    ``params`` the weights, on the bundle's device.  One background
    thread owns ALL device state (the page pool and the per-slot
    logits), so frontend threads never touch the device: they block on
    per-stream queues that the loop fans tokens into."""

    def __init__(self, fns, params, max_slots, max_seq,
                 prefill_chunk_tokens=256, prefix_cache=True):
        if max_slots < 1:
            raise ValueError(
                "max_slots must be >= 1 (got {})".format(max_slots))
        self._fns = fns
        self._params = params
        self._device = params["embed"].device
        self._max_slots = max_slots
        self._max_seq = max_seq
        # admission backpressure: an unbounded pending deque would let
        # one client enqueue arbitrarily many generations (each also
        # holding a frontend thread)
        self._max_pending = max(32, 8 * max_slots)
        # prompts whose padded prefill exceeds ``prefill_chunk_tokens``
        # prefill in chunks of that many tokens, one chunk per loop
        # iteration (None disables chunking); ``prefix_cache`` enables
        # the radix tree that shares prompt prefixes' pages.  Both
        # engage only where the fns say span prefill keeps the kernel
        # choice (``span_safe``)
        self._prefill_chunk_tokens = (int(prefill_chunk_tokens)
                                      if prefill_chunk_tokens else None)
        self._prefix_cache = bool(prefix_cache)
        self._cond = threading.Condition()
        self._pending = deque()  # guarded-by: _cond
        self._thread = None      # guarded-by: _cond
        self._closed = False     # guarded-by: _cond
        self._draining = False   # guarded-by: _cond
        # the exception that ended the decode loop  # guarded-by: _cond
        self._failed = None
        # lifetime SlotPoisoned count  # guarded-by: _cond
        self._quarantined = 0
        # every live (not yet terminally delivered) stream, pending or
        # slotted: close() fails exactly this set when the loop cannot,
        # and drain() waits on it  # guarded-by: _cond
        self._streams = set()
        # counters written only by the decode loop; they only grow, so a
        # racing stats() read may lag one step but never sees a decrease
        self._admitted_total = 0
        self._tokens_total = 0
        self._steps_total = 0
        self._prefix_hits = 0     # prompt tokens served from shared pages
        self._prefix_misses = 0   # prompt tokens prefilled
        self._prefix_evictions = 0  # pages evicted from the radix cache
        # (allocator, radix) of the running loop, for stats
        self._pager = None  # guarded-by: _cond

    # -- frontend side -----------------------------------------------------

    def submit(self, prompt, max_tokens, eos_id=None, deadline=None):
        """Enqueue one generation; returns an iterator of ``(token,
        logprob)`` pairs that blocks as the decode loop produces them.

        ``deadline`` is a ``time.monotonic()`` bound: past it, a
        still-pending request fails before prefill and an in-flight one
        retires mid-generation, both with ``RequestTimedOut`` (504)."""
        prompt = np.asarray(prompt, dtype=np.int32).reshape(-1)
        if len(prompt) == 0:
            raise ValueError("PROMPT_IDS must be non-empty")
        if len(prompt) + max_tokens > self._max_seq:
            raise ValueError(
                "position (0) + prompt ({}) + max_tokens ({}) exceeds max "
                "sequence {}".format(len(prompt), max_tokens, self._max_seq))
        stream = _Stream(prompt, int(max_tokens), eos_id, deadline=deadline)
        with self._cond:
            if self._closed:
                raise ServerUnavailable("scheduler is shut down")
            if self._failed is not None:
                raise ServerUnavailable(
                    "decode loop failed ({}); the scheduler serves no more "
                    "generations".format(self._failed))
            if self._draining:
                raise ServerUnavailable(
                    "scheduler is draining; not accepting new generations")
            if len(self._pending) >= self._max_pending:
                raise TooManyRequests(
                    "scheduler admission queue is full ({} waiting "
                    "generations); retry later".format(len(self._pending)))
            self._pending.append(stream)
            self._streams.add(stream)
            self._ensure_running_locked()
            self._cond.notify_all()
        return self._drain(stream)

    @staticmethod
    def _drain(stream):
        try:
            while True:
                kind, a, b = stream.queue.get()
                if kind == "tok":
                    yield a, b
                elif kind == "err":
                    stream.finished = True
                    raise a
                else:  # "done"
                    stream.finished = True
                    return
        finally:
            if not stream.finished:
                # consumer gone mid-generation (client cancel or
                # disconnect closes the generator): flag the stream so
                # the decode loop retires its slot instead of burning
                # batched steps on tokens nobody will read
                stream.cancelled = True

    def close(self, join_timeout=30):
        """Stop the loop; pending and in-flight requests fail with
        ``ServerUnavailable``, and so do later submits.  If the loop
        thread does not end within ``join_timeout`` (stuck in a device
        call), every stream it did not deliver is failed here, so no
        consumer is left blocked on its queue."""
        with self._cond:
            already_closed = self._closed
            self._closed = True
            self._cond.notify_all()
            thread = self._thread
        if thread is not None and not already_closed:
            thread.join(timeout=join_timeout)
        with self._cond:
            leftover = list(self._streams)
            self._streams.clear()
            self._pending.clear()
            self._cond.notify_all()
        err = ServerUnavailable("scheduler is shut down")
        for stream in leftover:
            stream.queue.put(("err", err, None))

    def drain(self, timeout=30.0):
        """Graceful drain: stop admission at once, let pending and
        in-flight generations finish within ``timeout`` seconds, then
        close, failing whatever remains."""
        deadline = time.monotonic() + timeout
        with self._cond:
            self._draining = True
            self._cond.notify_all()
            while self._streams:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(remaining)
        self.close(join_timeout=max(0.1, deadline - time.monotonic()))

    @property
    def healthy(self):
        """False once the scheduler is closed or its decode loop failed;
        the core's readiness answers report it."""
        with self._cond:
            return not self._closed and self._failed is None

    def stats(self):
        """Live stream, pending and slot counts, lifecycle flags and the
        loop's counters.  ``live_streams`` returning to zero after
        traffic is the no-leaked-slots invariant."""
        with self._cond:
            pager = self._pager
            if pager is not None:
                alloc, radix = pager
                pages_total = alloc.n_pages
                pages_free = alloc.free_count
                pages_cached = radix.unreferenced if radix is not None else 0
            else:
                pages_total = int(self._fns.get("n_pages", 0) or 0)
                pages_free = pages_total
                pages_cached = 0
            return {
                "live_streams": len(self._streams),
                "pending": len(self._pending),
                "max_slots": self._max_slots,
                "max_pending": self._max_pending,
                "draining": self._draining,
                "closed": self._closed,
                "healthy": self.healthy,
                "failed": self._failed is not None,
                "quarantined": self._quarantined,
                "admitted": self._admitted_total,
                "tokens": self._tokens_total,
                "steps": self._steps_total,
                "prefix_hits": self._prefix_hits,
                "prefix_misses": self._prefix_misses,
                "prefix_evictions": self._prefix_evictions,
                "pages_total": pages_total,
                "pages_free": pages_free,
                "pages_cached": pages_cached,
            }

    # -- decode loop -------------------------------------------------------

    def _ensure_running_locked(self):
        """Start the decode thread if it is not running.  Called with
        ``_cond`` held."""
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._run, name="decode-scheduler", daemon=True)
            self._thread.start()

    def _detach_locked(self, stream):
        """Retire a cancelled stream from the live registry.  Called with
        ``_cond`` held."""
        self._streams.discard(stream)
        self._cond.notify_all()

    def _fail(self, stream, exc):
        self._deliver(stream, ("err", exc, None))

    def _deliver(self, stream, event):
        """Deliver a terminal event and retire the stream from the live
        registry (never call while holding ``_cond``: it takes it)."""
        with self._cond:
            self._streams.discard(stream)
            self._cond.notify_all()
            stream.queue.put(event)

    def _run(self):
        slots = [None] * self._max_slots  # slot -> _Stream | None
        try:
            # inference mode and the current device are per thread: the
            # callers' settings do not reach this one
            with torch.inference_mode(), _on_device(self._device):
                self._loop(slots)
        except Exception as e:  # noqa: BLE001 — the loop's boundary: a
            # failure no single stream caused ends it, and every consumer
            # must hear of it rather than block on its queue forever
            _log.exception("decode loop failed")
            err = TorchServeError("decode loop failed: {}".format(e),
                                  code=500)
            with self._cond:
                self._failed = e
                to_fail = list(self._streams)
                self._streams.clear()
                self._pending.clear()
                self._cond.notify_all()
            for stream in to_fail:
                stream.queue.put(("err", err, None))

    def _loop(self, slots):
        fns = self._fns
        page = fns["page_size"]
        ppseq = fns["pages_per_seq"]
        n_pages = fns["n_pages"]
        # chunked and shared-prefix prefill run spans through the dense
        # cached path; where the flash kernel prefills, that could flip a
        # near-tie greedy argmax against the one-shot prefill, so both
        # fall back to whole-prompt prefill there (prefill_bucket's rule,
        # applied to spans)
        span_safe = fns["span_safe"]
        chunk = self._prefill_chunk_tokens if span_safe else None
        pages = fns["init_cache"]()
        logits = fns["init_logits"]()
        alloc = PageAllocator(n_pages, page)
        radix = (RadixPrefixCache(page)
                 if self._prefix_cache and span_safe else None)
        with self._cond:
            self._pager = (alloc, radix)
        # per-slot page tables, staged to the device each step (sentinel
        # rows are inert); mutated in place as slots turn over: each
        # step stages a copy of the then-current content
        tables = np.full((self._max_slots, ppseq), n_pages, np.int32)
        ready = [False] * self._max_slots  # prefill complete
        prefilling = {}                    # slot -> _PrefillTask
        inflight = None  # (tokens, logprobs, snapshot) of the last step
        no_force = np.zeros((self._max_slots,), np.int32)

        def clear_slot(slot):
            slots[slot] = None
            ready[slot] = False
            tables[slot] = n_pages

        def release_pages(stream, insert=True):
            """Return a stream's pages to the pool.  The pinned radix
            path unrefs; full pages covered by fed tokens donate to the
            radix cache as unpinned entries (content-addressed, so
            always safe to share); everything else frees.
            ``insert=False`` for poisoned or failed streams, whose
            written KV must not be cached."""
            table = stream.table
            nodes = stream.radix_nodes or []
            if table is None:
                # failed before the span was reserved: only the matched
                # pins (if any) need returning
                if nodes:
                    radix.release(nodes)
                stream.radix_nodes = None
                return
            path_len = len(nodes)
            owned = [int(table[d])
                     for d in range(path_len, stream.span_pages)]
            if insert and radix is not None:
                known = ([int(t) for t in stream.prompt]
                         + list(stream.history))
                insertable = min(stream.pos, len(known)) // page
                donate = max(0, insertable - path_len)
                if donate:
                    _, _, dup_ids = radix.insert_tail(
                        nodes, known, path_len, owned[:donate], pin=False)
                    alloc.free(dup_ids)
                    owned = owned[donate:]
            alloc.free(owned)
            if nodes:
                radix.release(nodes)
            stream.table = None
            stream.radix_nodes = None
            stream.span_pages = 0

        def complete_admission(slot, stream, full):
            """Post-admit bookkeeping: donate the prompt's full pages to
            the radix tree now (pinned: siblings admitted next iteration
            already share them), publish the page table, count the
            admission."""
            if radix is not None and full is not None:
                path_len = len(stream.radix_nodes)
                donate = stream.pos // page - path_len
                if donate > 0:
                    owned = [int(stream.table[d])
                             for d in range(path_len, path_len + donate)]
                    appended, dups, dup_ids = radix.insert_tail(
                        stream.radix_nodes, full, path_len, owned, pin=True)
                    for d, existing in dups:
                        # a sibling already donated this page's content:
                        # the tree's copy wins (equal bytes) and ours
                        # frees
                        stream.table[d] = existing
                    alloc.free(dup_ids)
                    stream.radix_nodes.extend(appended)
            tables[slot] = stream.table
            ready[slot] = True
            self._admitted_total += 1

        def start_admission(slot, stream):
            """Reserve the stream's page span and run (or begin) its
            prefill.  The slot is already reserved in ``slots``; on a
            shed or a per-request fault it is cleared here."""
            nonlocal pages, logits
            try:
                # a step snapshot of an earlier admission becomes inert
                stream.incarnation += 1
                full = stream.prompt
                prefill_len = len(full)
                # the whole potential span reserves up front, so decode
                # never runs out of pages mid-generation: exhaustion is a
                # typed admission-time shed
                span_pages = pages_for(prefill_len + stream.max_tokens, page)
                matched_nodes = []
                shared_pages = 0
                if radix is not None:
                    nodes, _ids = radix.match(full)
                    # the prompt's LAST token always re-runs: its logits
                    # seed the first decode step
                    shared_pages = min(len(nodes), (prefill_len - 1) // page)
                    matched_nodes = nodes[:shared_pages]
                    # recorded before anything can fail: the shed and
                    # fault paths unpin through release_pages(stream)
                    stream.radix_nodes = list(matched_nodes)
                    if matched_nodes:
                        # pin before any eviction runs for this admission
                        radix.acquire(matched_nodes)
                shared_len = shared_pages * page
                needed = span_pages - shared_pages
                owned = alloc.alloc(needed)
                if owned is None and radix is not None:
                    freed = radix.evict(needed - alloc.free_count)
                    self._prefix_evictions += len(freed)
                    alloc.free(freed)
                    owned = alloc.alloc(needed)
                if owned is None:
                    release_pages(stream, insert=False)  # unpin only
                    self._fail(stream, TooManyRequests(
                        "kv page pool exhausted: admission needs {} pages "
                        "but only {} are free and every cached page is "
                        "pinned by a live stream; retry later".format(
                            needed, alloc.free_count)))
                    clear_slot(slot)
                    return
                # counted once the reservation succeeded: a shed admission
                # served nothing and prefilled nothing
                if radix is not None:
                    self._prefix_hits += shared_len
                self._prefix_misses += prefill_len - shared_len
                table = np.full((ppseq,), n_pages, np.int32)
                for d, node in enumerate(matched_nodes):
                    table[d] = node.page
                table[shared_pages:span_pages] = owned
                stream.table = table
                if stream.radix_nodes is None:
                    stream.radix_nodes = []  # radix off
                stream.span_pages = span_pages
                suffix = np.asarray(full[shared_len:], np.int32)
                suffix_len = len(suffix)
                if shared_pages:
                    # restore the shared prefix into the single-row cache
                    # and prefill only the unique suffix on top of it
                    prefix_table = np.full((ppseq,), n_pages, np.int32)
                    prefix_table[:shared_pages] = table[:shared_pages]
                    slot_cache = fns["gather"](pages, prefix_table)
                    dest = table.copy()
                    # shared pages live in the pool already: never
                    # rewrite them from this admission's copy
                    dest[:shared_pages] = n_pages
                else:
                    slot_cache = None
                    dest = table
                if chunk is not None and suffix_len > chunk:
                    pad_len = min(-(-suffix_len // chunk) * chunk,
                                  self._max_seq - shared_len)
                    padded = np.zeros((pad_len,), np.int32)
                    padded[:suffix_len] = suffix
                    if slot_cache is None:
                        slot_cache = fns["init_slot_cache"]()
                    prefilling[slot] = _PrefillTask(
                        stream, slot, slot_cache, padded, shared_len,
                        suffix_len - 1, chunk, dest, full)
                    return
                if shared_pages:
                    bucket = 8
                    while bucket < suffix_len:
                        bucket <<= 1
                    bucket = min(bucket, self._max_seq - shared_len)
                    padded = np.zeros((bucket,), np.int32)
                    padded[:suffix_len] = suffix
                    slot_logits, slot_cache = fns["prefill_span"](
                        self._params, slot_cache, padded[None, :],
                        shared_len, suffix_len - 1)
                else:
                    # cold one-shot admission: the bucketed prefill
                    # (prefill_bucket keeps the kernel choice; padding
                    # rows stay masked)
                    bucket = fns["prefill_bucket"](suffix_len)
                    padded = np.zeros((bucket,), np.int32)
                    padded[:suffix_len] = suffix
                    slot_cache = fns["init_slot_cache"]()
                    slot_logits, slot_cache = fns["prefill"](
                        self._params, slot_cache, padded[None, :],
                        suffix_len)
                stream.pos = prefill_len
                pages, logits = fns["admit"](
                    pages, logits, slot_cache, slot_logits, dest, slot)
                complete_admission(slot, stream, full)
            except Exception as e:  # noqa: BLE001 — per-request fault
                release_pages(stream, insert=False)
                self._fail(stream, e)
                clear_slot(slot)

        def run_prefill_chunk():
            """One chunk of the oldest in-progress chunked prefill: a
            single bounded dispatch between decode steps, so co-batched
            streams keep emitting."""
            nonlocal pages, logits
            slot, task = next(iter(prefilling.items()))
            stream = task.stream
            n = min(task.chunk, task.total - task.done)
            rel = task.logits_at - task.done
            rel = rel if 0 <= rel < n else 0
            try:
                chunk_logits, task.slot_cache = fns["prefill_span"](
                    self._params, task.slot_cache,
                    task.padded[None, task.done:task.done + n],
                    task.start + task.done, rel)
                task.done += n
                if task.done < task.total:
                    return
                del prefilling[slot]
                stream.pos = task.start + task.logits_at + 1
                pages, logits = fns["admit"](
                    pages, logits, task.slot_cache, chunk_logits, task.dest,
                    slot)
                complete_admission(slot, stream, task.full)
            except Exception as e:  # noqa: BLE001 — per-request fault
                prefilling.pop(slot, None)
                release_pages(stream, insert=False)
                self._fail(stream, e)
                clear_slot(slot)

        def finish(stream, slot):
            release_pages(stream)
            self._deliver(stream, ("done", None, None))
            clear_slot(slot)

        while True:
            expired = []
            with self._cond:
                while (not self._closed and not self._draining
                       and not self._pending and inflight is None
                       and not any(s is not None for s in slots)):
                    self._cond.wait()
                if self._closed:
                    pending = list(self._pending)
                    self._pending.clear()
                    break
                if (self._draining and not self._pending
                        and inflight is None
                        and not any(s is not None for s in slots)):
                    # drain complete: every accepted generation finished
                    self._closed = True
                    pending = []
                    break
                # reap cancelled streams first: their consumers are gone,
                # so the slot and its pages free for waiting work (full
                # pages donate to the radix cache)
                for i, st in enumerate(slots):
                    if st is not None and st.cancelled:
                        prefilling.pop(i, None)
                        release_pages(st)
                        self._detach_locked(st)
                        clear_slot(i)
                # deadline sweep: a pending request past its deadline
                # fails before prefill; an in-flight one retires
                # mid-generation, its slot and pages freeing at once
                now = time.monotonic()
                if self._pending:
                    keep = deque()
                    for st in self._pending:
                        (expired if st.expired(now) else keep).append(st)
                    self._pending = keep
                for i, st in enumerate(slots):
                    if st is not None and st.expired(now):
                        expired.append(st)
                        prefilling.pop(i, None)
                        release_pages(st)
                        clear_slot(i)
                self._cond.notify_all()
                admissions = []
                free = [i for i, s in enumerate(slots) if s is None]
                while self._pending and free:
                    st = self._pending.popleft()
                    if st.cancelled:
                        self._detach_locked(st)
                        continue  # abandoned while still queued
                    slot = free.pop(0)
                    # reserve now, under the lock: the cancel reap must
                    # see prefilling streams as slotted
                    slots[slot] = st
                    admissions.append((slot, st))
            # failures deliver outside the lock (delivery takes it)
            for st in expired:
                self._fail(st, RequestTimedOut(
                    "request deadline exceeded after {} emitted "
                    "tokens".format(st.emitted)))
            # device work runs outside the lock: submitters enqueue while
            # the card computes
            for slot, stream in admissions:
                start_admission(slot, stream)
            if prefilling:
                # one bounded chunk per iteration: long prompts trickle
                # in while decode keeps stepping
                run_prefill_chunk()

            current = None
            active_ids = [i for i, s in enumerate(slots)
                          if s is not None and ready[i]]
            if active_ids:
                # the sentinel position max_seq on inert rows: their
                # writes go to the trash page
                positions = np.full((self._max_slots,), self._max_seq,
                                    np.int32)
                active = np.zeros((self._max_slots,), bool)
                snapshot = []
                for i in active_ids:
                    st = slots[i]
                    positions[i] = st.pos
                    active[i] = True
                    snapshot.append((i, st, st.incarnation))
                    st.pos += 1
                tokens_dev, logps_dev, logits, pages = fns["step"](
                    self._params, pages, logits, tables, positions, active,
                    no_force, no_force.astype(bool))
                self._steps_total += 1
                current = (tokens_dev, logps_dev, snapshot)

            if inflight is not None:
                tokens_dev, logps_dev, snapshot = inflight
                toks = np.asarray(tokens_dev)
                lps = np.asarray(logps_dev)
                quarantined = []
                finished = []
                with self._cond:
                    for i, st, inc in snapshot:
                        if slots[i] is not st or st.incarnation != inc:
                            # the slot retired (and maybe re-admitted)
                            # after this step was dispatched: its token is
                            # the pipeline's wasted extra
                            continue
                        if st.cancelled:
                            release_pages(st)
                            self._detach_locked(st)
                            clear_slot(i)
                            continue
                        tok = int(toks[i])
                        lp = float(lps[i])
                        if not np.isfinite(lp):
                            # this slot's own logits went non-finite; the
                            # step's math is row-independent, so only the
                            # offender retires, and its KV is not cached
                            quarantined.append((i, st))
                            release_pages(st, insert=False)
                            clear_slot(i)
                            continue
                        if st.emitted < st.max_tokens:
                            st.history.append(tok)
                            st.queue.put(("tok", tok, lp))
                            st.emitted += 1
                            self._tokens_total += 1
                        if st.emitted >= st.max_tokens or (
                                st.eos_id is not None and tok == st.eos_id):
                            finished.append((st, i))
                    self._quarantined += len(quarantined)
                for i, st in quarantined:
                    self._fail(st, SlotPoisoned(
                        "generation produced non-finite logits after {} "
                        "emitted tokens; its slot was quarantined "
                        "(co-batched generations are unaffected)".format(
                            st.emitted)))
                for st, i in finished:
                    finish(st, i)
            inflight = current

        # closed: fail whatever is still queued or running
        err = ServerUnavailable("scheduler is shut down")
        for st in slots:
            if st is not None:
                self._fail(st, err)
        for st in pending:
            self._fail(st, err)
