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
   cache into its pages (``llama.paged_admit``).  A stream admitted
   again (after a loop restart, or resumed) prefills ``prompt +
   history`` and emission continues where it stopped.  Two admissions
   prefill nothing: over a parked cache (``resume_cache``, the
   single-stream park shape) the cache scatters into the pages and the
   prompt feeds as forced tokens; over an attached KV export
   (``attach_cache``: a resume of a parked generation, or the decode leg
   of a prefill/decode split) the export scatters and ONE token, the
   last of its valid prefix, feeds again to regenerate the logits.
2. **step**: every iteration runs ``llama.paged_scheduler_step``: a
   greedy token per slot from the slot's logits row, then one batched
   decode over every slot (always ``max_slots`` rows, so a row's numbers
   never depend on how many neighbours it has), each row writing its K/V
   at its own position.  Steps are pipelined one deep: step *i+1* is
   dispatched before step *i*'s tokens are fetched, and the fetch waits
   for step *i*'s own copy to the host, so it overlaps step *i+1*.
   With ``spec_tokens=K`` each slot instead drafts up to K tokens
   (``tpuserver_torch.speculative``) and one ``llama.paged_spec_step``
   verifies them; see :class:`DecodeScheduler`.
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

Self-healing:

- **Per-slot quarantine.**  A slot whose own step output is poisoned (a
  non-finite logprob) retires with a typed
  :class:`~tpuserver_torch.errors.SlotPoisoned` (422) while every
  co-batched slot keeps decoding: the batched step's math is
  row-independent.
- **Supervised restart.**  A ``decode-supervisor`` thread owns the loop
  thread.  A failure no single stream caused (a failed batched step or
  fetch) ends the loop; the supervisor starts a new one with a fresh
  page pool, and every live stream is admitted again by prefilling
  ``prompt + history``, under a budget of ``max_restarts`` restarts per
  ``RESTART_WINDOW_S`` with exponential backoff.  A step stalled past
  ``step_timeout_s`` (the watchdog) is treated the same way: the loop's
  epoch moves on, so the stalled thread, when it wakes, delivers
  nothing.  The watchdog arms for each kind of device call (admission
  prefill, step, speculative step) once that kind has completed one
  call: the first pays the kernel library's load and cuBLAS's set-up.  With the budget spent the scheduler trips for good: every
  stream fails with ``ServerUnavailable`` (503), :attr:`healthy` stays
  False, later submits are refused, and drain and close still work.
- **Resumable generations.**  ``submit(generation_id=...)`` keeps every
  emitted ``(token, logprob)``; a disconnected or completed generation
  parks in a bounded, TTL'd replay buffer, and :meth:`resume` replays
  ``history[from_seq:]`` and then splices the live continuation.  With
  the ``kv_export`` hooks, a disconnected ``kv_export`` stream's pages
  are gathered and exported when it is reaped, and its resume attaches
  the export instead of prefilling ``prompt + history``.

Observability and chaos:

- **Adaptive admission shedding** (``target_queue_ms``): the CoDel
  control law over the pending queue (:class:`_CodelShedController`).
  Once the head of the queue has waited longer than the target for a
  whole control interval, ``submit`` sheds one arrival per (shrinking)
  interval with a typed 429 whose ``Retry-After`` is the interval,
  rounded up; ``max_pending`` stays the hard backstop.
- **Latency histograms** (``metrics``): the queue wait of each admission
  and the dispatch time of each batched step, as ``single_writer``
  children of ``tpuserver_torch.metrics`` families.  The decode loop is
  their only writer, so it observes without a lock.
- **Fault points** (``fault_scope``): ``scheduler.admit`` before each
  admission, ``scheduler.step`` before each step dispatch (plain or
  speculative, through one helper) and ``scheduler.fetch`` before the
  device-to-host token copy, each tripped through
  ``tpuserver_torch.fault_points`` with this scheduler's scope.

JAX's ``TPUSERVER_SPEC_TOKENS`` environment default is not read:
``spec_tokens`` is an argument.

Where the JAX scheduler raises its own ``SchedulerClosed``,
``AdmissionQueueFull`` and ``UnknownGeneration``, this one raises the
typed errors the core passes through: ``ServerUnavailable`` (503) once
closed, draining or tripped, ``TooManyRequests`` (429) when the pending
queue is full or the KV page pool is exhausted (``Retry-After: 1``) or
the controller sheds (its computed ``Retry-After``), and
``GenerationNotFound`` (404) for a resume id it does not hold.
"""

import contextlib
import logging
import math
import queue
import threading
import time
from collections import OrderedDict, deque

import numpy as np
import torch

from tpuserver_torch import fault_points
from tpuserver_torch.errors import (
    GenerationNotFound,
    RequestTimedOut,
    ServerUnavailable,
    SlotPoisoned,
    TooManyRequests,
    TorchServeError,
)
from tpuserver_torch.paging import PageAllocator, RadixPrefixCache, pages_for
from tpuserver_torch.speculative import NgramDrafter

_log = logging.getLogger(__name__)

#: the sliding window of the supervisor's restart budget, in seconds
RESTART_WINDOW_S = 60.0
#: parked generations the replay buffer holds (the oldest goes first)
REPLAY_CAPACITY = 256


class _CodelShedController:
    """Sojourn-time admission shedding: the CoDel control law applied to
    the scheduler's pending queue (Nichols & Jacobson, "Controlling
    Queue Delay"), in place of a fixed queue-length cliff.

    A long queue is not the problem; a queue that STAYS long is.  The
    controller watches the admission queue's sojourn (the head stream's
    wait, which ``tpu_scheduler_queue_wait_seconds`` histograms at
    admission): once it has exceeded ``target_s`` continuously for a
    full ``interval_s``, the scheduler sheds the NEWEST arrival with
    the typed 429 and keeps shedding one arrival per control interval,
    tightening the interval as ``interval / sqrt(shed_count)`` while
    overload persists and relaxing the moment sojourn drops back under
    target.  ``Retry-After`` is the ceiling of the current control
    interval: the pace the queue is draining at.

    A plain state machine, with no lock of its own: every method runs
    under the scheduler's ``_cond`` (submit holds it to shed; the decode
    loop holds it where it notes sojourn), and all time flows in as
    ``now``, so tests drive it without a clock.  A copy of the JAX
    package's controller."""

    __slots__ = ("target_s", "interval_s", "above_since", "shedding",
                 "shed_next", "shed_count")

    def __init__(self, target_s, interval_s):
        self.target_s = float(target_s)
        self.interval_s = float(interval_s)
        self.above_since = None  # first instant sojourn exceeded target
        self.shedding = False
        self.shed_next = 0.0     # next shed instant while shedding
        self.shed_count = 0      # sheds in the current overload episode

    def current_interval(self):
        return self.interval_s / math.sqrt(max(1, self.shed_count))

    def note_sojourn(self, sojourn_s, now):
        """One queue-delay observation (the head-of-queue wait: the FIFO
        maximum, so 'head under target' means the whole queue is).
        Below target: relax completely; above: start (or keep) the
        overload clock."""
        if sojourn_s < self.target_s:
            self.above_since = None
            self.shedding = False
            self.shed_count = 0
        elif self.above_since is None:
            self.above_since = now

    def on_arrival(self, now, queue_len):
        """Shed verdict for one new submit: the ``Retry-After`` seconds
        to shed with, or None to admit.  Never sheds an empty queue (its
        sojourn is a stale signal), never before the sojourn has been
        above target for one full interval, and while shedding drops one
        arrival per (shrinking) control interval, not every arrival."""
        if queue_len <= 0 or self.above_since is None:
            return None
        if now - self.above_since < self.interval_s:
            return None
        if not self.shedding:
            self.shedding = True
            self.shed_count = 1
        elif now >= self.shed_next:
            self.shed_count += 1
        else:
            return None
        interval = self.current_interval()
        self.shed_next = now + interval
        return max(1, int(math.ceil(interval)))


class _Stream:
    """One in-flight generation bound to a cache slot."""

    __slots__ = (
        "prompt", "max_tokens", "eos_id", "queue", "forced", "pos",
        "emitted", "on_finish", "resume_cache", "resume_pos", "finished",
        "cancelled", "deadline", "generation_id", "history", "incarnation",
        "enqueued_at",
        # paged-KV state, owned by the decode loop that admitted the
        # stream (reset for re-admission when a loop dies): the np
        # page-table row, the pinned radix path (table[:len(radix_nodes)]
        # are tree pages, the rest up to span_pages are owned), and the
        # reserved span in pages
        "table", "radix_nodes", "span_pages",
        # the data plane: the prompt as a device view (a CUDA-shm region's
        # memory, which a cold prefill consumes without a host copy), the
        # park-export opt-in, the export-on-finish of a prefill leg, the
        # attach state a resume or a decode leg scatters instead of
        # prefilling, and a failed export's error (its resume raises it)
        "prompt_dev", "kv_export", "kv_export_on_finish", "attach_cache",
        "attach_pos", "kv_error",
        # speculation throttle, owned by the decode loop: consecutive
        # drafted tokens with no acceptance, and steps left to skip
        # drafting once throttled
        "spec_miss", "spec_skip",
    )

    def __init__(self, prompt, max_tokens, eos_id, resume_cache=None,
                 resume_pos=0, on_finish=None, deadline=None,
                 generation_id=None, prompt_dev=None, kv_export=False,
                 kv_export_on_finish=False):
        self.prompt = prompt
        self.max_tokens = max_tokens
        self.eos_id = eos_id
        self.queue = queue.Queue()
        # tokens the next steps feed instead of their greedy pick, with
        # no emission (a parked cache's prompt, an attach's last token)
        self.forced = deque()
        self.pos = 0
        self.emitted = 0
        self.on_finish = on_finish  # park hook: gets the gathered cache
        self.resume_cache = resume_cache  # parked cache to continue from
        self.resume_pos = resume_pos      # and its position
        self.finished = False   # terminal queue event delivered
        self.cancelled = False  # consumer abandoned the token iterator
        self.deadline = deadline  # time.monotonic() bound, or None
        self.generation_id = generation_id  # resumable when set
        # every emitted (token, logprob): the replay buffer of a resume,
        # the re-admission feed of a restart, the radix donation key
        self.history = []
        # bumped on every admission: a step snapshot taken for an
        # earlier admission of this stream object never delivers
        self.incarnation = 0
        self.enqueued_at = time.monotonic()  # latest (re-)enqueue
        self.table = None
        self.radix_nodes = None
        self.span_pages = 0
        self.prompt_dev = prompt_dev
        self.kv_export = bool(kv_export)
        self.kv_export_on_finish = bool(kv_export_on_finish)
        self.attach_cache = None  # the KV export to scatter
        self.attach_pos = 0       # the end of its valid prefix
        self.kv_error = None
        self.spec_miss = 0
        self.spec_skip = 0

    def expired(self, now):
        return self.deadline is not None and now >= self.deadline


class _HungStep(Exception):
    """The watchdog's cause of a loop restart."""


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
    per-stream queues that the loop fans tokens into.

    Supervision: ``step_timeout_s`` (None: no watchdog) bounds every
    device call of the loop once a call of its kind has completed (the
    first pays the kernel library's load and cuBLAS's set-up);
    admission prefills get ten times it, since a new length pays
    cuBLAS's heuristics.  ``max_restarts`` restarts per sliding
    ``RESTART_WINDOW_S`` are allowed, each after a backoff that starts
    at ``restart_backoff_s`` and doubles (at most 2 s).  Replay:
    parked generations stay ``replay_ttl_s``, at most
    ``REPLAY_CAPACITY`` of them.

    KV hooks (all optional; absent, no stream exports):
    ``kv_export(generation_id, cache, valid_pos)`` parks a reaped
    ``kv_export`` stream's gathered pages, ``kv_import(generation_id)``
    returns ``(cache, valid_pos)`` or None when its resume looks for them,
    and ``kv_discard(generation_id)`` releases an export whose replay entry
    is gone (superseded, expired, evicted, consumed or closed).  A
    missing export falls back to prefilling ``prompt + history``; a
    failed one fails the stream's resume with its typed error.

    Speculation: ``spec_tokens=K`` (0: off) drafts up to K tokens per
    slot per step and verifies them in one ``fns["spec_step"]`` call;
    the tokens are bitwise those of ``spec_tokens=0``.  A stream that
    drafted ``spec_throttle_after`` consecutive tokens with no
    acceptance skips drafting for ``spec_probe_interval`` steps at a
    time until a draft lands.  (JAX reads its default from the
    ``TPUSERVER_SPEC_TOKENS`` environment variable; here it is only
    this argument, and ``serve.py --spec-tokens``.)

    Shedding: ``target_queue_ms`` (None: off) turns on the sojourn-time
    controller with a control interval of ``shed_interval_ms``.
    Observability: ``metrics`` (a ``tpuserver_torch.metrics``
    registry) gets the queue-wait and step histograms, labelled
    ``metric_labels``.  Chaos: ``fault_scope`` is this scheduler's
    scope at its fault points."""

    def __init__(self, fns, params, max_slots, max_seq,
                 prefill_chunk_tokens=256, prefix_cache=True,
                 step_timeout_s=None, max_restarts=5, restart_backoff_s=0.05,
                 replay_ttl_s=60.0, spec_tokens=0, spec_throttle_after=16,
                 spec_probe_interval=8, kv_export=None, kv_import=None,
                 kv_discard=None, target_queue_ms=None,
                 shed_interval_ms=100.0, metrics=None, metric_labels=None,
                 fault_scope=None):
        if max_slots < 1:
            raise ValueError(
                "max_slots must be >= 1 (got {})".format(max_slots))
        self._fns = fns
        self._params = params
        self._device = params["norm"].device  # a tensor, quantized or not
        self._max_slots = max_slots
        self._max_seq = max_seq
        # admission backpressure: an unbounded pending deque would let
        # one client enqueue arbitrarily many generations (each also
        # holding a frontend thread)
        self._max_pending = max(32, 8 * max_slots)
        # adaptive queue shedding (None: off, the fixed cliff only).
        # Written by submit and by the decode loop, both under _cond
        # (the loop notes sojourn inside a region that holds it anyway:
        # no new lock acquisition)  # guarded-by: _cond
        self._shed_ctl = (
            _CodelShedController(float(target_queue_ms) / 1e3,
                                 float(shed_interval_ms) / 1e3)
            if target_queue_ms else None)
        self._codel_sheds = 0  # guarded-by: _cond
        self.fault_scope = fault_scope
        # prompts whose padded prefill exceeds ``prefill_chunk_tokens``
        # prefill in chunks of that many tokens, one chunk per loop
        # iteration (None disables chunking); ``prefix_cache`` enables
        # the radix tree that shares prompt prefixes' pages.  Both
        # engage only where the fns say span prefill keeps the kernel
        # choice (``span_safe``)
        self._prefill_chunk_tokens = (int(prefill_chunk_tokens)
                                      if prefill_chunk_tokens else None)
        self._prefix_cache = bool(prefix_cache)
        self._step_timeout_s = step_timeout_s
        self._max_restarts = int(max_restarts)
        self._restart_backoff_s = float(restart_backoff_s)
        self._replay_ttl_s = float(replay_ttl_s)
        self._spec_tokens = max(0, int(spec_tokens))
        self._spec_throttle_after = int(spec_throttle_after)
        self._spec_probe_interval = int(spec_probe_interval)
        self._cond = threading.Condition()
        self._pending = deque()  # guarded-by: _cond
        self._thread = None      # guarded-by: _cond
        self._supervisor = None  # guarded-by: _cond
        self._closed = False     # guarded-by: _cond
        self._draining = False   # guarded-by: _cond
        # restart budget spent: permanent  # guarded-by: _cond
        self._tripped = False
        # the epoch demotes superseded (wedged) loop threads: every
        # delivery into stream queues checks it under _cond, so a thread
        # waking after a watchdog restart never emits into a stream the
        # new loop admitted again  # guarded-by: _cond
        self._epoch = 0
        # (epoch, monotonic start) of the current device call, or None;
        # epoch-tagged so a demoted thread's stale stamps can neither
        # trip the watchdog against its successor nor erase the
        # successor's beat  # guarded-by: _cond
        self._heartbeat = None
        # set by a dying loop for the supervisor  # guarded-by: _cond
        self._loop_error = None
        # kinds of device call that completed once: the watchdog times
        # only these (the card's and cuBLAS's set-up costs are paid once
        # per process, so a restarted loop keeps them)  # guarded-by: _cond
        self._warm = set()
        self._restarts = 0  # lifetime count  # guarded-by: _cond
        # restart times inside the window  # guarded-by: _cond
        self._recent_restarts = deque()
        # lifetime SlotPoisoned count  # guarded-by: _cond
        self._quarantined = 0
        # generation_id -> (stream, completed, expires_monotonic): the
        # bounded, TTL'd replay buffer  # guarded-by: _cond
        self._replay = OrderedDict()
        # every live (not yet terminally delivered) stream, pending or
        # slotted: close() fails exactly this set when the loop cannot,
        # and drain() waits on it  # guarded-by: _cond
        self._streams = set()
        # counters written only by the decode loop (or resume, under
        # _cond); they only grow, so a racing stats() read may lag one
        # step but never sees a decrease
        self._admitted_total = 0
        self._tokens_total = 0
        self._steps_total = 0
        self._replay_hits = 0
        self._prefix_hits = 0     # prompt tokens served from shared pages
        self._prefix_misses = 0   # prompt tokens prefilled
        self._prefix_evictions = 0  # pages evicted from the radix cache
        self._spec_steps = 0      # guarded-by: _cond
        self._spec_proposed = 0   # guarded-by: _cond
        self._spec_accepted = 0   # guarded-by: _cond
        self._spec_rollbacks = 0  # guarded-by: _cond
        # admissions over an attached KV export (no prefill), written by
        # the loop like the counters above
        self._attach_admissions = 0
        # chunks of chunked admission prefills run (one prefill_span call
        # each), written by the loop like the counters above
        self._prefill_chunks = 0
        self._kv_export = kv_export
        self._kv_import = kv_import
        self._kv_discard = kv_discard
        # (allocator, radix) of the running loop, for stats (a restart
        # rebuilds both with the pool)  # guarded-by: _cond
        self._pager = None
        # the latency histograms: the decode loop is their only writer,
        # so single_writer children observe without a lock
        self._queue_hist = None
        self._step_hist = None
        if metrics is not None:
            labels = dict(metric_labels or {})
            names = tuple(sorted(labels))
            self._queue_hist = metrics.histogram(
                "tpu_scheduler_queue_wait_seconds", labelnames=names,
                single_writer=True).labels(**labels)
            self._step_hist = metrics.histogram(
                "tpu_scheduler_step_seconds", labelnames=names,
                single_writer=True).labels(**labels)

    # -- frontend side -----------------------------------------------------

    def submit(self, prompt, max_tokens, eos_id=None, resume_cache=None,
               resume_pos=0, on_finish=None, deadline=None,
               generation_id=None, prompt_dev=None, kv_export=False,
               kv_export_on_finish=False, attach_cache=None, attach_pos=0):
        """Enqueue one generation; returns an iterator of ``(token,
        logprob)`` pairs that blocks as the decode loop produces them.

        ``resume_cache``/``resume_pos`` continue from a parked cache (the
        single-stream park shape): it scatters into the pages and the
        prompt feeds as forced tokens, with no emission.
        ``on_finish(cache)`` receives the stream's gathered cache when it
        finishes: the park hook.  ``deadline`` is a ``time.monotonic()``
        bound: past it, a still-pending request fails before prefill and
        an in-flight one retires mid-generation, both with
        ``RequestTimedOut`` (504).  ``generation_id`` makes the
        generation resumable: its tokens stay in the replay buffer after
        a disconnect or completion, and :meth:`resume` continues it.
        ``prompt_dev`` is the prompt as a device tensor (a view of a
        region's memory), which a cold prefill consumes in place of the
        host ids.

        The data plane: ``kv_export`` exports the stream's KV through the
        ``kv_export`` hook when a disconnect reaps it (its resume then
        attaches); ``kv_export_on_finish`` (a prefill leg) also exports
        when it finishes, and keeps the export past the completed park
        for a decode-side server to attach.  ``attach_cache`` /
        ``attach_pos`` admit over an imported export (a decode leg): it
        scatters into a fresh page span and ``prompt[attach_pos - 1:]``
        feeds as forced tokens, with no prefill.  A position outside
        ``(0, len(prompt)]`` falls back to the prefill."""
        prompt = np.asarray(prompt, dtype=np.int32).reshape(-1)
        if len(prompt) == 0:
            raise ValueError("PROMPT_IDS must be non-empty")
        start = resume_pos if resume_cache is not None else 0
        if start + len(prompt) + max_tokens > self._max_seq:
            raise ValueError(
                "position ({}) + prompt ({}) + max_tokens ({}) exceeds max "
                "sequence {}".format(start, len(prompt), max_tokens,
                                     self._max_seq))
        stream = _Stream(prompt, int(max_tokens), eos_id, resume_cache,
                         int(resume_pos), on_finish, deadline=deadline,
                         generation_id=generation_id, prompt_dev=prompt_dev,
                         kv_export=kv_export and resume_cache is None,
                         kv_export_on_finish=(
                             kv_export_on_finish and kv_export
                             and resume_cache is None
                             and generation_id is not None))
        if (attach_cache is not None and resume_cache is None
                and 0 < int(attach_pos) <= len(prompt)):
            stream.attach_cache = attach_cache
            stream.attach_pos = int(attach_pos)
        with self._cond:
            self._check_admitting_locked()
            if self._shed_ctl is not None:
                retry_after = self._shed_ctl.on_arrival(
                    time.monotonic(), len(self._pending))
                if retry_after is not None:
                    self._codel_sheds += 1
                    raise TooManyRequests(
                        "admission queue sojourn above target for a full "
                        "control interval ({} waiting generations); retry "
                        "later".format(len(self._pending)),
                        retry_after=retry_after)
            if len(self._pending) >= self._max_pending:
                raise TooManyRequests(
                    "scheduler admission queue is full ({} waiting "
                    "generations); retry later".format(len(self._pending)))
            if generation_id is not None:
                # a reused id supersedes any parked predecessor, and its
                # KV export
                if (self._replay.pop(generation_id, None) is not None
                        and self._kv_discard is not None):
                    self._kv_discard(generation_id)
            self._pending.append(stream)
            self._streams.add(stream)
            self._ensure_running_locked()
            self._cond.notify_all()
        return self._drain(stream)

    def _check_admitting_locked(self):
        """Raise ``ServerUnavailable`` unless new decode work may enter.
        Called with ``_cond`` held."""
        if self._closed:
            raise ServerUnavailable("scheduler is shut down")
        if self._tripped:
            raise ServerUnavailable(
                "decode loop restart budget exhausted; the scheduler is "
                "tripped: drain and restart the server")
        if self._draining:
            raise ServerUnavailable(
                "scheduler is draining; not accepting new generations")

    def resume(self, generation_id, from_seq=0, wait_s=5.0, deadline=None):
        """Continue a parked generation: replays its ``(token,
        logprob)`` history from ``from_seq`` (the first sequence number
        the caller has NOT seen), then, for an interrupted generation,
        splices the live tokens of a continuation admitted again
        (``prompt + history`` prefilled).  Raises
        :class:`~tpuserver_torch.errors.GenerationNotFound` when the id
        was never issued, was already resumed, or aged out of the
        buffer.

        A disconnected stream parks only when the decode loop next reaps
        its cancelled slot, so a fast reconnect can arrive first: while
        the id still names a live stream, resume waits up to ``wait_s``
        for the park.  ``deadline`` is the RESUME request's own
        monotonic bound (None: none); the original request's deadline
        died with its connection.  A completed generation's tail stays
        replayable for the whole TTL; an interrupted one is consumed by
        its first resume."""
        from_seq = int(from_seq)
        wait_deadline = time.monotonic() + float(wait_s)
        discard_export = False
        with self._cond:
            while True:
                if self._closed:
                    raise ServerUnavailable("scheduler is shut down")
                self._sweep_replay_locked(time.monotonic())
                entry = self._replay.pop(generation_id, None)
                if entry is not None:
                    break
                live = any(st.generation_id == generation_id
                           for st in self._streams)
                remaining = wait_deadline - time.monotonic()
                if not live or remaining <= 0:
                    raise GenerationNotFound(
                        "unknown or expired generation id '{}' (replay "
                        "entries live {}s after a disconnect; resume is "
                        "local to one server)".format(
                            generation_id, self._replay_ttl_s))
                self._cond.wait(min(0.05, remaining))
            stream, completed, _ = entry
            if from_seq < 0 or from_seq > len(stream.history):
                # a malformed resume must not destroy the replay state
                self._replay[generation_id] = entry
                raise GenerationNotFound(
                    "resume point {} is beyond generation '{}' ({} tokens "
                    "emitted)".format(from_seq, generation_id,
                                      len(stream.history)))
            replay = list(stream.history[from_seq:])
            if completed:
                self._replay[generation_id] = entry
            else:
                try:
                    # admitting it again is new decode work: the same
                    # gate as submit()
                    self._check_admitting_locked()
                except ServerUnavailable:
                    self._replay[generation_id] = entry
                    raise
                if stream.kv_error is not None:
                    # its export failed when it was reaped: the stream
                    # fails with that error (the replay entry is spent)
                    raise stream.kv_error
                # a fresh queue: the abandoned one may hold tokens the
                # old consumer never took, which the replay re-delivers
                stream.queue = queue.Queue()
                stream.cancelled = False
                stream.finished = False
                stream.deadline = deadline  # the reconnect's own bound
                self._reset_for_readmission(stream)
                if (self._kv_import is not None and stream.kv_export
                        and stream.resume_cache is None):
                    # the reap exported the stream's KV: the admission
                    # scatters it back and feeds one token instead of
                    # prefilling prompt + history.  The import is a copy,
                    # and consumes the export (dropped once _cond is
                    # released); none means the prefill path
                    got = self._kv_import(generation_id)
                    if got is not None:
                        cache, valid = got
                        known = len(stream.prompt) + len(stream.history)
                        if 0 < valid <= known:
                            stream.attach_cache = cache
                            stream.attach_pos = int(valid)
                        discard_export = self._kv_discard is not None
                self._pending.append(stream)
                self._streams.add(stream)
                self._ensure_running_locked()
                self._cond.notify_all()
            self._replay_hits += 1
        if discard_export:
            self._kv_discard(generation_id)

        def gen():
            live = None if completed else self._drain(stream)
            try:
                yield from replay
                if live is not None:
                    yield from live
            finally:
                if live is not None and not stream.finished:
                    # abandoned during the replay prefix: the live
                    # generator's own cancel hook never ran
                    stream.cancelled = True
                    live.close()

        return gen()

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
                # batched steps on tokens nobody will read (a resumable
                # stream then parks in the replay buffer)
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
            supervisor = self._supervisor
        if not already_closed:
            # join once: a second close() must not wait again on a
            # wedged thread
            if thread is not None:
                thread.join(timeout=join_timeout)
            if supervisor is not None:
                supervisor.join(timeout=5)
        with self._cond:
            leftover = list(self._streams)
            self._streams.clear()
            self._pending.clear()
            parked_ids = list(self._replay)
            self._replay.clear()
            self._cond.notify_all()
        if self._kv_discard is not None:
            for gid in parked_ids:
                self._kv_discard(gid)
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
        """False once the scheduler is closed or tripped (its restart
        budget spent); the core's readiness answers report it."""
        with self._cond:
            return not self._closed and not self._tripped

    def stats(self):
        """Live stream, pending and slot counts, lifecycle flags and the
        loop's counters.  ``live_streams`` returning to zero after
        traffic is the no-leaked-slots invariant; ``restarts`` rising is
        the flapping signal."""
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
                "tripped": self._tripped,
                "restarts": self._restarts,
                "quarantined": self._quarantined,
                "replay_entries": len(self._replay),
                "replay_hits": self._replay_hits,
                "codel_sheds": self._codel_sheds,
                "codel_shedding": bool(
                    self._shed_ctl is not None and self._shed_ctl.shedding),
                "admitted": self._admitted_total,
                "tokens": self._tokens_total,
                "steps": self._steps_total,
                "prefix_hits": self._prefix_hits,
                "prefix_misses": self._prefix_misses,
                "attach_admissions": self._attach_admissions,
                "prefill_chunks": self._prefill_chunks,
                "prefix_evictions": self._prefix_evictions,
                "spec_tokens": self._spec_tokens,
                "spec_steps": self._spec_steps,
                "spec_proposed": self._spec_proposed,
                "spec_accepted": self._spec_accepted,
                "spec_rollbacks": self._spec_rollbacks,
                "spec_accept_per_step": (
                    (self._spec_steps + self._spec_accepted)
                    / self._spec_steps if self._spec_steps else 0.0),
                "pages_total": pages_total,
                "pages_free": pages_free,
                "pages_cached": pages_cached,
            }

    # -- supervisor --------------------------------------------------------

    def _ensure_running_locked(self):
        """Start the supervisor if it is not running; it owns the loop
        thread.  Called with ``_cond`` held."""
        if self._supervisor is None or not self._supervisor.is_alive():
            self._supervisor = threading.Thread(
                target=self._supervise, name="decode-supervisor",
                daemon=True)
            self._supervisor.start()

    def _start_loop_locked(self):
        self._epoch += 1
        self._heartbeat = None
        self._loop_error = None
        self._thread = threading.Thread(
            target=self._run, args=(self._epoch,), name="decode-scheduler",
            daemon=True)
        self._thread.start()

    def _beat(self, epoch, now):
        """Stamp (or clear, ``now=None``) this loop's device-call
        heartbeat.  A superseded loop's stamps and clears are dropped, so
        a demoted thread cannot overwrite or erase the live loop's beat.
        Takes ``_cond`` (reentrant: the loop's except hook calls it with
        the lock held)."""
        with self._cond:
            if epoch != self._epoch:
                return
            self._heartbeat = None if now is None else (epoch, now)

    def _hung_locked(self, now):
        hb = self._heartbeat
        return (self._step_timeout_s is not None and hb is not None
                and hb[0] == self._epoch  # a demoted thread's stamp is inert
                and now - hb[1] > self._step_timeout_s)

    def _supervise(self):
        """Own the decode thread: start it, watch for its death or a hung
        device call, and start a new one (live streams admitted again)
        under the restart budget, or trip for good when it is spent."""
        poll = 0.05 if self._step_timeout_s is not None else 0.5
        while True:
            with self._cond:
                if self._closed or self._tripped:
                    return
                if self._thread is None:
                    self._start_loop_locked()
                thread = self._thread
            thread.join(timeout=poll)
            death = None
            with self._cond:
                if self._closed:
                    return
                now = time.monotonic()
                self._sweep_replay_locked(now)
                if self._loop_error is not None:
                    # the loop died; its except hook already moved its
                    # slotted streams back into _pending
                    death = self._loop_error
                    self._loop_error = None
                elif thread.is_alive() and self._hung_locked(now):
                    # a wedged device call: demote the thread (every
                    # delivery it attempts after waking is dropped) and
                    # take its streams back from the registry
                    death = _HungStep(
                        "decode step exceeded step_timeout_s={}s".format(
                            self._step_timeout_s))
                    self._epoch += 1
                    self._heartbeat = None
                    self._thread = None
                    pending = set(self._pending)
                    for st in [s for s in self._streams
                               if s not in pending]:
                        if st.cancelled:
                            self._detach_locked(st)
                        else:
                            self._reset_for_readmission(st)
                            self._pending.appendleft(st)
                if death is None:
                    continue
                _log.warning("decode loop restart: %s", death)
                # the restart budget: a sliding window of restart times
                while (self._recent_restarts
                       and now - self._recent_restarts[0]
                       > RESTART_WINDOW_S):
                    self._recent_restarts.popleft()
                if len(self._recent_restarts) >= self._max_restarts:
                    self._tripped = True
                    to_fail = list(self._streams)
                    self._streams.clear()
                    self._pending.clear()
                    self._cond.notify_all()
                else:
                    to_fail = None
                    self._recent_restarts.append(now)
                    self._restarts += 1
                    backoff = min(self._restart_backoff_s * 2 ** (
                        len(self._recent_restarts) - 1), 2.0)
                    # the FULL backoff elapses (a transient device fault
                    # needs the pause): every submit's or delivery's
                    # notify_all would otherwise cut the wait short and
                    # spend the budget in milliseconds.  Only close()
                    # ends it early
                    backoff_until = now + backoff
                    while not self._closed:
                        remaining = backoff_until - time.monotonic()
                        if remaining <= 0:
                            break
                        self._cond.wait(remaining)
                    if self._closed:
                        return
                    if self._thread is None:
                        self._start_loop_locked()
            if to_fail is not None:
                err = ServerUnavailable(
                    "decode loop restart budget exhausted ({} restarts in "
                    "{}s) after: {}".format(self._max_restarts,
                                            RESTART_WINDOW_S, death))
                for st in to_fail:
                    st.queue.put(("err", err, None))
                return

    def _reset_for_readmission(self, stream):
        """Prepare a salvaged or resumed stream for a fresh admission: the
        next loop prefills ``prompt + history``, so emission continues
        where it stopped (over a parked cache: feeds both as forced
        tokens).  Its paging state belonged to the old loop's pool, a
        pending attach dies with the loop that would have scattered it
        (the prefill path is token-identical), and its speculation
        throttle starts afresh.  Called with ``_cond`` held."""
        stream.pos = 0
        stream.forced.clear()
        stream.enqueued_at = time.monotonic()
        stream.table = None
        stream.radix_nodes = None
        stream.span_pages = 0
        stream.attach_cache = None
        stream.attach_pos = 0
        stream.spec_miss = 0
        stream.spec_skip = 0

    # -- replay buffer -----------------------------------------------------

    def _sweep_replay_locked(self, now):
        for gid in [gid for gid, (_, _, expires) in self._replay.items()
                    if expires <= now]:
            del self._replay[gid]
            if self._kv_discard is not None:
                # an export lives as long as its replay entry
                self._kv_discard(gid)

    def _park_locked(self, stream, completed):
        """Keep a resumable generation's history for a later resume.
        Called with ``_cond`` held."""
        now = time.monotonic()
        self._sweep_replay_locked(now)
        # the prompt's device view reads a region whose pin ends with the
        # request: a later admission uses the host ids
        stream.prompt_dev = None
        if completed:
            # a completed park only replays history: its device state
            # goes now, and so does its export, unless it is a prefill
            # leg's, which a decode-side server attaches after the leg
            # finished (it still dies with the entry)
            stream.resume_cache = None
            stream.on_finish = None
            stream.attach_cache = None
            if (self._kv_discard is not None and stream.kv_export
                    and not stream.kv_export_on_finish):
                self._kv_discard(stream.generation_id)
        self._replay[stream.generation_id] = (stream, completed,
                                              now + self._replay_ttl_s)
        self._replay.move_to_end(stream.generation_id)
        while len(self._replay) > REPLAY_CAPACITY:
            gid, _ = self._replay.popitem(last=False)  # the oldest goes
            if self._kv_discard is not None:
                self._kv_discard(gid)

    def _detach_locked(self, stream):
        """Retire a cancelled stream from the live registry; a resumable
        one parks in the replay buffer.  Called with ``_cond`` held."""
        self._streams.discard(stream)
        if stream.generation_id is not None and not stream.finished:
            self._park_locked(stream, completed=False)
        self._cond.notify_all()

    # -- decode loop -------------------------------------------------------

    def _fail(self, stream, exc, epoch):
        self._deliver(stream, ("err", exc, None), epoch)

    def _deliver(self, stream, event, epoch):
        """Deliver a terminal event and retire the stream from the live
        registry (never call while holding ``_cond``: it takes it).  A
        loop whose epoch was superseded delivers nothing: the new loop
        owns the stream."""
        with self._cond:
            if epoch != self._epoch:
                return
            self._streams.discard(stream)
            if event[0] == "done" and stream.generation_id is not None:
                # a completed generation stays resumable for the TTL, so
                # a client that lost the tail can replay it
                self._park_locked(stream, completed=True)
            self._cond.notify_all()
            # under the lock: a racing watchdog salvage either sees this
            # delivery or runs strictly before it
            stream.queue.put(event)

    def _run(self, epoch):
        slots = [None] * self._max_slots  # slot -> _Stream | None
        try:
            # inference mode and the current device are per thread: the
            # callers' settings do not reach this one, and each
            # restarted loop enters both again
            with torch.inference_mode(), _on_device(self._device):
                self._loop(slots, epoch)
        except Exception as e:  # noqa: BLE001 — loop death is the
            # supervisor's restart (or trip) signal; swallowing it would
            # leave every consumer blocked on its queue
            _log.exception("decode loop failed")
            with self._cond:
                if self._epoch != epoch:
                    return  # demoted: the new loop owns everything
                # without its traceback: that pins the dead loop's frames
                # and with them its page pool
                self._loop_error = e.with_traceback(None)
                self._beat(epoch, None)
                if self._thread is threading.current_thread():
                    # unregister now, under the lock: the supervisor
                    # starts the replacement
                    self._thread = None
                # salvage: slotted streams go back to the FRONT of the
                # queue (they were admitted first), to prefill prompt +
                # history again
                for st in reversed([s for s in slots if s is not None]):
                    if st not in self._streams:
                        continue  # already terminally delivered
                    if st.cancelled:
                        self._detach_locked(st)
                        continue
                    self._reset_for_readmission(st)
                    self._pending.appendleft(st)
                self._cond.notify_all()
                self._ensure_running_locked()

    def _loop(self, slots, epoch):
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
        # speculation: the drafter reads the radix tree (when there is
        # one) and each stream's own context, read-only.  Its first
        # proposal predicts the step's own next token, which the verify
        # computes exactly, so it drafts spec_k + 1 and the first drops
        spec_k = self._spec_tokens
        drafter = (NgramDrafter(radix, max_draft=spec_k + 1)
                   if spec_k > 0 else None)

        def beat(kind, headroom=1):
            """Stamp the heartbeat for a device call of ``kind`` that may
            take ``headroom`` times ``step_timeout_s`` (a future-dated
            stamp gives the watchdog's deadline that headroom).  A kind
            with no completed call yet runs unwatched."""
            with self._cond:
                if kind not in self._warm:
                    self._beat(epoch, None)
                    return
            now = time.monotonic()
            if self._step_timeout_s is not None and headroom > 1:
                now += (headroom - 1) * self._step_timeout_s
            self._beat(epoch, now)

        def done(kind):
            """Clear the heartbeat after a device call of ``kind``
            completed; later calls of that kind are watched."""
            with self._cond:
                self._warm.add(kind)
                self._beat(epoch, None)

        def superseded():
            """True once a watchdog demotion replaced this loop: a thread
            waking from a hung call must not touch stream state the next
            loop owns (its own pool, tables and tasks die with it)."""
            with self._cond:
                return self._epoch != epoch

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
            if superseded():
                # the stream may already be admitted by the next loop,
                # with paging state of ITS pool
                return
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
            if (insert and radix is not None
                    and stream.resume_cache is None):
                # tokens fed so far; rejected speculative writes past
                # stream.pos are never donated
                known = ([int(t) for t in stream.prompt]
                         + [t for t, _ in stream.history])
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

        def export_kv(stream):
            """Export a stream's gathered KV through the ``kv_export``
            hook (the server keeps it as a CUDA region keyed by the
            generation id), valid up to ``prompt + history``: every write
            of a dispatched but unfetched step lies beyond it.  Runs
            before ``release_pages``: the gather copies the pool as it is
            now, so later page reuse cannot touch the export.  A failed
            export (a typed error, such as a CUDA allocation failure) is
            kept on the stream: its resume fails with it."""
            if (self._kv_export is None or not stream.kv_export
                    or stream.generation_id is None
                    or stream.resume_cache is not None
                    or stream.table is None):
                return
            valid = len(stream.prompt) + len(stream.history)
            parked = fns["gather"](pages, stream.table)
            try:
                self._kv_export(stream.generation_id, parked, valid)
            except TorchServeError as e:
                stream.kv_error = e

        def complete_admission(slot, stream, full):
            """Post-admit bookkeeping: donate the prompt's full pages to
            the radix tree now (pinned: siblings admitted next iteration
            already share them), publish the page table, count the
            admission."""
            if superseded():
                return
            if (radix is not None and full is not None
                    and stream.resume_cache is None):
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
            if self._queue_hist is not None:
                self._queue_hist.observe(
                    time.monotonic() - stream.enqueued_at)

        def reserve(span_pages):
            """``span_pages`` fresh pages (evicting cached ones when
            needed), or None when the pool cannot give them."""
            owned = alloc.alloc(span_pages)
            if owned is None and radix is not None:
                freed = radix.evict(span_pages - alloc.free_count)
                self._prefix_evictions += len(freed)
                alloc.free(freed)
                owned = alloc.alloc(span_pages)
            return owned

        def attach_admission(slot, stream):
            """Admit over an attached KV export: it scatters into a fresh
            page span, and the last token of its valid prefix feeds
            again (rewriting its own K/V with the same values) to
            regenerate the logits.  No prefill runs."""
            nonlocal pages, logits
            known = [int(t) for t in stream.prompt] + [
                t for t, _ in stream.history]
            start = stream.attach_pos - 1
            span_pages = pages_for(len(stream.prompt) + stream.max_tokens,
                                   page)
            stream.radix_nodes = []
            owned = reserve(span_pages)
            if owned is None:
                self._fail(stream, TooManyRequests(
                    "kv page pool exhausted: an attach needs {} pages but "
                    "only {} are free; retry later".format(
                        span_pages, alloc.free_count)), epoch)
                clear_slot(slot)
                return
            table = np.full((ppseq,), n_pages, np.int32)
            table[:span_pages] = owned
            stream.table = table
            stream.span_pages = span_pages
            beat("admit", headroom=10)
            attach_cache, stream.attach_cache = stream.attach_cache, None
            stream.forced.extend(known[start:])
            stream.pos = start
            pages, logits = fns["admit"](
                pages, logits, attach_cache,
                logits.new_zeros((1, logits.shape[1])), table, slot)
            done("admit")
            self._attach_admissions += 1
            complete_admission(slot, stream, None)

        def start_admission(slot, stream):
            """Reserve the stream's page span and run (or begin) its
            prefill of ``prompt + history``, or scatter a parked cache
            or an attached export instead.  The slot is already reserved
            in ``slots``; on a shed or a per-request fault it is cleared
            here."""
            nonlocal pages, logits
            try:
                if superseded():
                    return  # the remaining admissions are the next loop's
                fault_points.trip("scheduler.admit", self.fault_scope)
                # a step snapshot of an earlier admission becomes inert
                stream.incarnation += 1
                if stream.attach_cache is not None:
                    attach_admission(slot, stream)
                    return
                replayed = [t for t, _ in stream.history]
                start = (stream.resume_pos
                         if stream.resume_cache is not None else 0)
                full = (np.concatenate([stream.prompt,
                                        np.asarray(replayed, np.int32)])
                        if replayed else stream.prompt)
                prefill_len = start + len(full)
                # the whole potential span reserves up front, so decode
                # never runs out of pages mid-generation: exhaustion is a
                # typed admission-time shed
                span_pages = pages_for(
                    start + len(stream.prompt) + stream.max_tokens, page)
                matched_nodes = []
                shared_pages = 0
                if radix is not None and stream.resume_cache is None:
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
                owned = reserve(needed)
                if owned is None:
                    release_pages(stream, insert=False)  # unpin only
                    self._fail(stream, TooManyRequests(
                        "kv page pool exhausted: admission needs {} pages "
                        "but only {} are free and every cached page is "
                        "pinned by a live stream; retry later".format(
                            needed, alloc.free_count)), epoch)
                    clear_slot(slot)
                    return
                # counted once the reservation succeeded: a shed admission
                # served nothing and prefilled nothing
                if stream.resume_cache is None:
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
                # admission prefills are watchdogged with ten times the
                # step's headroom: a new length pays cuBLAS's heuristics
                beat("admit", headroom=10)
                if stream.resume_cache is not None:
                    # a parked cache: it scatters into the reserved pages
                    # (only read: the region's copy stays valid for the
                    # next resume) and the prompt (and history, after a
                    # restart) feeds as forced tokens
                    stream.forced.extend(int(t) for t in stream.prompt)
                    stream.forced.extend(replayed)
                    stream.pos = start
                    pages, logits = fns["admit"](
                        pages, logits, stream.resume_cache,
                        logits.new_zeros((1, logits.shape[1])), table, slot)
                    done("admit")
                    complete_admission(slot, stream, None)
                    return
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
                    if stream.prompt_dev is not None and not replayed:
                        # the prompt is a view of a region's device
                        # memory: it is padded on the device, so the
                        # prefill's ids never pass through the host
                        padded = torch.zeros(
                            (1, bucket), dtype=torch.int64,
                            device=stream.prompt_dev.device)
                        padded[0, :suffix_len] = stream.prompt_dev
                    else:
                        padded = np.zeros((1, bucket), np.int32)
                        padded[0, :suffix_len] = suffix
                    slot_cache = fns["init_slot_cache"]()
                    slot_logits, slot_cache = fns["prefill"](
                        self._params, slot_cache, padded, suffix_len)
                if superseded():
                    return  # demoted mid-call: mutate nothing
                stream.pos = prefill_len
                pages, logits = fns["admit"](
                    pages, logits, slot_cache, slot_logits, dest, slot)
                done("admit")
                complete_admission(slot, stream, full)
            except Exception as e:  # noqa: BLE001 — per-request fault
                release_pages(stream, insert=False)
                self._fail(stream, e, epoch)
                clear_slot(slot)
            finally:
                self._beat(epoch, None)

        def run_prefill_chunk():
            """One chunk of the oldest in-progress chunked prefill: a
            single bounded call between decode steps, so co-batched
            streams keep emitting."""
            nonlocal pages, logits
            slot, task = next(iter(prefilling.items()))
            stream = task.stream
            n = min(task.chunk, task.total - task.done)
            rel = task.logits_at - task.done
            rel = rel if 0 <= rel < n else 0
            beat("admit", headroom=10)
            try:
                chunk_logits, task.slot_cache = fns["prefill_span"](
                    self._params, task.slot_cache,
                    task.padded[None, task.done:task.done + n],
                    task.start + task.done, rel)
                if superseded():
                    return
                done("admit")
                self._prefill_chunks += 1
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
                self._fail(stream, e, epoch)
                clear_slot(slot)
            finally:
                self._beat(epoch, None)

        def dispatch_step(kind, call):
            """The one ``scheduler.step`` site: trip the point, run the
            step dispatch ``call(logits)`` under the heartbeat of
            ``kind`` and observe its time.  A ``nan`` action poisons one
            slot's logits row (the quarantine path); a ``hang`` stalls
            inside the heartbeat window, where the watchdog sees it."""
            nonlocal logits
            action = fault_points.trip("scheduler.step", self.fault_scope)
            if action is not None and action[0] == "nan":
                logits[min(max(0, action[1]), self._max_slots - 1)] = \
                    float("nan")
            start = time.monotonic()
            beat(kind)
            if action is not None and action[0] == "hang":
                time.sleep(action[1])
            out = call(logits)
            if self._step_hist is not None:
                self._step_hist.observe(time.monotonic() - start)
            return out

        def fetch_chaos():
            """The one ``scheduler.fetch`` site: before a step's
            device-to-host token copy, on either path."""
            fault_points.trip("scheduler.fetch", self.fault_scope)

        def finish(stream, slot):
            if stream.on_finish is not None:
                # the park: a gather and a copy into the region, watched
                # like an admission
                beat("admit", headroom=10)
                try:
                    parked = fns["gather"](pages, stream.table)
                    if superseded():
                        return  # never park over the next loop's park
                    stream.on_finish(parked)
                except Exception as e:  # noqa: BLE001 — the park is the
                    # stream's own: it fails, co-batched streams go on
                    self._fail(stream, e, epoch)
                    release_pages(stream)
                    clear_slot(slot)
                    return
                finally:
                    self._beat(epoch, None)
            if stream.kv_export_on_finish:
                # a prefill leg: its KV (prompt and the one emitted token)
                # exports before the pages free, for a decode-side server
                # to attach instead of prefilling
                export_kv(stream)
                if stream.kv_error is not None:
                    release_pages(stream)
                    self._fail(stream, stream.kv_error, epoch)
                    clear_slot(slot)
                    return
            release_pages(stream)
            self._deliver(stream, ("done", None, None), epoch)
            clear_slot(slot)

        def quarantine(poisoned):
            for st in poisoned:
                self._fail(st, SlotPoisoned(
                    "generation produced non-finite logits after {} "
                    "emitted tokens; its slot was quarantined (co-batched "
                    "generations are unaffected)".format(st.emitted)),
                    epoch)

        def step_inputs(active_ids):
            """Sentinel-filled positions (inert rows write to the trash
            page), the active mask, and the forced tokens and their mask
            of one batched step (a row with forced tokens left feeds the
            next one instead of its greedy pick)."""
            positions = np.full((self._max_slots,), self._max_seq, np.int32)
            active = np.zeros((self._max_slots,), bool)
            forced = np.zeros((self._max_slots,), np.int32)
            forced_mask = np.zeros((self._max_slots,), bool)
            for i in active_ids:
                st = slots[i]
                positions[i] = st.pos
                active[i] = True
                if st.forced:
                    forced[i] = st.forced.popleft()
                    forced_mask[i] = True
            return positions, active, forced, forced_mask

        def draft_for(st):
            """This step's draft of ``st`` (a list, maybe empty), under
            the throttle and the emission budget: the base token and
            every accepted draft must fit in max_tokens, which also
            keeps rejected writes inside the reserved span."""
            if st.spec_skip > 0:
                st.spec_skip -= 1  # throttled: this step drafts nothing
                return []
            budget = min(spec_k, st.max_tokens - st.emitted - 1)
            if budget <= 0:
                return []
            ctx = [int(t) for t in st.prompt]
            ctx.extend(t for t, _ in st.history)
            return drafter.draft(ctx, budget + 1)[1:]

        def spec_iteration(active_ids):
            """One speculative step: draft, verify all slots in one call
            (a plain step when nobody drafted), fetch at once and keep
            each row's accepted prefix plus its base token.  A row's
            advance depends on this step's acceptance, so the one-deep
            pipeline cannot run here: dispatch and fetch share the
            iteration."""
            nonlocal pages, logits
            positions, active, forced, forced_mask = step_inputs(active_ids)
            draft = np.zeros((self._max_slots, spec_k), np.int32)
            draft_len = np.zeros((self._max_slots,), np.int32)
            snapshot = []
            for i in active_ids:
                st = slots[i]
                # a forced feed drafts nothing
                d = [] if forced_mask[i] else draft_for(st)
                draft[i, :len(d)] = d
                draft_len[i] = len(d)
                snapshot.append((i, st, st.incarnation, len(d),
                                 bool(forced_mask[i])))
            # the verify chain runs to this step's longest draft: deeper
            # sub-steps would have every row inert.  Nobody drafted: a
            # plain step is bitwise the same for the one token
            width = int(draft_len.max())
            kind = "spec_step" if width else "step"
            if width:
                toks_dev, lps_dev, acc_dev, logits, pages = dispatch_step(
                    kind, lambda lg: fns["spec_step"](
                        self._params, pages, lg, tables, positions, active,
                        forced, forced_mask, draft[:, :width], draft_len))
            else:
                toks_dev, lps_dev, logits, pages = dispatch_step(
                    kind, lambda lg: fns["step"](
                        self._params, pages, lg, tables, positions, active,
                        forced, forced_mask))
                acc_dev = None
            self._steps_total += 1
            fetch_chaos()
            beat(kind)
            toks = np.asarray(toks_dev).reshape(self._max_slots, -1)
            lps = np.asarray(lps_dev).reshape(self._max_slots, -1)
            accs = (np.asarray(acc_dev) if acc_dev is not None
                    else np.zeros((self._max_slots,), np.int32))
            done(kind)
            poisoned, finished = [], []
            with self._cond:
                if self._epoch != epoch:
                    return False  # demoted mid-fetch: deliver nothing
                for i, st, inc, k_i, was_forced in snapshot:
                    if slots[i] is not st or st.incarnation != inc:
                        continue
                    if st.cancelled:
                        export_kv(st)
                        release_pages(st)
                        self._detach_locked(st)
                        clear_slot(i)
                        continue
                    if was_forced:
                        st.pos += 1
                        continue  # a forced feed emits nothing
                    a = min(int(accs[i]), k_i)
                    if k_i:
                        self._spec_steps += 1
                        self._spec_proposed += k_i
                        self._spec_accepted += a
                        if a < k_i:
                            self._spec_rollbacks += 1
                        if a > 0:
                            st.spec_miss = 0
                        else:
                            st.spec_miss += k_i
                            if st.spec_miss >= self._spec_throttle_after:
                                st.spec_skip = self._spec_probe_interval
                    fed, bad, hit_eos = 0, False, False
                    for j in range(min(1 + a, st.max_tokens - st.emitted)):
                        tok, lp = int(toks[i, j]), float(lps[i, j])
                        if not np.isfinite(lp):
                            bad = True
                            break
                        st.history.append((tok, lp))
                        st.queue.put(("tok", tok, lp))
                        st.emitted += 1
                        self._tokens_total += 1
                        fed += 1
                        if st.eos_id is not None and tok == st.eos_id:
                            hit_eos = True
                            break
                    if bad:
                        # this row's own logits went non-finite; the
                        # step is row-independent, so only it retires,
                        # and its KV is not cached
                        poisoned.append(st)
                        release_pages(st, insert=False)
                        clear_slot(i)
                        continue
                    # the rollback of rejected drafts is this cursor move:
                    # the next step writes over them
                    st.pos += fed
                    if st.emitted >= st.max_tokens or hit_eos:
                        finished.append((st, i))
                self._quarantined += len(poisoned)
            quarantine(poisoned)
            for st, i in finished:
                finish(st, i)
            return True

        while True:
            expired = []
            with self._cond:
                if self._epoch != epoch:
                    return  # superseded by a watchdog restart
                while (not self._closed and not self._draining
                       and not self._pending and inflight is None
                       and not any(s is not None for s in slots)):
                    self._cond.wait()
                    if self._epoch != epoch:
                        return
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
                # pages donate to the radix cache; resumable streams
                # park)
                for i, st in enumerate(slots):
                    if st is not None and st.cancelled:
                        prefilling.pop(i, None)
                        if ready[i]:
                            # export before the pages free: the resume
                            # attaches it
                            export_kv(st)
                        release_pages(st)
                        self._detach_locked(st)
                        clear_slot(i)
                # deadline sweep: a pending request past its deadline
                # fails before prefill; an in-flight one retires
                # mid-generation, its slot and pages freeing at once
                now = time.monotonic()
                if self._shed_ctl is not None:
                    # the controller's sojourn signal: the head stream's
                    # wait is the FIFO maximum.  Noted inside this held
                    # region: no new lock acquisition
                    self._shed_ctl.note_sojourn(
                        (now - self._pending[0].enqueued_at)
                        if self._pending else 0.0, now)
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
                    # reserve now, under the lock: the cancel reap and the
                    # watchdog salvage must see prefilling streams as
                    # slotted
                    slots[slot] = st
                    admissions.append((slot, st))
            # failures deliver outside the lock (delivery takes it)
            for st in expired:
                self._fail(st, RequestTimedOut(
                    "request deadline exceeded after {} emitted "
                    "tokens".format(st.emitted)), epoch)
            # device work runs outside the lock: submitters enqueue while
            # the card computes
            for slot, stream in admissions:
                start_admission(slot, stream)
            if prefilling:
                # one bounded chunk per iteration: long prompts trickle
                # in while decode keeps stepping
                run_prefill_chunk()
            if (admissions or prefilling) and superseded():
                return  # demoted during an admission: step nothing

            active_ids = [i for i, s in enumerate(slots)
                          if s is not None and ready[i]]
            if spec_k > 0:
                if active_ids and not spec_iteration(active_ids):
                    return
                continue

            current = None
            if active_ids:
                positions, active, forced, forced_mask = step_inputs(
                    active_ids)
                snapshot = []
                for i in active_ids:
                    st = slots[i]
                    snapshot.append((i, st, st.incarnation,
                                     bool(forced_mask[i])))
                    st.pos += 1
                tokens_dev, logps_dev, logits, pages = dispatch_step(
                    "step", lambda lg: fns["step"](
                        self._params, pages, lg, tables, positions, active,
                        forced, forced_mask))
                self._beat(epoch, None)
                self._steps_total += 1
                current = (tokens_dev, logps_dev, snapshot)

            if inflight is not None:
                tokens_dev, logps_dev, snapshot = inflight
                fetch_chaos()
                beat("step")
                toks = np.asarray(tokens_dev)
                lps = np.asarray(logps_dev)
                done("step")
                poisoned = []
                finished = []
                with self._cond:
                    if self._epoch != epoch:
                        return  # demoted mid-fetch: deliver nothing
                    for i, st, inc, was_forced in snapshot:
                        if slots[i] is not st or st.incarnation != inc:
                            # the slot retired (and maybe re-admitted)
                            # after this step was dispatched: its token is
                            # the pipeline's wasted extra
                            continue
                        if st.cancelled:
                            # consumer gone: export (a resume attaches
                            # it), free the pages, park
                            export_kv(st)
                            release_pages(st)
                            self._detach_locked(st)
                            clear_slot(i)
                            continue
                        if was_forced:
                            continue  # a forced feed emits nothing
                        tok = int(toks[i])
                        lp = float(lps[i])
                        if not np.isfinite(lp):
                            # this slot's own logits went non-finite; the
                            # step's math is row-independent, so only the
                            # offender retires, and its KV is not cached
                            poisoned.append(st)
                            release_pages(st, insert=False)
                            clear_slot(i)
                            continue
                        if st.emitted < st.max_tokens:
                            st.history.append((tok, lp))
                            st.queue.put(("tok", tok, lp))
                            st.emitted += 1
                            self._tokens_total += 1
                        if st.emitted >= st.max_tokens or (
                                st.eos_id is not None and tok == st.eos_id):
                            finished.append((st, i))
                    self._quarantined += len(poisoned)
                quarantine(poisoned)
                for st, i in finished:
                    finish(st, i)
            inflight = current

        # closed: fail whatever is still queued or running
        err = ServerUnavailable("scheduler is shut down")
        for st in slots:
            if st is not None:
                self._fail(st, err, epoch)
        for st in pending:
            self._fail(st, err, epoch)
