"""Decoupled llama generation serving model (the port of
``tpuserver/models/llama_serving.py``).

One request carries the prompt ids and streams one response per token.

- ``mesh=``: tensor-parallel serving over a mesh's ``tp`` axis
  (``tpuserver_torch.parallel.make_mesh``), on the mesh's driver while
  the other ranks run ``tpuserver_torch.parallel.follow``: the weights
  Megatron-split (``llama.tp_params``: each rank draws every leaf from
  the seed and keeps its slice), the KV cache kv-head-sharded, both
  paths (``llama.make_tp_serving``/``make_tp_step``, and
  ``make_scheduler_fns(mesh=)``).  A parked or exported cache takes the
  full ``[L, 2, 1, max_seq, Hkv, D]`` layout (the kv heads gathered to
  the driver), so any tp degree attaches it.
- ``quantize=True``: int8 weights with per-output-channel scales
  (``llama.quantize_params``), about half the bytes of bf16; a product
  over few rows runs the W8A16 kernel, a prompt's the w8a8 product
  (``tpuserver_torch.ops.quant``).  The KV cache stays in ``cfg.dtype``.
- ``max_slots=1``: the single-stream path.  The model prefills a fresh
  KV cache in one batched pass (through the flash kernel at lengths
  ``llama._flash_blocks`` tiles), then greedy-decodes in chunks of
  ``decode_chunk`` tokens (each token's attention through the decode
  kernel).  A chunk runs on the card without a host sync; its tokens are
  fetched once at its end.  One generation at a time holds the card.
- ``max_slots>1``: continuous batching.  A ``DecodeScheduler`` runs one
  batched decode step for up to ``max_slots`` concurrent generations
  over a paged KV pool (``llama.make_scheduler_fns``), admitting waiting
  requests mid-flight into freed slots, optionally verifying drafted
  tokens (``spec_tokens``), under a supervisor that restarts a failed or
  hung decode loop.  Each response carries its ``generation_id`` and
  0-based ``seq`` as response parameters, and a request with
  ``resume_generation_id`` (and ``resume_from_seq``, the first ``seq``
  not yet seen) continues a parked generation.  The model is then
  ``concurrent_decoupled``: a gRPC stream runs its requests side by
  side.  ``target_queue_ms``/``shed_interval_ms`` turn on the
  scheduler's sojourn-time shedding, ``fault_scope`` names it at the
  fault points, and the scheduler's latency histograms go into the
  attached server's ``metrics`` registry (register the model before
  ``warmup`` builds the scheduler).

The shared-memory data plane (the server attaches itself when the model
is registered):

- ``PROMPT_IDS`` read from a CUDA-shm region arrives as a view of the
  region's device memory, which the prefill consumes with no host copy
  (the batched path reads the ids once more for its bookkeeping).
- ``shm_ring_region``/``shm_ring_slots`` (``shm_ring_offset``, optional
  ``shm_ring_seq_base``): each step's TOKEN and LOGPROB land in an 8-byte
  ring slot of the region, and the event carries only its descriptor
  (and the tensors too when seq-guarded, see ``tpuserver_torch.shm_ring``).
- ``kv_cache_region`` parks the finished KV cache in a registered CUDA
  region; ``kv_cache_resume`` with ``kv_cache_position`` continues from
  it without a prefill, on either path.
- ``kv_park`` (default: the model's ``kv_export``): a disconnected
  generation's KV becomes the server-owned region
  ``kvexport/<generation_id>``, and its resume attaches it instead of
  prefilling ``prompt + history``.  ``kv_phase=prefill`` exports the KV
  of a finished prefill leg; ``kv_attach=<descriptor>`` (from
  ``/v2/kvexport/<generation_id>`` of this or another server process)
  admits a decode leg over it.
- Every region a request references is pinned for the stream's life:
  unregistering it is a typed 409.
"""

import json
import threading
import uuid

import numpy as np
import torch

from tpuserver_torch import cuda_shared_memory as csm
from tpuserver_torch import resolve_device, shm_ring
from tpuserver_torch.core import RESPONSE_PARAMS_KEY, Model, TensorSpec
from tpuserver_torch.errors import (
    BadRequest,
    GenerationNotFound,
    KvExportMissing,
)
from tpuserver_torch.models import llama
from tpuserver_torch.ops import _build, quant
from tpuserver_torch.parallel import spmd
from tpuserver_torch.parallel.mesh import mesh_state
from tpuserver_torch.scheduler import DecodeScheduler


class LlamaGenerateModel(Model):
    """PROMPT_IDS int32[-1], MAX_TOKENS int32[1] -> stream of
    (TOKEN int32[1], LOGPROB fp32[1]) responses."""

    name = "llama_generate"
    platform = "pytorch"
    backend = "pytorch"
    max_batch_size = 0
    decoupled = True
    inputs = (
        TensorSpec("PROMPT_IDS", "INT32", [-1]),
        TensorSpec("MAX_TOKENS", "INT32", [1]),
    )
    outputs = (
        TensorSpec("TOKEN", "INT32", [1]),
        TensorSpec("LOGPROB", "FP32", [1]),
    )

    # tokens greedy-decoded between host syncs
    decode_chunk = 8

    def __init__(self, cfg=None, max_seq=512, decode_chunk=None,
                 max_slots=1, params=None, seed=0, device=None,
                 page_size=16, kv_pages=None, spec_tokens=0,
                 step_timeout_s=None, kv_export=False, target_queue_ms=None,
                 shed_interval_ms=100.0, fault_scope=None, quantize=False,
                 mesh=None, max_restarts=5, restart_backoff_s=0.05,
                 prefill_chunk_tokens=256, prefix_cache=True):
        """``params``: weights to serve (a params dict of tensors, e.g.
        from ``llama.params_from_jax``, or another model's, which is then
        shared, not copied), moved to ``device``; None draws random ones
        from ``seed`` at the first request.  ``device`` defaults to the
        card (see ``tpuserver_torch.resolve_device``).

        ``quantize`` serves int8 weights: random ones are drawn and then
        quantized layer by layer on the device (the peak stays near the
        bf16 tree's size); given ``params`` that are not quantized yet are
        quantized into a new tree, and quantized ones are served as they
        are.

        ``max_slots>1`` serves through a ``DecodeScheduler``;
        ``page_size`` and ``kv_pages`` set its KV pool (default: room for
        ``max_slots`` full-length sequences), ``spec_tokens`` its drafted
        tokens per step, ``step_timeout_s`` its watchdog, and
        ``max_restarts`` and ``restart_backoff_s`` its restart budget per
        ``scheduler.RESTART_WINDOW_S`` and the backoff's base (see
        ``DecodeScheduler``).  ``prefill_chunk_tokens`` (None: off) and
        ``prefix_cache`` set its chunked prefill and its radix prefix
        cache, both only where ``make_scheduler_fns`` says span prefill
        keeps the kernel choice (``span_safe``); ``max_slots=1`` ignores
        them.  ``kv_export`` is the default of the
        ``kv_park`` request parameter.  ``target_queue_ms`` (None: off)
        and ``shed_interval_ms`` set the scheduler's adaptive shedding,
        ``fault_scope`` its scope at the fault points.

        ``mesh`` serves tensor-parallel over its ``tp`` axis (a mesh
        without one raises ValueError); the device is the mesh's
        (``device``, when given, must be of its kind).  ``params`` are then
        the full weights, sharded at first use, or this mesh's sharded
        params (another TP model's, shared)."""
        self._mesh = mesh
        if mesh is not None:
            names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
            if "tp" not in names:
                raise ValueError(
                    "llama serving mesh needs a 'tp' axis (got {})".format(
                        names))
            self._device = mesh_state(mesh).device
            if device is not None and \
                    resolve_device(device).type != self._device.type:
                raise ValueError("device {} is not the mesh's ({})".format(
                    device, self._device))
        else:
            self._device = resolve_device(device)
        self.device_kind = "gpu" if self._device.type == "cuda" else "cpu"
        if max_slots < 1:
            raise ValueError("max_slots must be >= 1 (got {})".format(
                max_slots))
        self._max_slots = int(max_slots)
        # the scheduler runs concurrent generations: a gRPC stream runs
        # its requests to this model side by side, not in order
        self.concurrent_decoupled = self._max_slots > 1
        self._cfg = cfg or llama.tiny(vocab=2048)
        self._max_seq = int(max_seq)
        self._seed = seed
        self._quantize = bool(quantize)
        if decode_chunk is not None:
            if decode_chunk < 1:
                raise ValueError(
                    "decode_chunk must be >= 1 (got {})".format(decode_chunk))
            self.decode_chunk = decode_chunk
        # full weights of a mesh model, sharded at first use
        self._unsharded = None
        if params is not None and mesh is not None and not \
                spmd.mirror(mesh).owns(_first_leaf(params)):
            self._unsharded, params = params, None
        elif params is not None and mesh is None:
            params = _to_device(params, self._device)
            if self._quantize and not quant.is_quantized(params["lm_head"]):
                params = llama.quantize_params(params)
        self._params = params
        # the scheduler's bundle (stateless; built here so a bad page
        # geometry fails at construction) and the scheduler, built at
        # first use
        self._fns = (llama.make_scheduler_fns(
            self._cfg, self._max_seq, self._max_slots, page_size=page_size,
            kv_pages=kv_pages, device=self._device, mesh=mesh)
            if self._max_slots > 1 else None)
        self._tp = None
        if mesh is not None and self._max_slots == 1:
            init_cache, prefill_fn, chunk_fn = llama.make_tp_serving(
                mesh, self._cfg, chunk=self.decode_chunk)
            self._tp = {"init_cache": init_cache, "prefill": prefill_fn,
                        "chunk": chunk_fn,
                        "step": llama.make_tp_step(mesh, self._cfg)}
        self._spec_tokens = spec_tokens
        self._step_timeout_s = step_timeout_s
        self._max_restarts = max_restarts
        self._restart_backoff_s = restart_backoff_s
        self._prefill_chunk_tokens = prefill_chunk_tokens
        self._prefix_cache = prefix_cache
        self._kv_export = bool(kv_export)
        self._target_queue_ms = target_queue_ms
        self._shed_interval_ms = shed_interval_ms
        self._fault_scope = fault_scope
        self._scheduler = None
        # the InferenceServer whose shared-memory regions and KV exports
        # requests reference (attach_server)
        self._server = None
        # max_slots=1: one generation at a time (each holds a full-length
        # KV cache); max_slots>1: guards building the scheduler
        self._lock = threading.Lock()

    def attach_server(self, server):
        """Called by ``InferenceServer.register_model``."""
        self._server = server

    def _ensure_params(self):
        if self._params is None and self._mesh is not None:
            self._params = llama.tp_params(
                self._mesh, self._cfg, params=self._unsharded,
                seed=self._seed, quantize=self._quantize)
            self._unsharded = None
        elif self._params is None:
            gen = torch.Generator(device=self._device).manual_seed(self._seed)
            params = llama.init_params(self._cfg, gen, self._device)
            if self._quantize:
                params = _quantize_on_load(params)
            self._params = params
        return self._params

    def _ensure_scheduler(self):
        """The continuous-batching scheduler, built at first use (and
        anew after ``close``)."""
        with self._lock:
            if self._scheduler is None:
                self._scheduler = DecodeScheduler(
                    self._fns, self._ensure_params(), self._max_slots,
                    self._max_seq, spec_tokens=self._spec_tokens,
                    step_timeout_s=self._step_timeout_s,
                    max_restarts=self._max_restarts,
                    restart_backoff_s=self._restart_backoff_s,
                    prefill_chunk_tokens=self._prefill_chunk_tokens,
                    prefix_cache=self._prefix_cache,
                    kv_export=self._export_kv, kv_import=self._import_kv,
                    kv_discard=self._discard_kv,
                    target_queue_ms=self._target_queue_ms,
                    shed_interval_ms=self._shed_interval_ms,
                    fault_scope=self._fault_scope,
                    # the queue-wait and step histograms land in the
                    # attached server's /metrics registry
                    metrics=getattr(self._server, "metrics", None),
                    metric_labels={"model": self.name})
            return self._scheduler

    # the scheduler's KV hooks, resolved against the server attached when
    # they run (a model warmed up before its registration gets them too)

    def _export_kv(self, generation_id, cache, position):
        if self._server is not None:
            self._server.export_kv_region(
                generation_id, self._park_cache(cache), position)

    def _import_kv(self, generation_id):
        if self._server is None:
            return None
        return self._server.import_kv_region(generation_id)

    def _discard_kv(self, generation_id):
        if self._server is not None:
            self._server.drop_kv_region(generation_id)

    def warmup(self):
        """Draw the weights, build the scheduler and, on the card, build
        and load the kernel library, so the first request pays none of
        them."""
        with self._lock:
            self._ensure_params()
        if self._device.type == "cuda":
            _build.load_library()
        if self._max_slots > 1:
            self._ensure_scheduler()

    # -- the shared-memory data plane --------------------------------------

    def _require_server(self, what):
        if self._server is None:
            raise BadRequest(
                "model '{}' has no server attached; {} requires a "
                "registered shared-memory region".format(self.name, what))
        return self._server

    def _kv_region(self, request):
        name = request.parameters.get("kv_cache_region")
        if not name:
            return None
        return self._require_server("kv_cache_region").cuda_shm_region(name)

    @staticmethod
    def _resume_state(request, region):
        """(parked cache view or None, resume position) for a
        ``kv_cache_resume`` request, on either path."""
        if region is None or not request.parameters.get("kv_cache_resume"):
            return None, 0
        parked = region.parked_tensor(0)
        if parked is None:
            return None, 0
        if "kv_cache_position" not in request.parameters:
            raise ValueError(
                "kv_cache_resume requires kv_cache_position (the sequence "
                "position the parked cache was left at)")
        return parked, int(request.parameters["kv_cache_position"])

    def _ring_writer(self, request):
        """``(region name, write, seq_guarded)`` for a request with a
        token-ring descriptor (``shm_ring_region`` and ``shm_ring_slots``,
        optional ``shm_ring_offset`` base), or None.  ``write(seq, token,
        logprob)`` lands the step in slot ``seq % slots`` through the
        server's bounds-checked writes and returns the slot's byte offset,
        which the event carries instead of the tensors; the write has
        reached the region's memory when it returns, so the event naming
        the slot never leaves before its payload.

        ``shm_ring_seq_base`` brackets every payload write with a begin
        and a commit seq word (``tpuserver_torch.shm_ring``) at that base,
        and the events then carry the tensors too: the payload a reader
        that finds a torn slot falls back to."""
        name = request.parameters.get("shm_ring_region")
        if not name:
            return None
        server = self._require_server("shm_ring_region")
        slots = int(request.parameters.get("shm_ring_slots") or 0)
        if slots < 1:
            raise ValueError(
                "shm_ring_region requires shm_ring_slots >= 1 (the ring "
                "geometry travels with the request)")
        base = int(request.parameters.get("shm_ring_offset") or 0)
        slot_bytes = server.SHM_RING_SLOT_BYTES
        seq_base = request.parameters.get("shm_ring_seq_base")

        if seq_base is None:
            def write(seq, token, logprob):
                off = base + (seq % slots) * slot_bytes
                server.write_shm_ring_slot(name, off, token, logprob)
                return off

            return name, write, False

        seq_base = int(seq_base)

        def write(seq, token, logprob):
            off = base + (seq % slots) * slot_bytes
            word_off = shm_ring.seq_word_offset(seq, slots, seq_base)
            server.write_shm_ring_seq_word(name, word_off,
                                           shm_ring.begin_word(seq))
            server.write_shm_ring_slot(name, off, token, logprob)
            server.write_shm_ring_seq_word(name, word_off,
                                           shm_ring.commit_word(seq))
            return off

        return name, write, True

    @staticmethod
    def _emit_token(token, logprob, seq, ring_write, seq_guarded=False,
                    params=None):
        """One decoupled response: TOKEN/LOGPROB in-band, or on the token
        ring only the slot's descriptor (with the tensors too when the
        ring is seq-guarded).  ``params`` are response parameters to
        carry (the batched path's ``generation_id`` and ``seq``)."""
        event = {}
        if ring_write is not None:
            params = dict(params or {"seq": seq})
            params["shm_ring_offset"] = ring_write(seq, int(token),
                                                   float(logprob))
        if ring_write is None or seq_guarded:
            event["TOKEN"] = np.array([token], dtype=np.int32)
            event["LOGPROB"] = np.array([logprob], dtype=np.float32)
        if params is not None:
            event[RESPONSE_PARAMS_KEY] = params
        return event

    def _attach_from_params(self, request):
        """``(imported cache, position)`` for a ``kv_attach`` descriptor
        (the decode leg of a prefill/decode split), or ``(None, 0)`` when
        the parameter is absent or the export is no longer there
        (released, expired, malformed): the admission then prefills,
        token-identically.  A CUDA error of the attach raises."""
        desc = request.parameters.get("kv_attach")
        if not desc or self._server is None:
            return None, 0
        if isinstance(desc, (bytes, str)):
            try:
                desc = json.loads(desc)
            except ValueError:
                return None, 0
        try:
            return self._server.import_kv_descriptor(desc)
        except KvExportMissing:
            return None, 0

    # -- execution ---------------------------------------------------------

    def execute_stream(self, inputs, request):
        raw_prompt = inputs["PROMPT_IDS"]
        prompt_dev = prompt = None
        if isinstance(raw_prompt, torch.Tensor):
            # a view of a CUDA-shm region's memory (the front end read it
            # by reference): the prefill consumes it on the device
            prompt_dev = raw_prompt.reshape(-1)
            prompt_len = prompt_dev.numel()
        else:
            prompt = np.asarray(raw_prompt).reshape(-1).astype(np.int64)
            prompt_len = len(prompt)
        max_tokens = int(np.asarray(inputs["MAX_TOKENS"]).reshape(-1)[0])
        if prompt_len == 0:
            raise ValueError("PROMPT_IDS must be non-empty")
        if max_tokens < 0:
            raise ValueError("MAX_TOKENS must be >= 0")
        eos_id = request.parameters.get("eos_id")
        eos_id = int(eos_id) if eos_id is not None else None
        ring = self._ring_writer(request)
        ring_write, seq_guarded = (ring[1], ring[2]) if ring else (None,
                                                                   False)
        # every region the stream references stays registered until it
        # ends: a concurrent unregister is a typed 409, never a write
        # into (or a read of) memory that is gone
        names = {n for n in (ring[0] if ring else None,
                             request.parameters.get("kv_cache_region")) if n}
        names.update(getattr(request, "shm_input_regions", ()))
        server = self._require_server("a shared-memory reference") \
            if names else None
        pinned = []
        try:
            for name in sorted(names):
                server.pin_shm_region(name)
                pinned.append(name)
            if self._max_slots > 1:
                if prompt is None:
                    # the scheduler's bookkeeping (replay history, radix
                    # keys) needs host ids: one read; the prefill still
                    # consumes the device view
                    prompt = csm.to_host(prompt_dev).astype(np.int64)
                self._check_ids(prompt)
                yield from self._execute_scheduled(
                    prompt, max_tokens, eos_id, request, ring_write,
                    prompt_dev, seq_guarded)
            else:
                self._check_ids(prompt if prompt is not None else prompt_dev)
                yield from self._execute_single(
                    prompt, prompt_dev, prompt_len, max_tokens, eos_id,
                    request, ring_write, seq_guarded)
        finally:
            for name in pinned:
                server.unpin_shm_region(name)

    def _check_ids(self, ids):
        """A typed 400 for ids outside the vocabulary (host array, or a
        device view checked on the device: one flag comes back)."""
        if isinstance(ids, torch.Tensor):
            bad = bool(((ids < 0) | (ids >= self._cfg.vocab)).any())
        else:
            bad = ids.min() < 0 or ids.max() >= self._cfg.vocab
        if bad:
            raise ValueError("PROMPT_IDS out of range [0, {})".format(
                self._cfg.vocab))

    def _check_fits(self, pos, prompt_len, max_tokens):
        if pos + prompt_len + max_tokens > self._max_seq:
            raise ValueError(
                "position ({}) + prompt ({}) + max_tokens ({}) exceeds max "
                "sequence {}".format(pos, prompt_len, max_tokens,
                                     self._max_seq))

    def _execute_single(self, prompt, prompt_dev, prompt_len, max_tokens,
                        eos_id, request, ring_write, seq_guarded):
        """The single-stream path, with the ``kv_cache_region`` park (when
        the generation finishes or stops at ``eos_id``) and resume."""
        if request.parameters.get("resume_generation_id"):
            raise GenerationNotFound(
                "the single-stream path (max_slots=1) keeps no replay "
                "state: there is no generation to resume")
        region = self._kv_region(request)
        parked, pos = self._resume_state(request, region)
        self._check_fits(pos, prompt_len, max_tokens)
        if prompt_dev is not None:
            tokens = prompt_dev.to(self._device, torch.int64)[None, :]
        else:
            tokens = torch.from_numpy(prompt)[None, :].to(self._device)
        state = {}
        emitted = 0
        with self._lock:
            chunks = self._generate_chunks(tokens, max_tokens, parked, pos,
                                           state)
            try:
                stop = False
                for toks, logps in chunks:
                    for tok, logp in zip(toks, logps):
                        yield self._emit_token(tok, logp, emitted,
                                               ring_write, seq_guarded)
                        emitted += 1
                        if eos_id is not None and int(tok) == eos_id:
                            stop = True
                            break
                    if stop:
                        break
            finally:
                chunks.close()
            if region is not None:
                # park: the cache's rows past the resume position (chunks
                # that ran on after an eos) stay masked behind it
                region.put_device_tensor(0, self._park_cache(state["cache"]))

    def _execute_scheduled(self, prompt, max_tokens, eos_id, request,
                           ring_write=None, prompt_dev=None,
                           seq_guarded=False):
        """Continuous-batching path: submit to the shared decode loop and
        stream its per-step tokens back.  Every generation here is
        resumable: it gets an id (the ``generation_id`` request
        parameter, or a fresh one) and each response carries it with its
        0-based ``seq``.  A request with ``resume_generation_id`` instead
        continues a parked generation from ``resume_from_seq``: buffered
        tokens replay first, then live ones follow, with no duplicates
        or gaps, under the reconnect's own deadline.  On a token ring,
        replayed tokens write their slots again (``seq`` is kept)."""
        scheduler = self._ensure_scheduler()
        resume_id = request.parameters.get("resume_generation_id")
        if resume_id:
            gen_id = str(resume_id)
            seq = int(request.parameters.get("resume_from_seq", 0))
            stream = scheduler.resume(gen_id, seq, deadline=request.deadline)
        else:
            region = self._kv_region(request)
            parked, pos = self._resume_state(request, region)
            on_finish = None
            if region is not None:
                def on_finish(cache):
                    # the stream's gathered cache, in the single-stream
                    # park shape: either path may resume it
                    region.put_device_tensor(0, self._park_cache(cache))

            gen_id = str(request.parameters.get("generation_id")
                         or uuid.uuid4().hex)
            kv_park = request.parameters.get("kv_park")
            # a prefill leg exports its KV when it finishes; a decode leg
            # attaches such an export instead of prefilling
            kv_prefill = request.parameters.get("kv_phase") == "prefill"
            attach_cache, attach_pos = self._attach_from_params(request)
            seq = 0
            stream = scheduler.submit(
                prompt, max_tokens, eos_id=eos_id,
                # a copy: the region's park stays valid for another
                # resume, and unpinned once this request ends
                resume_cache=parked.clone() if parked is not None else None,
                resume_pos=pos, on_finish=on_finish,
                deadline=request.deadline, generation_id=gen_id,
                prompt_dev=prompt_dev,
                kv_export=(True if kv_prefill else (
                    self._kv_export if kv_park is None else bool(kv_park))),
                kv_export_on_finish=kv_prefill,
                attach_cache=attach_cache, attach_pos=attach_pos)
        try:
            for token, logprob in stream:
                yield self._emit_token(
                    token, logprob, seq, ring_write, seq_guarded,
                    params={"generation_id": gen_id, "seq": seq})
                seq += 1
        finally:
            # a consumer that stops early retires the slot at once (and
            # the generation parks for a resume)
            stream.close()

    def healthy(self):
        """Readiness hook: False once the continuous-batching scheduler
        is closed or tripped."""
        scheduler = self._scheduler
        return scheduler is None or scheduler.healthy

    def scheduler_stats(self):
        """The scheduler's ``stats()``, or None before its first use and
        for ``max_slots=1``."""
        scheduler = self._scheduler
        return scheduler.stats() if scheduler is not None else None

    def drain(self, timeout=30.0):
        """Stop admission and let in-flight generations finish within
        ``timeout`` seconds (no-op for ``max_slots=1``)."""
        scheduler = self._scheduler
        if scheduler is not None:
            scheduler.drain(timeout)

    def close(self):
        """Stop the continuous-batching loop (no-op for ``max_slots=1``);
        a later request builds a fresh scheduler."""
        with self._lock:
            scheduler, self._scheduler = self._scheduler, None
        if scheduler is not None:
            scheduler.close()

    @torch.inference_mode()
    def _generate_chunks(self, tokens, max_tokens, parked, pos, state):
        """(tokens, logprobs) numpy arrays: first the prefill's token
        alone, then one pair per decode chunk.  ``tokens`` is the prompt,
        [1, T] on the device.  With ``parked`` (a parked cache) the
        generation continues from ``pos``: a copy of it takes the prompt
        token by token (or as a prefill at position 0).  The cache is left
        in ``state["cache"]`` for a park."""
        params = self._ensure_params()
        if parked is not None:
            # a copy (of this rank's heads, under a mesh): the park stays
            # valid for another resume
            cache = (llama.tp_scatter_cache(self._mesh, parked)
                     if self._tp else parked.clone())
        else:
            cache = (self._tp["init_cache"](1, self._max_seq) if self._tp
                     else llama.init_kv_cache(self._cfg, 1, self._max_seq,
                                              self._device))
            pos = 0
        state["cache"] = cache
        if pos == 0:
            logits, cache = self._prefill(params, cache, tokens)
            pos = tokens.shape[1]
        else:
            for t in range(tokens.shape[1]):
                logits, cache = self._step(params, cache, tokens[:, t], pos)
                pos += 1
        if max_tokens == 0:
            return
        # early first token: the argmax of the prefill logits, fetched
        # before any decode step, so time-to-first-token is the prefill's
        logp = torch.log_softmax(logits, dim=-1)
        first = torch.argmax(logits, dim=-1)
        yield (first.cpu().numpy().astype(np.int32),
               logp.gather(-1, first[:, None])[:, 0].cpu().numpy())
        # tokens the decode chunks have covered (the first chunk covers
        # the early token again, as its token 0)
        done = 0 if max_tokens > 1 else max_tokens
        while done < max_tokens:
            n = min(self.decode_chunk, max_tokens - done)
            toks, logps, logits, cache = self._chunk(params, cache, logits,
                                                     pos, n)
            # the first chunk's token 0 is the early token: skip it
            skip = 1 if done == 0 else 0
            pos += n
            done += n
            yield (toks[skip:, 0].cpu().numpy().astype(np.int32),
                   logps[skip:, 0].cpu().numpy().astype(np.float32))

    # the single-stream steps, sharded under a mesh

    def _prefill(self, params, cache, tokens):
        if self._tp:
            return self._tp["prefill"](params, cache, tokens)
        return llama.prefill(params, cache, tokens, self._cfg)

    def _step(self, params, cache, tokens, pos):
        if self._tp:
            return self._tp["step"](params, cache, tokens, pos)
        return llama.decode_step(params, cache, tokens, pos, self._cfg)

    def _chunk(self, params, cache, logits, pos, n):
        """``llama.decode_chunk`` of ``n`` tokens (one mirrored call
        under a mesh)."""
        if self._tp:
            return self._tp["chunk"](params, cache, logits, pos, n)
        return llama.decode_chunk(params, cache, logits, pos, self._cfg, n)

    def _park_cache(self, cache):
        """A cache in the park layout: the full kv heads (gathered to the
        driver under a mesh)."""
        if self._mesh is None:
            return cache
        return llama.tp_gather_cache(self._mesh, cache)


def _first_leaf(tree):
    while isinstance(tree, (dict, list, tuple)):
        tree = next(iter(tree.values())) if isinstance(tree, dict) \
            else tree[0]
    return tree


def _quantize_on_load(params):
    """``llama.quantize_params`` of a tree the model owns, in place and
    layer by layer: each layer's bf16 weights are dropped once their int8
    form exists, so the peak stays near the bf16 tree's size instead of
    bf16 plus int8.  ``lm_head`` is quantized as ``quantize_params`` does,
    ``embed`` and the norms stay."""
    layers = params["layers"]
    for i in range(len(layers)):
        layers[i] = llama.quantize_layer(layers[i])
    params["lm_head"] = quant.quantize_int8(params["lm_head"], axis=0)
    return params


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_device(v, device) for v in tree]
    return tree.to(device)
