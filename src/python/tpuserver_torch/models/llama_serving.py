"""Decoupled llama generation serving model (the port of
``tpuserver/models/llama_serving.py``).

One request carries the prompt ids and streams one response per token.

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
  not yet seen) continues a parked generation.

The KV-cache park/resume region, the shared-memory token ring and the
disaggregated KV attach come in later slices of the port: requests asking
for them get ``NotPortedYet``.
"""

import threading
import uuid

import numpy as np
import torch

from tpuserver_torch import resolve_device
from tpuserver_torch.core import RESPONSE_PARAMS_KEY, Model, TensorSpec
from tpuserver_torch.errors import GenerationNotFound, NotPortedYet
from tpuserver_torch.models import llama
from tpuserver_torch.ops import _build
from tpuserver_torch.scheduler import DecodeScheduler

#: request parameters of the JAX server that a later slice brings
_LATER_PARAMETERS = ("kv_cache_region", "kv_cache_resume", "shm_ring_region",
                     "kv_attach", "kv_park", "kv_phase")


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
                 step_timeout_s=None):
        """``params``: weights to serve (a params dict of tensors, e.g.
        from ``llama.params_from_jax``, or another model's, which is then
        shared, not copied), moved to ``device``; None draws random ones
        from ``seed`` at the first request.  ``device`` defaults to the
        card (see ``tpuserver_torch.resolve_device``).

        ``max_slots>1`` serves through a ``DecodeScheduler``;
        ``page_size`` and ``kv_pages`` set its KV pool (default: room for
        ``max_slots`` full-length sequences), ``spec_tokens`` its drafted
        tokens per step and ``step_timeout_s`` its watchdog (see
        ``DecodeScheduler``)."""
        self._device = resolve_device(device)
        self.device_kind = "gpu" if self._device.type == "cuda" else "cpu"
        if max_slots < 1:
            raise ValueError("max_slots must be >= 1 (got {})".format(
                max_slots))
        self._max_slots = int(max_slots)
        self._cfg = cfg or llama.tiny(vocab=2048)
        self._max_seq = int(max_seq)
        self._seed = seed
        if decode_chunk is not None:
            if decode_chunk < 1:
                raise ValueError(
                    "decode_chunk must be >= 1 (got {})".format(decode_chunk))
            self.decode_chunk = decode_chunk
        self._params = (_to_device(params, self._device)
                        if params is not None else None)
        # the scheduler's bundle (stateless; built here so a bad page
        # geometry fails at construction) and the scheduler, built at
        # first use
        self._fns = (llama.make_scheduler_fns(
            self._cfg, self._max_seq, self._max_slots, page_size=page_size,
            kv_pages=kv_pages, device=self._device)
            if self._max_slots > 1 else None)
        self._spec_tokens = spec_tokens
        self._step_timeout_s = step_timeout_s
        self._scheduler = None
        # max_slots=1: one generation at a time (each holds a full-length
        # KV cache); max_slots>1: guards building the scheduler
        self._lock = threading.Lock()

    def _ensure_params(self):
        if self._params is None:
            gen = torch.Generator(device=self._device).manual_seed(self._seed)
            self._params = llama.init_params(self._cfg, gen, self._device)
        return self._params

    def _ensure_scheduler(self):
        """The continuous-batching scheduler, built at first use (and
        anew after ``close``)."""
        with self._lock:
            if self._scheduler is None:
                self._scheduler = DecodeScheduler(
                    self._fns, self._ensure_params(), self._max_slots,
                    self._max_seq, spec_tokens=self._spec_tokens,
                    step_timeout_s=self._step_timeout_s)
            return self._scheduler

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

    def execute_stream(self, inputs, request):
        for key in _LATER_PARAMETERS:
            if request.parameters.get(key):
                raise NotPortedYet(
                    "request parameter '{}' comes in a later slice of the "
                    "port".format(key))
        prompt = np.asarray(inputs["PROMPT_IDS"]).reshape(-1).astype(np.int64)
        max_tokens = int(np.asarray(inputs["MAX_TOKENS"]).reshape(-1)[0])
        if len(prompt) == 0:
            raise ValueError("PROMPT_IDS must be non-empty")
        if max_tokens < 0:
            raise ValueError("MAX_TOKENS must be >= 0")
        if len(prompt) + max_tokens > self._max_seq:
            raise ValueError(
                "position (0) + prompt ({}) + max_tokens ({}) exceeds max "
                "sequence {}".format(len(prompt), max_tokens, self._max_seq))
        if prompt.min() < 0 or prompt.max() >= self._cfg.vocab:
            raise ValueError("PROMPT_IDS out of range [0, {})".format(
                self._cfg.vocab))
        eos_id = request.parameters.get("eos_id")
        eos_id = int(eos_id) if eos_id is not None else None
        if self._max_slots > 1:
            yield from self._execute_scheduled(prompt, max_tokens, eos_id,
                                               request)
            return
        if request.parameters.get("resume_generation_id"):
            raise GenerationNotFound(
                "the single-stream path (max_slots=1) keeps no replay "
                "state: there is no generation to resume")
        with self._lock:
            yield from self._generate(prompt, max_tokens, eos_id)

    def _execute_scheduled(self, prompt, max_tokens, eos_id, request):
        """Continuous-batching path: submit to the shared decode loop and
        stream its per-step tokens back.  Every generation here is
        resumable: it gets an id (the ``generation_id`` request
        parameter, or a fresh one) and each response carries it with its
        0-based ``seq``.  A request with ``resume_generation_id`` instead
        continues a parked generation from ``resume_from_seq``: buffered
        tokens replay first, then live ones follow, with no duplicates
        or gaps, under the reconnect's own deadline."""
        scheduler = self._ensure_scheduler()
        resume_id = request.parameters.get("resume_generation_id")
        if resume_id:
            gen_id = str(resume_id)
            seq = int(request.parameters.get("resume_from_seq", 0))
            stream = scheduler.resume(gen_id, seq, deadline=request.deadline)
        else:
            gen_id = str(request.parameters.get("generation_id")
                         or uuid.uuid4().hex)
            seq = 0
            stream = scheduler.submit(prompt, max_tokens, eos_id=eos_id,
                                      deadline=request.deadline,
                                      generation_id=gen_id)
        try:
            for token, logprob in stream:
                yield {"TOKEN": np.array([token], dtype=np.int32),
                       "LOGPROB": np.array([logprob], dtype=np.float32),
                       RESPONSE_PARAMS_KEY: {"generation_id": gen_id,
                                             "seq": seq}}
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
    def _generate_chunks(self, prompt, max_tokens):
        """(tokens, logprobs) numpy arrays: first the prefill's token
        alone, then one pair per decode chunk."""
        cfg = self._cfg
        params = self._ensure_params()
        cache = llama.init_kv_cache(cfg, 1, self._max_seq, self._device)
        tokens = torch.from_numpy(prompt)[None, :].to(self._device)
        logits, cache = llama.prefill(params, cache, tokens, cfg)
        if max_tokens == 0:
            return
        # early first token: the argmax of the prefill logits, fetched
        # before any decode step, so time-to-first-token is the prefill's
        logp = torch.log_softmax(logits, dim=-1)
        first = torch.argmax(logits, dim=-1)
        yield (first.cpu().numpy().astype(np.int32),
               logp.gather(-1, first[:, None])[:, 0].cpu().numpy())
        pos = len(prompt)
        # tokens the decode chunks have covered (the first chunk covers
        # the early token again, as its token 0)
        done = 0 if max_tokens > 1 else max_tokens
        while done < max_tokens:
            n = min(self.decode_chunk, max_tokens - done)
            toks, logps, logits, cache = llama.decode_chunk(
                params, cache, logits, pos, cfg, n)
            # the first chunk's token 0 is the early token: skip it
            skip = 1 if done == 0 else 0
            pos += n
            done += n
            yield (toks[skip:, 0].cpu().numpy().astype(np.int32),
                   logps[skip:, 0].cpu().numpy().astype(np.float32))

    def _generate(self, prompt, max_tokens, eos_id):
        for toks, logps in self._generate_chunks(prompt, max_tokens):
            for tok, logp in zip(toks, logps):
                yield {"TOKEN": np.array([tok], dtype=np.int32),
                       "LOGPROB": np.array([logp], dtype=np.float32)}
                if eos_id is not None and int(tok) == eos_id:
                    return


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_device(v, device) for v in tree]
    return tree.to(device)
