"""Decoupled llama generation serving model (the port of
``tpuserver/models/llama_serving.py``'s single-stream path).

One request carries the prompt ids; the model prefills a fresh KV cache
in one batched pass (through the flash kernel at lengths
``llama._flash_blocks`` tiles), then greedy-decodes in chunks of
``decode_chunk`` tokens (each token's attention through the decode
kernel) and streams one response per token.  A chunk runs on the card
without a host sync; its tokens are fetched once at its end.

Only ``max_slots=1`` is ported.  Continuous batching, the KV-cache
park/resume region and the shared-memory token ring come in later
slices of the port: requests asking for them get ``NotPortedYet``.
"""

import threading

import numpy as np
import torch

from tpuserver_torch import resolve_device
from tpuserver_torch.core import Model, TensorSpec
from tpuserver_torch.errors import NotPortedYet
from tpuserver_torch.models import llama

#: request parameters of the JAX server that a later slice brings
_LATER_PARAMETERS = ("kv_cache_region", "kv_cache_resume", "shm_ring_region",
                     "resume_generation_id", "kv_attach", "kv_park",
                     "kv_phase")


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
                 max_slots=1, params=None, seed=0, device=None):
        """``params``: weights to serve (a params dict of tensors, e.g.
        from ``llama.params_from_jax``),
        moved to ``device``; None draws random ones from ``seed`` at the
        first request.  ``device`` defaults to the card (see
        ``tpuserver_torch.resolve_device``)."""
        self._device = resolve_device(device)
        self.device_kind = "gpu" if self._device.type == "cuda" else "cpu"
        if max_slots != 1:
            raise NotPortedYet(
                "max_slots={}: continuous batching comes in a later slice "
                "of the port (only max_slots=1 is served)".format(max_slots))
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
        # one generation at a time: each holds a full-length KV cache
        self._lock = threading.Lock()

    def _ensure_params(self):
        if self._params is None:
            gen = torch.Generator(device=self._device).manual_seed(self._seed)
            self._params = llama.init_params(self._cfg, gen, self._device)
        return self._params

    def warmup(self):
        with self._lock:
            self._ensure_params()

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
        with self._lock:
            yield from self._generate(prompt, max_tokens, eos_id)

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
