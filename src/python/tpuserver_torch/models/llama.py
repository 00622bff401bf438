"""Llama-family decoder-only transformer in PyTorch: the port of
``tpuserver/models/llama.py``'s single-device serving half.

Parameters are a plain dict of tensors with the JAX package's structure
and layouts (``{embed, layers: [..], norm, lm_head}``, weights ``[in,
out]`` so a projection is ``x @ w``); activations are ``[B, T, H, D]``
and the KV cache ``[L, 2, B, S, Hkv, D]``.  The large matmuls, norms,
RoPE and the embedding gather are plain ``torch`` ops (an int8 weight's
few-row product goes through the W8A16 kernel); attention goes through
the port's CUDA kernels (``tpuserver_torch.ops``), whose plain versions
run when the tensors lie on the CPU.

Pieces:
- ``LlamaConfig`` and the presets ``tiny`` .. ``llama3_8b``
- ``init_params`` (seeded ``torch.Generator``) and ``params_from_jax``
  (the JAX package's params, as numpy arrays, bridged to the port)
- ``quantize_params``: int8 weights with per-output-channel scales; every
  product and embedding lookup goes through ``_mm`` and ``_embed_rows``,
  which serve a plain or an int8 leaf (``tpuserver_torch.ops.quant``)
- ``forward`` (teacher-forcing logits)
- ``init_kv_cache`` / ``prefill`` / ``decode_step`` / ``decode_chunk``
  for token-by-token serving
- continuous batching: the slotted step (``batched_decode_step``,
  ``scheduler_step``, ``scheduler_admit``, ``scheduler_extract``), the
  paged KV pool (``init_paged_kv_cache``, ``paged_batched_decode_step``,
  ``paged_scheduler_step``, ``paged_spec_step``, ``paged_admit``,
  ``paged_gather``), the admission prefills (``prefill_bucket``, ``prefill_to_length``,
  ``prefill_span``) and the scheduler's bundle (``make_scheduler_fns``)
"""

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

from tpuserver_torch import resolve_device
from tpuserver_torch.ops import decode_attention, flash_attention, quant


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab: int = 128256
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    d_ff: int = 14336
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    # prefill/forward attention: "kernel" (the CUDA flash kernel,
    # tpuserver_torch.ops.flash_attention, at lengths _flash_blocks
    # tiles) or "dense" (plain masked softmax) — the JAX "pallas"/"xla"
    attn_impl: str = "dense"
    # single-query decode attention: "auto" (the decode kernel whenever
    # max_seq tiles by 256 or 128, else dense) or "dense"
    decode_impl: str = "auto"
    # the JAX package's flash tile preferences; kept so that _flash_blocks
    # sends exactly the same prompt lengths to the flash path
    flash_block_q: int = 256
    flash_block_k: int = 512

    @property
    def head_dim(self):
        return self.d_model // self.n_heads


def llama3_8b():
    return LlamaConfig(attn_impl="kernel")


def llama3_3b():
    """Llama-3.2-3B shapes (untied head)."""
    return LlamaConfig(
        d_model=3072, n_layers=28, n_heads=24, n_kv_heads=8, d_ff=8192,
        attn_impl="kernel",
    )


def llama3_1b():
    """Llama-3.2-1B shapes (untied head)."""
    return LlamaConfig(
        d_model=2048, n_layers=16, n_heads=32, n_kv_heads=8, d_ff=8192,
        attn_impl="kernel",
    )


def tiny(vocab=256):
    """Test-size config: same graph, toy dims."""
    return LlamaConfig(
        vocab=vocab, d_model=64, n_layers=2, n_heads=8, n_kv_heads=4,
        d_ff=128, rope_theta=10000.0,
    )


PRESETS = {"tiny": tiny, "llama3_1b": llama3_1b, "llama3_3b": llama3_3b,
           "llama3_8b": llama3_8b}


# -- parameters --------------------------------------------------------------


def init_params(cfg, generator, device):
    """Random params in ``cfg.dtype`` on ``device``: normal / sqrt(fan_in)
    for projections and embeddings, ones for the norm weights (the JAX
    init's distribution; the numbers differ, as the generators do).
    ``generator`` is a seeded ``torch.Generator`` on ``device``."""

    def dense(shape, fan_in):
        w = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return w.div_(float(np.sqrt(fan_in))).to(cfg.dtype)

    def ones():
        return torch.ones(cfg.d_model, dtype=cfg.dtype, device=device)

    hd = cfg.head_dim
    dm = cfg.d_model
    embed = dense((cfg.vocab, dm), dm)
    lm_head = dense((dm, cfg.vocab), dm)
    layers = []
    for _ in range(cfg.n_layers):
        layers.append({
            "attn_norm": ones(),
            "wq": dense((dm, cfg.n_heads * hd), dm),
            "wk": dense((dm, cfg.n_kv_heads * hd), dm),
            "wv": dense((dm, cfg.n_kv_heads * hd), dm),
            "wo": dense((cfg.n_heads * hd, dm), cfg.n_heads * hd),
            "mlp_norm": ones(),
            "w_gate": dense((dm, cfg.d_ff), dm),
            "w_up": dense((dm, cfg.d_ff), dm),
            "w_down": dense((cfg.d_ff, dm), cfg.d_ff),
        })
    return {"embed": embed, "layers": layers, "norm": ones(),
            "lm_head": lm_head}


def _tensor_from_numpy(a, device):
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:  # e.g. a view of a JAX array's buffer
        a = a.copy()
    if a.dtype.name == "bfloat16":
        # numpy has no bfloat16 of its own (ml_dtypes supplies it): move
        # the bits as uint16 and reinterpret them on the torch side
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_jax(np_tree, device):
    """The JAX package's llama params (its pytree with every leaf turned
    into a numpy array, e.g. by ``jax.device_get``) as the port's params
    on ``device``, same values and dtypes (bfloat16 bit for bit)."""
    if isinstance(np_tree, dict):
        return {k: params_from_jax(v, device) for k, v in np_tree.items()}
    if isinstance(np_tree, (list, tuple)):
        return [params_from_jax(v, device) for v in np_tree]
    return _tensor_from_numpy(np_tree, device)


_QUANTIZED_LAYER_WEIGHTS = ("wq", "wk", "wv", "wo", "w_gate", "w_up",
                            "w_down")


def quantize_layer(layer):
    """One layer's params with its matmul weights int8-quantized
    (``quant.quantize_int8(w, axis=0)``); the norms stay as they are."""
    return {k: quant.quantize_int8(v, axis=0)
            if k in _QUANTIZED_LAYER_WEIGHTS else v
            for k, v in layer.items()}


def quantize_params(params, quantize_embed=False):
    """Int8-quantize the serving weights (per-output-channel scales), as
    the JAX package's ``quantize_params`` does: layer matmul weights and
    ``lm_head`` go int8 (about half the bytes); norms stay as they are.
    ``embed`` is a row gather, not a matmul: it stays as it is unless
    ``quantize_embed`` (one scale per row, ``axis=1``)."""
    return {
        "embed": (quant.quantize_int8(params["embed"], axis=1)
                  if quantize_embed else params["embed"]),
        "norm": params["norm"],
        "lm_head": quant.quantize_int8(params["lm_head"], axis=0),
        "layers": [quantize_layer(layer) for layer in params["layers"]],
    }


# -- layers ------------------------------------------------------------------


def _flash_blocks(T, cfg):
    """Largest usable (block_q, block_k) for a length-T flash prefill:
    the preferred tile when T divides by it, else 128-tiles, else None
    (caller takes the dense path).  The same gate as the JAX package, so
    both take the flash path at exactly the same prompt lengths."""
    bq = next(
        (b for b in (cfg.flash_block_q, 128) if b <= T and T % b == 0),
        None,
    )
    bk = next(
        (b for b in (cfg.flash_block_k, 256, 128)
         if b <= T and T % b == 0),
        None,
    )
    return bq, bk


def _mm(x, w):
    """Matmul against a plain or int8-quantized weight leaf."""
    return quant.matmul(x, w)


def _embed_rows(params, tokens, cfg):
    """Embedding lookup from a plain or row-quantized table, dequantized
    rows in ``cfg.dtype``."""
    return quant.gather_rows(params["embed"], tokens, dtype=cfg.dtype)


def _rms_norm(x, w, eps):
    xf = x.float()
    scale = torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + eps)
    return (xf * scale).to(x.dtype) * w


def _rope(x, positions, theta):
    """Rotary embedding. x: [B, T, H, D]; positions: [T] or [B, T]."""
    d = x.shape[-1]
    freqs = 1.0 / (theta ** (
        torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d))
    if positions.dim() == 1:
        positions = positions[None, :]
    angles = positions[..., None].float() * freqs  # [B, T, D/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _expand_kv(k, n_rep):
    """GQA: repeat kv heads to full head count. [B,T,Hkv,D] -> [B,T,H,D]."""
    if n_rep == 1:
        return k
    return k.repeat_interleave(n_rep, dim=2)


def _block(params, x, positions, cfg, attn_fn):
    """One transformer block: x [B, T, Dm] -> [B, T, Dm]; ``attn_fn(q, k,
    v)`` takes q [B, T, H, D] and un-expanded k/v [B, T, Hkv, D]."""
    B, T, _ = x.shape
    hd = cfg.head_dim
    h = _rms_norm(x, params["attn_norm"], cfg.norm_eps)
    q = _mm(h, params["wq"]).reshape(B, T, cfg.n_heads, hd)
    k = _mm(h, params["wk"]).reshape(B, T, cfg.n_kv_heads, hd)
    v = _mm(h, params["wv"]).reshape(B, T, cfg.n_kv_heads, hd)
    q = _rope(q, positions, cfg.rope_theta)
    k = _rope(k, positions, cfg.rope_theta)
    attn = attn_fn(q, k, v)
    x = x + _mm(attn.reshape(B, T, cfg.n_heads * hd), params["wo"])
    h = _rms_norm(x, params["mlp_norm"], cfg.norm_eps)
    gated = F.silu(_mm(h, params["w_gate"])) * _mm(h, params["w_up"])
    return x + _mm(gated, params["w_down"])


def _dense_causal(q, k, v, n_rep):
    """Plain causal attention in float32 (the JAX dense path)."""
    T = q.shape[1]
    k = _expand_kv(k, n_rep).float()
    v = _expand_kv(v, n_rep).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k) / np.sqrt(q.shape[-1])
    idx = torch.arange(T, device=q.device)
    s = s.masked_fill(idx[None, :] > idx[:, None], float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v).to(q.dtype)


def forward(params, tokens, cfg):
    """Teacher-forcing logits [B, T, vocab] (float32)."""
    B, T = tokens.shape
    n_rep = cfg.n_heads // cfg.n_kv_heads
    positions = torch.arange(T, device=tokens.device)
    bq, bk = _flash_blocks(T, cfg)

    def attn_fn(q, k, v):
        if cfg.attn_impl == "kernel" and bq is not None and bk is not None:
            return flash_attention(q, k, v, causal=True, block_q=bq,
                                   block_k=bk)
        return _dense_causal(q, k, v, n_rep)

    x = _embed_rows(params, tokens, cfg)
    for layer in params["layers"]:
        x = _block(layer, x, positions, cfg, attn_fn)
    x = _rms_norm(x, params["norm"], cfg.norm_eps)
    return _mm(x, params["lm_head"]).float()


# -- decode (serving) --------------------------------------------------------


def init_kv_cache(cfg, batch, max_seq, device, dtype=None):
    """[n_layers, 2, B, max_seq, n_kv_heads, head_dim] zeros."""
    return torch.zeros(
        (cfg.n_layers, 2, batch, max_seq, cfg.n_kv_heads, cfg.head_dim),
        dtype=dtype or cfg.dtype, device=device)


def _decode_block(max_seq):
    """The decode kernel's block_k for a cache of ``max_seq`` (256 or
    128), or None when neither tiles it (the dense path then runs)."""
    return next((b for b in (256, 128) if max_seq % b == 0), None)


def _run_cached(params, cache, x, positions, write_pos, lengths, cfg):
    """Shared decode/prefill body: run all blocks, writing new K/V into
    ``cache`` IN PLACE at ``write_pos`` and attending over
    ``cache[:lengths]``.

    x: [B, T, Dm] embedded inputs; write_pos and lengths are ints.
    Returns (x_out, cache) — the same cache object, updated."""
    n_rep = cfg.n_heads // cfg.n_kv_heads
    max_seq = cache.shape[3]
    T = x.shape[1]
    block_k = _decode_block(max_seq)
    decode_kernel = (T == 1 and block_k is not None
                     and cfg.decode_impl == "auto")
    pf_bq, pf_bk = _flash_blocks(T, cfg)
    flash = (cfg.attn_impl == "kernel" and T > 1 and write_pos == 0
             and pf_bq is not None and pf_bk is not None)
    len_vec = None
    if decode_kernel:
        len_vec = torch.full((x.shape[0],), lengths, dtype=torch.int32,
                             device=x.device)

    for i, layer in enumerate(params["layers"]):
        def attn_fn(q, k, v, i=i):
            cache[i, 0, :, write_pos:write_pos + T] = k.to(cache.dtype)
            cache[i, 1, :, write_pos:write_pos + T] = v.to(cache.dtype)
            if decode_kernel:
                # the serving hot op: single-query attention over the
                # valid cache prefix, GQA served inside the kernel
                out = decode_attention(q[:, 0], cache[i, 0], cache[i, 1],
                                       len_vec, block_k=block_k)
                return out[:, None]
            if flash:
                # prefill from position 0 is causal self-attention over
                # the prompt: the flash kernel, GQA native (no expand)
                return flash_attention(q, k, v, causal=True, block_q=pf_bq,
                                       block_k=pf_bk)
            return _attend_cached(q, cache[i, 0], cache[i, 1], positions,
                                  lengths, n_rep)

        x = _block(layer, x, positions, cfg, attn_fn)
    return x, cache


def _attend_cached(q, cache_k, cache_v, q_pos, length, n_rep):
    """q: [B, Tq, H, D] against cache [B, S, Hkv, D], masking cache
    positions >= ``length`` (an int, or a per-row [B] tensor when the
    continuous-batching step decodes rows at different positions) and
    (causally) > the query's own position ``q_pos`` [B, Tq].  Plain
    float32 attention."""
    k = _expand_kv(cache_k, n_rep).float()
    v = _expand_kv(cache_v, n_rep).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k) / np.sqrt(q.shape[-1])
    k_idx = torch.arange(k.shape[1], device=q.device)[None, None, None, :]
    if isinstance(length, torch.Tensor):
        length = length.reshape(-1, 1, 1, 1)  # per-row valid prefixes
    mask = (k_idx >= length) | (k_idx > q_pos[:, None, :, None])
    s = s.masked_fill(mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v).to(q.dtype)


def decode_step(params, cache, tokens, pos, cfg):
    """One token of autoregressive decode.

    tokens: [B] int64/int32; pos: int (current position, same for the
    batch).  Returns (logits [B, vocab] fp32, cache updated in place)."""
    B = tokens.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.long,
                           device=tokens.device)
    x = _embed_rows(params, tokens, cfg)[:, None, :]  # [B, 1, Dm]
    x, cache = _run_cached(params, cache, x, positions, pos, pos + 1, cfg)
    x = _rms_norm(x, params["norm"], cfg.norm_eps)
    logits = _mm(x[:, 0, :], params["lm_head"]).float()
    return logits, cache


def prefill(params, cache, tokens, cfg):
    """Run the prompt tokens [B, T] through the cache in one batched
    pass from position 0; returns (last logits [B, vocab] fp32, cache
    updated in place)."""
    B, T = tokens.shape
    positions = torch.arange(T, device=tokens.device)[None, :].expand(B, T)
    x = _embed_rows(params, tokens, cfg)
    x, cache = _run_cached(params, cache, x, positions, 0, T, cfg)
    x = _rms_norm(x, params["norm"], cfg.norm_eps)
    logits = _mm(x[:, -1, :], params["lm_head"]).float()
    return logits, cache


def decode_chunk(params, cache, logits, pos, cfg, chunk):
    """Greedy-decode ``chunk`` tokens: each step takes the argmax of the
    current logits and decodes it.  Runs without a host sync, so the
    card works ahead while the caller waits for the chunk.

    logits: [B, vocab] for the NEXT position.  Returns (tokens [chunk, B],
    logprobs [chunk, B], next_logits, cache); positions pos..pos+chunk-1
    are written in place."""
    tokens, logps = [], []
    for i in range(chunk):
        logp = torch.log_softmax(logits, dim=-1)
        token = torch.argmax(logits, dim=-1)
        tokens.append(token)
        logps.append(logp.gather(-1, token[:, None])[:, 0])
        logits, cache = decode_step(params, cache, token, pos + i, cfg)
    return torch.stack(tokens), torch.stack(logps), logits, cache


# -- continuous batching (the slotted decode step) ---------------------------


def prefill_bucket(cfg, max_seq, true_len):
    """The padded length the scheduler prefills a ``true_len`` prompt
    at: the next power of two (min 8, capped at ``max_seq``), UNLESS
    padding would change which prefill attention path runs.

    With ``attn_impl="kernel"`` the flash kernel runs only at lengths
    ``_flash_blocks`` tiles; padding a dense-length prompt to a tileable
    bucket would change the admission prefill's arithmetic against the
    single-stream path's exact-length prefill, and a near-tie in the
    first token's logits could flip the greedy argmax.  Such lengths
    prefill exactly instead; everything on the dense path buckets."""
    bucket = 8
    while bucket < true_len:
        bucket <<= 1
    bucket = min(bucket, max_seq)
    if bucket == true_len or cfg.attn_impl != "kernel":
        return bucket

    def dense(T):
        return None in _flash_blocks(T, cfg)

    return bucket if dense(true_len) and dense(bucket) else true_len


def prefill_to_length(params, cache, tokens, true_len, cfg):
    """Prefill a PADDED prompt [B, T] from position 0, returning the
    logits at ``true_len - 1`` (and the cache, updated in place).

    Causal attention makes the padding harmless: position ``true_len -
    1`` attends only positions <= itself, and the padding rows' K/V
    (written at ``true_len..T-1``) sit past the slot's length, masked
    until decode steps overwrite them."""
    B, T = tokens.shape
    positions = torch.arange(T, device=tokens.device)[None, :].expand(B, T)
    x = _embed_rows(params, tokens, cfg)
    x, cache = _run_cached(params, cache, x, positions, 0, T, cfg)
    x = _rms_norm(x, params["norm"], cfg.norm_eps)
    logits = _mm(x[:, true_len - 1, :], params["lm_head"]).float()
    return logits, cache


def _live_lengths(positions, max_seq):
    """(live [S] bool, lengths [S] int32) of a batched step.  Rows at the
    sentinel position ``max_seq`` hold no live request; their length is
    1, not ``max_seq``: the decode kernel reads only each row's valid
    prefix, and an empty slot must not stream its whole dead cache every
    step (length 0 would give a zero row; the one position attended is
    discarded with the row's output)."""
    live = positions < max_seq
    lengths = torch.where(live, positions + 1, torch.ones_like(positions))
    return live, lengths.to(torch.int32)


def batched_decode_step(params, cache, tokens, positions, cfg):
    """One decode token per cache SLOT at per-slot positions: the compute
    heart of the continuous-batching scheduler (``tpuserver_torch.
    scheduler``).

    ``cache`` [L, 2, S, max_seq, Hkv, D] holds one in-flight generation
    per row; ``tokens`` [S] are the rows' next input tokens and
    ``positions`` [S] their write positions.  Each row's K/V lands at its
    own position and attention masks each row to its own valid prefix
    (``positions + 1``).  Rows holding no live request carry the sentinel
    position ``max_seq``: their cache is left as it was (JAX drops those
    writes with ``mode="drop"``; here the row's last position is written
    back with what it holds, since an out-of-bounds write on the card is
    a device-side assert).

    Returns (logits [S, vocab] fp32, cache updated in place).  Per-row
    math does not depend on the other rows, so a row's tokens do not
    depend on its slot or its neighbours."""
    S = tokens.shape[0]
    max_seq = cache.shape[3]
    positions = positions.long()
    live, lengths = _live_lengths(positions, max_seq)
    write_pos = positions.clamp(max=max_seq - 1)
    rows = torch.arange(S, device=tokens.device)
    keep = live[:, None, None]
    q_pos = positions[:, None]
    n_rep = cfg.n_heads // cfg.n_kv_heads
    block_k = _decode_block(max_seq)
    decode_kernel = block_k is not None and cfg.decode_impl == "auto"
    x = _embed_rows(params, tokens, cfg)[:, None, :]  # [S, 1, Dm]

    for i, layer in enumerate(params["layers"]):
        def attn_fn(q, k, v, i=i):
            for j, new in ((0, k), (1, v)):
                old = cache[i, j, rows, write_pos]
                cache[i, j, rows, write_pos] = torch.where(
                    keep, new[:, 0].to(cache.dtype), old)
            if decode_kernel:
                # the decode kernel takes per-row lengths: continuous
                # batching is its natural shape
                out = decode_attention(q[:, 0], cache[i, 0], cache[i, 1],
                                       lengths, block_k=block_k)
                return out[:, None]
            return _attend_cached(q, cache[i, 0], cache[i, 1], q_pos,
                                  lengths, n_rep)

        x = _block(layer, x, q_pos, cfg, attn_fn)
    x = _rms_norm(x, params["norm"], cfg.norm_eps)
    logits = _mm(x[:, 0, :], params["lm_head"]).float()
    return logits, cache


def _sample(logits_all, forced, forced_mask):
    """Greedy token per row, or the row's ``forced`` token where
    ``forced_mask`` says so, with its log-probability."""
    logp = torch.log_softmax(logits_all, dim=-1)
    greedy = torch.argmax(logits_all, dim=-1)
    tokens = torch.where(forced_mask, forced.long(), greedy)
    return tokens, logp.gather(-1, tokens[:, None])[:, 0]


def scheduler_step(params, cache, logits_all, positions, active, forced,
                   forced_mask, cfg):
    """One continuous-batching iteration over every cache slot.

    Each slot's next token is sampled greedily from its ``logits_all``
    row, or its ``forced`` token is taken where ``forced_mask`` is set;
    the batched decode step then writes every active row's K/V at its
    own position.  Inactive rows keep their previous logits.

    Returns (tokens [S], logprobs [S], next logits [S, vocab], cache)."""
    tokens, tok_logp = _sample(logits_all, forced, forced_mask)
    new_logits, cache = batched_decode_step(params, cache, tokens, positions,
                                            cfg)
    new_logits = torch.where(active[:, None], new_logits, logits_all)
    return tokens, tok_logp, new_logits, cache


def scheduler_admit(cache, logits_all, slot_cache, slot_logits, slot):
    """Admit one prefilled request into the slotted tensors, in place: its
    [L, 2, 1, S, Hkv, D] cache into batch row ``slot`` and its next-token
    logits [1, vocab] into ``logits_all`` row ``slot``."""
    cache[:, :, slot] = slot_cache[:, :, 0].to(cache.dtype)
    logits_all[slot] = slot_logits[0].to(logits_all.dtype)
    return cache, logits_all


def scheduler_extract(cache, slot):
    """One slot's cache rows as a fresh [L, 2, 1, S, Hkv, D] tensor."""
    return cache[:, :, slot:slot + 1].clone()


# -- paged KV (block-granular cache pool) ------------------------------------


def init_paged_kv_cache(cfg, n_pages, page_size, device, dtype=None):
    """[L, 2, n_pages + 1, page_size, Hkv, D] zeros: the paged form of
    :func:`init_kv_cache`.  A sequence's KV lives scattered across the
    pages its page table names.  Page id ``n_pages`` is the sentinel and
    the one extra page is its trash page: rows that hold no live request
    write there, and nothing reads it (JAX's pool has no such page and
    drops those writes with ``mode="drop"``, which has no counterpart
    here: an out-of-bounds write on the card is a device-side assert)."""
    return torch.zeros(
        (cfg.n_layers, 2, n_pages + 1, page_size, cfg.n_kv_heads,
         cfg.head_dim), dtype=dtype or cfg.dtype, device=device)


def paged_batched_decode_step(params, pages, tokens, page_tables, positions,
                              cfg):
    """:func:`batched_decode_step` over a paged pool: one decode token per
    sequence row, with each row's KV scattered across the physical pages
    its ``page_tables`` row names.

    ``pages`` is the pool from :func:`init_paged_kv_cache`;
    ``page_tables`` [S, pages_per_seq] maps each row's logical pages to
    physical ids (the sentinel ``n_pages`` for unreserved pages, never
    read below the row's valid length and never written).  Per layer
    the rows' pages are gathered (``index_select``) into the contiguous
    [S, max_seq, Hkv, D] view the slotted step attends over: the same
    values in the same order, so the step is bitwise equal to the slotted
    one.  New K/V land at (``page_tables[s, positions[s] // page_size]``,
    ``positions[s] % page_size``); rows at the sentinel position
    ``max_seq`` write into the trash page.  Returns (logits [S, vocab]
    fp32, pages updated in place)."""
    S = tokens.shape[0]
    n_pages, page = pages.shape[2] - 1, pages.shape[3]
    ppseq = page_tables.shape[1]
    max_seq = ppseq * page
    positions = positions.long()
    page_tables = page_tables.long()
    live, lengths = _live_lengths(positions, max_seq)
    logical = (positions // page).clamp(0, ppseq - 1)
    phys = page_tables.gather(1, logical[:, None])[:, 0]
    phys = torch.where(live, phys, torch.full_like(phys, n_pages))
    offs = positions % page
    # unreserved logical pages read a valid (arbitrary) page, never the
    # trash page: all they contribute lies past the row's valid length
    gather_ids = page_tables.clamp(0, n_pages - 1).reshape(-1)
    q_pos = positions[:, None]
    n_rep = cfg.n_heads // cfg.n_kv_heads
    block_k = _decode_block(max_seq)
    decode_kernel = block_k is not None and cfg.decode_impl == "auto"
    x = _embed_rows(params, tokens, cfg)[:, None, :]  # [S, 1, Dm]

    for i, layer in enumerate(params["layers"]):
        def attn_fn(q, k, v, i=i):
            pages[i, 0, phys, offs] = k[:, 0].to(pages.dtype)
            pages[i, 1, phys, offs] = v[:, 0].to(pages.dtype)
            tail = pages.shape[4:]
            k_seq = pages[i, 0].index_select(0, gather_ids).view(
                S, max_seq, *tail)
            v_seq = pages[i, 1].index_select(0, gather_ids).view(
                S, max_seq, *tail)
            if decode_kernel:
                # the gathered view is a plain contiguous cache: the
                # decode kernel applies unchanged
                out = decode_attention(q[:, 0], k_seq, v_seq, lengths,
                                       block_k=block_k)
                return out[:, None]
            return _attend_cached(q, k_seq, v_seq, q_pos, lengths, n_rep)

        x = _block(layer, x, q_pos, cfg, attn_fn)
    x = _rms_norm(x, params["norm"], cfg.norm_eps)
    logits = _mm(x[:, 0, :], params["lm_head"]).float()
    return logits, pages


def paged_scheduler_step(params, pages, logits_all, page_tables, positions,
                         active, forced, forced_mask, cfg):
    """:func:`scheduler_step` on the paged pool: greedy-or-forced token
    per row, then one :func:`paged_batched_decode_step`.  The page
    indirection changes where K/V bytes live, never what they are."""
    tokens, tok_logp = _sample(logits_all, forced, forced_mask)
    new_logits, pages = paged_batched_decode_step(
        params, pages, tokens, page_tables, positions, cfg)
    new_logits = torch.where(active[:, None], new_logits, logits_all)
    return tokens, tok_logp, new_logits, pages


def paged_spec_step(params, pages, logits_all, page_tables, positions,
                    active, forced, forced_mask, draft, draft_len, cfg):
    """Multi-token speculative verify: :func:`paged_scheduler_step`
    followed by up to K drafted continuation tokens, all in one call
    (``tpuserver_torch.speculative`` is the draft source).

    ``draft`` [S, K] holds each row's proposed continuation and
    ``draft_len`` [S] how many of those entries are real (0: no
    speculation for the row).  The step is a chain of K+1 sub-steps,
    each the exact op sequence of :func:`paged_scheduler_step` (log
    softmax, argmax, :func:`paged_batched_decode_step`) over all S rows,
    so every intermediate logits row is bitwise what K+1 separate
    single-token steps compute.  Sub-step 0 feeds the greedy-or-forced
    token at ``positions``; sub-step j feeds ``draft[:, j-1]`` at
    ``positions + j``, and rows past their ``draft_len`` feed at the
    sentinel ``max_seq`` (their write goes to the trash page, the row is
    inert for that sub-step).  Row ``i`` accepts the longest prefix of
    its drafts where the previous sub-step's argmax equals the drafted
    token, and its returned logits are the sub-step output at that
    depth, selected by indexing, never by masked arithmetic, so a
    poisoned row's NaN reaches the host's quarantine check intact.

    Rejected drafts leave K/V at ``positions + accept + 1`` onward, past
    the row's advanced write cursor: the next step overwrites them, and
    the retirement donation reads only up to the cursor.

    Returns (tokens [S, K+1], logprobs [S, K+1], accept [S] int32,
    new_logits [S, vocab], pages updated in place): ``tokens[:, 0]`` is
    the base token, ``tokens[:, j]`` the j-th draft, and the host emits
    ``tokens[i, :1 + accept[i]]``."""
    S, K = draft.shape
    max_seq = page_tables.shape[1] * pages.shape[3]
    positions = positions.long()
    draft = draft.long()
    t0, lp0 = _sample(logits_all, forced, forced_mask)
    cur, pages = paged_batched_decode_step(params, pages, t0, page_tables,
                                           positions, cfg)
    toks, lps = [t0], [lp0]
    stack = [cur]  # stack[j]: the logits after feeding sub-step j
    matches = []
    for j in range(1, K + 1):
        cand = draft[:, j - 1]
        fed = j <= draft_len
        logp = torch.log_softmax(cur, dim=-1)
        matches.append((torch.argmax(cur, dim=-1) == cand) & fed)
        lps.append(logp.gather(-1, cand[:, None])[:, 0])
        toks.append(cand)
        pos_j = torch.where(fed, positions + j,
                            torch.full_like(positions, max_seq))
        cur, pages = paged_batched_decode_step(params, pages, cand,
                                               page_tables, pos_j, cfg)
        stack.append(cur)
    accept = torch.cumprod(torch.stack(matches).int(), dim=0).sum(dim=0)
    final = torch.stack(stack)[accept, torch.arange(S, device=cur.device)]
    final = torch.where(active[:, None], final, logits_all)
    return (torch.stack(toks, dim=1), torch.stack(lps, dim=1),
            accept.int(), final, pages)


def _host_ids(ids):
    """A page-id vector (numpy array, list or tensor) as numpy int64."""
    if isinstance(ids, torch.Tensor):
        ids = ids.cpu().numpy()
    return np.asarray(ids, dtype=np.int64).reshape(-1)


def _host_tensor(a, device):
    """A host array as a tensor on ``device``.  On the card the copy goes
    through pinned memory without waiting: a copy from pageable memory
    would first wait for every step already in flight.  PyTorch's pinned
    allocator keeps the staging block until the copy has run, so the
    caller may reuse ``a`` at once."""
    t = torch.from_numpy(np.array(a))  # a copy: the caller may mutate a
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def paged_admit(pages, logits_all, slot_cache, slot_logits, dest_ids, slot):
    """Admit one prefilled request into the paged pool, in place: the
    single-row contiguous cache [L, 2, 1, max_seq, Hkv, D] splits into
    ``pages_per_seq`` logical pages, and page ``d`` is copied to the
    physical id ``dest_ids[d]``.  Sentinel ids (``n_pages``: unreserved
    pages, and shared prefix pages that already live in the pool) are
    left out on the host, where ``dest_ids`` lives, so only the reserved
    pages are copied.  The row's next-token logits land in
    ``logits_all`` row ``slot``."""
    n_pages, page = pages.shape[2] - 1, pages.shape[3]
    dest = _host_ids(dest_ids)
    keep = np.flatnonzero((dest >= 0) & (dest < n_pages))
    src = slot_cache.reshape(slot_cache.shape[0], 2, len(dest), page,
                             *slot_cache.shape[4:])
    if len(keep):
        src_ids = _host_tensor(keep, pages.device)
        dst_ids = _host_tensor(dest[keep], pages.device)
        pages[:, :, dst_ids] = src.index_select(2, src_ids).to(pages.dtype)
    logits_all[slot] = slot_logits[0].to(logits_all.dtype)
    return pages, logits_all


def paged_gather(pages, page_ids):
    """One sequence's pages as a fresh single-row contiguous cache
    [L, 2, 1, max_seq, Hkv, D]: the prefix-restore source a shared-prefix
    admission prefills on top of.  Sentinel or unreserved ids gather as
    zeros."""
    n_pages, page = pages.shape[2] - 1, pages.shape[3]
    ids = _host_ids(page_ids)
    keep = np.flatnonzero((ids >= 0) & (ids < n_pages))
    rows = torch.zeros((pages.shape[0], 2, len(ids)) + tuple(pages.shape[3:]),
                       dtype=pages.dtype, device=pages.device)
    if len(keep):
        rows[:, :, _host_tensor(keep, pages.device)] = pages.index_select(
            2, _host_tensor(ids[keep], pages.device))
    return rows.reshape(pages.shape[0], 2, 1, len(ids) * page,
                        *pages.shape[4:])


def prefill_span(params, cache, tokens, start, logits_at, cfg):
    """Prefill a token span [B, T] at positions ``start..start+T-1`` into
    a single-row contiguous cache: the chunked-prefill and
    shared-prefix-suffix building block.

    K/V land at ``start`` and queries attend the cache's first ``start +
    T`` positions under the causal mask, so a span on top of an
    already-present prefix (earlier chunks, or a radix-cache restore)
    computes what a from-zero prefill would.  The caller keeps
    ``start + T <= max_seq`` and uses spans only where the flash kernel
    is not in play (``make_scheduler_fns``'s ``span_safe``).

    Returns the logits at span index ``logits_at`` and the cache,
    updated in place."""
    B, T = tokens.shape
    positions = start + torch.arange(T, device=tokens.device)[None, :].expand(
        B, T)
    x = _embed_rows(params, tokens, cfg)
    x, cache = _run_cached(params, cache, x, positions, start, start + T,
                           cfg)
    x = _rms_norm(x, params["norm"], cfg.norm_eps)
    logits = _mm(x[:, logits_at, :], params["lm_head"]).float()
    return logits, cache


class _HostFetch:
    """A step output's copy into pinned host memory, enqueued right after
    the step: ``np.asarray`` of it waits for that copy alone.  A blocking
    ``.cpu()`` at fetch time would instead queue behind the next step,
    already dispatched, and serialise the scheduler's one-deep pipeline."""

    def __init__(self, t):
        self._event = None
        if t.device.type == "cuda":
            self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = t

    def __array__(self, dtype=None, copy=None):
        if self._event is not None:
            self._event.synchronize()
        a = self._host.numpy()
        return a if dtype is None else a.astype(dtype)


def make_scheduler_fns(cfg, max_seq, max_slots, page_size=16, kv_pages=None,
                       device=None):
    """The function bundle of the continuous-batching scheduler, over a
    paged KV pool on ``device`` (the card unless the caller asks for the
    CPU).

    The device cache is a page pool (:func:`init_paged_kv_cache`) rather
    than ``max_slots`` contiguous rows: a sequence holds only the pages
    its span needs, page tables map logical to physical pages, and the
    scheduler's host-side allocator and radix tree
    (``tpuserver_torch.paging``) decide who owns what.  ``kv_pages``
    defaults to ``max_slots * max_seq / page_size``.  The functions
    take their small integer inputs as host (numpy) arrays and stage
    them to the device without waiting.

    Returns a dict of:

    - ``init_cache()`` — the page pool
    - ``init_slot_cache()`` — a single-row contiguous cache for
      prefill-on-admit (copied into pages by ``admit``)
    - ``init_logits()`` — [max_slots, vocab] fp32 zeros
    - ``prefill(params, slot_cache, tokens, true_len)`` — the one-shot
      admission prefill (:func:`prefill_to_length`); ``tokens`` is a host
      array, or a tensor already on the device
    - ``prefill_span(params, slot_cache, tokens, start, logits_at)`` —
      the chunked / shared-prefix-suffix prefill (:func:`prefill_span`)
    - ``prefill_bucket(true_len)`` — the padded length to use
    - ``step(params, pages, logits, page_tables, positions, active,
      forced, forced_mask)`` — :func:`paged_scheduler_step`; its tokens
      and logprobs come back as objects that ``np.asarray`` turns into
      host arrays, waiting for this step's copy alone
    - ``spec_step(params, pages, logits, page_tables, positions, active,
      forced, forced_mask, draft, draft_len)`` — :func:`paged_spec_step`,
      the speculative verify; tokens, logprobs and accept counts come
      back as ``step``'s do
    - ``admit(pages, logits, slot_cache, slot_logits, dest_ids, slot)``
      — :func:`paged_admit`
    - ``gather(pages, page_ids)`` — :func:`paged_gather`, the
      shared-prefix restore
    - ``page_size`` / ``pages_per_seq`` / ``n_pages`` — the pool
      geometry the scheduler's allocator mirrors
    - ``span_safe`` — whether chunked or shared-prefix prefill keeps the
      one-shot prefill's kernel choice (False where the flash kernel
      prefills: a dense span against a one-shot flash pass could flip a
      near-tie greedy argmax, the hazard :func:`prefill_bucket` guards,
      so the scheduler prefills whole prompts there)
    """
    device = resolve_device(device)
    page_size = int(page_size)
    if page_size < 1 or max_seq % page_size:
        raise ValueError(
            "page_size must be >= 1 and divide max_seq (got page_size={}, "
            "max_seq={}): a slot's cache row must stay [.., max_seq, ..] "
            "for the single-row prefill".format(page_size, max_seq))
    pages_per_seq = max_seq // page_size
    n_pages = (int(kv_pages) if kv_pages is not None
               else max_slots * pages_per_seq)
    if n_pages < pages_per_seq:
        raise ValueError(
            "kv_pages={} cannot hold even one full-length sequence ({} "
            "pages of {} tokens)".format(n_pages, pages_per_seq, page_size))

    def tokens_in(tokens):
        if isinstance(tokens, torch.Tensor):
            # already on the device (a prompt read from a CUDA-shm
            # region): cast there, no host round trip
            return tokens.to(device=device, dtype=torch.int64)
        return _host_tensor(np.asarray(tokens, np.int64), device)

    def init_cache():
        return init_paged_kv_cache(cfg, n_pages, page_size, device)

    def init_slot_cache():
        return init_kv_cache(cfg, 1, max_seq, device)

    def init_logits():
        return torch.zeros((max_slots, cfg.vocab), dtype=torch.float32,
                           device=device)

    def prefill(params, slot_cache, tokens, true_len):
        return prefill_to_length(params, slot_cache, tokens_in(tokens),
                                 int(true_len), cfg)

    def prefill_span_fn(params, slot_cache, tokens, start, logits_at):
        return prefill_span(params, slot_cache, tokens_in(tokens),
                            int(start), int(logits_at), cfg)

    def step(params, pages, logits, page_tables, positions, active, forced,
             forced_mask):
        # one staged copy for all five control inputs
        s = max_slots * pages_per_seq
        packed = tokens_in(np.concatenate([
            np.asarray(page_tables).reshape(-1), np.asarray(positions),
            np.asarray(active), np.asarray(forced),
            np.asarray(forced_mask)]))
        tables_d = packed[:s].view(max_slots, pages_per_seq)
        pos_d, active_d, forced_d, fmask_d = packed[s:].view(4, max_slots)
        toks, logps, logits, pages = paged_scheduler_step(
            params, pages, logits, tables_d, pos_d, active_d != 0, forced_d,
            fmask_d != 0, cfg)
        return _HostFetch(toks), _HostFetch(logps), logits, pages

    def spec_step(params, pages, logits, page_tables, positions, active,
                  forced, forced_mask, draft, draft_len):
        # one staged copy for the step's five control inputs and the
        # drafts
        s = max_slots * pages_per_seq
        k = np.asarray(draft).shape[1]
        packed = tokens_in(np.concatenate([
            np.asarray(page_tables).reshape(-1), np.asarray(positions),
            np.asarray(active), np.asarray(forced),
            np.asarray(forced_mask), np.asarray(draft_len),
            np.asarray(draft).reshape(-1)]))
        tables_d = packed[:s].view(max_slots, pages_per_seq)
        pos_d, active_d, forced_d, fmask_d, dlen_d = packed[
            s:s + 5 * max_slots].view(5, max_slots)
        draft_d = packed[s + 5 * max_slots:].view(max_slots, k)
        toks, logps, accept, logits, pages = paged_spec_step(
            params, pages, logits, tables_d, pos_d, active_d != 0, forced_d,
            fmask_d != 0, draft_d, dlen_d, cfg)
        return (_HostFetch(toks), _HostFetch(logps), _HostFetch(accept),
                logits, pages)

    return {
        "init_cache": init_cache,
        "init_slot_cache": init_slot_cache,
        "init_logits": init_logits,
        "prefill": prefill,
        "prefill_span": prefill_span_fn,
        "prefill_bucket": functools.partial(prefill_bucket, cfg, max_seq),
        "step": step,
        "spec_step": spec_step,
        "admit": paged_admit,
        "gather": paged_gather,
        "page_size": page_size,
        "pages_per_seq": pages_per_seq,
        "n_pages": n_pages,
        "span_safe": cfg.attn_impl != "kernel",
    }
