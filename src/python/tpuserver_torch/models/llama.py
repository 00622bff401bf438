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
- tensor-parallel serving over ``torch.distributed``: ``param_specs``,
  ``cache_spec``, ``serving_shardings``, ``tp_params`` (each rank's
  shard), ``make_tp_serving``, ``make_tp_step``,
  ``make_scheduler_fns(mesh=)`` and the park layout (``tp_gather_cache``,
  ``tp_scatter_cache``).  The serving functions take ``tp=``, a rank's
  ``tpuserver_torch.parallel.spmd.TPContext`` (local head counts, the
  all-reduce after each row-parallel product, the vocab-split embedding
  and the gathered logits); the mesh's driver mirrors each call on every
  rank (``tpuserver_torch.parallel.spmd``)
- SPMD training over a (dp, sp, tp) mesh: ``sharded_forward`` and
  ``_forward_spmd`` (the vocab-split embedding, ``copy_to_tp`` and
  ``reduce_from_tp`` around the Megatron products, ring or Ulysses
  attention over sp, the logits gathered over tp) and ``make_train_step``
  (AdamW, gradients summed over dp x sp); every rank runs its own loop
"""

import dataclasses
import functools
import gc

import numpy as np
import torch
import torch.nn.functional as F

from tpuserver_torch import resolve_device
from tpuserver_torch.ops import decode_attention, flash_attention, quant
from tpuserver_torch.parallel import spmd
from tpuserver_torch.parallel.collectives import (
    copy_to_tp,
    gather_from_tp,
    mesh_context,
    reduce_from_tp,
)
from tpuserver_torch.parallel.mesh import mesh_state, shard, shard_tree
from tpuserver_torch.parallel.ring import ring_attention
from tpuserver_torch.parallel.ulysses import ulysses_attention


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
    # sequence-parallel attention of the SPMD (training) forward: "ring"
    # (K/V rotate around the sp ring: any head count) or "ulysses" (two
    # all-to-alls, full-sequence attention per head shard: local heads
    # divisible by sp)
    sp_strategy: str = "ring"
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


def _draw(cfg, generator, device):
    """:func:`init_params`' leaves one at a time, in its draw order, as
    (path, tensor): ``("embed",)``, ``("lm_head",)``, ``("layers", i,
    name)`` and ``("norm",)``."""

    def dense(shape, fan_in):
        w = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return w.div_(float(np.sqrt(fan_in))).to(cfg.dtype)

    def ones():
        return torch.ones(cfg.d_model, dtype=cfg.dtype, device=device)

    hd = cfg.head_dim
    dm = cfg.d_model
    yield ("embed",), dense((cfg.vocab, dm), dm)
    yield ("lm_head",), dense((dm, cfg.vocab), dm)
    for i in range(cfg.n_layers):
        yield ("layers", i, "attn_norm"), ones()
        yield ("layers", i, "wq"), dense((dm, cfg.n_heads * hd), dm)
        yield ("layers", i, "wk"), dense((dm, cfg.n_kv_heads * hd), dm)
        yield ("layers", i, "wv"), dense((dm, cfg.n_kv_heads * hd), dm)
        yield ("layers", i, "wo"), dense((cfg.n_heads * hd, dm),
                                         cfg.n_heads * hd)
        yield ("layers", i, "mlp_norm"), ones()
        yield ("layers", i, "w_gate"), dense((dm, cfg.d_ff), dm)
        yield ("layers", i, "w_up"), dense((dm, cfg.d_ff), dm)
        yield ("layers", i, "w_down"), dense((cfg.d_ff, dm), cfg.d_ff)
    yield ("norm",), ones()


def _tree(cfg, leaves):
    """The params dict of :func:`_draw`'s (path, leaf) pairs."""
    params = {"embed": None, "layers": [{} for _ in range(cfg.n_layers)],
              "norm": None, "lm_head": None}
    for path, leaf in leaves:
        if path[0] == "layers":
            params["layers"][path[1]][path[2]] = leaf
        else:
            params[path[0]] = leaf
    return params


def init_params(cfg, generator, device):
    """Random params in ``cfg.dtype`` on ``device``: normal / sqrt(fan_in)
    for projections and embeddings, ones for the norm weights (the JAX
    init's distribution; the numbers differ, as the generators do).
    ``generator`` is a seeded ``torch.Generator`` on ``device``."""
    return _tree(cfg, _draw(cfg, generator, device))


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


def _mm(x, w, reduce=None):
    """Matmul against a plain or int8-quantized weight leaf; ``reduce``
    (a row-parallel product's all-reduce over tp) applies to its partial
    sums (``quant.matmul``)."""
    return quant.matmul(x, w, reduce=reduce)


def _embed_rows(params, tokens, cfg, tp=None, reduce=None):
    """Embedding lookup from a plain or row-quantized table, dequantized
    rows in ``cfg.dtype``.  Under tp the table is split on vocab: each
    rank gathers the rows it holds (zeros for the others) and the
    all-reduce (``reduce``, default ``tp.all_reduce``) sums them, as JAX's
    ``_forward_spmd`` does."""
    table = params["embed"]
    if tp is None:
        return quant.gather_rows(table, tokens, dtype=cfg.dtype)
    vloc = (table["q"] if quant.is_quantized(table) else table).shape[0]
    local = tokens - tp.rank * vloc
    hit = (local >= 0) & (local < vloc)
    rows = quant.gather_rows(table, local.clamp(0, vloc - 1),
                             dtype=cfg.dtype)
    return (reduce or tp.all_reduce)(torch.where(hit[..., None], rows,
                                                 rows.new_zeros(())))


def _logits(x, params, tp=None):
    """float32 logits of the final-normed ``x``; under tp the lm_head is
    column-parallel and its slices are gathered, so that every rank
    holds the full logits."""
    y = _mm(x, params["lm_head"])
    if tp is not None:
        y = tp.all_gather(y, dim=-1)
    return y.float()


def _tp_kwargs(cfg, tp, layer):
    """``_block``'s local head counts and reduction for block ``layer``
    under tp ({} without)."""
    if tp is None:
        return {}
    return {"n_heads": cfg.n_heads // tp.size,
            "n_kv_heads": cfg.n_kv_heads // tp.size,
            "reduce": tp.faults.get(layer, tp.all_reduce)}


def _kv_heads(cfg, tp):
    """The kv heads a rank's cache holds."""
    return cfg.n_kv_heads // (tp.size if tp is not None else 1)


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


def _block(params, x, positions, cfg, attn_fn, n_heads=None,
           n_kv_heads=None, reduce=None, enter=None):
    """One transformer block: x [B, T, Dm] -> [B, T, Dm]; ``attn_fn(q, k,
    v)`` takes q [B, T, H, D] and un-expanded k/v [B, T, Hkv, D].

    ``n_heads``/``n_kv_heads`` are the local head counts (a tp shard's);
    ``reduce(partial, op)`` is the all-reduce of the row-parallel
    products (wo, w_down) over tp, None without tp; ``enter(h)`` applies
    to each norm's output before the column-parallel products (training's
    ``copy_to_tp``, whose backward sums the gradient over tp), None when
    serving."""
    B, T, _ = x.shape
    hd = cfg.head_dim
    nh = n_heads if n_heads is not None else cfg.n_heads
    nkv = n_kv_heads if n_kv_heads is not None else cfg.n_kv_heads
    h = _rms_norm(x, params["attn_norm"], cfg.norm_eps)
    if enter is not None:
        h = enter(h)
    q = _mm(h, params["wq"]).reshape(B, T, nh, hd)
    k = _mm(h, params["wk"]).reshape(B, T, nkv, hd)
    v = _mm(h, params["wv"]).reshape(B, T, nkv, hd)
    q = _rope(q, positions, cfg.rope_theta)
    k = _rope(k, positions, cfg.rope_theta)
    attn = attn_fn(q, k, v)
    x = x + _mm(attn.reshape(B, T, nh * hd), params["wo"], reduce)
    h = _rms_norm(x, params["mlp_norm"], cfg.norm_eps)
    if enter is not None:
        h = enter(h)
    gated = F.silu(_mm(h, params["w_gate"])) * _mm(h, params["w_up"])
    return x + _mm(gated, params["w_down"], reduce)


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


def init_kv_cache(cfg, batch, max_seq, device, dtype=None, tp=None):
    """[n_layers, 2, B, max_seq, n_kv_heads, head_dim] zeros (under tp a
    rank's shard: its kv heads, ``cache_spec``)."""
    return torch.zeros(
        (cfg.n_layers, 2, batch, max_seq, _kv_heads(cfg, tp), cfg.head_dim),
        dtype=dtype or cfg.dtype, device=device)


def _decode_block(max_seq):
    """The decode kernel's block_k for a cache of ``max_seq`` (256 or
    128), or None when neither tiles it (the dense path then runs)."""
    return next((b for b in (256, 128) if max_seq % b == 0), None)


def _run_cached(params, cache, x, positions, write_pos, lengths, cfg,
                tp=None):
    """Shared decode/prefill body: run all blocks, writing new K/V into
    ``cache`` IN PLACE at ``write_pos`` and attending over
    ``cache[:lengths]``.

    x: [B, T, Dm] embedded inputs; write_pos and lengths are ints; under
    ``tp`` the cache and the attention hold the rank's heads.
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

        x = _block(layer, x, positions, cfg, attn_fn,
                   **_tp_kwargs(cfg, tp, i))
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


def decode_step(params, cache, tokens, pos, cfg, tp=None):
    """One token of autoregressive decode.

    tokens: [B] int64/int32; pos: int (current position, same for the
    batch).  Returns (logits [B, vocab] fp32, cache updated in place)."""
    B = tokens.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.long,
                           device=tokens.device)
    x = _embed_rows(params, tokens, cfg, tp)[:, None, :]  # [B, 1, Dm]
    x, cache = _run_cached(params, cache, x, positions, pos, pos + 1, cfg,
                           tp)
    x = _rms_norm(x, params["norm"], cfg.norm_eps)
    return _logits(x[:, 0, :], params, tp), cache


def prefill(params, cache, tokens, cfg, tp=None):
    """Run the prompt tokens [B, T] through the cache in one batched
    pass from position 0; returns (last logits [B, vocab] fp32, cache
    updated in place)."""
    B, T = tokens.shape
    positions = torch.arange(T, device=tokens.device)[None, :].expand(B, T)
    x = _embed_rows(params, tokens, cfg, tp)
    x, cache = _run_cached(params, cache, x, positions, 0, T, cfg, tp)
    x = _rms_norm(x, params["norm"], cfg.norm_eps)
    return _logits(x[:, -1, :], params, tp), cache


def decode_chunk(params, cache, logits, pos, cfg, chunk, tp=None):
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
        logits, cache = decode_step(params, cache, token, pos + i, cfg, tp)
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


def prefill_to_length(params, cache, tokens, true_len, cfg, tp=None):
    """Prefill a PADDED prompt [B, T] from position 0, returning the
    logits at ``true_len - 1`` (and the cache, updated in place).

    Causal attention makes the padding harmless: position ``true_len -
    1`` attends only positions <= itself, and the padding rows' K/V
    (written at ``true_len..T-1``) sit past the slot's length, masked
    until decode steps overwrite them."""
    B, T = tokens.shape
    positions = torch.arange(T, device=tokens.device)[None, :].expand(B, T)
    x = _embed_rows(params, tokens, cfg, tp)
    x, cache = _run_cached(params, cache, x, positions, 0, T, cfg, tp)
    x = _rms_norm(x, params["norm"], cfg.norm_eps)
    return _logits(x[:, true_len - 1, :], params, tp), cache


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


def batched_decode_step(params, cache, tokens, positions, cfg, tp=None):
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
    x = _embed_rows(params, tokens, cfg, tp)[:, None, :]  # [S, 1, Dm]

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

        x = _block(layer, x, q_pos, cfg, attn_fn, **_tp_kwargs(cfg, tp, i))
    x = _rms_norm(x, params["norm"], cfg.norm_eps)
    return _logits(x[:, 0, :], params, tp), cache


def _sample(logits_all, forced, forced_mask):
    """Greedy token per row, or the row's ``forced`` token where
    ``forced_mask`` says so, with its log-probability."""
    logp = torch.log_softmax(logits_all, dim=-1)
    greedy = torch.argmax(logits_all, dim=-1)
    tokens = torch.where(forced_mask, forced.long(), greedy)
    return tokens, logp.gather(-1, tokens[:, None])[:, 0]


def scheduler_step(params, cache, logits_all, positions, active, forced,
                   forced_mask, cfg, tp=None):
    """One continuous-batching iteration over every cache slot.

    Each slot's next token is sampled greedily from its ``logits_all``
    row, or its ``forced`` token is taken where ``forced_mask`` is set;
    the batched decode step then writes every active row's K/V at its
    own position.  Inactive rows keep their previous logits.

    Returns (tokens [S], logprobs [S], next logits [S, vocab], cache)."""
    tokens, tok_logp = _sample(logits_all, forced, forced_mask)
    new_logits, cache = batched_decode_step(params, cache, tokens, positions,
                                            cfg, tp)
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


def init_paged_kv_cache(cfg, n_pages, page_size, device, dtype=None,
                        tp=None):
    """[L, 2, n_pages + 1, page_size, Hkv, D] zeros: the paged form of
    :func:`init_kv_cache`.  A sequence's KV lives scattered across the
    pages its page table names.  Page id ``n_pages`` is the sentinel and
    the one extra page is its trash page: rows that hold no live request
    write there, and nothing reads it (JAX's pool has no such page and
    drops those writes with ``mode="drop"``, which has no counterpart
    here: an out-of-bounds write on the card is a device-side assert)."""
    return torch.zeros(
        (cfg.n_layers, 2, n_pages + 1, page_size, _kv_heads(cfg, tp),
         cfg.head_dim), dtype=dtype or cfg.dtype, device=device)


def paged_batched_decode_step(params, pages, tokens, page_tables, positions,
                              cfg, tp=None):
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
    x = _embed_rows(params, tokens, cfg, tp)[:, None, :]  # [S, 1, Dm]

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

        x = _block(layer, x, q_pos, cfg, attn_fn, **_tp_kwargs(cfg, tp, i))
    x = _rms_norm(x, params["norm"], cfg.norm_eps)
    return _logits(x[:, 0, :], params, tp), pages


def paged_scheduler_step(params, pages, logits_all, page_tables, positions,
                         active, forced, forced_mask, cfg, tp=None):
    """:func:`scheduler_step` on the paged pool: greedy-or-forced token
    per row, then one :func:`paged_batched_decode_step`.  The page
    indirection changes where K/V bytes live, never what they are."""
    tokens, tok_logp = _sample(logits_all, forced, forced_mask)
    new_logits, pages = paged_batched_decode_step(
        params, pages, tokens, page_tables, positions, cfg, tp)
    new_logits = torch.where(active[:, None], new_logits, logits_all)
    return tokens, tok_logp, new_logits, pages


def paged_spec_step(params, pages, logits_all, page_tables, positions,
                    active, forced, forced_mask, draft, draft_len, cfg,
                    tp=None):
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
                                           positions, cfg, tp)
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
                                               page_tables, pos_j, cfg, tp)
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


def prefill_span(params, cache, tokens, start, logits_at, cfg, tp=None):
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
    x = _embed_rows(params, tokens, cfg, tp)
    x, cache = _run_cached(params, cache, x, positions, start, start + T,
                           cfg, tp)
    x = _rms_norm(x, params["norm"], cfg.norm_eps)
    return _logits(x[:, logits_at, :], params, tp), cache


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
                       device=None, mesh=None, quantized=False):
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

    With a ``mesh`` (``tpuserver_torch.parallel.make_mesh``) the bundle is
    the tensor-parallel form, run on the mesh's driver: params
    Megatron-split (``param_specs``), the page pool and slot cache
    kv-head-sharded over tp (``cache_spec``: the page axes are unsharded,
    so the gather and scatter indexing stays collective-free), the
    logits and control inputs replicated.  Each function is mirrored on
    every rank (``tpuserver_torch.parallel.spmd``); ``device`` is the
    mesh's.  A parked or attached cache in the full layout given to
    ``admit`` scatters its kv heads to their ranks.  ``quantized`` is
    JAX's argument (there it picks the shardings) and is accepted for
    its signature: the port reads the weight format from the params.
    """
    if mesh is not None:
        m = _tp_mirror(mesh, cfg, device)
        device, tp, run = spmd.DEVICE, spmd.LOCAL, m.call
    else:
        device, tp, run = resolve_device(device), None, _direct
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
    geometry = (max_slots, pages_per_seq)

    def init_cache():
        if mesh is not None:
            # a restarted loop's dead pool (in a reference cycle, say)
            # frees on every rank before its successor is allocated
            gc.collect()
        return run(init_paged_kv_cache, cfg, n_pages, page_size, device,
                   tp=tp)

    def init_slot_cache():
        return run(init_kv_cache, cfg, 1, max_seq, device, tp=tp)

    def init_logits():
        return run(_zero_logits, max_slots, cfg.vocab, device)

    def prefill(params, slot_cache, tokens, true_len):
        return run(_bundle_prefill, params, slot_cache, tokens,
                   int(true_len), cfg, device, tp=tp)

    def prefill_span_fn(params, slot_cache, tokens, start, logits_at):
        return run(_bundle_prefill_span, params, slot_cache, tokens,
                   int(start), int(logits_at), cfg, device, tp=tp)

    def step(params, pages, logits, page_tables, positions, active, forced,
             forced_mask):
        return run(_bundle_step, params, pages, logits,
                   page_tables, positions, active, forced, forced_mask,
                   geometry, cfg, device, tp=tp)

    def spec_step(params, pages, logits, page_tables, positions, active,
                  forced, forced_mask, draft, draft_len):
        return run(_bundle_spec_step, params, pages, logits,
                   page_tables, positions, active, forced, forced_mask,
                   draft, draft_len, geometry, cfg, device, tp=tp)

    def admit(pages, logits, slot_cache, slot_logits, dest_ids, slot):
        return run(_bundle_admit, pages, logits, slot_cache, slot_logits,
                   dest_ids, slot, tp=tp)

    def gather(pages, page_ids):
        return run(paged_gather, pages, page_ids)

    return {
        "init_cache": init_cache,
        "init_slot_cache": init_slot_cache,
        "init_logits": init_logits,
        "prefill": prefill,
        "prefill_span": prefill_span_fn,
        "prefill_bucket": functools.partial(prefill_bucket, cfg, max_seq),
        "step": step,
        "spec_step": spec_step,
        "admit": admit,
        "gather": gather,
        "page_size": page_size,
        "pages_per_seq": pages_per_seq,
        "n_pages": n_pages,
        "span_safe": cfg.attn_impl != "kernel",
    }


def _direct(fn, *args, **kwargs):
    """A bundle function's body run here alone (no mesh)."""
    return fn(*args, **kwargs)


def _tokens(tokens, device):
    """Token ids as int64 on ``device``: a host array is staged without
    waiting; a tensor already on the device (a prompt read from a
    CUDA-shm region) is cast there, with no host round trip."""
    if isinstance(tokens, torch.Tensor):
        return tokens.to(device=device, dtype=torch.int64)
    return _host_tensor(np.asarray(tokens, np.int64), device)


def _zero_logits(rows, vocab, device):
    return torch.zeros((rows, vocab), dtype=torch.float32, device=device)


def _bundle_prefill(params, slot_cache, tokens, true_len, cfg, device,
                    tp=None):
    return prefill_to_length(params, slot_cache, _tokens(tokens, device),
                             true_len, cfg, tp)


def _bundle_prefill_span(params, slot_cache, tokens, start, logits_at, cfg,
                         device, tp=None):
    return prefill_span(params, slot_cache, _tokens(tokens, device), start,
                        logits_at, cfg, tp)


def _bundle_step(params, pages, logits, page_tables, positions, active,
                 forced, forced_mask, geometry, cfg, device, tp=None):
    max_slots, pages_per_seq = geometry
    # one staged copy for all five control inputs
    s = max_slots * pages_per_seq
    packed = _tokens(np.concatenate([
        np.asarray(page_tables).reshape(-1), np.asarray(positions),
        np.asarray(active), np.asarray(forced),
        np.asarray(forced_mask)]), device)
    tables_d = packed[:s].view(max_slots, pages_per_seq)
    pos_d, active_d, forced_d, fmask_d = packed[s:].view(4, max_slots)
    toks, logps, logits, pages = paged_scheduler_step(
        params, pages, logits, tables_d, pos_d, active_d != 0, forced_d,
        fmask_d != 0, cfg, tp)
    return _HostFetch(toks), _HostFetch(logps), logits, pages


def _bundle_spec_step(params, pages, logits, page_tables, positions, active,
                      forced, forced_mask, draft, draft_len, geometry, cfg,
                      device, tp=None):
    max_slots, pages_per_seq = geometry
    # one staged copy for the step's five control inputs and the drafts
    s = max_slots * pages_per_seq
    k = np.asarray(draft).shape[1]
    packed = _tokens(np.concatenate([
        np.asarray(page_tables).reshape(-1), np.asarray(positions),
        np.asarray(active), np.asarray(forced),
        np.asarray(forced_mask), np.asarray(draft_len),
        np.asarray(draft).reshape(-1)]), device)
    tables_d = packed[:s].view(max_slots, pages_per_seq)
    pos_d, active_d, forced_d, fmask_d, dlen_d = packed[
        s:s + 5 * max_slots].view(5, max_slots)
    draft_d = packed[s + 5 * max_slots:].view(max_slots, k)
    toks, logps, accept, logits, pages = paged_spec_step(
        params, pages, logits, tables_d, pos_d, active_d != 0, forced_d,
        fmask_d != 0, draft_d, dlen_d, cfg, tp)
    return (_HostFetch(toks), _HostFetch(logps), _HostFetch(accept),
            logits, pages)


def _bundle_admit(pages, logits, slot_cache, slot_logits, dest_ids, slot,
                  tp=None):
    if tp is not None and slot_cache.shape[4] != pages.shape[4]:
        # a parked or attached cache in the full layout: this rank's heads
        slot_cache = shard(slot_cache, 4, tp.size, tp.rank)
    return paged_admit(pages, logits, slot_cache, slot_logits, dest_ids,
                       slot)


# -- tensor-parallel serving -------------------------------------------------


def param_specs(cfg, quantized=False, quantized_embed=False):
    """The shard dim of every params leaf over tp (None: replicated):
    the Megatron split, as the JAX package's ``param_specs``.  wq, wk,
    wv, w_gate, w_up and lm_head are column-parallel (dim 1), wo and
    w_down row-parallel (dim 0), embed split on vocab (dim 0), the norms
    replicated.

    With ``quantized=True`` the specs match the ``quantize_params`` tree:
    each int8 weight keeps its spec and its per-output-channel scale
    shards with the weight's outputs (replicated for the row-parallel
    weights, whose outputs are whole).  ``quantized_embed=True`` iff
    ``quantize_params`` ran with ``quantize_embed=True`` (its per-row
    scales shard with the vocab rows)."""

    def wspec(dim, scale_dim):
        return dim if not quantized else {"q": dim, "s": scale_dim}

    col, row = wspec(1, 0), wspec(0, None)
    layer = {"attn_norm": None, "wq": col, "wk": col, "wv": col, "wo": row,
             "mlp_norm": None, "w_gate": col, "w_up": col, "w_down": row}
    return {
        "embed": ({"q": 0, "s": 0} if quantized and quantized_embed
                  else 0),
        "layers": [dict(layer) for _ in range(cfg.n_layers)],
        "norm": None,
        "lm_head": col,
    }


def cache_spec(cfg):
    """The shard dim of the KV cache [n_layers, 2, B, S, n_kv_heads, hd]
    and of the page pool [n_layers, 2, pages, page, n_kv_heads, hd]: the
    kv heads (dim 4).  Each rank owns its heads' cache rows, so decode's
    cache reads and writes are collective-free."""
    return 4


def serving_shardings(mesh, cfg, quantized=False, quantized_embed=False):
    """``(param specs, cache spec, None)`` for TP serving, the shape of
    the JAX package's ``(param_sh, cache_sh, repl)``: a torch tensor
    carries no layout, so the shardings are the shard dims each rank
    applies (``shard_params``), and a replicated value has none."""
    _check_tp(cfg, mesh_state(mesh).tp)
    return (param_specs(cfg, quantized=quantized,
                        quantized_embed=quantized_embed),
            cache_spec(cfg), None)


def _check_tp(cfg, tp):
    if cfg.n_heads % tp or cfg.n_kv_heads % tp:
        raise ValueError(
            "tp={} must divide n_heads={} and n_kv_heads={}".format(
                tp, cfg.n_heads, cfg.n_kv_heads))
    if cfg.vocab % tp or cfg.d_ff % tp:
        raise ValueError(
            "tp={} must divide vocab={} and d_ff={} (the port shards "
            "evenly)".format(tp, cfg.vocab, cfg.d_ff))


def _mesh_device(mesh, device=None):
    """The mesh's state, after checking that ``device`` (when given) is
    the mesh's kind."""
    state = mesh_state(mesh)
    if device is not None and resolve_device(device).type != \
            state.device.type:
        raise ValueError("device {} is not the mesh's ({})".format(
            device, state.device))
    return state


def _tp_mirror(mesh, cfg, device=None):
    """The mesh's mirror, after checking that ``cfg`` shards over its tp
    and that ``device`` (when given) is the mesh's kind."""
    _check_tp(cfg, _mesh_device(mesh, device).tp)
    return spmd.mirror(mesh)


def _draw_shard(cfg, seed, quantize, device, tp=None):
    """This rank's shard of ``init_params`` drawn from ``seed``: every full
    leaf is drawn in ``init_params``' order on ``device`` (the same
    numbers on every rank), int8-quantized when asked (the full leaf, as
    ``quantize_params`` does, so that the scales are the unsharded
    ones), then cut to this rank's slice; the rest is freed before the
    next leaf.  The shards concatenate to the unsharded params bit for
    bit."""
    gen = torch.Generator(device=device).manual_seed(seed)
    specs = param_specs(cfg, quantized=quantize)
    size, rank = (tp.size, tp.rank) if tp is not None else (1, 0)

    def one(path, leaf):
        spec = specs
        for p in path:
            spec = spec[p]
        if quantize and path[-1] in _QUANTIZED_LAYER_WEIGHTS + ("lm_head",):
            leaf = quant.quantize_int8(leaf, axis=0)
        return shard_tree(leaf, spec, size, rank)

    return _tree(cfg, ((path, one(path, leaf))
                       for path, leaf in _draw(cfg, gen, device)))


def _shard_local(params, specs, tp=None):
    return shard_tree(params, specs, tp.size, tp.rank)


def tp_params(mesh, cfg, params=None, seed=0, quantize=False):
    """The served params over a mesh, as the driver's handles to every
    rank's shard.  ``params=None``: each rank draws them from ``seed``
    (:func:`_draw_shard`; ``quantize`` makes them int8).  Given full
    ``params`` (e.g. from :func:`params_from_jax`) on the driver, they
    are quantized first when ``quantize`` asks and they are not yet, then
    sent to every rank, which keeps its slice (``shard_params``)."""
    m = _tp_mirror(mesh, cfg)
    if params is None:
        return m.call(_draw_shard, cfg, int(seed), bool(quantize),
                      spmd.DEVICE, tp=spmd.LOCAL)
    if quantize and not quant.is_quantized(params["lm_head"]):
        params = quantize_params(params)
    specs = param_specs(cfg, quantized=quant.is_quantized(params["lm_head"]),
                        quantized_embed=quant.is_quantized(params["embed"]))
    return m.call(_shard_local, params, specs, tp=spmd.LOCAL)


def _full_heads(cache, tp=None):
    return tp.all_gather(cache, dim=4)


def _local_heads(full, tp=None):
    local = shard(full, 4, tp.size, tp.rank)
    return local.clone() if local is full else local


def tp_gather_cache(mesh, cache):
    """A sharded cache (or slot cache) in the full ``[L, 2, B, S, Hkv,
    D]`` layout, on the driver: the ranks' kv heads all-gathered.  The
    park of a TP generation, which any tp degree can attach."""
    return spmd.mirror(mesh).call(_full_heads, cache, tp=spmd.LOCAL,
                                  keep=False)


def tp_scatter_cache(mesh, full):
    """A full-layout cache given on the driver as a sharded cache: each
    rank keeps a copy of its kv heads (the attach of a park)."""
    return spmd.mirror(mesh).call(_local_heads, full, tp=spmd.LOCAL)


def _tp_prefill(params, cache, tokens, cfg, device, tp=None):
    return prefill(params, cache, _tokens(tokens, device), cfg, tp)


def _tp_decode_chunk(params, cache, logits, pos, cfg, chunk, donate,
                     tp=None):
    if not donate:
        cache = cache.clone()
    return decode_chunk(params, cache, logits, pos, cfg, chunk, tp)


def _tp_step(params, cache, tokens, pos, cfg, donate, device, tp=None):
    if not donate:
        cache = cache.clone()
    return decode_step(params, cache, _tokens(tokens, device).reshape(-1),
                       pos, cfg, tp)


def tp_plant_fault(layer, tp=None):
    """The planted fault of the TP checks, on the rank that runs it
    (mirror it to set it on every rank): block ``layer``'s wo all-reduce
    is dropped, so each rank adds only its own heads' share; None clears
    it.  A block makes two sums a forward, wo's then w_down's (a w8a8
    product's amax maximum in between is kept), so every other sum is
    dropped."""
    tp.faults.clear()
    if layer is None:
        return
    wo_next = [True]

    def reduce(t, op="sum"):
        if op != "sum":
            return tp.all_reduce(t, op)
        drop, wo_next[0] = wo_next[0], not wo_next[0]
        return t if drop else tp.all_reduce(t, op)

    tp.faults[layer] = reduce


def make_tp_serving(mesh, cfg, chunk=8, donate=True, quantized=False):
    """Tensor-parallel prefill and chunked greedy decode over a mesh's
    ``tp`` axis, on the mesh's driver: params Megatron-split
    (:func:`param_specs`), the cache kv-head-sharded (:func:`cache_spec`),
    one all-reduce after each row-parallel product (``TPContext.
    all_reduce``: a float sum in one order for every element), the
    vocab-split embedding summed over tp, and the logits gathered to
    every rank.  The
    attention is collective-free: each rank holds its own heads' Q and KV
    rows, and runs the flash and decode kernels at those head counts.

    Requires tp | n_heads, n_kv_heads, vocab and d_ff.  Returns
    ``(init_cache, prefill_fn, decode_fn)``: ``init_cache(batch,
    max_seq)``, ``prefill_fn(params, cache, tokens)`` (tokens [B, T], a
    host array or a device tensor; the cache is written in place) and
    ``decode_fn(params, cache, logits, pos, n=chunk)``,
    :func:`decode_chunk` of ``n`` tokens (a shorter tail is one call
    too).  ``donate=False`` leaves the decode's input cache as it was
    (the port's decode otherwise writes in place, where JAX donates).
    ``params`` come from :func:`tp_params`; ``quantized`` is accepted for
    JAX's signature (the port reads the weight format from the
    params)."""
    m = _tp_mirror(mesh, cfg)

    def init_cache(batch, max_seq):
        return m.call(init_kv_cache, cfg, int(batch), int(max_seq),
                      spmd.DEVICE, tp=spmd.LOCAL)

    def prefill_fn(params, cache, tokens):
        return m.call(_tp_prefill, params, cache, tokens, cfg, spmd.DEVICE,
                      tp=spmd.LOCAL)

    def decode_fn(params, cache, logits, pos, n=chunk):
        return m.call(_tp_decode_chunk, params, cache, logits, int(pos), cfg,
                      int(n), bool(donate), tp=spmd.LOCAL)

    return init_cache, prefill_fn, decode_fn


def make_tp_step(mesh, cfg, donate=True, quantized=False):
    """Single-token tensor-parallel :func:`decode_step` (the sharding of
    :func:`make_tp_serving`): ``step(params, cache, tokens, pos)``, tokens
    [B] a host array or a device tensor.  Serving uses it to feed a
    resumed prompt into a parked cache.  ``quantized`` as in
    :func:`make_tp_serving`."""
    m = _tp_mirror(mesh, cfg)

    def step(params, cache, tokens, pos):
        return m.call(_tp_step, params, cache, tokens, int(pos), cfg,
                      bool(donate), spmd.DEVICE, tp=spmd.LOCAL)

    return step


# -- SPMD training over a (dp, sp, tp) mesh ----------------------------------

# bytes of one bucket of the gradient sum over dp x sp: gloo on the card
# stages each bucket through pinned host memory, so this bounds what a sum
# pins at once (a leaf larger than a bucket is cut across buckets)
GRAD_BUCKET_BYTES = 256 << 20


def _local_block(tokens, ctx):
    """This rank's [B/dp, T/sp] block of the global [B, T] ``tokens`` (a
    host array or a tensor), int64 on the rank's device."""
    t = _tokens(tokens, ctx.device)
    B, T = t.shape
    if B % ctx.dp or T % ctx.sp.size:
        raise ValueError(
            "dp={} must divide the batch ({}) and sp={} the length "
            "({})".format(ctx.dp, B, ctx.sp.size, T))
    return t.chunk(ctx.dp, 0)[ctx.dp_rank].chunk(ctx.sp.size, 1)[
        ctx.sp.rank]


def sharded_forward(mesh, cfg, device=None):
    """The forward over a (dp, sp, tp) mesh, as JAX's ``shard_map`` of
    ``_forward_spmd``: batch on dp, time on sp, weights on tp.  Returns
    ``fn(params, tokens)``: ``params`` this rank's tp shards
    (:func:`param_specs`), ``tokens`` the global [B, T] batch (a host
    array or a tensor); the result is this rank's [B/dp, T/sp, vocab]
    float32 block of the logits, whole on vocab (JAX's ``out_specs=P("dp",
    "sp", "tp")``).  Every rank of the mesh calls it."""
    _mesh_device(mesh, device)
    ctx = mesh_context(mesh)

    def fn(params, tokens):
        return _forward_spmd(params, _local_block(tokens, ctx), cfg, ctx)

    return fn


def _forward_spmd(params, tokens, cfg, ctx):
    """One rank's forward: ``tokens`` its [B/dp, T/sp] block, ``params``
    its tp shards, ``ctx`` its ``MeshContext``.  The tp partial sums are
    reduced explicitly and differentiably (``reduce_from_tp`` after the
    row-parallel products, ``copy_to_tp`` before the column-parallel
    ones); attention runs over sp by ``cfg.sp_strategy``."""
    B, T = tokens.shape
    tp = ctx.tp.size
    if cfg.n_kv_heads % tp != 0 or cfg.n_heads % tp != 0:
        raise ValueError(
            "tp={} must divide n_heads={} and n_kv_heads={} (KV-head "
            "replication across tp is not supported)".format(
                tp, cfg.n_heads, cfg.n_kv_heads
            )
        )
    nh_loc = cfg.n_heads // tp
    nkv_loc = cfg.n_kv_heads // tp
    n_rep = nh_loc // nkv_loc
    positions = ctx.sp.rank * T + torch.arange(T, device=tokens.device)

    if cfg.sp_strategy not in ("ring", "ulysses"):
        raise ValueError(
            "unknown sp_strategy '{}' (expected 'ring' or "
            "'ulysses')".format(cfg.sp_strategy)
        )

    def attn_fn(q, k, v):
        if cfg.sp_strategy == "ulysses":
            # unexpanded kv heads ride the all-to-alls; GQA replication
            # happens after redistribution
            return ulysses_attention(q, k, v, axis=ctx.sp, causal=True,
                                     kv_repeat=n_rep)
        return ring_attention(q, _expand_kv(k, n_rep), _expand_kv(v, n_rep),
                              axis=ctx.sp, causal=True)

    def reduce(y, op="sum"):
        return reduce_from_tp(y, ctx.tp)

    def enter(h):
        return copy_to_tp(h, ctx.tp)

    x = _embed_rows(params, tokens, cfg, ctx.tp if tp > 1 else None, reduce)
    for i, layer in enumerate(params["layers"]):
        x = _block(layer, x, positions, cfg, attn_fn, n_heads=nh_loc,
                   n_kv_heads=nkv_loc, reduce=reduce,
                   enter=ctx.faults.get(i, enter))
    x = _rms_norm(x, params["norm"], cfg.norm_eps)
    y = _mm(copy_to_tp(x, ctx.tp), params["lm_head"])
    return gather_from_tp(y, ctx.tp, dim=-1).float()


def _leaves(tree):
    """The tensors of a params tree, in its order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _map_leaves(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_leaves(fn, v) for v in tree]
    return fn(tree)


def _sum_grads(leaves, group, bucket_bytes=GRAD_BUCKET_BYTES):
    """Each leaf's gradient replaced by its sum over ``group``
    (``GroupContext.all_reduce``: rank order, float32, one rounding), in
    buckets of at most ``bucket_bytes``."""
    if group.size == 1:
        return
    pieces, nbytes = [], 0
    for p in leaves:
        flat = p.grad.view(-1)
        for piece in flat.split(max(1, bucket_bytes // flat.element_size())):
            size = piece.numel() * piece.element_size()
            if pieces and nbytes + size > bucket_bytes:
                _sum_bucket(pieces, group)
                pieces, nbytes = [], 0
            pieces.append(piece)
            nbytes += size
    if pieces:
        _sum_bucket(pieces, group)


def _sum_bucket(pieces, group):
    summed = group.all_reduce(torch.cat(pieces))
    for piece, part in zip(pieces, summed.split([p.numel() for p in pieces])):
        piece.copy_(part)


def make_train_step(mesh, cfg, learning_rate=3e-4, device=None):
    """The SPMD train step over (dp, sp, tp): every rank of the mesh runs
    it on the same global batch (no driver, no mirror).

    Loss: the mean next-token cross-entropy over the global batch; each
    rank takes its block's sum over B * T, and the step returns the sum of
    those over dp x sp (a float, the same on every rank).  Gradients:
    autograd through the differentiable collectives gives each rank its
    block's share of every leaf's gradient (whole over tp), summed over
    dp x sp in place (:func:`_sum_grads`, buckets of
    ``GRAD_BUCKET_BYTES``).  Optimizer: ``torch.optim.AdamW`` with
    optax.adamw's defaults (betas 0.9 and 0.999, eps 1e-8, weight decay
    1e-4, not torch's 1e-2), its state in the params' dtype as optax's mu
    and nu are, ``fused=True``: one multi-tensor kernel per group of
    leaves, in place, with no temporaries the size of the state (the
    default multi-tensor path allocates them, 16 GB at 8B).

    Returns ``(step_fn, init_fn)``.  ``init_fn(seed, tokens, params=None)``
    returns ``(params, opt_state)``: this rank's shards, drawn from
    ``seed`` as :func:`tp_params` draws them, or cut from full ``params``
    (e.g. from :func:`params_from_jax`; copied, replicated over dp and
    sp), and the optimizer.  ``step_fn(params, opt_state, tokens,
    targets)`` returns ``(params, opt_state, loss)``, updating the params
    and the optimizer in place (where JAX donates); each leaf's ``grad``
    holds the step's summed gradient after it."""
    _mesh_device(mesh, device)
    ctx = mesh_context(mesh)
    fwd = sharded_forward(mesh, cfg)

    def loss_fn(params, tokens, targets):
        logits = fwd(params, tokens)
        tgt = _local_block(targets, ctx)
        nll = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                              tgt.reshape(-1), reduction="sum")
        return nll / (tgt.numel() * ctx.dp * ctx.sp.size)

    def init_fn(seed, tokens, params=None):
        if params is None:
            params = _draw_shard(cfg, int(seed), False, ctx.device,
                                 tp=ctx.tp)
        else:
            params = _map_leaves(
                lambda t: t.detach().to(ctx.device, copy=True),
                shard_tree(params, param_specs(cfg), ctx.tp.size,
                           ctx.tp.rank))
        leaves = list(_leaves(params))
        for t in leaves:
            t.requires_grad_(True)
        opt = torch.optim.AdamW(leaves, lr=learning_rate, betas=(0.9, 0.999),
                                eps=1e-8, weight_decay=1e-4, fused=True)
        return params, opt

    def step_fn(params, opt_state, tokens, targets):
        opt_state.zero_grad(set_to_none=True)
        loss = loss_fn(params, tokens, targets)
        loss.backward()
        _sum_grads(opt_state.param_groups[0]["params"], ctx.dpsp)
        opt_state.step()
        total = loss.detach().reshape(1)
        if ctx.dpsp.size > 1:
            total = ctx.dpsp.all_reduce(total)
        return params, opt_state, float(total[0])

    return step_fn, init_fn


def train_plant_fault(mesh, layer):
    """The planted fault of the training checks, on the rank that runs it
    (every rank runs it): block ``layer``'s ``copy_to_tp`` hooks lose
    their backward sum over tp, so each rank keeps only its own heads'
    and columns' share of the gradient at the norms' outputs; None
    clears it."""
    ctx = mesh_context(mesh)
    ctx.faults.clear()
    if layer is not None:
        ctx.faults[layer] = _no_tp_sum


def _no_tp_sum(h):
    return h
