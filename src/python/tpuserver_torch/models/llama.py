"""Llama-family decoder-only transformer in PyTorch: the port of
``tpuserver/models/llama.py``'s single-device serving half.

Parameters are a plain dict of tensors with the JAX package's structure
and layouts (``{embed, layers: [..], norm, lm_head}``, weights ``[in,
out]`` so a projection is ``x @ w``); activations are ``[B, T, H, D]``
and the KV cache ``[L, 2, B, S, Hkv, D]``.  The large matmuls, norms,
RoPE and the embedding gather are plain ``torch`` ops; attention goes
through the port's CUDA kernels (``tpuserver_torch.ops``), whose plain
versions run when the tensors lie on the CPU.

Pieces:
- ``LlamaConfig`` and the presets ``tiny`` .. ``llama3_8b``
- ``init_params`` (seeded ``torch.Generator``) and ``params_from_jax``
  (the JAX package's params, as numpy arrays, bridged to the port)
- ``forward`` (teacher-forcing logits)
- ``init_kv_cache`` / ``prefill`` / ``decode_step`` / ``decode_chunk``
  for token-by-token serving
"""

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from tpuserver_torch.ops import decode_attention, flash_attention


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
    q = (h @ params["wq"]).reshape(B, T, cfg.n_heads, hd)
    k = (h @ params["wk"]).reshape(B, T, cfg.n_kv_heads, hd)
    v = (h @ params["wv"]).reshape(B, T, cfg.n_kv_heads, hd)
    q = _rope(q, positions, cfg.rope_theta)
    k = _rope(k, positions, cfg.rope_theta)
    attn = attn_fn(q, k, v)
    x = x + attn.reshape(B, T, cfg.n_heads * hd) @ params["wo"]
    h = _rms_norm(x, params["mlp_norm"], cfg.norm_eps)
    gated = F.silu(h @ params["w_gate"]) * (h @ params["w_up"])
    return x + gated @ params["w_down"]


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

    x = params["embed"][tokens]
    for layer in params["layers"]:
        x = _block(layer, x, positions, cfg, attn_fn)
    x = _rms_norm(x, params["norm"], cfg.norm_eps)
    return (x @ params["lm_head"]).float()


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
    positions >= ``length`` and (causally) > the query's own position
    ``q_pos`` [B, Tq].  Plain float32 attention."""
    k = _expand_kv(cache_k, n_rep).float()
    v = _expand_kv(cache_v, n_rep).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k) / np.sqrt(q.shape[-1])
    k_idx = torch.arange(k.shape[1], device=q.device)[None, None, None, :]
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
    x = params["embed"][tokens][:, None, :]  # [B, 1, Dm]
    x, cache = _run_cached(params, cache, x, positions, pos, pos + 1, cfg)
    x = _rms_norm(x, params["norm"], cfg.norm_eps)
    logits = (x[:, 0, :] @ params["lm_head"]).float()
    return logits, cache


def prefill(params, cache, tokens, cfg):
    """Run the prompt tokens [B, T] through the cache in one batched
    pass from position 0; returns (last logits [B, vocab] fp32, cache
    updated in place)."""
    B, T = tokens.shape
    positions = torch.arange(T, device=tokens.device)[None, :].expand(B, T)
    x = params["embed"][tokens]
    x, cache = _run_cached(params, cache, x, positions, 0, T, cfg)
    x = _rms_norm(x, params["norm"], cfg.norm_eps)
    logits = (x[:, -1, :] @ params["lm_head"]).float()
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
