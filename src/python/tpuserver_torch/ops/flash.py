"""Attention kernels of the port: flash attention (prefill) and
single-query decode attention, each a hand-written CUDA kernel for
``sm_90a`` (``tpuserver_torch/csrc``) beside its plain PyTorch version.

A wrapper runs the plain version only for tensors that lie on the CPU
(the tests hold it against the JAX package there).  For CUDA tensors it
launches the kernel or raises; it never falls back.  Each wrapper counts
its launches in ``<wrapper>.launches``.

Each kernel has two routes, chosen from the operands' dtype before the
launch (:func:`flash_route`, :func:`decode_route`): the tensor cores for
bfloat16 and a float32-FMA kernel on the CUDA cores for float32, each at
every head dim of the JAX kernels' domain (any multiple of 8 up to 256)
and any number of query heads per kv head.  Launches are also counted by
route, in ``<wrapper>.route_launches``.
"""

import ctypes
import functools

import torch

from tpuserver_torch.ops import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the routes, in the order csrc/flash_attention.cu and
# csrc/decode_attention.cu number them
FLASH_ROUTES = ("wgmma", "simt")
DECODE_ROUTES = ("mma", "simt")
# the query heads of one kv head that a decode block takes, by route: the
# MMA's 16 rows on "mma", 8 on "simt" (csrc/decode_attention.cu's kMmaRep
# and kSimtRep)
DECODE_GROUP_HEADS = {"mma": 16, "simt": 8}
_MAX_HEAD_DIM = 256
_MAX_SPLIT = 64  # decode kernel: key-range splits per (row, kv head)


# -- plain versions ----------------------------------------------------------


def _fold(s, v, einsum):
    """Softmax of scores ``s`` (masked entries -inf) applied to ``v``, with
    the kernels' edge rule: a fully masked row gives zeros, not nan."""
    m = s.amax(dim=-1, keepdim=True)
    shift = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - shift)
    l = p.sum(dim=-1, keepdim=True)
    l = torch.where(l == 0, torch.ones_like(l), l)
    return torch.einsum(einsum, p / l, v)


def flash_attention_reference(q, k, v, causal=True, scale=None):
    """Plain PyTorch attention in float32: q [B, T, H, D] against k/v
    [B, Tk, Hkv, D] (GQA expanded here), causal positions counted from 0
    on both sides.  Returns [B, T, H, D] in ``q.dtype``."""
    d = q.shape[-1]
    scale = d ** -0.5 if scale is None else scale
    n_rep = q.shape[2] // k.shape[2]
    kf = k.float().repeat_interleave(n_rep, dim=2)
    vf = v.float().repeat_interleave(n_rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * scale
    if causal:
        t, tk = q.shape[1], k.shape[1]
        q_pos = torch.arange(t, device=q.device)[:, None]
        k_pos = torch.arange(tk, device=q.device)[None, :]
        s = s.masked_fill(k_pos > q_pos, float("-inf"))
    return _fold(s, vf, "bhqk,bkhd->bqhd").to(q.dtype)


def decode_attention_reference(q, k_cache, v_cache, lengths, scale=None):
    """Plain PyTorch single-query attention in float32: q [B, H, D] over
    caches [B, S, Hkv, D] (GQA expanded here), keys at positions >=
    ``lengths[b]`` masked.  Returns [B, H, D] in ``q.dtype``."""
    d = q.shape[-1]
    scale = d ** -0.5 if scale is None else scale
    n_rep = q.shape[1] // k_cache.shape[2]
    kf = k_cache.float().repeat_interleave(n_rep, dim=2)
    vf = v_cache.float().repeat_interleave(n_rep, dim=2)
    s = torch.einsum("bhd,bshd->bhs", q.float() * scale, kf)
    pos = torch.arange(k_cache.shape[1], device=q.device)
    dead = pos[None, :] >= lengths.to(q.device).long()[:, None]
    s = s.masked_fill(dead[:, None, :], float("-inf"))
    return _fold(s, vf, "bhs,bshd->bhd").to(q.dtype)


def _split_ranges(lengths, n_split):
    """Each row's key range [lo, hi) for every split, as the decode kernel
    cuts it: ``ceil(length / n_split)`` rounded up to 16 keys a split, so
    the trailing splits of a short row are empty."""
    n = lengths.long().clamp_min(0)
    per = ((n + n_split - 1) // n_split + 15) // 16 * 16
    j = torch.arange(n_split, device=n.device)
    lo = torch.minimum(n[:, None], j[None, :] * per[:, None])
    hi = torch.minimum(n[:, None], lo + per[:, None])
    return lo, hi


def decode_attention_split_reference(q, k_cache, v_cache, lengths, n_split,
                                     scale=None):
    """Plain PyTorch model of the decode kernel's split-K in float32: each
    of ``n_split`` key ranges folds alone into (m, l, acc), an empty range
    giving (-inf, 0, 0), and the splits combine in order with the
    finite-shift rule and ``l == 0 -> 1``.  Used by the tests only.
    Returns [B, H, D] in ``q.dtype``."""
    d = q.shape[-1]
    scale = d ** -0.5 if scale is None else scale
    n_rep = q.shape[1] // k_cache.shape[2]
    kf = k_cache.float().repeat_interleave(n_rep, dim=2)
    vf = v_cache.float().repeat_interleave(n_rep, dim=2)
    s = torch.einsum("bhd,bshd->bhs", q.float() * scale, kf)
    lengths = lengths.to(q.device)
    lo, hi = _split_ranges(lengths, n_split)
    pos = torch.arange(k_cache.shape[1], device=q.device)
    # [B, n_split, S]: key s belongs to split j of row b
    own = (pos[None, None, :] >= lo[:, :, None]) & (
        pos[None, None, :] < hi[:, :, None])
    sj = s[:, None].masked_fill(~own[:, :, None, :], float("-inf"))
    m = sj.amax(dim=-1)  # [B, n_split, H]
    fin = torch.isfinite(m)
    shift = torch.where(fin, m, torch.zeros_like(m))
    p = torch.exp(sj - shift[..., None])
    l = p.sum(dim=-1)
    acc = torch.einsum("bjhs,bshd->bjhd", p, vf)
    m_all = m.amax(dim=1, keepdim=True)
    shift_all = torch.where(torch.isfinite(m_all), m_all,
                            torch.zeros_like(m_all))
    a = torch.where(fin, torch.exp(torch.where(fin, m, shift_all)
                                   - shift_all), torch.zeros_like(m))
    l_all = (l * a).sum(dim=1)
    l_all = torch.where(l_all == 0, torch.ones_like(l_all), l_all)
    out = (acc * a[..., None]).sum(dim=1) / l_all[..., None]
    return out.to(q.dtype)


# -- kernel launches ---------------------------------------------------------


def _check_domain(name, dtype, d):
    """Raise ValueError for what no route of the kernels takes: a dtype
    other than float32 or bfloat16, a head dim that is not a multiple of
    8 from 8 to 256."""
    if dtype not in _DTYPE_CODES:
        raise ValueError("{}: dtype {} is outside the kernels' domain "
                         "(float32 or bfloat16)".format(name, dtype))
    if d < 8 or d % 8 or d > _MAX_HEAD_DIM:
        raise ValueError("{}: head dim {} is outside the kernels' domain "
                         "(a multiple of 8 from 8 to {})".format(
                             name, d, _MAX_HEAD_DIM))


def flash_route(dtype, d):
    """The flash kernel's route for operands of ``dtype`` with head dim
    ``d``: ``"wgmma"`` (the tensor cores, the head dim padded to 64, 128,
    192 or 256) for bfloat16, ``"simt"`` (float32 FMA on the CUDA cores,
    register-tiled) for float32, at any head dim of the domain.
    ValueError for what neither takes."""
    _check_domain("flash_attention", dtype, d)
    return "wgmma" if dtype == torch.bfloat16 else "simt"


def decode_route(dtype, d, n_rep):
    """The decode kernel's route for operands of ``dtype``, head dim
    ``d`` and ``n_rep`` query heads per kv head (any;
    :func:`decode_head_groups` says how many blocks share them):
    ``"mma"`` (the tensor cores) for bfloat16, ``"simt"`` (the CUDA
    cores) for float32, at any head dim of the domain.  ValueError for
    what neither takes."""
    if n_rep < 1:
        raise ValueError("decode_attention: {} query heads per kv head "
                         "(want at least 1)".format(n_rep))
    _check_domain("decode_attention", dtype, d)
    return "mma" if dtype == torch.bfloat16 else "simt"


def decode_head_groups(route, n_rep):
    """The blocks each (row, kv head, split) of the decode kernel takes
    on ``route``: its ``n_rep`` query heads in groups of
    ``DECODE_GROUP_HEADS[route]`` (16 on ``"mma"``: 16 heads are one
    group, 17 are two), each group re-reading the kv head's cache."""
    return -(-n_rep // DECODE_GROUP_HEADS[route])


def _check_cuda(name, dtype, *tensors):
    """Raise unless every tensor is a CUDA tensor of ``dtype`` on one
    device, with unit last-dim stride and 16-byte aligned rows, and a
    dtype and head dim in the kernels' domain."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError("{}: tensors on {} (expected cpu or cuda)".format(
            name, dev))
    _check_domain(name, dtype, tensors[0].shape[-1])
    itemsize = torch.empty((), dtype=dtype).element_size()
    for t in tensors:
        if t.device != dev or t.dtype != dtype:
            raise ValueError("{}: operands must share device and dtype "
                             "({} {} vs {} {})".format(
                                 name, t.device, t.dtype, dev, dtype))
        if t.stride(-1) != 1 or t.data_ptr() % 16 or any(
                (s * itemsize) % 16 for s in t.stride()[:-1]):
            raise ValueError("{}: operands need a unit last-dim stride and "
                             "16-byte aligned rows".format(name))


def _stream(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


@functools.lru_cache(maxsize=None)
def _sm_count(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def decode_splits(b, h_kv, s, n_sms):
    """Key-range splits per (row, kv head) for the decode kernel: enough
    blocks for about two waves of ``n_sms`` SMs, at most 64, with at least
    64 keys of the cache length ``s`` a split.  Chosen from shapes only, so
    ``lengths`` never leave the device."""
    want = -(-2 * n_sms // (b * h_kv))
    return max(1, min(want, s // 64, _MAX_SPLIT))


def _raise_on(rc, name):
    if rc != 0:
        raise RuntimeError("{} kernel launch failed: CUDA error {}".format(
            name, rc))


def flash_attention(q, k, v, causal=True, scale=None, block_q=128,
                    block_k=128):
    """Exact attention, q [B, T, H, D] and k/v [B, Tk, Hkv, D] ->
    [B, T, H, D].

    GQA is native (``Hkv`` divides ``H``; query head h reads kv head
    ``h // (H // Hkv)``).  ``block_q``/``block_k`` keep the JAX
    signature's divisibility contract (T and Tk must divide by them,
    else ValueError); the CUDA kernel picks its own tiles.  On the card
    :func:`flash_route` picks the kernel from the dtype;
    ValueError for what stays outside the kernels' domain (see
    ``_check_cuda``).
    """
    b, t, h, d = q.shape
    t_kv, h_kv = k.shape[1], k.shape[2]
    if h % h_kv:
        raise ValueError("query heads ({}) must be a multiple of kv heads "
                         "({})".format(h, h_kv))
    block_q = min(block_q, t)
    block_k = min(block_k, t_kv)
    if t % block_q or t_kv % block_k:
        raise ValueError(
            "sequence lengths ({}, {}) must divide by block sizes "
            "({}, {})".format(t, t_kv, block_q, block_k))
    if scale is None:
        scale = d ** -0.5
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal, scale=scale)
    _check_cuda("flash_attention", q.dtype, q, k, v)
    route = flash_route(q.dtype, d)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    strides = (ctypes.c_int64 * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    lib = _build.load_library()
    rc = lib.tt_flash_attention(
        _DTYPE_CODES[q.dtype], FLASH_ROUTES.index(route), q.data_ptr(),
        k.data_ptr(), v.data_ptr(), out.data_ptr(), b, t, t_kv, h, h_kv, d,
        int(bool(causal)), strides, float(scale), _stream(q.device))
    _raise_on(rc, "flash_attention")
    flash_attention.launches += 1
    flash_attention.route_launches[route] += 1
    return out


flash_attention.launches = 0
flash_attention.route_launches = dict.fromkeys(FLASH_ROUTES, 0)


def flash_tile_product(q, k, v):
    """The two tile products the flash kernel is built on, alone, for
    q, k, v bf16 [64, 128]: ``S = q k^T`` and ``O = bf16(S) v``, both
    float32.  On the card it runs the kernel's TMA loads and ``wgmma``
    descriptors on one warpgroup (a check of their swizzle conventions);
    on the CPU the plain products."""
    if q.shape != (64, 128) or k.shape != q.shape or v.shape != q.shape:
        raise ValueError("flash_tile_product: q, k, v must be [64, 128]")
    if q.device.type == "cpu":
        s = q.float() @ k.float().T
        return s, s.to(torch.bfloat16).float() @ v.float()
    _check_cuda("flash_tile_product", torch.bfloat16, q, k, v)
    q, k, v = (t.contiguous() for t in (q, k, v))
    s = torch.empty(64, 64, dtype=torch.float32, device=q.device)
    o = torch.empty(64, 128, dtype=torch.float32, device=q.device)
    lib = _build.load_library()
    rc = lib.tt_flash_tile_product(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                   s.data_ptr(), o.data_ptr(),
                                   _stream(q.device))
    _raise_on(rc, "flash_tile_product")
    flash_tile_product.launches += 1
    return s, o


flash_tile_product.launches = 0


def decode_attention(q, k_cache, v_cache, lengths, scale=None, block_k=256):
    """Single-token decode attention over a padded KV cache.

    q [B, H, D] (the current token's queries); k_cache/v_cache
    [B, S, Hkv, D] with valid prefix ``lengths`` [B] int32.  GQA is
    served inside the kernel (the expanded cache never exists) and keys
    past ``lengths[b]`` are never read.  ``block_k`` keeps the JAX
    signature's contract (S must divide by it).  Returns [B, H, D].

    On the card the key range is split across ``decode_splits(...)``
    blocks per (row, kv head) (each kv head's query heads in
    :func:`decode_head_groups` groups, a block each), whose partials a
    second kernel combines in split order
    (``decode_attention_split_reference`` models it); :func:`decode_route`
    picks the kernel from the dtype.
    """
    b, h, d = q.shape
    s, h_kv = k_cache.shape[1], k_cache.shape[2]
    if h % h_kv:
        raise ValueError("query heads ({}) must be a multiple of kv heads "
                         "({})".format(h, h_kv))
    block_k = min(block_k, s)
    if s % block_k:
        raise ValueError(
            "cache length {} must divide by block_k {}".format(s, block_k))
    if scale is None:
        scale = d ** -0.5
    if q.device.type == "cpu":
        return decode_attention_reference(q, k_cache, v_cache, lengths,
                                          scale=scale)
    _check_cuda("decode_attention", q.dtype, q, k_cache, v_cache)
    route = decode_route(q.dtype, d, h // h_kv)
    lengths = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    n_split = decode_splits(b, h_kv, s, _sm_count(q.device))
    # the splits' fp32 partials: acc [B, Hkv, n_split, n_rep, D], then m
    # and l [B, Hkv, n_split, n_rep]
    part = (torch.empty(b * h * n_split * (d + 2), dtype=torch.float32,
                        device=q.device) if n_split > 1 else None)
    strides = (ctypes.c_int64 * 10)(
        *q.stride()[:2], *k_cache.stride()[:3], *v_cache.stride()[:3],
        *out.stride()[:2])
    lib = _build.load_library()
    rc = lib.tt_decode_attention(
        _DTYPE_CODES[q.dtype], DECODE_ROUTES.index(route), q.data_ptr(),
        k_cache.data_ptr(), v_cache.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), None if part is None else part.data_ptr(), b, h,
        h_kv, s, d, n_split, strides, float(scale), _stream(q.device))
    _raise_on(rc, "decode_attention")
    decode_attention.launches += 1
    decode_attention.route_launches[route] += 1
    return out


decode_attention.launches = 0
decode_attention.route_launches = dict.fromkeys(DECODE_ROUTES, 0)


def reset_launch_counts():
    """Set every kernel wrapper's launch counts (total and by route) to
    0."""
    flash_attention.launches = 0
    decode_attention.launches = 0
    flash_tile_product.launches = 0
    for counts in (flash_attention.route_launches,
                   decode_attention.route_launches):
        for route in counts:
            counts[route] = 0

