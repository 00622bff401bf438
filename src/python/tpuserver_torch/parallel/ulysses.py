"""Ulysses-style sequence parallelism: exact attention over a sequence
sharded on the ``sp`` mesh axis via head redistribution (the counterpart
of ``tpuserver/parallel/ulysses.py``).

Where ring attention keeps the sequence sharded and rotates K/V blocks
around the ring (O(sp) steps), the all-to-all strategy re-shards ONCE:
an all-to-all trades the sequence shards for head shards, every rank
then runs blockwise online-softmax attention over the FULL sequence for
its subset of heads, and a second all-to-all restores sequence
sharding.  Communication is two all-to-alls regardless of sequence
length.

The per-shard attention reuses ring's fold over fixed K/V blocks
(float32 accumulation), so the [T, T] score matrix never materializes
here either.  With sp=1 both all-to-alls are identities and this is
plain blockwise attention.
"""

import torch

from tpuserver_torch.parallel.collectives import all_to_all
from tpuserver_torch.parallel.ring import _fold_block


def _blockwise_attention(q, k, v, scale, causal, block_size=512):
    """Full-sequence exact attention via the online-softmax fold.

    q: [B, Tq, H, D]; k, v: [B, Tk, H, D].  K/V are folded in
    ``block_size`` chunks so peak memory is O(Tq * block_size), not
    O(Tq * Tk).
    """
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    dev = q.device
    qf = q.float()
    o = torch.zeros((B, Tq, H, D), dtype=torch.float32, device=dev)
    m = torch.full((B, H, Tq), float("-inf"), dtype=torch.float32,
                   device=dev)
    l = torch.zeros((B, H, Tq), dtype=torch.float32, device=dev)
    q_pos = torch.arange(Tq, device=dev)
    for start in range(0, Tk, block_size):
        stop = min(start + block_size, Tk)
        k_pos = start + torch.arange(stop - start, device=dev)
        o, m, l = _fold_block(
            qf, k[:, start:stop], v[:, start:stop], o, m, l, q_pos, k_pos,
            scale, causal,
        )
    l = torch.where(l == 0.0, 1.0, l)
    out = o / l.transpose(1, 2)[..., None]
    return out.to(q.dtype)


def _expand_heads(x, repeat):
    """[B, T, Hkv, D] -> [B, T, Hkv*repeat, D] (GQA head replication)."""
    if repeat == 1:
        return x
    b, t, h, d = x.shape
    return x[:, :, :, None, :].expand(b, t, h, repeat, d).reshape(
        b, t, h * repeat, d)


def ulysses_attention(
        q, k, v, axis=None, causal=True, scale=None, kv_repeat=1,
        block_size=512):
    """Exact attention with q/k/v sequence-sharded on ``axis`` (the
    rank's sp :class:`~tpuserver_torch.parallel.collectives.GroupContext`).

    q: [B, T_local, H, D]; k, v: [B, T_local, H_kv, D] with
    ``H == H_kv * kv_repeat`` (pass ``kv_repeat > 1`` for GQA so the
    all-to-alls move the UNexpanded kv heads — expansion happens after
    redistribution when the kv head count allows it).  H must be
    divisible by the axis size.  Without an axis (``axis=None``) this is
    plain blockwise attention.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if axis is None or axis.size == 1:
        return _blockwise_attention(
            q, _expand_heads(k, kv_repeat), _expand_heads(v, kv_repeat),
            scale, causal, block_size)
    sp = axis.size
    heads = q.shape[2]
    if heads % sp != 0:
        raise ValueError(
            "ulysses attention needs heads ({}) divisible by the '{}' "
            "axis size ({}); use ring_attention otherwise".format(
                heads, axis.name, sp
            )
        )
    # expand kv heads only as far as divisibility by sp requires; the
    # rest of the GQA replication happens after the all_to_all so the
    # wire carries as few kv copies as possible
    kv_heads = k.shape[2]
    pre = 1
    while (kv_heads * pre) % sp != 0:
        pre += 1
    if pre > kv_repeat:
        raise ValueError(
            "kv heads ({}) times kv_repeat ({}) must be divisible by "
            "the '{}' axis size ({})".format(
                kv_heads, kv_repeat, axis.name, sp
            )
        )
    post = kv_repeat // pre
    if (kv_repeat % pre) != 0:
        # uneven split: fall back to full pre-expansion
        pre, post = kv_repeat, 1
    k = _expand_heads(k, pre)
    v = _expand_heads(v, pre)

    # [B, T/sp, H, D] -> [B, T, H/sp, D]: trade sequence shards for head
    # shards (split dim 2 across the axis, concatenate the received
    # pieces along dim 1)
    q = all_to_all(q, axis, split_dim=2, concat_dim=1)
    k = all_to_all(k, axis, split_dim=2, concat_dim=1)
    v = all_to_all(v, axis, split_dim=2, concat_dim=1)
    out = _blockwise_attention(
        q, _expand_heads(k, post), _expand_heads(v, post), scale, causal,
        block_size)
    # [B, T, H/sp, D] -> [B, T/sp, H, D]: restore sequence sharding
    return all_to_all(out, axis, split_dim=1, concat_dim=2)
