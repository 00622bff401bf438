"""Ring attention: exact attention over a sequence sharded on the ``sp``
mesh axis (the counterpart of ``tpuserver/parallel/ring.py``).

Each rank holds one block of Q/K/V along time.  K/V blocks rotate around
the ``sp`` ring by :func:`~tpuserver_torch.parallel.collectives.ppermute`
while every rank folds the visiting block into a numerically stable
online softmax (the flash-attention recurrence), so the full [T, T] score
matrix never materializes.  With sp=1 this is a single fold: plain
attention.

The fold is plain PyTorch (einsum and elementwise ops), as it is XLA in
the JAX package: no Pallas kernel runs here, and autograd differentiates
it and the rotation (the transposed ``ppermute``) for training.
"""

import torch

from tpuserver_torch.parallel.collectives import ppermute


def _fold_block(q, k, v, o, m, l, q_pos, k_pos, scale, causal):
    """One online-softmax fold of a visiting K/V block.

    q: [B, Tq, H, D] float32; k, v: [B, Tk, H, D]; o: [B, Tq, H, D];
    m, l: [B, H, Tq] running max / normalizer; positions are global indices
    used for causal masking across blocks.
    """
    s = torch.einsum("bqhd,bkhd->bhqk", q, k.float()) * scale
    if causal:
        mask = k_pos[None, None, None, :] > q_pos[None, None, :, None]
        s = torch.where(mask, float("-inf"), s)
    m_blk = s.amax(dim=-1)  # [B, H, Tq]
    m_new = torch.maximum(m, m_blk)
    # exp(-inf - -inf) guards: where a row saw no valid key yet, m_new stays
    # -inf and the correction factor must be 0, not nan.
    dead = torch.isneginf(m_new)
    alpha = torch.where(dead, 0.0, torch.exp(m - m_new))
    p = torch.exp(s - m_new[..., None])
    p = torch.where(dead[..., None], 0.0, p)
    l_new = l * alpha + p.sum(dim=-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    o_new = o * alpha.transpose(1, 2)[..., None] + pv
    return o_new, m_new, l_new


def ring_attention(q, k, v, axis=None, causal=True, scale=None):
    """Exact (optionally causal) attention; when ``axis`` (the rank's sp
    :class:`~tpuserver_torch.parallel.collectives.GroupContext`) is given
    the time axis is taken as sharded over it and K/V ride the ring.

    q, k, v: [B, T_local, H, D] (kv heads already expanded to H).
    Returns [B, T_local, H, D] in q.dtype.
    """
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    if scale is None:
        scale = 1.0 / (D**0.5)
    dev = q.device
    qf = q.float()

    o = torch.zeros((B, Tq, H, D), dtype=torch.float32, device=dev)
    m = torch.full((B, H, Tq), float("-inf"), dtype=torch.float32,
                   device=dev)
    l = torch.zeros((B, H, Tq), dtype=torch.float32, device=dev)

    if axis is None or axis.size == 1:
        q_pos = torch.arange(Tq, device=dev)
        k_pos = torch.arange(Tk, device=dev)
        o, m, l = _fold_block(qf, k, v, o, m, l, q_pos, k_pos, scale, causal)
    else:
        sp, my = axis.size, axis.rank
        q_pos = my * Tq + torch.arange(Tq, device=dev)
        k_cur, v_cur = k, v
        for step in range(sp):
            # after `step` rotations we hold the block originally on
            # rank (my - step) mod sp
            blk = (my - step) % sp
            k_pos = blk * Tk + torch.arange(Tk, device=dev)
            o, m, l = _fold_block(qf, k_cur, v_cur, o, m, l, q_pos, k_pos,
                                  scale, causal)
            if step + 1 < sp:
                # JAX rotates once more after the last fold and drops the
                # result; the port skips that rotation
                k_cur = ppermute(k_cur, axis)
                v_cur = ppermute(v_cur, axis)

    l = torch.where(l == 0.0, 1.0, l)  # fully-masked rows (shouldn't happen)
    out = o / l.transpose(1, 2)[..., None]
    return out.to(q.dtype)
