"""The collectives of a (dp, sp, tp) mesh, and the differentiable ones of
SPMD training.

JAX writes a sharded program once and its autodiff transposes each
collective (``psum``, ``ppermute``, ``all_to_all``).  Torch runs one
process per rank, so each rank calls its collectives itself, and the
training path's are ``torch.autograd.Function``s whose backward is the
transposed collective:

- :func:`reduce_from_tp`: sum over tp forward, identity backward (after a
  row-parallel product);
- :func:`copy_to_tp`: identity forward, sum over tp backward (on the
  input of the column-parallel products);
- :func:`gather_from_tp`: all-gather forward, the rank's own slice
  backward (the lm_head logits);
- :func:`ppermute`: send to the next sp rank and receive from the previous
  one; backward sends the other way (ring attention's K/V rotation);
- :func:`all_to_all`: split one dim over the group and concatenate the
  received pieces on another; backward is the inverse all-to-all
  (Ulysses' head redistribution).

Each takes the :class:`GroupContext` of its axis and is the identity on a
group of one rank.  A floating-point sum adds the ranks' tensors in rank
order in float32 and rounds once (:meth:`GroupContext.all_reduce`), so a
result's bits do not depend on where it sits in a tensor.

:func:`mesh_context` gives a rank's :class:`MeshContext`: its tp, sp and
dp x sp groups and coordinates, and the training path's planted faults.
"""

import torch
import torch.distributed as dist

from tpuserver_torch.parallel.mesh import mesh_state

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


class GroupContext:
    """One rank's collectives over one group of a mesh.  With gloo on the
    card (several ranks sharing one card) each collective passes through
    host memory: the tensor is copied to the host, exchanged there and
    copied back.  ``stats`` counts each kind of collective this rank
    made and the bytes it sent: kind -> [calls, bytes]."""

    def __init__(self, name, group, ranks, rank, device, backend):
        self.name = name
        self.size = len(ranks)
        self.rank = rank
        self.ranks = tuple(ranks)
        self.device = device
        self.group = group
        self._src = self.ranks[0]
        self._staged = backend == "gloo" and device.type == "cuda"
        self._scatter = backend == "nccl"
        self.stats = {}

    def _count(self, kind, t):
        entry = self.stats.setdefault(kind, [0, 0])
        entry[0] += 1
        entry[1] += t.numel() * t.element_size()

    def all_reduce(self, t, op="sum"):
        """``t`` reduced over the group (``op`` "sum" or "max"); returns
        the result.

        A floating-point sum adds the ranks' tensors in rank order, in
        float32, the same order for every element, and rounds once to
        ``t``'s dtype: a ring all-reduce sums each chunk of the tensor in
        another order, so a row's bits would depend on where in the
        tensor it lies (its slot in a batched step).  Over NCCL it is a
        reduce-scatter and an all-gather (:meth:`_sum_scattered`, an
        all-reduce's bytes); over gloo, whose collectives cost a fixed
        latency each, one all-gather and the sum on every rank
        (:meth:`_sum_gathered`).  Both give the same bits.  Integer sums
        and maxima are exact in any order and run as one all-reduce."""
        self._count("all_reduce", t)
        if op == "sum" and t.is_floating_point():
            return (self._sum_scattered(t) if self._scatter
                    else self._sum_gathered(t))
        buf = self._host(t) if self._staged else t.contiguous()
        dist.all_reduce(buf, op=_OPS[op], group=self.group)
        return buf.to(t.device, non_blocking=True) if self._staged else buf

    def _sum_gathered(self, t):
        """The float sum as one all-gather of the whole tensors: each rank
        receives (size - 1) tensors and sums all of them."""
        return _rank_order_sum(self._gather(t)).to(t.dtype)

    def _sum_scattered(self, t):
        """The float sum with an all-reduce's bytes (each rank sends and
        receives 2 (size - 1) / size of the tensor): ``all_to_all`` hands
        rank r block r of every rank's tensor, r sums its block's parts in
        rank order, and the summed blocks are all-gathered.  Device
        tensors on the card's own backend, or host tensors (no staging)."""
        n = self.size
        flat = t.reshape(-1)
        pad = -flat.numel() % n
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        flat = flat.contiguous()
        parts = torch.empty_like(flat)
        dist.all_to_all_single(parts, flat, group=self.group)
        block = _rank_order_sum(parts.view(n, -1)).to(t.dtype)
        out = block.new_empty((n, block.numel()))
        dist.all_gather(list(out.unbind(0)), block, group=self.group)
        return out.view(-1)[:t.numel()].view(t.shape)

    def all_gather(self, t, dim):
        """Every rank's ``t`` concatenated on ``dim`` in group order."""
        self._count("all_gather", t)
        return torch.cat(self._gather(t).unbind(0), dim=dim)

    def broadcast(self, t):
        """``t`` (the group's first rank's value; each other rank's
        allocation) sent from the first rank to every rank, in place."""
        self._count("broadcast", t)
        buf = self._host(t) if self._staged else t
        dist.broadcast(buf, src=self._src, group=self.group)
        return t.copy_(buf, non_blocking=True) if self._staged else t

    def ppermute(self, t, shift=1):
        """``t`` sent to the rank ``shift`` places on in group order
        (cyclically), and the tensor of the rank ``shift`` places back
        received: the ``lax.ppermute`` of a ring.  The sends and receives
        go as one batch, so no pair of ranks waits on the other."""
        self._count("ppermute", t)
        n = self.size
        src = self._host(t) if self._staged else t.contiguous()
        out = (torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
               if self._staged else torch.empty_like(src))
        ops = [dist.P2POp(dist.isend, src, self.ranks[(self.rank + shift) % n],
                          self.group),
               dist.P2POp(dist.irecv, out, self.ranks[(self.rank - shift) % n],
                          self.group)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return out.to(t.device, non_blocking=True) if self._staged else out

    def all_to_all(self, t, split_dim, concat_dim):
        """``t`` cut into ``size`` equal pieces on ``split_dim``, piece r
        sent to rank r, and the pieces received concatenated on
        ``concat_dim`` in group order: ``lax.all_to_all(..., tiled=True)``."""
        self._count("all_to_all", t)
        parts = torch.stack(t.chunk(self.size, split_dim))
        src = self._host(parts) if self._staged else parts
        out = (torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
               if self._staged else torch.empty_like(src))
        dist.all_to_all_single(out, src, group=self.group)
        if self._staged:
            out = out.to(t.device, non_blocking=True)
        return torch.cat(out.unbind(0), dim=concat_dim)

    def _gather(self, t):
        """Every rank's ``t`` stacked in group order, [size, *t.shape], on
        ``t``'s device (the list form of all-gather: the single-tensor
        form's output shape differs between torch versions on gloo)."""
        src = self._host(t) if self._staged else t.contiguous()
        shape = (self.size,) + tuple(src.shape)
        out = (torch.empty(shape, dtype=src.dtype, pin_memory=True)
               if self._staged else src.new_empty(shape))
        dist.all_gather(list(out.unbind(0)), src, group=self.group)
        return out.to(t.device, non_blocking=True) if self._staged else out

    @staticmethod
    def _host(t):
        """A pinned host copy of a device tensor, its copy waited for."""
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        buf.copy_(t, non_blocking=True)
        torch.cuda.current_stream(t.device).synchronize()
        return buf


def _rank_order_sum(parts):
    """float32 sum of ``parts`` [size, ...] over its first dim, added in
    index order (the same order for every element)."""
    acc = parts[0].to(torch.float32, copy=True)
    for part in parts[1:]:
        acc += part
    return acc


# -- the differentiable collectives ------------------------------------------


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.group.all_reduce(grad), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return group.all_reduce(x)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return group.all_gather(x, dim)

    @staticmethod
    def backward(ctx, grad):
        part = grad.chunk(ctx.group.size, ctx.dim)[ctx.group.rank]
        return part.contiguous(), None, None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return group.ppermute(x, shift)

    @staticmethod
    def backward(ctx, grad):
        return ctx.group.ppermute(grad, -ctx.shift), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.group, ctx.dims = group, (split_dim, concat_dim)
        return group.all_to_all(x, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, grad):
        split_dim, concat_dim = ctx.dims
        return (ctx.group.all_to_all(grad.contiguous(), concat_dim,
                                     split_dim), None, None, None)


def copy_to_tp(x, tp):
    """Identity forward, the sum over tp of the gradient backward."""
    return x if tp.size == 1 else _CopyToTP.apply(x, tp)


def reduce_from_tp(x, tp):
    """The sum over tp forward, identity backward."""
    return x if tp.size == 1 else _ReduceFromTP.apply(x, tp)


def gather_from_tp(x, tp, dim):
    """Every tp rank's ``x`` concatenated on ``dim`` forward; the rank's
    own slice of the gradient backward."""
    return x if tp.size == 1 else _GatherFromTP.apply(x, tp, dim)


def ppermute(x, axis, shift=1):
    """``x`` of the rank ``shift`` places back on ``axis``'s ring (it sends
    its own ``shift`` places on); backward sends the gradient the other
    way."""
    return x if axis.size == 1 else _PPermute.apply(x, axis, shift)


def all_to_all(x, axis, split_dim, concat_dim):
    """:meth:`GroupContext.all_to_all` over ``axis``; backward is the
    inverse all-to-all."""
    if axis.size == 1:
        return x
    return _AllToAll.apply(x, axis, split_dim, concat_dim)


# -- a rank's view of the mesh -----------------------------------------------


class MeshContext:
    """One rank's collectives over a (dp, sp, tp) mesh for the SPMD
    training path: ``tp``, ``sp`` and ``dpsp`` (:class:`GroupContext`,
    each with its size and this rank's place; the differentiable
    collectives are the identity on a group of one rank), the dp size
    and coordinate (``dp``, ``dp_rank``), and ``faults``: block -> the
    hook that stands for ``copy_to_tp`` there (the planted fault of the
    training check, ``llama.train_plant_fault``; empty otherwise)."""

    def __init__(self, state):
        rank = dist.get_rank()

        def group(name, g, ranks):
            return GroupContext(name, g, ranks, ranks.index(rank),
                                state.device, state.backend)

        self.device = state.device
        self.dp, self.dp_rank = state.dp, state.dp_rank
        self.tp = group("tp", state.data, state.tp_ranks)
        self.sp = group("sp", state.sp_group, state.sp_ranks)
        self.dpsp = group("dpsp", state.dpsp_group, state.dpsp_ranks)
        self.faults = {}

    def groups(self):
        return (self.tp, self.sp, self.dpsp)

    def stats(self, reset=False):
        """Every collective this rank made since the last reset, by axis
        and kind: {axis: {kind: [calls, bytes]}}."""
        out = {g.name: {k: list(v) for k, v in g.stats.items()}
               for g in self.groups()}
        if reset:
            for g in self.groups():
                g.stats.clear()
        return out


def mesh_context(mesh):
    """This rank's :class:`MeshContext` of a mesh (one per mesh)."""
    state = mesh_state(mesh)
    if state.train is None:
        state.train = MeshContext(state)
    return state.train
