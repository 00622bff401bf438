"""Device-mesh construction and sharding rules for the port (the
counterpart of ``tpuserver/parallel/mesh.py``).

Axes (in mesh order):

- ``dp``  — data parallel: the batch dimension.
- ``sp``  — sequence/context parallel: the time dimension.
- ``tp``  — tensor parallel: the hidden/head dimension of weights, the
            Megatron column/row split (``llama.param_specs``).

Torch runs one process per rank, each holding its own shard of every
sharded tensor, so a sharding is a shard dimension per leaf (an int, or
None for a replicated leaf) that :func:`shard_params` applies to this
rank's copy.  ``named_sharding`` has no torch meaning and is left out: a
torch tensor lives on one rank's device and carries no layout over the
mesh, which is what a ``NamedSharding`` is.

``mesh_factorize`` puts the largest factor on ``tp``, the innermost axis,
whose collectives are the most latency-sensitive.
"""

import dataclasses
import datetime
import logging

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from tpuserver_torch import resolve_device

AXES = ("dp", "sp", "tp")
# seconds a collective of a mesh's tp groups may wait for its peers
DEFAULT_TIMEOUT_S = 120.0
# a follower waits this long for the driver's next message: an idle
# server sends none
_IDLE_TIMEOUT = datetime.timedelta(days=7)

_log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    dp: int = 1
    sp: int = 1
    tp: int = 1

    @property
    def size(self):
        return self.dp * self.sp * self.tp


def mesh_factorize(n_devices, want_sp=True):
    """Pick a (dp, sp, tp) factorization of ``n_devices``.

    tp gets the largest power-of-two factor up to 8 (tp collectives are the
    most latency-sensitive, so they belong on the innermost axis), then
    sp (if requested) so long-context paths are exercised, then dp.
    """
    rem = n_devices
    tp = 1
    while tp < 8 and rem % 2 == 0:
        tp *= 2
        rem //= 2
    sp = 1
    if want_sp and rem % 2 == 0:
        sp = 2
        rem //= 2
    elif want_sp and rem == 1 and tp >= 4:
        # steal a factor from tp so the ring path is exercised
        tp //= 2
        sp = 2
    dp = rem
    assert dp * sp * tp == n_devices
    return MeshConfig(dp=dp, sp=sp, tp=tp)


@dataclasses.dataclass
class MeshState:
    """What the port keeps beside a ``DeviceMesh``: the device this rank
    computes on, the data backend, and its groups.  Of its tp group,
    ``data`` carries the model's collectives, ``control`` (gloo, no
    practical timeout) the driver's messages, ``status`` (gloo) each
    call's outcome; see ``tpuserver_torch.parallel.spmd``.  The sp, dp
    and dp x sp groups (``data``'s backend) serve the training path
    (``tpuserver_torch.parallel.collectives``); an axis of size 1 has no
    group (None) and its ranks are this rank alone."""
    device: torch.device
    backend: str
    tp: int
    tp_rank: int
    tp_ranks: tuple
    data: object
    control: object
    status: object
    timeout_s: float
    mirror: object = None
    context: object = None
    dp: int = 1
    sp: int = 1
    dp_rank: int = 0
    sp_rank: int = 0
    sp_ranks: tuple = ()
    sp_group: object = None
    dp_ranks: tuple = ()
    dp_group: object = None
    dpsp_ranks: tuple = ()
    dpsp_group: object = None
    train: object = None


def make_mesh(config=None, device=None, backend=None,
              timeout_s=DEFAULT_TIMEOUT_S):
    """A ``DeviceMesh`` with axes (dp, sp, tp) over the initialised default
    process group, which every rank builds in the same order.

    ``device`` comes from ``resolve_device``: the card unless ``"cpu"``
    is given, and RuntimeError without a card.  ``backend`` is the data
    collectives' backend, ``nccl`` on the card and ``gloo`` on the CPU by
    default, and must be the default group's.  ``backend="gloo"`` on the
    card (several ranks sharing one card, which NCCL refuses) is taken
    only when the caller passes it, and is logged: its collectives pass
    through host memory.  ``timeout_s`` bounds every collective of the
    mesh's groups (tp; sp, dp and dp x sp where the axis has more than
    one rank), so a rank that fails surfaces as an error on its peers
    rather than a hang."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs the default process group: call "
            "torch.distributed.init_process_group (or "
            "tpuserver_torch.parallel.spmd.start) first")
    want = backend or ("nccl" if dev.type == "cuda" else "gloo")
    have = dist.get_backend()
    if have != want:
        raise ValueError(
            "the default process group runs {} but the mesh wants {} on "
            "{} (pass backend='{}' to choose it)".format(
                have, want, dev.type, have))
    if dev.type == "cuda" and want == "gloo":
        _log.warning("tp mesh on %s over gloo: its collectives pass "
                     "through host memory", dev)
    world = dist.get_world_size()
    config = config or mesh_factorize(world)
    if config.size != world:
        raise ValueError("mesh {} needs {} ranks, the group has {}".format(
            config, config.size, world))
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", dist.get_rank()
                               % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    mesh = init_device_mesh(dev.type, (config.dp, config.sp, config.tp),
                            mesh_dim_names=AXES)
    timeout = datetime.timedelta(seconds=timeout_s)
    rank = dist.get_rank()
    mine = None
    # every rank creates every tp group, in the same order
    for start in range(0, world, config.tp):
        ranks = tuple(range(start, start + config.tp))
        data = dist.new_group(list(ranks), timeout=timeout, backend=want)
        control = dist.new_group(list(ranks), timeout=_IDLE_TIMEOUT,
                                 backend="gloo")
        status = dist.new_group(list(ranks), timeout=timeout,
                                backend="gloo")
        if rank in ranks:
            mine = (ranks, data, control, status)
    ranks, data, control, status = mine
    state = MeshState(
        device=dev, backend=want, tp=config.tp, tp_rank=ranks.index(rank),
        tp_ranks=ranks, data=data, control=control, status=status,
        timeout_s=timeout_s, dp=config.dp, sp=config.sp,
        dp_rank=rank // (config.sp * config.tp),
        sp_rank=rank // config.tp % config.sp)
    _axis_groups(state, config, rank, timeout, want)
    mesh._tpuserver = state
    return mesh


def _axis_groups(state, config, rank, timeout, backend):
    """The sp groups (same dp and tp coordinate), the dp groups (same sp
    and tp coordinate) and one dp x sp group per tp coordinate, in that
    order on every rank, in JAX's layout ``reshape(dp, sp, tp)``: rank =
    (d * sp + s) * tp + t.  An axis of size 1 makes no group."""
    dp, sp, tp = config.dp, config.sp, config.tp

    def at(d, s, t):
        return (d * sp + s) * tp + t

    kinds = (
        ("sp", sp, [[at(d, s, t) for s in range(sp)]
                    for d in range(dp) for t in range(tp)]),
        ("dp", dp, [[at(d, s, t) for d in range(dp)]
                    for s in range(sp) for t in range(tp)]),
        ("dpsp", dp * sp, [[at(d, s, t) for d in range(dp)
                            for s in range(sp)] for t in range(tp)]),
    )
    for name, size, groups in kinds:
        for ranks in groups:
            group = (dist.new_group(ranks, timeout=timeout, backend=backend)
                     if size > 1 else None)
            if rank in ranks:
                setattr(state, name + "_ranks", tuple(ranks))
                setattr(state, name + "_group", group)


def mesh_state(mesh):
    """The port's :class:`MeshState` of a mesh from :func:`make_mesh`."""
    state = getattr(mesh, "_tpuserver", None)
    if state is None:
        raise ValueError("not a mesh of tpuserver_torch.parallel.make_mesh")
    return state


def shard(t, dim, size, rank):
    """Rank ``rank``'s slice of ``t`` cut into ``size`` equal parts on
    ``dim``, a contiguous copy that holds nothing else of ``t`` (``t``
    itself when ``dim`` is None or ``size`` is 1)."""
    if dim is None or size == 1:
        return t
    if t.shape[dim] % size:
        raise ValueError("tp={} must divide dim {} of a {} leaf".format(
            size, dim, tuple(t.shape)))
    # a copy even where the slice is contiguous (dim 0): a view would keep
    # the whole leaf alive
    return t.chunk(size, dim)[rank].clone(
        memory_format=torch.contiguous_format)


def shard_tree(tree, specs, size, rank):
    """:func:`shard` over a params tree and its matching tree of shard
    dims (``llama.param_specs``)."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, specs[k], size, rank)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [shard_tree(v, s, size, rank) for v, s in zip(tree, specs)]
    return shard(tree, specs, size, rank)


def shard_params(params, specs, mesh):
    """This rank's slice of each leaf of ``params`` under ``specs`` (a
    tree of shard dims, ``llama.param_specs``), each a contiguous copy;
    replicated leaves are kept as they are."""
    state = mesh_state(mesh)
    return shard_tree(params, specs, state.tp, state.tp_rank)
