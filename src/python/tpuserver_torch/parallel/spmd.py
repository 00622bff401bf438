"""The driver/follower mirror: tensor-parallel serving with one process
per rank.

The JAX package serves over a mesh as one controller: GSPMD compiles one
program and places its collectives.  Torch runs one process per rank, so
the port mirrors the calls of one process on the others.  The rank at tp
coordinate 0 is the **driver**: it runs the model, its scheduler and the
servers.  Every other rank of its tp group is a **follower** and runs
:func:`follow`.

- Each call of a TP bundle function (:meth:`Mirror.call`) broadcasts
  ``(function, host arguments, handles)`` over the tp group's gloo
  control group, and then every rank runs the same shard-local function
  (a module-level function, pickled by reference).  Its collectives
  (:class:`TPContext`) run on the data group in the same order on every
  rank.  Ops are applied in broadcast order only, so no follower runs
  ahead of the driver's sampling.
- Host arguments (numpy arrays, ints, configs, CPU tensors) travel in the
  message.  Device values cross by handle: every tensor a call returns is
  registered under a number that every rank assigns alike, and each rank
  keeps its own shard under it.  A returned tensor the driver passes back
  travels as its number and each follower substitutes its own shard.  A
  device tensor the driver made itself (not a call's result) is taken as
  replicated: the driver's value is broadcast over the data group.
- When the driver drops a returned tensor, ``weakref.finalize`` queues its
  number, and the next message frees it on every rank.
- After each call every rank reports whether it raised: a follower's
  exception is raised on the driver as :class:`FollowerError`.  The tp
  groups carry a timeout, so a follower that fails before a collective
  surfaces as an error, never as a hang; after a timed-out collective the
  groups' state is unknown and the mirror refuses further calls.

The sentinels :data:`LOCAL` and :data:`DEVICE`, passed as a top-level
argument of a call, stand for each rank's own :class:`TPContext` and
device.  :func:`start` spawns the followers of one host (daemon processes
of the ``spawn`` context, over a ``file://`` store) and makes the calling
process the driver; :func:`shutdown` stops and joins them.
"""

import collections
import contextlib
import datetime
import gc
import logging
import os
import threading
import weakref

import torch
import torch.distributed as dist

from tpuserver_torch import resolve_device
from tpuserver_torch.parallel.collectives import GroupContext
from tpuserver_torch.parallel.mesh import (
    DEFAULT_TIMEOUT_S,
    MeshConfig,
    make_mesh,
    mesh_state,
)

_log = logging.getLogger(__name__)


class FollowerError(RuntimeError):
    """A follower raised in a mirrored call, or the tp group was lost."""


class _Sentinel:
    def __init__(self, name):
        self._name = name

    def __repr__(self):
        return self._name

    def __reduce__(self):
        return self._name  # pickled by reference: the module's own object


#: stands for each rank's :class:`TPContext` in a mirrored call
LOCAL = _Sentinel("LOCAL")
#: stands for each rank's device in a mirrored call
DEVICE = _Sentinel("DEVICE")


class TPContext(GroupContext):
    """One rank's view of its tp group: the collectives of the sharded
    model (:class:`~tpuserver_torch.parallel.collectives.GroupContext`),
    run on the data group."""

    def __init__(self, state):
        super().__init__("tp", state.data, state.tp_ranks, state.tp_rank,
                         state.device, state.backend)
        # planted faults of the port's tp check: block -> the reduction
        # that stands for all_reduce there (``llama.tp_plant_fault``)
        self.faults = {}


class _Handle:
    __slots__ = ("n",)

    def __init__(self, n):
        self.n = n


class _Sent:
    """A device tensor broadcast over the data group after the message."""
    __slots__ = ("shape", "dtype")

    def __init__(self, shape, dtype):
        self.shape = shape
        self.dtype = dtype


def _tensors(out):
    """The tensors of a call's result, in a fixed order (tuples, lists
    and dicts walked; anything else skipped)."""
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, (list, tuple)):
        for v in out:
            yield from _tensors(v)
    elif isinstance(out, dict):
        for v in out.values():
            yield from _tensors(v)


def _lost(error):
    """Whether an exception leaves the groups' state unknown (a timed-out
    or broken collective)."""
    return isinstance(error, dist.DistError) or "timed out" in str(
        error).lower()


class Mirror:
    """The mirror of one tp group, on every rank of it (see the module
    docstring).  Get it with :func:`mirror`."""

    def __init__(self, mesh):
        state = mesh_state(mesh)
        self._state = state
        self.tp = context(mesh)
        self.tp.mirror = self
        self.is_driver = state.tp_rank == 0
        self._lock = threading.Lock()
        self._next = 0
        self._ids = {}  # driver: id(tensor) -> (number, weakref)
        self._table = {}  # follower: number -> tensor
        self._table_ids = {}  # follower: id(tensor) -> number
        self._frees = collections.deque()
        self.broken = None
        self.stopped = False

    # -- the driver ---------------------------------------------------------

    def call(self, fn, *args, keep=True, **kwargs):
        """Run ``fn(*args, **kwargs)`` on every rank of the tp group and
        return the driver's result.  ``keep=False``: the followers drop
        their results and nothing is registered (a result only the
        driver reads, such as a gathered cache)."""
        if not self.is_driver:
            raise RuntimeError("only the driver calls the mirror; a "
                               "follower runs follow()")
        with self._lock:
            self._usable()
            sends = []
            msg = ("call", fn, self._encode(args, sends),
                   self._encode(kwargs, sends), keep, self._take_frees())
            try:
                self._send(msg)
                for t in sends:
                    self.tp.broadcast(t.contiguous())
            except Exception as e:  # noqa: BLE001 — the group is gone
                self.broken = [(0, repr(e), True)]
                raise FollowerError("tp group lost: {}".format(e)) from e
            return self._run(fn, self._resolve(args), self._resolve(kwargs),
                             keep)

    def gather(self, fn, *args, **kwargs):
        """``fn(*args, **kwargs)`` on every rank; its (picklable) results
        as a list in tp order."""
        with self._lock:
            self._usable()
            self._send(("gather", fn, args, kwargs, self._take_frees()))
            return self._gather(fn, self._resolve(args),
                                self._resolve(kwargs))

    def handles(self):
        """(count, bytes) of the tensors each rank holds for the driver's
        live handles, in tp order, after sending the frees queued so far
        (a garbage collection first: handles in reference cycles)."""
        gc.collect()
        return self.gather(_holdings, LOCAL)

    def stop(self):
        """End every follower's :func:`follow` loop."""
        with self._lock:
            if not self.stopped and self.broken is None:
                self._send(("stop", self._take_frees()))
            self.stopped = True

    def _usable(self):
        if self.stopped:
            raise FollowerError("the tp mirror was stopped")
        if self.broken is not None:
            raise FollowerError(
                "the tp mirror is broken since a collective failed: "
                "{}".format(self.broken))

    def _take_frees(self):
        frees = []
        while self._frees:
            frees.append(self._frees.popleft())
        return frees

    def _dropped(self, key, n):
        entry = self._ids.get(key)
        if entry is not None and entry[0] == n:
            del self._ids[key]
        self._frees.append(n)

    def _encode(self, obj, sends):
        if isinstance(obj, torch.Tensor):
            entry = self._ids.get(id(obj))
            if entry is not None and entry[1]() is obj:
                return _Handle(entry[0])
            if obj.device.type == "cpu":
                return obj
            sends.append(obj)
            return _Sent(tuple(obj.shape), obj.dtype)
        if isinstance(obj, dict):
            return {k: self._encode(v, sends) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return type(obj)(self._encode(v, sends) for v in obj)
        return obj

    def _resolve(self, args):
        """Top-level sentinels replaced by this rank's context/device."""
        def one(v):
            if v is LOCAL:
                return self.tp
            if v is DEVICE:
                return self.tp.device
            return v

        if isinstance(args, dict):
            return {k: one(v) for k, v in args.items()}
        return tuple(one(v) for v in args)

    def _send(self, msg):
        dist.broadcast_object_list([msg], src=self._state.tp_ranks[0],
                                   group=self._state.control)

    # -- both ends ----------------------------------------------------------

    def _run(self, fn, args, kwargs, keep):
        out = error = None
        try:
            with torch.inference_mode():
                out = fn(*args, **kwargs)
        except Exception as e:  # noqa: BLE001 — reported to every rank
            error = e
        failures = self._exchange(error)
        if failures:
            return self._fail(failures, error)
        if keep:
            self._register(out)
        return out

    def _gather(self, fn, args, kwargs):
        out = error = None
        try:
            out = fn(*args, **kwargs)
        except Exception as e:  # noqa: BLE001 — reported to every rank
            error = e
        failures = self._exchange(error)
        if failures:
            return self._fail(failures, error)
        every = [None] * self._state.tp
        dist.all_gather_object(every, out, group=self._state.status)
        return every

    def _fail(self, failures, error):
        if not self.is_driver:
            _log.error("tp rank %d: mirrored call failed: %s",
                       self._state.tp_rank, failures)
            return None
        followers = [f for f in failures if f[0] != 0]
        if followers:
            raise FollowerError("tp follower(s) raised: {}".format(
                "; ".join("rank {}: {}".format(r, m)
                          for r, m, _ in followers))) from error
        raise error

    def _exchange(self, error):
        """Every rank's failure, if any rank failed: [(tp rank, message,
        whether the groups' state is lost)]; [] when all succeeded."""
        group = self._state.status
        flag = torch.tensor([0 if error is None else 1], dtype=torch.int32)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=group)
        if not flag.item():
            return []
        mine = None if error is None else (
            self._state.tp_rank, "{}: {}".format(type(error).__name__,
                                                 error), _lost(error))
        every = [None] * self._state.tp
        dist.all_gather_object(every, mine, group=group)
        failures = [f for f in every if f is not None]
        if any(f[2] for f in failures):
            self.broken = failures
        return failures

    def _register(self, out):
        for t in _tensors(out):
            if self.is_driver:
                entry = self._ids.get(id(t))
                if entry is not None and entry[1]() is t:
                    continue
                n, self._next = self._next, self._next + 1
                self._ids[id(t)] = (n, weakref.ref(t))
                weakref.finalize(t, self._dropped, id(t), n).atexit = False
            elif id(t) not in self._table_ids:
                n, self._next = self._next, self._next + 1
                self._table[n] = t
                self._table_ids[id(t)] = n

    # -- a follower ---------------------------------------------------------

    def _serve_one(self):
        """Receive and apply one message; False once told to stop."""
        box = [None]
        dist.broadcast_object_list(box, src=self._state.tp_ranks[0],
                                   group=self._state.control)
        msg = box[0]
        for n in msg[-1]:
            t = self._table.pop(n, None)
            if t is not None:
                self._table_ids.pop(id(t), None)
        kind = msg[0]
        if kind == "stop":
            self.stopped = True
            return False
        if kind == "gather":
            _, fn, args, kwargs, _ = msg
            self._gather(fn, self._resolve(args), self._resolve(kwargs))
            return True
        _, fn, args, kwargs, keep, _ = msg
        sent = []
        self._walk_sent((args, kwargs), sent)
        received = [self.tp.broadcast(torch.empty(
            s.shape, dtype=s.dtype, device=self.tp.device)) for s in sent]
        it = iter(received)
        args = self._decode(args, it)
        kwargs = self._decode(kwargs, it)
        self._run(fn, args, kwargs, keep)
        return True

    def _walk_sent(self, obj, sent):
        if isinstance(obj, _Sent):
            sent.append(obj)
        elif isinstance(obj, dict):
            for v in obj.values():
                self._walk_sent(v, sent)
        elif isinstance(obj, (list, tuple)):
            for v in obj:
                self._walk_sent(v, sent)

    def _decode(self, obj, received):
        if obj is LOCAL:
            return self.tp
        if obj is DEVICE:
            return self.tp.device
        if isinstance(obj, _Handle):
            return self._table.get(obj.n)
        if isinstance(obj, _Sent):
            return next(received)
        if isinstance(obj, dict):
            return {k: self._decode(v, received) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return type(obj)(self._decode(v, received) for v in obj)
        return obj

    def owns(self, t):
        """Whether ``t`` is a live handle of this mirror (on the driver)."""
        entry = self._ids.get(id(t))
        return entry is not None and entry[1]() is t

    def holdings(self):
        """(count, bytes) of the tensors this rank holds under handles."""
        if self.is_driver:
            live = [ref() for _, ref in list(self._ids.values())]
            live = [t for t in live if t is not None]
        else:
            live = list(self._table.values())
        return len(live), sum(t.numel() * t.element_size() for t in live)


def context(mesh):
    """This rank's :class:`TPContext` of a mesh (one per mesh)."""
    state = mesh_state(mesh)
    if state.context is None:
        state.context = TPContext(state)
    return state.context


def mirror(mesh):
    """The :class:`Mirror` of a mesh's tp group (one per mesh)."""
    state = mesh_state(mesh)
    if state.mirror is None:
        if state.tp_ranks[0] != 0:
            raise ValueError(
                "TP serving runs on the tp group of rank 0: a mesh whose "
                "dp or sp is above 1 is not served (got tp ranks {})".format(
                    state.tp_ranks))
        state.mirror = Mirror(mesh)
    return state.mirror


def _holdings(tp):
    return tp.mirror.holdings()


def follow(mesh):
    """A follower's loop: apply the driver's calls in broadcast order
    until :meth:`Mirror.stop`.  A call that raises is reported to the
    driver and the loop goes on."""
    m = mirror(mesh)
    if m.is_driver:
        raise RuntimeError("the driver does not follow; it calls")
    device = m.tp.device
    with (torch.cuda.device(device) if device.type == "cuda"
          else contextlib.nullcontext()):
        while m._serve_one():
            pass


def rank_report(reset_launches=False, reset_peak=False):
    """This rank's kernel launch counts and device memory (allocated now
    and at its peak), for :meth:`Mirror.gather`; the resets zero the
    counts and the peak after reading them."""
    from tpuserver_torch.ops import flash, quant

    report = {"launches": {
        "flash_attention": flash.flash_attention.launches,
        "decode_attention": flash.decode_attention.launches,
        "int8_matmul": quant.int8_matmul.launches}}
    if reset_launches:
        flash.reset_launch_counts()
        quant.reset_launch_counts()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        report["allocated_bytes"] = torch.cuda.memory_allocated()
        report["peak_bytes"] = torch.cuda.max_memory_allocated()
        if reset_peak:
            torch.cuda.reset_peak_memory_stats()
    return report


# -- processes ---------------------------------------------------------------


class Followers:
    """The follower processes :func:`start` spawned (daemons)."""

    def __init__(self, procs):
        self.procs = procs

    def close(self, timeout=30.0):
        """Join every follower within ``timeout`` seconds each, killing
        any that is still alive; returns their exit codes."""
        for p in self.procs:
            p.join(timeout)
            if p.is_alive():
                p.kill()
                p.join(5.0)
        return [p.exitcode for p in self.procs]


def _follower_main(rank, world_size, init_method, device, backend, config,
                   timeout_s, threads):
    if threads:
        torch.set_num_threads(threads)
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))
    try:
        follow(make_mesh(config, device=device, backend=backend,
                         timeout_s=timeout_s))
    finally:
        dist.destroy_process_group()


def start(world_size, store_path, device=None, backend=None, config=None,
          timeout_s=DEFAULT_TIMEOUT_S, threads=None):
    """Spawn ranks 1 .. ``world_size - 1`` as followers on this host and
    make the calling process rank 0, the driver, over the ``file://``
    store at ``store_path`` (a path that does not exist yet).  Returns
    ``(mesh, followers)``; end with :func:`shutdown`.  ``device``,
    ``backend``, ``config`` (default: every rank on tp) and ``timeout_s``
    are :func:`make_mesh`'s, on every rank; ``threads`` sets each
    follower's intra-op threads."""
    dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    config = config or MeshConfig(tp=world_size)
    init = "file://" + os.path.abspath(store_path)
    ctx = torch.multiprocessing.get_context("spawn")
    procs = []
    followers = Followers(procs)
    try:
        for rank in range(1, world_size):
            procs.append(ctx.Process(
                target=_follower_main,
                args=(rank, world_size, init, str(dev), backend, config,
                      timeout_s, threads),
                daemon=True))
            procs[-1].start()
        dist.init_process_group(
            backend, init_method=init, rank=0, world_size=world_size,
            timeout=datetime.timedelta(seconds=timeout_s))
        mesh = make_mesh(config, device=dev, backend=backend,
                         timeout_s=timeout_s)
    except BaseException:
        if dist.is_initialized():
            dist.destroy_process_group()
        followers.close(timeout=1.0)
        raise
    return mesh, followers


def shutdown(mesh, followers, timeout=30.0):
    """Stop the followers' loops, leave the process group and join the
    followers; returns their exit codes."""
    try:
        mirror(mesh).stop()
    finally:
        dist.destroy_process_group()
    return followers.close(timeout)
