"""Four gloo ranks for the port's SPMD training tests
(``test_torch_train.py``), and the tasks they run.  This module imports
no JAX: the spawned ranks import it to find their tasks.

:class:`RankPool` spawns ``world`` processes over a ``file://`` store and
keeps them for a test module.  :meth:`RankPool.run` sends one task (a
module-level function and its host arguments) to every rank; each rank
runs it on its own (SPMD: no driver, no mirror) and the results come back
in rank order.  A rank keeps one mesh per (dp, sp, tp), built the first
time a task asks for it; every rank builds them in the same order, since
every rank runs every task.
"""

import dataclasses
import datetime
import os
import traceback

import numpy as np
import torch
import torch.distributed as dist

from tpuserver_torch.models import llama as tl
from tpuserver_torch.parallel import MeshConfig, make_mesh
from tpuserver_torch.parallel.collectives import mesh_context

TIMEOUT_S = 60.0
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class RankPool:
    """``world`` spawned gloo ranks on the CPU, one torch thread each."""

    def __init__(self, world, store_path):
        ctx = torch.multiprocessing.get_context("spawn")
        init = "file://" + os.path.abspath(store_path)
        self.world = world
        self._conns, self._procs = [], []
        for rank in range(world):
            mine, theirs = ctx.Pipe()
            proc = ctx.Process(target=_serve, args=(rank, world, init, theirs),
                               daemon=True)
            proc.start()
            theirs.close()
            self._conns.append(mine)
            self._procs.append(proc)

    def run(self, fn, *args):
        """``fn(*args)`` on every rank; the results in rank order.  A rank
        that raised raises here with its traceback."""
        for conn in self._conns:
            conn.send((fn, args))
        out = []
        for rank, conn in enumerate(self._conns):
            if not conn.poll(2 * TIMEOUT_S):
                raise TimeoutError("rank {} did not answer".format(rank))
            ok, value = conn.recv()
            if not ok:
                raise RuntimeError("rank {}: {}".format(rank, value))
            out.append(value)
        return out

    def close(self, timeout=30.0):
        """Stop every rank; returns their exit codes."""
        for conn in self._conns:
            conn.send(None)
        for proc in self._procs:
            proc.join(timeout)
            if proc.is_alive():
                proc.kill()
                proc.join(5.0)
        return [p.exitcode for p in self._procs]


def _serve(rank, world, init, conn):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=init, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        while True:
            msg = conn.recv()
            if msg is None:
                return
            fn, args = msg
            try:
                conn.send((True, fn(*args)))
            except Exception:  # noqa: BLE001 — reported to the test
                conn.send((False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


_MESHES = {}


def _mesh(shape):
    """This rank's mesh of (dp, sp, tp) ``shape``, built once."""
    if shape not in _MESHES:
        _MESHES[shape] = make_mesh(MeshConfig(*shape), device="cpu",
                                   timeout_s=TIMEOUT_S)
    return _MESHES[shape]


def _np(t):
    return t.detach().float().numpy()


def coords(shape):
    """This rank's (dp, sp, tp) coordinates in a mesh of ``shape``."""
    _, sp, tp = shape
    rank = dist.get_rank()
    return rank // (sp * tp), rank // tp % sp, rank % tp


# -- tasks -------------------------------------------------------------------


def attention(strategy, sp, q, k, v, gout, kv_repeat):
    """Ring or Ulysses attention with time sharded over ``sp`` ranks
    (mesh (4 / sp, sp, 1)) on this rank's block of the global q, k, v
    [B, T, H, D]: (its output block, and the gradients of sum(out * gout)
    on its q, k and v blocks), float32 numpy."""
    from tpuserver_torch.parallel import ring_attention, ulysses_attention

    axis = mesh_context(_mesh((4 // sp, sp, 1))).sp
    qb, kb, vb, gb = (torch.from_numpy(a).chunk(sp, 1)[axis.rank]
                      .clone().requires_grad_(a is not gout)
                      for a in (q, k, v, gout))
    if strategy == "ring":
        out = ring_attention(qb, kb, vb, axis=axis)
    else:
        out = ulysses_attention(qb, kb, vb, axis=axis, kv_repeat=kv_repeat)
    (out * gb).sum().backward()
    return _np(out), _np(qb.grad), _np(kb.grad), _np(vb.grad)


def ulysses_error(heads, kv_heads, kv_repeat):
    """The message of the ValueError ``ulysses_attention`` raises at sp=4
    for these head counts (None if it raises none)."""
    from tpuserver_torch.parallel import ulysses_attention

    axis = mesh_context(_mesh((1, 4, 1))).sp
    q = torch.zeros(1, 2, heads, 8)
    kv = torch.zeros(1, 2, kv_heads, 8)
    try:
        ulysses_attention(q, kv, kv, axis=axis, kv_repeat=kv_repeat)
    except ValueError as e:
        return str(e)
    return None


def _cfg(dtype, strategy, vocab):
    return dataclasses.replace(tl.tiny(vocab=vocab), dtype=DTYPES[dtype],
                               sp_strategy=strategy)


def forward_and_grads(shape, strategy, full, tokens, targets, fault=None):
    """``sharded_forward``'s logits block and one ``make_train_step`` step
    (learning rate 0: the gradients only) at mesh ``shape``, float32:
    (coords, logits block, loss, {leaf path: this rank's summed
    gradient})."""
    mesh = _mesh(shape)
    cfg = _cfg("float32", strategy, full["embed"].shape[0])
    step_fn, init_fn = tl.make_train_step(mesh, cfg, learning_rate=0.0)
    local, opt = init_fn(0, tokens, params=tl.params_from_jax(full, "cpu"))
    with torch.no_grad():
        logits = tl.sharded_forward(mesh, cfg)(local, tokens)
    tl.train_plant_fault(mesh, fault)
    try:
        _, _, loss = step_fn(local, opt, tokens, targets)
    finally:
        tl.train_plant_fault(mesh, None)
    return coords(shape), _np(logits), loss, _paths(local, "grad")


def train(shape, strategy, dtype, full, tokens, targets, lr, steps):
    """``steps`` ``make_train_step`` steps at mesh ``shape``: (coords,
    losses, {leaf path: this rank's params after them})."""
    mesh = _mesh(shape)
    cfg = _cfg(dtype, strategy, full["embed"].shape[0])
    step_fn, init_fn = tl.make_train_step(mesh, cfg, learning_rate=lr)
    # JAX's init draws float32 and casts to the config's dtype: so does this
    bridged = tl.params_from_jax(full, "cpu")
    bridged["layers"] = [{k: v.to(cfg.dtype) for k, v in layer.items()}
                         for layer in bridged["layers"]]
    for k in ("embed", "norm", "lm_head"):
        bridged[k] = bridged[k].to(cfg.dtype)
    params, opt = init_fn(0, tokens, params=bridged)
    losses = []
    for _ in range(steps):
        params, opt, loss = step_fn(params, opt, tokens, targets)
        losses.append(loss)
    return coords(shape), losses, _paths(params, "data")


def _paths(params, attr):
    """{"embed": a, "layers.0.wq": a, ...}: each leaf's ``attr`` (its
    ``data`` or ``grad``) as float32 numpy."""
    out = {}

    def walk(tree, prefix):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, prefix + (k,))
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                walk(v, prefix + (str(i),))
        else:
            out[".".join(prefix)] = _np(getattr(tree, attr))

    walk(params, ())
    return out


def random_tokens(seed, batch, length, vocab):
    """A seeded [batch, length + 1] int32 token array (inputs are the
    first ``length`` columns, targets the last)."""
    return np.random.RandomState(seed).randint(
        0, vocab, (batch, length + 1)).astype(np.int32)
