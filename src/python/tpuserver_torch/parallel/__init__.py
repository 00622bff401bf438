"""Parallelism for the port (the counterpart of ``tpuserver/parallel``):
the (dp, sp, tp) mesh (:mod:`.mesh`); the collectives of its groups and
the differentiable ones of SPMD training (:mod:`.collectives`); the two
sequence-parallel attentions, ``ring_attention`` (:mod:`.ring`: K/V
rotate around the sp ring) and ``ulysses_attention`` (:mod:`.ulysses`:
two all-to-alls trade sequence shards for head shards); and the
driver/follower mirror of tensor-parallel serving, one process per rank
(:mod:`.spmd`).  Training needs no mirror: every rank runs its own loop
(``tpuserver_torch.models.llama.make_train_step``)."""

from tpuserver_torch.parallel.mesh import (
    AXES,
    MeshConfig,
    make_mesh,
    mesh_factorize,
    shard_params,
)
from tpuserver_torch.parallel.ring import ring_attention
from tpuserver_torch.parallel.spmd import FollowerError, follow
from tpuserver_torch.parallel.ulysses import ulysses_attention

__all__ = ["AXES", "FollowerError", "MeshConfig", "follow", "make_mesh",
           "mesh_factorize", "ring_attention", "shard_params",
           "ulysses_attention"]
