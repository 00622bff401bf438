"""Tensor-parallel serving for the port (the counterpart of
``tpuserver/parallel``): the mesh (:mod:`.mesh`) and the driver/follower
mirror that runs one process per rank (:mod:`.spmd`).  The sequence-
parallel attentions (``ring_attention``, ``ulysses_attention``) belong to
training and are not ported yet."""

from tpuserver_torch.parallel.mesh import (
    AXES,
    MeshConfig,
    make_mesh,
    mesh_factorize,
    shard_params,
)
from tpuserver_torch.parallel.spmd import FollowerError, follow

__all__ = ["AXES", "FollowerError", "MeshConfig", "follow", "make_mesh",
           "mesh_factorize", "shard_params"]
