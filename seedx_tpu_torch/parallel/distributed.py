"""Process groups, the per-rank batch contract and the collectives the
sharded modules run (reference: seedx_tpu/parallel/distributed.py).

The JAX package starts ``jax.distributed`` from ``JAX_COORDINATOR_ADDRESS``
/ ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID`` (one process a host).  The port
runs one process a GPU under torchrun's environment, which
``maybe_initialize`` reads: ``MASTER_ADDR`` / ``MASTER_PORT`` (the
coordinator's address), ``WORLD_SIZE`` (the number of processes), ``RANK``
(this process's id) and ``LOCAL_RANK`` (its card on the host).  It is a
no-op in a single process.

``MeshGroups`` holds a mesh's ``fsdp`` and ``tensor`` process groups and
runs the sharded modules' collectives on them: the all-reduce of a
row-parallel projection's partial sums, the all-reduce MAX of a row's
absmax, the all-gather of a leaf split over ``fsdp`` (into a buffer kept
per leaf, so every layer's gather lands at the same address and a
captured program replays it) and of logits split over the vocab.  A
collective runs on a group of one rank too (NCCL's identity): the
one-card path is the path of a larger mesh.  ``COLLECTIVES`` counts the
calls the host makes.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

COLLECTIVES: Dict[str, int] = {"all_reduce": 0, "all_gather": 0}


def maybe_initialize(device=None) -> bool:
    """Start the default process group once, under torchrun's environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` /
    ``MASTER_PORT``): NCCL on ``cuda:LOCAL_RANK``, or gloo when ``device``
    is the CPU.  Idempotent; returns whether a group exists (False in a
    single process without that environment)."""
    if dist.is_initialized():
        return True
    if "WORLD_SIZE" not in os.environ or "RANK" not in os.environ:
        return False
    device = torch.device(device if device is not None else "cuda")
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", "0"))
        torch.cuda.set_device(local)
        dist.init_process_group("nccl", init_method="env://",
                                device_id=torch.device("cuda", local))
    else:
        dist.init_process_group("gloo", init_method="env://")
    logger.info("torch.distributed initialized: rank %d/%d (%s)",
                dist.get_rank(), dist.get_world_size(),
                dist.get_backend())
    return True


def put_global(x: torch.Tensor, sharding):
    """Place a batch on a (possibly multi-process) sharding from
    ``mesh_sharding``: a ``DTensor`` over its mesh.  In one process ``x``
    is the whole batch, split as the sharding says (``device_put``); with
    several processes ``x`` is this rank's slice of the global batch (the
    per-rank data contract: each rank reads its own shard of the data) and
    the global tensor is assembled from every rank's slice without moving
    data."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    mesh = sharding.mesh
    placements = sharding.placements()
    x = x.to(mesh.device_type)
    if dist.get_world_size() == 1:
        return distribute_tensor(x, mesh, placements)
    return DTensor.from_local(x, mesh, placements, run_check=False)


class MeshGroups:
    """The ``fsdp`` and ``tensor`` groups of a mesh and the collectives
    of the sharded modules."""

    AXES = ("fsdp", "tensor")

    def __init__(self, mesh):
        self.mesh = mesh
        names = mesh.mesh_dim_names
        self.group = {a: mesh.get_group(a) for a in self.AXES}
        self.size = {a: mesh.size(names.index(a)) for a in self.AXES}
        self.rank = {a: mesh.get_local_rank(a) for a in self.AXES}
        self.backend = dist.get_backend(self.group["tensor"])
        self._bufs: Dict[tuple, torch.Tensor] = {}

    def warm_up(self, device) -> None:
        """One collective on each group: NCCL sets a communicator up at its
        first collective, which must not happen under stream capture."""
        for a in self.AXES:
            self.all_reduce(torch.zeros(1, device=device), a)

    def all_reduce(self, x: torch.Tensor, axis: str = "tensor",
                   op: str = "sum") -> torch.Tensor:
        """In place; returns ``x``."""
        COLLECTIVES["all_reduce"] += 1
        dist.all_reduce(x, op=dist.ReduceOp.MAX if op == "max"
                        else dist.ReduceOp.SUM, group=self.group[axis])
        return x

    def all_gather(self, x: torch.Tensor, dim: int, axis: str,
                   key: Optional[tuple] = None) -> torch.Tensor:
        """Concatenate every rank's ``x`` along ``dim`` (rank order).  With
        ``key`` the gather lands in a buffer kept for that key and shape."""
        n = self.size[axis]
        x = x.contiguous()
        shape = (n,) + tuple(x.shape)
        buf = None
        if key is not None:
            bkey = key + (shape, x.dtype, x.device)
            buf = self._bufs.get(bkey)
            if buf is None:
                buf = self._bufs[bkey] = torch.empty(shape, dtype=x.dtype,
                                                     device=x.device)
        else:
            buf = torch.empty(shape, dtype=x.dtype, device=x.device)
        COLLECTIVES["all_gather"] += 1
        dist.all_gather_into_tensor(buf.view((-1,) + tuple(x.shape[1:]))
                                    if x.dim() else buf, x,
                                    group=self.group[axis])
        dim = dim % x.dim()
        out = buf.movedim(0, dim)
        return out.reshape(x.shape[:dim] + (n * x.shape[dim],)
                           + x.shape[dim + 1:])
