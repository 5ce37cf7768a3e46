"""Process groups, the per-rank batch contract and the collectives the
sharded modules run (reference: seedx_tpu/parallel/distributed.py).

The JAX package starts ``jax.distributed`` from ``JAX_COORDINATOR_ADDRESS``
/ ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID`` (one process a host).  The port
runs one process a GPU under torchrun's environment, which
``maybe_initialize`` reads: ``MASTER_ADDR`` / ``MASTER_PORT`` (the
coordinator's address), ``WORLD_SIZE`` (the number of processes), ``RANK``
(this process's id) and ``LOCAL_RANK`` (its card on the host).  It is a
no-op in a single process.

``MeshGroups`` holds a mesh's ``data``, ``fsdp`` and ``tensor`` process
groups and runs the sharded modules' collectives on them: the all-reduce
of a row-parallel projection's partial sums, the all-reduce MAX of a
row's absmax, the all-gather of a leaf split over ``fsdp`` (into a buffer
kept per leaf, so every layer's gather lands at the same address and a
captured program replays it) and of logits split over the vocab; for the
split SDXL denoise the halo exchange of latent rows (``halo``), the fp32
sums of GroupNorm and the gathers of keys / values, rows and CFG
branches.  Training takes gradients through them: ``gather_leaf`` (its
backward reduce-scatters), ``copy_to`` / ``reduce_from`` (Megatron's "f"
and "g") and ``gather_from`` (its backward keeps the rank's block).  A
collective runs on a group of one rank too (NCCL's identity): the
one-card path is the path of a larger mesh.  ``COLLECTIVES`` counts the
calls the host makes.  ``batch_coordinate`` is a rank's place among the
readers of different data (``data/pipeline.process_rank``).
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

COLLECTIVES: Dict[str, int] = {"all_reduce": 0, "all_gather": 0, "halo": 0,
                               "reduce_scatter": 0}


# the mesh this process made last (``mesh.create_mesh``): the data
# pipeline shards its files by the rank's coordinate on its batch axes
DATA_MESH = None


def batch_coordinate() -> Tuple[int, int]:
    """(index, count) of this process among the readers of different data:
    on a mesh (``DATA_MESH``) its coordinate over (data, fsdp), row-major,
    so ``tensor`` peers read the same rows; else its rank and the world
    size of the default group; (0, 1) in a single process."""
    if not (dist.is_available() and dist.is_initialized()):
        return 0, 1
    mesh = DATA_MESH
    if mesh is None:
        return dist.get_rank(), dist.get_world_size()
    names = mesh.mesh_dim_names
    fsdp = mesh.size(names.index("fsdp"))
    return (mesh.get_local_rank("data") * fsdp + mesh.get_local_rank("fsdp"),
            mesh.size(names.index("data")) * fsdp)


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
    """The ``data``, ``fsdp`` and ``tensor`` groups of a mesh and the
    collectives of the sharded modules."""

    AXES = ("data", "fsdp", "tensor")

    def __init__(self, mesh):
        self.mesh = mesh
        names = mesh.mesh_dim_names
        self.group = {a: mesh.get_group(a) for a in self.AXES}
        self.size = {a: mesh.size(names.index(a)) for a in self.AXES}
        self.rank = {a: mesh.get_local_rank(a) for a in self.AXES}
        self.backend = dist.get_backend(self.group["tensor"])
        self._bufs: Dict[tuple, torch.Tensor] = {}

    # ---- the batch axes ----------------------------------------------------

    @property
    def batch_count(self) -> int:
        """Ranks holding different rows of a batch: data x fsdp."""
        return self.size["data"] * self.size["fsdp"]

    @property
    def batch_index(self) -> int:
        """This rank's coordinate over (data, fsdp), row-major (the order a
        JAX mesh lays its devices out); ``tensor`` peers share it."""
        return self.rank["data"] * self.size["fsdp"] + self.rank["fsdp"]

    def batch_sum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum ``x`` over the batch axes (fsdp, then data), in place."""
        for axis in ("fsdp", "data"):
            self.all_reduce(x, axis)
        return x

    def warm_up(self, device) -> None:
        """One collective on each group: NCCL sets a communicator up at its
        first collective, which must not happen under stream capture."""
        for a in self.AXES:
            self.all_reduce(torch.zeros(1, device=device), a)

    # ---- the collectives (no autograd) ---------------------------------------

    def all_reduce(self, x: torch.Tensor, axis: str = "tensor",
                   op: str = "sum") -> torch.Tensor:
        """In place; returns ``x``."""
        COLLECTIVES["all_reduce"] += 1
        dist.all_reduce(x, op=dist.ReduceOp.MAX if op == "max"
                        else dist.ReduceOp.SUM, group=self.group[axis])
        return x

    def _gather(self, x: torch.Tensor, axis: str,
                key: Optional[tuple] = None) -> torch.Tensor:
        """Every rank's ``x`` stacked on a new leading dim [n, *x.shape]
        (rank order); with ``key`` into a buffer kept for that key and
        shape."""
        x = x.contiguous()
        shape = (self.size[axis],) + tuple(x.shape)
        buf = None
        if key is not None:
            bkey = key + (shape, x.dtype, x.device)
            buf = self._bufs.get(bkey)
            if buf is None:
                buf = self._bufs[bkey] = torch.empty(shape, dtype=x.dtype,
                                                     device=x.device)
        else:
            buf = torch.empty(shape, dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(buf.view((-1,) + tuple(x.shape[1:]))
                                    if x.dim() else buf, x,
                                    group=self.group[axis])
        return buf

    def all_gather(self, x: torch.Tensor, dim: int, axis: str,
                   key: Optional[tuple] = None) -> torch.Tensor:
        """Concatenate every rank's ``x`` along ``dim`` (rank order).  With
        ``key`` the gather lands in a buffer kept for that key and shape."""
        COLLECTIVES["all_gather"] += 1
        n = self.size[axis]
        buf = self._gather(x, axis, key)
        dim = dim % x.dim()
        out = buf.movedim(0, dim)
        return out.reshape(x.shape[:dim] + (n * x.shape[dim],)
                           + x.shape[dim + 1:])

    def reduce_scatter(self, x: torch.Tensor, dim: int,
                       axis: str) -> torch.Tensor:
        """Sum ``x`` over the ``axis`` group and keep this rank's block of
        ``dim`` (the inverse of ``all_gather`` for gradients).  NCCL
        reduce-scatters; gloo all-reduces and slices."""
        COLLECTIVES["reduce_scatter"] += 1
        n, r = self.size[axis], self.rank[axis]
        dim = dim % x.dim()
        k = x.shape[dim] // n
        xt = x.movedim(dim, 0).contiguous()
        if self.backend == "nccl":
            out = torch.empty((k,) + tuple(xt.shape[1:]), dtype=x.dtype,
                              device=x.device)
            dist.reduce_scatter_tensor(out, xt, group=self.group[axis])
        else:
            dist.all_reduce(xt, group=self.group[axis])
            out = xt[r * k:(r + 1) * k]
        return out.movedim(0, dim).contiguous()

    def halo(self, x: torch.Tensor, top: int, bottom: int,
             axis: str = "tensor", dim: int = 1) -> torch.Tensor:
        """``x`` (this rank's contiguous block of ``dim``) with the ``top``
        rows just above it and the ``bottom`` rows just below it, from its
        ``axis`` neighbours; zeros past the first and the last rank (the
        image's edges).  One all-gather of every rank's edge rows."""
        n, r, h = self.size[axis], self.rank[axis], x.shape[dim]
        if max(top, bottom) > h:
            raise ValueError(f"a halo of {max(top, bottom)} rows needs at "
                             f"least that many rows a rank, got {h}")
        COLLECTIVES["halo"] += 1
        edges = torch.cat([x.narrow(dim, 0, bottom),
                           x.narrow(dim, h - top, top)], dim)
        buf = self._gather(edges, axis)
        zeros = x.new_zeros(x.shape[:dim] + (1,) + x.shape[dim + 1:])
        above = (buf[r - 1].narrow(dim, bottom, top) if r > 0
                 else zeros.expand(*x.shape[:dim], top, *x.shape[dim + 1:]))
        below = (buf[r + 1].narrow(dim, 0, bottom) if r < n - 1
                 else zeros.expand(*x.shape[:dim], bottom,
                                   *x.shape[dim + 1:]))
        return torch.cat([above, x, below], dim)

    # ---- the collectives of a training forward (autograd) -------------------

    def gather_leaf(self, t: torch.Tensor, dim: int,
                    axis: str) -> torch.Tensor:
        """``all_gather`` of a trainable leaf's shard, whose backward
        reduce-scatters (sums) the gathered gradient over ``axis``."""
        return _GatherLeaf.apply(t, self, dim, axis)

    def copy_to(self, x: torch.Tensor, axis: str = "tensor") -> torch.Tensor:
        """Megatron's "f": the identity, whose backward all-reduces (sums)
        the gradient over ``axis`` (the input of a column-parallel
        product, whose ranks each give back a partial dx)."""
        return _CopyTo.apply(x, self, axis)

    def reduce_from(self, y: torch.Tensor,
                    axis: str = "tensor") -> torch.Tensor:
        """Megatron's "g": sum partial results over ``axis`` (in fp32, one
        rounding back); its backward is the identity."""
        return _ReduceFrom.apply(y, self, axis)

    def gather_from(self, x: torch.Tensor, dim: int,
                    axis: str = "tensor") -> torch.Tensor:
        """``all_gather`` of an activation split over ``axis`` (the
        vocab-parallel logits), whose backward keeps this rank's block."""
        return _GatherFrom.apply(x, self, dim, axis)


class _GatherLeaf(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, groups, dim, axis):
        ctx.groups, ctx.dim, ctx.axis = groups, dim, axis
        return groups.all_gather(t, dim, axis)

    @staticmethod
    def backward(ctx, g):
        return (ctx.groups.reduce_scatter(g, ctx.dim, ctx.axis), None, None,
                None)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups, axis):
        ctx.groups, ctx.axis = groups, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        out = g.to(torch.float32, copy=True)
        return ctx.groups.all_reduce(out, ctx.axis).to(g.dtype), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, groups, axis):
        out = y.to(torch.float32, copy=True)
        return groups.all_reduce(out, axis).to(y.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups, dim, axis):
        ctx.k, ctx.dim = x.shape[dim], dim
        ctx.r = groups.rank[axis]
        return groups.all_gather(x, dim, axis)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.r * ctx.k, ctx.k), None, None, None
