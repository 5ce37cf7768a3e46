"""Device mesh and the placement of the port's weights on it (reference:
seedx_tpu/parallel/mesh.py).

One ``torch.distributed.device_mesh.DeviceMesh`` with the JAX package's
three axes over the ranks of the default process group: ``data`` (batch),
``fsdp`` (weights split, gathered a layer at a time right before use) and
``tensor`` (attention heads, MLP columns and the vocabulary split, each
rank computing on its own).  Logical axis names map to mesh axes through
the same rule tables (``DEFAULT_RULES``), resolved as flax's
``logical_to_mesh_axes`` does.

The JAX package annotates every parameter with logical axes inside its
flax modules (``nn.with_logical_partitioning``).  The port has no boxes:
``logical_axes(module)`` reads them from one table, ``DENSE_AXES`` (the
``kernel_axes`` of each projection, from which its kernel, quantized
leaves, scales, bias, LoRA factors and IA3 scales take their axes as the
JAX package's ``LoRADense`` gives them) and ``LEAF_AXES`` (the other
leaves); norms are replicated, and a leading stacked-layer dim is
``"layers"``.  ``place_params`` keeps on each rank only its shard of every
leaf (a plain local tensor) and tells each module which of its splits to
gather at use and which it computes on (see ``models/layers.leaf``).

Each rank runs the flash / decode attention kernels on its own heads: the
JAX package's ``custom_partitioning`` of the flash kernel has no
counterpart to port.  A fused q/k/v leaf (the ViT's ``in_proj``) is split
head-aligned when its heads compute over ``tensor``: rank r holds the q,
k and v columns of its heads.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

# Logical axis vocabulary (as the JAX package's):
#   "batch", "images"  batch dims of activations
#   "seq"              sequence dim of activations
#   "embed"            model embedding / hidden dim
#   "mlp"              MLP hidden dim
#   "heads"            attention heads (fused head * head_dim)
#   "kv"               kv projection input dim
#   "vocab"            vocabulary dim
#   "conv_io"          conv output-channel dim
#   "layers"           stacked layer dim (never split)
DEFAULT_RULES: Tuple[Tuple[str, Any], ...] = (
    ("batch", ("data", "fsdp")),
    ("images", ("data", "fsdp")),
    ("seq", None),
    ("embed", "fsdp"),
    ("mlp", "tensor"),
    ("heads", "tensor"),
    ("kv", None),
    ("vocab", "tensor"),
    ("conv_io", None),
    ("layers", None),
    ("queries", None),
    # SDXL denoise activations: CFG branches over data, latent rows over
    # tensor (SDXLAdapter.shard; models/sdxl/unet.RowSplit)
    ("cfg_batch", "data"),
    ("height", "tensor"),
)

TP_RULES: Tuple[Tuple[str, Any], ...] = DEFAULT_RULES

MESH_AXES = ("data", "fsdp", "tensor")


def mesh_shape(data: int, fsdp: int, tensor: int, n: int) -> Tuple[int, ...]:
    """The (data, fsdp, tensor) sizes over ``n`` ranks; one axis may be -1
    (inferred).  Raises the JAX package's errors."""
    sizes = [data, fsdp, tensor]
    if sizes.count(-1) > 1:
        raise ValueError("at most one mesh axis may be -1")
    if -1 in sizes:
        known = math.prod(s for s in sizes if s != -1)
        if n % known:
            raise ValueError(f"{n} devices not divisible by {known}")
        sizes[sizes.index(-1)] = n // known
    if math.prod(sizes) != n:
        raise ValueError(f"mesh {sizes} != {n} devices")
    return tuple(sizes)


def create_mesh(data: int = 1, fsdp: int = -1, tensor: int = 1, *,
                devices: Optional[Sequence[int]] = None,
                device_type: Optional[str] = None):
    """A ('data', 'fsdp', 'tensor') ``DeviceMesh`` over ``devices`` (global
    ranks, default: every rank of the default group); one axis may be -1.
    Starts the default group first (``distributed.maybe_initialize``; in a
    single process without torchrun's environment, a group of one rank:
    NCCL on the card, gloo for ``device_type="cpu"``).  ``device_type``
    defaults to the group's: ``cpu`` under gloo, else ``cuda``.  The mesh
    becomes the process's data mesh (``distributed.DATA_MESH``): the data
    pipeline shards its files by the rank's batch coordinate on it."""
    from torch.distributed.device_mesh import DeviceMesh

    from seedx_tpu_torch.parallel import distributed

    if not distributed.maybe_initialize(device_type):
        cuda = device_type != "cpu"
        if cuda:
            torch.cuda.set_device(0)
        dist.init_process_group("nccl" if cuda else "gloo",
                                store=dist.HashStore(), rank=0,
                                world_size=1,
                                **({"device_id": torch.device("cuda", 0)}
                                   if cuda else {}))
    if device_type is None:
        device_type = "cpu" if dist.get_backend() == "gloo" else "cuda"
    ranks = list(devices if devices is not None
                 else range(dist.get_world_size()))
    sizes = mesh_shape(data, fsdp, tensor, len(ranks))
    mesh = DeviceMesh(device_type, torch.tensor(ranks).reshape(sizes),
                      mesh_dim_names=MESH_AXES)
    distributed.DATA_MESH = mesh
    return mesh


def local_mesh(device_type: Optional[str] = None):
    """Every rank on the fsdp axis (the single-host default)."""
    return create_mesh(device_type=device_type)


def logical_rules(extra: Sequence[Tuple[str, Any]] = ()
                  ) -> Tuple[Tuple[str, Any], ...]:
    return tuple(extra) + DEFAULT_RULES


def logical_to_mesh_axes(names: Sequence[Optional[str]],
                         rules: Sequence[Tuple[str, Any]] = DEFAULT_RULES
                         ) -> Tuple[Any, ...]:
    """Per dim the mesh axis (a name, a tuple of names, or None) that
    splits it: the rules in order, each taking its dim only if none of its
    mesh axes is taken yet (flax's ``logical_to_mesh_axes``)."""
    names = tuple(names)
    dups = [n for n in set(names) if isinstance(n, str)
            and names.count(n) > 1]
    if dups:
        raise ValueError(f"Unsupported: Dimensions {tuple(dups)} occur more "
                         f"than once in array names.")
    unset = object()
    out = [unset if isinstance(n, str) else n for n in names]

    def used(axes):
        flat = set()
        for r in out:
            if r is unset or r is None:
                continue
            flat.update(r if isinstance(r, tuple) else (r,))
        mine = axes if isinstance(axes, tuple) else (axes,)
        return any(a in flat for a in mine if a is not None)

    for logical, axes in rules:
        if logical in names:
            pos = names.index(logical)
            if out[pos] is unset and not used(axes):
                out[pos] = axes
    return tuple(None if r is unset else r for r in out)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """The port's placement of one tensor: its mesh and, per dim, the mesh
    axes that split it (``spec``; a name, a tuple of names or None)."""

    mesh: Any
    spec: Tuple[Any, ...]

    def parts(self, dim: int) -> Tuple[str, ...]:
        s = self.spec[dim]
        return () if s is None else s if isinstance(s, tuple) else (s,)

    def placements(self):
        """DTensor placements, one a mesh dim."""
        from torch.distributed.tensor import Replicate, Shard

        out = []
        for axis in MESH_AXES:
            dims = [d for d in range(len(self.spec)) if axis in self.parts(d)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return out


def mesh_sharding(mesh, *logical_axes: Optional[str],
                  rules: Sequence[Tuple[str, Any]] = DEFAULT_RULES
                  ) -> Sharding:
    """The placement of a tensor whose dims carry the given logical names."""
    return Sharding(mesh, logical_to_mesh_axes(logical_axes, rules))


# ---- the logical axes of every leaf ------------------------------------

# (state-name regex of a projection, its kernel_axes (in, out)), as the
# JAX modules give them (layers.py, llama.py, vit.py, resampler.py)
DENSE_AXES: Tuple[Tuple[str, Tuple[Optional[str], Optional[str]]], ...] = (
    (r"layers\.(q|k|v)_proj", ("embed", "heads")),
    (r"layers\.(gate|up)_proj", ("embed", "mlp")),
    (r"layers\.o_proj", ("heads", "embed")),
    (r"layers\.down_proj", ("mlp", "embed")),
    (r"lm_head", ("embed", "vocab")),
    (r"score", ("embed", None)),
    (r"blocks\.in_proj", ("embed", "heads")),
    (r"blocks\.out_proj", ("heads", "embed")),
    (r"blocks\.mlp\.c_fc", ("embed", "mlp")),
    (r"blocks\.mlp\.c_proj", ("mlp", "embed")),
    (r"attn\.(q|k|v)_proj", ("embed", "heads")),
    (r"attn\.out_proj", ("heads", "embed")),
    (r"kv_proj", ("kv", "embed")),
)

# (state-name regex, logical axes) of the leaves that are not a
# projection's or a norm's
LEAF_AXES: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = (
    (r"embed_tokens\.embedding(_q)?", ("vocab", "embed")),
    (r"embed_tokens\.embedding_scale", ("vocab",)),
    (r"query", ("queries", "embed")),
    (r"patch_pos_embed", (None, "embed")),
    (r"positional_embedding", (None, "embed")),
    (r"proj", ("embed", None)),
    (r"conv1\.kernel", (None, None, None, "conv_io")),
    (r"soft_prompt\.embedding", (None, "embed")),
)


def logical_axes(module: nn.Module) -> Dict[str, Tuple[Optional[str], ...]]:
    """{state name: logical axes} of every weight of ``module`` (an LLM,
    agent, ViT or resampler, or a module holding them)."""
    from seedx_tpu_torch.models.layers import (PDense, PLayerNorm,
                                               RMSNorm)

    out = {}
    for name, t in module.state_dict(keep_vars=True).items():
        owner_name, _, leaf = name.rpartition(".")
        owner = module.get_submodule(owner_name)
        if isinstance(owner, (RMSNorm, PLayerNorm)):
            out[name] = ("layers",) * (t.dim() - 1) + (None,)
            continue
        if isinstance(owner, PDense):
            axes = next((ax for pat, ax in DENSE_AXES
                         if re.fullmatch(rf"(.*\.)?{pat}", owner_name)), None)
            if axes is None:
                raise KeyError(f"{name}: no kernel_axes entry")
            a_in, a_out = axes
            leaf_axes = {"kernel": (a_in, a_out), "kernel_q": (a_in, a_out),
                         "kernel_q4": (a_in, a_out), "bias": (a_out,),
                         "lora_a": (a_in, None), "lora_b": (None, a_out),
                         "ia3_scale": ((a_in,) if getattr(owner, "ia3", None)
                                       == "in" else (a_out,)),
                         "kernel_scale": ((None, a_out)
                                          if owner.quantize == "int4"
                                          else (a_out,))}[leaf]
            out[name] = ("layers",) * (t.dim() - len(leaf_axes)) + leaf_axes
            continue
        axes = next((ax for pat, ax in LEAF_AXES
                     if re.fullmatch(rf"(.*\.)?{pat}", name)), None)
        if axes is None:
            raise KeyError(f"{name}: no logical axes entry")
        out[name] = axes
    return out


# ---- placement ----------------------------------------------------------


def sharding_of(module: nn.Module, mesh,
                rules: Sequence[Tuple[str, Any]] = DEFAULT_RULES
                ) -> Dict[str, Sharding]:
    """{state name: Sharding} of every weight of ``module``."""
    return {name: Sharding(mesh, logical_to_mesh_axes(axes, rules))
            for name, axes in logical_axes(module).items()}


def _split(t: torch.Tensor, dim: int, parts: Tuple[str, ...], mesh,
           fused: int = 1) -> torch.Tensor:
    """This rank's part of ``t`` along ``dim`` split over the mesh axes
    ``parts`` (row-major over them, as a JAX mesh lays devices out);
    ``fused`` > 1: the dim is that many equal parts, each split alike."""
    names = mesh.mesh_dim_names
    n, idx = 1, 0
    for axis in parts:
        size = mesh.size(names.index(axis))
        n, idx = n * size, idx * size + mesh.get_local_rank(axis)
    size = t.shape[dim]
    if size % (n * fused):
        raise ValueError(
            f"a sharding over {parts} implies that the global size of "
            f"dimension {dim} should be divisible by {n * fused}, but it is "
            f"equal to {size} (shape {tuple(t.shape)})")
    part = size // fused // n
    return t.unflatten(dim, (fused, n, part)).select(dim + 1, idx).flatten(
        dim, dim + 1)


def tensor_plan(module: nn.Module, tensor: int) -> Dict[str, str]:
    """{module name: role} of every module that computes on its own part of
    a ``tensor`` split: ``col`` (column-parallel projection: local output
    columns), ``row`` (row-parallel: local input rows, partial sums
    all-reduced), ``vocab`` (the vocab-parallel embedding).  Each model
    module's ``tp_plan(tensor)`` names its children's roles; a module with
    no role gathers its splits at use and computes the whole."""
    roles = {}
    for name, sub in module.named_modules():
        plan = getattr(sub, "tp_plan", None)
        if plan is not None:
            for child, role in plan(tensor).items():
                if role is not None:
                    roles[f"{name}.{child}" if name else child] = role
    return roles


def _local_shards(module: nn.Module, mesh, rules):
    """{state name: (local shard, gathers, role, splits)}: gathers lists
    the (dim from the end, mesh axis) splits the owner gathers at use,
    splits the (dim, mesh axes, fused parts) of every split over more
    than one rank."""
    names = mesh.mesh_dim_names
    roles = tensor_plan(module, mesh.size(names.index("tensor")))
    axes = logical_axes(module)
    out = {}
    for name, t in module.state_dict(keep_vars=True).items():
        owner_name, _, leaf = name.rpartition(".")
        owner = module.get_submodule(owner_name)
        role = roles.get(owner_name)
        spec = logical_to_mesh_axes(axes[name], rules)
        local, gathers, splits = t.detach(), [], []
        for d, s in enumerate(spec):
            parts = () if s is None else s if isinstance(s, tuple) else (s,)
            if math.prod(mesh.size(names.index(a)) for a in parts) == 1:
                continue          # over one rank: whole, nothing to gather
            fused = (getattr(owner, "fused_parts", 1)
                     if role == "col" and parts == ("tensor",)
                     and d == t.dim() - 1 else 1)
            splits.append((d, parts, fused))
            local = _split(local, d, parts, mesh, fused)
            if not (role is not None and parts == ("tensor",)):
                if len(parts) != 1:
                    raise ValueError(f"{name}: a weight split over {parts}")
                gathers.append((d - t.dim(), parts[0]))
        out[name] = (local, gathers, role, splits)
    return out


def shard_pytree(module: nn.Module, mesh,
                 rules: Sequence[Tuple[str, Any]] = DEFAULT_RULES
                 ) -> Dict[str, torch.Tensor]:
    """{state name: this rank's shard} of ``module``'s weights, as
    ``place_params`` would keep them (the module is not changed)."""
    return {k: v[0].clone() for k, v in
            _local_shards(module, mesh, rules).items()}


def place_params(module: nn.Module, mesh,
                 rules: Sequence[Tuple[str, Any]] = DEFAULT_RULES
                 ) -> nn.Module:
    """Keep only this rank's shard of every weight of ``module`` (in
    place), and set each owning module up to compute on it: ``_par`` (the
    mesh's groups), ``_gathers`` ({leaf: [(dim, axis)]}, the splits
    gathered at use), ``_splits`` ({leaf: [(dim, mesh axes, fused
    parts)]}, every split: see ``split_axes``, ``gather_full`` and
    ``local_part``) and ``tp`` (its role, see ``tensor_plan``)."""
    from seedx_tpu_torch.parallel.distributed import MeshGroups

    for m in module.modules():
        refuse = getattr(getattr(m, "cfg", None), "refuse", None)
        if refuse is not None:
            refuse("mesh")
    groups = MeshGroups(mesh)
    shards = _local_shards(module, mesh, rules)
    for name, (local, gathers, role, splits) in shards.items():
        owner_name, _, leaf = name.rpartition(".")
        owner = module.get_submodule(owner_name)
        if splits:
            local = local.clone()      # the shard alone, not a view
        if leaf in owner._parameters:
            owner._parameters[leaf] = nn.Parameter(
                local, requires_grad=owner._parameters[leaf].requires_grad)
        else:
            owner._buffers[leaf] = local
        owner._par = groups
        owner.tp = role
        if "_gathers" not in owner.__dict__:
            owner._gathers, owner._splits = {}, {}
        owner._gathers[leaf] = gathers
        owner._splits[leaf] = splits
    for sub in module.modules():
        if getattr(sub, "tp_plan", None) is not None:
            sub._par = groups
    return module


def leaf_layout(module: nn.Module, name: str) -> list:
    """[(dim, mesh axes, fused parts)] of every split of leaf ``name`` of a
    placed ``module`` (empty when whole)."""
    owner_name, _, leaf = name.rpartition(".")
    owner = module.get_submodule(owner_name)
    return owner.__dict__.get("_splits", {}).get(leaf, [])


def split_axes(layout) -> Tuple[str, ...]:
    """The mesh axes of a ``leaf_layout``."""
    return tuple(a for _, parts, _ in layout for a in parts)


def gather_full(t: torch.Tensor, layout, groups) -> torch.Tensor:
    """The whole leaf from every rank's shard ``t`` (a collective: every
    rank of the mesh calls it); the inverse of ``local_part``."""
    for d, parts, fused in layout:
        if len(parts) != 1:
            raise ValueError(f"a weight split over {parts}")
        n, k = groups.size[parts[0]], t.shape[d]
        t = groups.all_gather(t, d, parts[0])
        if fused > 1:
            # rank r held [fused, part] of the dim: back to [fused, n, part]
            t = t.unflatten(d, (n, fused, k // fused)).transpose(
                d, d + 1).flatten(d, d + 2)
    return t


def local_part(t: torch.Tensor, layout, mesh) -> torch.Tensor:
    """This rank's shard of the whole leaf ``t``, as ``place_params`` keeps
    it."""
    for d, parts, fused in layout:
        t = _split(t, d, parts, mesh, fused)
    return t


def unbox(tree: Any) -> Any:
    """The JAX package strips its sharding boxes here; the port's leaves are
    plain tensors.  A ``DTensor`` (``put_global``) becomes its full value;
    mappings are walked."""
    if isinstance(tree, dict):
        return {k: unbox(v) for k, v in tree.items()}
    full = getattr(tree, "full_tensor", None)
    return full() if full is not None else tree
