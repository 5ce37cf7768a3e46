"""Multi-device placement (reference: seedx_tpu/parallel): the mesh, the
logical-axis rules, the placement of the port's weights and the process
group start-up."""

from seedx_tpu_torch.parallel.mesh import (  # noqa: F401
    DEFAULT_RULES,
    TP_RULES,
    create_mesh,
    local_mesh,
    logical_rules,
    mesh_sharding,
    shard_pytree,
    unbox,
)
