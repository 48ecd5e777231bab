"""Swarms and GAN training over several ranks with `torch.distributed`
(counterpart of `gan_discovery_pso_tpu/parallel/`). See `mesh.py` for the
devices, backends and collectives, `swarm_sharding.py` for the sharded
swarms, and `launch.py` for starting ranks in new processes."""

from gan_discovery_pso_tpu_torch.parallel.mesh import (
    Mesh,
    distributed_initialize_if_needed,
    gather_rows,
    make_mesh,
    make_mesh_2d,
)
from gan_discovery_pso_tpu_torch.parallel.shardmap_swarm import make_shardmap_optimize
from gan_discovery_pso_tpu_torch.parallel.swarm_sharding import (
    history_sharding,
    make_batched_sharded_discovery_runner,
    make_multi_swarm_optimize,
    make_sharded_discovery_runner,
    make_sharded_optimize,
    swarm_state_sharding,
)

__all__ = [
    "Mesh",
    "distributed_initialize_if_needed",
    "gather_rows",
    "history_sharding",
    "make_batched_sharded_discovery_runner",
    "make_mesh",
    "make_mesh_2d",
    "make_multi_swarm_optimize",
    "make_shardmap_optimize",
    "make_sharded_discovery_runner",
    "make_sharded_optimize",
    "swarm_state_sharding",
]
