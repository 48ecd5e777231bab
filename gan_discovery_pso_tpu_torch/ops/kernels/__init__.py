"""Hand-written CUDA kernels of the port (sources in `csrc/`), each beside
its plain PyTorch version. Importing needs neither nvcc nor a card: the
library is built and loaded at the first launch (`_build.library`).
Importing registers B2 as the operator `gdpt::rescale01_rows`, which
exported programs call."""

from gan_discovery_pso_tpu_torch.ops.kernels.rescale import (
    rescale01_per_sample,
    rescale01_per_sample_op,
    rescale01_rows,
    rescale01_rows_op,
    rescale01_rows_plain,
)
from gan_discovery_pso_tpu_torch.ops.kernels.swarm_update import (
    PbestLocal,
    SwarmMove,
    SwarmUpdate,
    swarm_move,
    swarm_move_plain,
    swarm_pbest_local,
    swarm_pbest_local_plain,
    swarm_update,
    swarm_update_plain,
)

# the main path's kernels (the batched runner); the split pair runs where a
# swarm is sharded over ranks (parallel/)
KERNELS = (rescale01_rows, swarm_update)
SPLIT_KERNELS = (swarm_pbest_local, swarm_move)

__all__ = [
    "KERNELS",
    "PbestLocal",
    "SPLIT_KERNELS",
    "SwarmMove",
    "SwarmUpdate",
    "rescale01_per_sample",
    "rescale01_per_sample_op",
    "rescale01_rows",
    "rescale01_rows_op",
    "rescale01_rows_plain",
    "swarm_move",
    "swarm_move_plain",
    "swarm_pbest_local",
    "swarm_pbest_local_plain",
    "swarm_update",
    "swarm_update_plain",
]
