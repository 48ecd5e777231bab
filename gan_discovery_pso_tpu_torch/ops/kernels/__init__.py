"""Hand-written CUDA kernels of the port (sources in `csrc/`), each beside
its plain PyTorch version. Importing needs neither nvcc nor a card: the
library is built and loaded at the first launch (`_build.library`)."""

from gan_discovery_pso_tpu_torch.ops.kernels.rescale import (
    rescale01_per_sample,
    rescale01_rows,
    rescale01_rows_plain,
)
from gan_discovery_pso_tpu_torch.ops.kernels.swarm_update import (
    SwarmUpdate,
    swarm_update,
    swarm_update_plain,
)

KERNELS = (rescale01_rows, swarm_update)

__all__ = [
    "KERNELS",
    "SwarmUpdate",
    "rescale01_per_sample",
    "rescale01_rows",
    "rescale01_rows_plain",
    "swarm_update",
    "swarm_update_plain",
]
