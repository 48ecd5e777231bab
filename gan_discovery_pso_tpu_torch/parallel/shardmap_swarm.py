"""The hand-collectived sharded swarm (counterpart of
`gan_discovery_pso_tpu/parallel/shardmap_swarm.py`).

The JAX package has two sharded swarms: `make_sharded_optimize`, where
GSPMD places the global-best reduction, and this one, where `shard_map`
spells it out (two `pmin` and one `psum` an iteration). With
`torch.distributed` every collective is spelled out, so the two are one
loop (`swarm_sharding.py`: one all-reduce MIN of an order key and one
all-reduce SUM of the winner's row). This module keeps the JAX name and its
return: a dict of the final arrays and the g-best trace, with the early
stop latched on the same iteration on every rank.
"""

from __future__ import annotations

from typing import Callable

import torch

from gan_discovery_pso_tpu_torch.core.config import PsoConfig
from gan_discovery_pso_tpu_torch.parallel.mesh import Mesh
from gan_discovery_pso_tpu_torch.parallel.swarm_sharding import make_sharded_optimize


def make_shardmap_optimize(mesh: Mesh, fitness_fn: Callable[[torch.Tensor], torch.Tensor],
                           hp: PsoConfig, axis: str = "swarm"):
    """run(init_state, r1, r2) → {positions, velocities, p_best_pos,
    p_best_val, g_best_pos, g_best_val, g_best_trace} (JAX `:146-155`),
    each with a leading swarm axis; g_best_trace is [B, iters]. Raises
    ValueError when the mesh axis does not divide n_particles (JAX
    `:48-49`)."""
    sharded = make_sharded_optimize(mesh, fitness_fn, hp, axis)

    def run(init_state, r1, r2) -> dict:
        final, history, _ = sharded(init_state, r1, r2)
        out = {f: getattr(final, f) for f in ("positions", "velocities", "p_best_pos",
                                                "p_best_val", "g_best_pos", "g_best_val")}
        return {**out, "g_best_trace": history.g_best_val}

    return run
