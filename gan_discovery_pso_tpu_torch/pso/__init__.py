from gan_discovery_pso_tpu_torch.pso.fitness import (
    OPTIMIZE_IN,
    OPTIMIZE_OUT,
    apply_discovery_fitness,
    assessor_posterior,
    fitness_from_posterior,
)
from gan_discovery_pso_tpu_torch.pso.runner import (
    make_batched_discovery_runner,
    make_discovery_runner,
)
from gan_discovery_pso_tpu_torch.pso.swarm import (
    PsoHistory,
    SwarmResult,
    SwarmState,
    draw_uniforms,
    last_iteration,
    mean_pairwise_distance,
    optimize,
    pso_iteration,
    state_from_positions,
    swarm_init,
)

__all__ = [
    "OPTIMIZE_IN",
    "OPTIMIZE_OUT",
    "PsoHistory",
    "SwarmResult",
    "SwarmState",
    "apply_discovery_fitness",
    "assessor_posterior",
    "draw_uniforms",
    "fitness_from_posterior",
    "last_iteration",
    "make_batched_discovery_runner",
    "make_discovery_runner",
    "mean_pairwise_distance",
    "optimize",
    "pso_iteration",
    "state_from_positions",
    "swarm_init",
]
