from gan_discovery_pso_tpu_torch.pso.fitness import (
    OPTIMIZE_IN,
    OPTIMIZE_OUT,
    apply_discovery_fitness,
    assessor_posterior,
    fitness_from_posterior,
    make_discovery_fitness_dynamic,
)
from gan_discovery_pso_tpu_torch.pso.io import (
    load_final_particle_positions,
    load_particle_trajectories,
    save_particle_histories,
)
from gan_discovery_pso_tpu_torch.pso.runner import (
    make_batched_discovery_runner,
    make_discovery_runner,
    resolve_fitness_chunk,
    select_program,
)
from gan_discovery_pso_tpu_torch.pso.swarm import (
    PsoHistory,
    SwarmResult,
    SwarmState,
    draw_uniforms,
    last_iteration,
    mean_pairwise_distance,
    optimize,
    optimize_resumable,
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
    "load_final_particle_positions",
    "load_particle_trajectories",
    "make_batched_discovery_runner",
    "make_discovery_fitness_dynamic",
    "make_discovery_runner",
    "mean_pairwise_distance",
    "optimize",
    "optimize_resumable",
    "pso_iteration",
    "resolve_fitness_chunk",
    "save_particle_histories",
    "select_program",
    "state_from_positions",
    "swarm_init",
]
