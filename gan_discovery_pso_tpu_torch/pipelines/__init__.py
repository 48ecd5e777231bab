from gan_discovery_pso_tpu_torch.pipelines.context import StageContext
from gan_discovery_pso_tpu_torch.pipelines.pso_discovery import (
    emit_swarm_reports,
    render_swarm_grids,
    run_pso_discovery,
    run_pso_discovery_batched,
)
from gan_discovery_pso_tpu_torch.pipelines.stages import (
    assessor_factory,
    load_cnn,
    load_encoder,
    load_gan,
    run_extractor,
    run_inverter,
    run_pso_inverter,
    run_regularize_inverter,
    run_regularize_inverter_statistics,
)

__all__ = [
    "StageContext",
    "assessor_factory",
    "emit_swarm_reports",
    "load_cnn",
    "load_encoder",
    "load_gan",
    "render_swarm_grids",
    "run_extractor",
    "run_inverter",
    "run_pso_discovery",
    "run_pso_discovery_batched",
    "run_pso_inverter",
    "run_regularize_inverter",
    "run_regularize_inverter_statistics",
]
