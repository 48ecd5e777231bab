from gan_discovery_pso_tpu_torch.core.config import (
    AdamConfig,
    Config,
    PsoConfig,
    cfg_default,
    load_config,
)
from gan_discovery_pso_tpu_torch.core.device import resolve_device
from gan_discovery_pso_tpu_torch.core.gpulock import gpu_lock
from gan_discovery_pso_tpu_torch.core.profiling import trace

__all__ = ["AdamConfig", "Config", "PsoConfig", "cfg_default", "gpu_lock", "load_config",
           "resolve_device", "trace"]
