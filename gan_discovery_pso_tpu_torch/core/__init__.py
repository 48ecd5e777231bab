from gan_discovery_pso_tpu_torch.core.config import (
    AdamConfig,
    Config,
    PsoConfig,
    cfg_default,
    load_config,
)
from gan_discovery_pso_tpu_torch.core.device import resolve_device

__all__ = ["AdamConfig", "Config", "PsoConfig", "cfg_default", "load_config", "resolve_device"]
