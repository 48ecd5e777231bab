from gan_discovery_pso_tpu_torch.compat.weights import (
    encoder_state_dict,
    encoder_tree,
    generator_state_dict,
    generator_tree,
    load_reference_checkpoint,
    resnet_state_dict,
    resnet_tree,
    to_tensors,
)

__all__ = [
    "encoder_state_dict",
    "encoder_tree",
    "generator_state_dict",
    "generator_tree",
    "load_reference_checkpoint",
    "resnet_state_dict",
    "resnet_tree",
    "to_tensors",
]
