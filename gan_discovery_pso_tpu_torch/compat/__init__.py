from gan_discovery_pso_tpu_torch.compat.weights import (
    discriminator_state_dict,
    discriminator_tree,
    encoder_attgan_state_dict,
    encoder_attgan_tree,
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
    "discriminator_state_dict",
    "discriminator_tree",
    "encoder_attgan_state_dict",
    "encoder_attgan_tree",
    "encoder_state_dict",
    "encoder_tree",
    "generator_state_dict",
    "generator_tree",
    "load_reference_checkpoint",
    "resnet_state_dict",
    "resnet_tree",
    "to_tensors",
]
