from gan_discovery_pso_tpu_torch.models.dcgan import (
    Discriminator,
    DiscriminatorDef,
    Generator,
    GeneratorDef,
)
from gan_discovery_pso_tpu_torch.models.encoder import (
    Encoder,
    EncoderAttGAN,
    EncoderAttGANDef,
    EncoderDef,
)
from gan_discovery_pso_tpu_torch.models.layers import (
    dcgan_init_,
    glorot_normal_init_,
    linear,
    torch_default_init_,
    torch_default_linear_,
)
from gan_discovery_pso_tpu_torch.models.resnet import (
    Bottleneck,
    ResNet,
    ResNetDef,
    change_classifier_head,
)

__all__ = [
    "Bottleneck",
    "Discriminator",
    "DiscriminatorDef",
    "Encoder",
    "EncoderAttGAN",
    "EncoderAttGANDef",
    "EncoderDef",
    "Generator",
    "GeneratorDef",
    "ResNet",
    "ResNetDef",
    "change_classifier_head",
    "dcgan_init_",
    "glorot_normal_init_",
    "torch_default_init_",
    "torch_default_linear_",
    "linear",
]
