from gan_discovery_pso_tpu_torch.models.dcgan import Generator, GeneratorDef
from gan_discovery_pso_tpu_torch.models.layers import (
    dcgan_init_,
    glorot_normal_init_,
    linear,
)
from gan_discovery_pso_tpu_torch.models.resnet import Bottleneck, ResNet, ResNetDef

__all__ = [
    "Bottleneck",
    "Generator",
    "GeneratorDef",
    "ResNet",
    "ResNetDef",
    "dcgan_init_",
    "glorot_normal_init_",
    "linear",
]
