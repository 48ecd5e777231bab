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
from gan_discovery_pso_tpu_torch.models.cae import (
    CAEDecoder,
    CAEDef,
    CAEEncoder,
    add_noise,
)
from gan_discovery_pso_tpu_torch.models.layers import (
    CNN_INITIALIZERS,
    cnn_init_,
    dcgan_init_,
    glorot_normal_init_,
    linear,
    torch_default_init_,
    torch_default_linear_,
)
from gan_discovery_pso_tpu_torch.models.resnet import (
    AlexNet,
    AlexNetDef,
    Bottleneck,
    ResNet,
    ResNetDef,
    change_classifier_head,
)

__all__ = [
    "AlexNet",
    "AlexNetDef",
    "Bottleneck",
    "CAEDecoder",
    "CAEDef",
    "CAEEncoder",
    "CNN_INITIALIZERS",
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
    "add_noise",
    "change_classifier_head",
    "cnn_init_",
    "dcgan_init_",
    "glorot_normal_init_",
    "torch_default_init_",
    "torch_default_linear_",
    "linear",
]
