"""Plain PyTorch models of the benchmark's configurations, in float32.

Written from the published descriptions and the reference repository's
layer lists, with `torch.nn` modules only and no code of the measured
package. Parameter names are the reference repository's state-dict names,
so one state dict made by the benchmark loads into these modules and into
the measured program's alike.

- `Generator`: DCGAN-G (arXiv:1511.06434) as the reference builds it for
  28x28 images: ConvT(z, 2f, k7, s1, p0) + BN + ReLU, ConvT(2f, f, k4, s2,
  p1) + BN + ReLU, ConvT(f, C, k4, s2, p1) + Tanh; names `gen.0.0`,
  `gen.0.1`, `gen.1.0`, `gen.1.1`, `gen.2`.
- `ResNet`: bottleneck ResNet (arXiv:1512.03385) with the reference
  repository's departures: bias-free convs, a global MAX pool where the
  paper pools by the mean, a Linear(2048, n_class) head; names `conv1`,
  `bn1`, `layerX.Y.convZ`/`bnZ`, `layerX.Y.identity_downsample.{0,1}`, `fc`.
- `Encoder`: the inverter's encoder, the discriminator's conv stack ending
  in z channels: Conv(C, f, k4, s2, p1) + LeakyReLU(0.2), Conv(f, 2f, k4,
  s2, p1) + LeakyReLU(0.2), Conv(2f, z, k7, s2, p0); names `enc.0`,
  `enc.2.0`, `enc.3`.

Every module is used in eval mode: BatchNorm normalises by its running
statistics.
"""

from __future__ import annotations

import torch
from torch import nn

RESNET_LAYERS = {"ResNet50": (3, 4, 6, 3), "ResNet101": (3, 4, 23, 3),
                 "ResNet152": (3, 8, 36, 3)}
EXPANSION = 4


class Generator(nn.Module):
    def __init__(self, z_dim: int, channels: int, features: int):
        super().__init__()
        f = features

        def block(cin, cout, k, s, p):
            return nn.Sequential(nn.ConvTranspose2d(cin, cout, k, s, p),
                                 nn.BatchNorm2d(cout), nn.ReLU())

        self.gen = nn.Sequential(block(z_dim, 2 * f, 7, 1, 0), block(2 * f, f, 4, 2, 1),
                                 nn.ConvTranspose2d(f, channels, 4, 2, 1), nn.Tanh())

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        """z [M, z_dim] or [M, z_dim, 1, 1] → images [M, C, 28, 28]."""
        return self.gen(z.reshape(z.shape[0], -1, 1, 1))


class Bottleneck(nn.Module):
    def __init__(self, cin: int, width: int, stride: int, downsample: bool):
        super().__init__()
        cout = width * EXPANSION
        self.conv1 = nn.Conv2d(cin, width, 1, 1, 0, bias=False)
        self.bn1 = nn.BatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(width)
        self.conv3 = nn.Conv2d(width, cout, 1, 1, 0, bias=False)
        self.bn3 = nn.BatchNorm2d(cout)
        self.identity_downsample = (
            nn.Sequential(nn.Conv2d(cin, cout, 1, stride, 0, bias=False), nn.BatchNorm2d(cout))
            if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.bn1(self.conv1(x)))
        h = torch.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        if self.identity_downsample is not None:
            x = self.identity_downsample(x)
        return torch.relu(h + x)


class ResNet(nn.Module):
    def __init__(self, model_name: str, channels: int, n_class: int):
        super().__init__()
        self.conv1 = nn.Conv2d(channels, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        cin = 64
        for i, (n_blocks, width, stride) in enumerate(
                zip(RESNET_LAYERS[model_name], (64, 128, 256, 512), (1, 2, 2, 2)), start=1):
            blocks = []
            for j in range(n_blocks):
                s = stride if j == 0 else 1
                blocks.append(Bottleneck(cin, width, s,
                                         j == 0 and (s != 1 or cin != width * EXPANSION)))
                cin = width * EXPANSION
            setattr(self, f"layer{i}", nn.Sequential(*blocks))
        self.pool = nn.AdaptiveMaxPool2d((1, 1))
        self.fc = nn.Linear(512 * EXPANSION, n_class)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [M, C, H, W] → logits [M, n_class]."""
        h = self.maxpool(torch.relu(self.bn1(self.conv1(x))))
        h = self.layer4(self.layer3(self.layer2(self.layer1(h))))
        return self.fc(torch.flatten(self.pool(h), 1))


class Encoder(nn.Module):
    def __init__(self, z_dim: int, channels: int, features: int):
        super().__init__()
        f = features
        self.enc = nn.Sequential(
            nn.Conv2d(channels, f, 4, 2, 1), nn.LeakyReLU(0.2),
            nn.Sequential(nn.Conv2d(f, 2 * f, 4, 2, 1), nn.LeakyReLU(0.2)),
            nn.Conv2d(2 * f, z_dim, 7, 2, 0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [M, C, 28, 28] → z [M, z_dim]."""
        return self.enc(x).reshape(x.shape[0], -1)


def build(cfg: dict, device=None) -> dict:
    """The configuration's reference models by role ("gen", "assessor" and,
    where the configuration has one, "encoder"), in eval mode, on `device`
    (the "meta" device gives shapes without storage)."""
    img = cfg["image"]
    models = {
        "gen": Generator(cfg["gan"]["z_dim"], img["channels"], cfg["gan"]["features_g"]),
        "assessor": ResNet(cfg["assessor"]["model_name"], img["channels"],
                           cfg["assessor"]["n_class"]),
    }
    if "encoder" in cfg:
        models["encoder"] = Encoder(cfg["gan"]["z_dim"], img["channels"],
                                    cfg["encoder"]["features_e"])
    return {k: m.to(device).eval() for k, m in models.items()}
