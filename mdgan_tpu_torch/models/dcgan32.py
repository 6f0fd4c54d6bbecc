"""DCGAN pair for 32x32 images (CIFAR-10), NCHW.

Port of ``mdgan_tpu/models/dcgan32.py``:

Discriminator:
    Conv(3 ->  ndf,   k4 s2 p1)      + LeakyReLU(0.2)   # 32 -> 16
    Conv(ndf -> 2ndf, k4 s2 p1) + BN + LeakyReLU(0.2)   # 16 -> 8
    Conv(2ndf-> 4ndf, k4 s2 p1) + BN + LeakyReLU(0.2)   # 8 -> 4
    Conv(4ndf->    1, k4 s1 p0)      -> logit           # 4 -> 1
Generator:
    ConvT(z   -> 8ngf, k4 s1 p0) + BN + ReLU            # 1 -> 4
    ConvT(8ngf-> 4ngf, k4 s2 p1) + BN + ReLU            # 4 -> 8
    ConvT(4ngf-> 2ngf, k4 s2 p1) + BN + ReLU            # 8 -> 16
    ConvT(2ngf->    3, k4 s2 p1) + tanh                 # 16 -> 32

Both take ``ngf``/``ndf`` so tests can run narrow.  Outputs are float32
(logits, and images in [-1, 1]) whatever the autocast dtype.
"""

from __future__ import annotations

import torch
from torch import nn

from mdgan_tpu_torch.models.layers import ConvBlock, ConvTransposeBlock

SHAPE = (32, 32, 3)  # stored uint8 image shape (H, W, C)
Z_DIM = 100
NDF = 64
NGF = 64


class DCGANDiscriminator32(nn.Module):
    def __init__(self, ndf: int = NDF, channels: int = 3):
        super().__init__()
        self.block0 = ConvBlock(channels, ndf, use_bn=False)
        self.block1 = ConvBlock(ndf, ndf * 2)
        self.block2 = ConvBlock(ndf * 2, ndf * 4)
        self.out = nn.Conv2d(ndf * 4, 1, 4, 1, 0, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        x = self.block2(self.block1(self.block0(x)))
        return self.out(x).reshape(b).float()


class DCGANGenerator32(nn.Module):
    def __init__(self, ngf: int = NGF, channels: int = 3, z_dim: int = Z_DIM):
        super().__init__()
        self.block0 = ConvTransposeBlock(z_dim, ngf * 8, stride=1, padding=0)
        self.block1 = ConvTransposeBlock(ngf * 8, ngf * 4)
        self.block2 = ConvTransposeBlock(ngf * 4, ngf * 2)
        self.out = nn.ConvTranspose2d(ngf * 2, channels, 4, 2, 1, bias=False)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = z.reshape(z.shape[0], -1, 1, 1)
        x = self.block2(self.block1(self.block0(x)))
        return torch.tanh(self.out(x).float())
