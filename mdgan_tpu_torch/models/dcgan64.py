"""DCGAN pair for 64x64 images (CelebA), NCHW.

Port of ``mdgan_tpu/models/dcgan64.py:1-71``, keeping the reference's
quirks (``src/datasets/CelebA.py:75-142``):

Discriminator:
    Conv(3    ->  ndf, k4 s2 p1, no bias)      + LeakyReLU(0.01)  # 64 -> 32
    Conv(ndf  -> 2ndf, k4 s2 p1, bias)  + BN   + LeakyReLU(0.2)   # 32 -> 16
    Conv(2ndf -> 4ndf, k4 s2 p1, bias)  + BN   + LeakyReLU(0.2)   # 16 -> 8
    Conv(4ndf -> 8ndf, k4 s2 p1, no bias) + BN + LeakyReLU(0.2)   # 8 -> 4
    Conv(8ndf ->    1, k4 s1 p0, no bias)      -> logit           # 4 -> 1
Generator (5 stages):
    ConvT(z    -> 8ngf, k4 s1 p0) + BN + ReLU                     # 1 -> 4
    ConvT(8ngf -> 4ngf), ConvT(4ngf -> 2ngf), ConvT(2ngf -> ngf),
        each k4 s2 p1 + BN + ReLU                                 # 4 -> 32
    ConvT(ngf  ->    3, k4 s2 p1) + tanh                          # 32 -> 64

The first D block's slope is torch's default 0.01 (the reference calls
``F.leaky_relu(x)`` there); its blocks 1 and 2 have biased convs.  Weights
init with :func:`layers.dcgan_init_`, which gives those biases torch's
default U(+-1/sqrt(fan_in)).
"""

from __future__ import annotations

import torch
from torch import nn

from mdgan_tpu_torch.models.layers import ConvBlock, ConvTransposeBlock

SHAPE = (64, 64, 3)
Z_DIM = 100
NDF = 64
NGF = 64


class DCGANDiscriminator64(nn.Module):
    def __init__(self, ndf: int = NDF, channels: int = 3):
        super().__init__()
        self.block0 = ConvBlock(channels, ndf, use_bn=False, slope=0.01)
        self.block1 = ConvBlock(ndf, ndf * 2, use_bias=True)
        self.block2 = ConvBlock(ndf * 2, ndf * 4, use_bias=True)
        self.block3 = ConvBlock(ndf * 4, ndf * 8)
        self.out = nn.Conv2d(ndf * 8, 1, 4, 1, 0, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        x = self.block3(self.block2(self.block1(self.block0(x))))
        return self.out(x).reshape(b).float()


class DCGANGenerator64(nn.Module):
    def __init__(self, ngf: int = NGF, channels: int = 3, z_dim: int = Z_DIM):
        super().__init__()
        self.block0 = ConvTransposeBlock(z_dim, ngf * 8, stride=1, padding=0)
        self.block1 = ConvTransposeBlock(ngf * 8, ngf * 4)
        self.block2 = ConvTransposeBlock(ngf * 4, ngf * 2)
        self.block3 = ConvTransposeBlock(ngf * 2, ngf)
        self.out = nn.ConvTranspose2d(ngf, channels, 4, 2, 1, bias=False)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = z.reshape(z.shape[0], -1, 1, 1)
        x = self.block3(self.block2(self.block1(self.block0(x))))
        return torch.tanh(self.out(x).float())
