"""Layers and initializers with the JAX package's conventions.

Port of ``mdgan_tpu/models/layers.py:22-149`` in NCHW with OIHW weights:

* DCGAN init: conv and conv-transpose weights ~ N(0, 0.02), BatchNorm scale
  ~ N(1, 0.02), bias 0 (``layers.py:33-40``), drawn from an explicit
  ``torch.Generator``.  A biased conv (the CelebA quirk) keeps torch's
  default bias init U(+-1/sqrt(in*k*k)) (``layers.py:88-101``).
* torch's default Linear init, U(+-1/sqrt(fan_in)) for weight and bias
  (``layers.py:43-63``), which the reference's MLP keeps.
* :class:`BatchNorm2d` follows flax's ``nn.BatchNorm`` rather than torch's:
  eps 1e-5, running averages with torch momentum 0.1 (flax's 0.9), the
  variance as ``max(E[x^2] - E[x]^2, 0)`` (flax's fast variance), and a
  ``running_var`` that holds the BIASED batch variance — a stock
  ``nn.BatchNorm2d`` stores the unbiased one (``torch_interop.py:29-33``).
  Statistics are computed in float32 whatever the input dtype, as flax does.
  With a replica axis (``replica``, set by the MD-GAN engine when the batch
  is split over ranks, ``core/mesh.py``) the statistics are those of the
  whole batch: one all-reduce of (sum x, sum x^2, count) per channel, the
  gradient summed back through it, each rank weighted by its real rows.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mdgan_tpu_torch.core.distributed import all_reduce_sum

DCGAN_W_STD = 0.02
# flax momentum 0.9 == torch momentum 0.1 (layers.py:26-30)
BN_MOMENTUM = 0.1
BN_EPS = 1e-5


class BatchNorm2d(nn.Module):
    """Normalizes with the batch's statistics and keeps flax-convention
    running averages.  Every forward of the reference runs in train mode
    (its generator samples and scores in ``.train()`` too), so there is no
    eval-mode path."""

    def __init__(self, num_features: int, momentum: float = BN_MOMENTUM,
                 eps: float = BN_EPS):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.replica = None  # the mesh's replica axis, when the batch is split

    def _moments(self, xf: torch.Tensor):
        """The batch's mean and flax's fast variance, over every replica's
        rows."""
        if self.replica is None or not self.replica.active:
            mean = xf.mean(dim=(0, 2, 3))
            return mean, torch.clamp((xf * xf).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
        c = xf.shape[1]
        count = xf.new_full((1,), xf.numel() // c)
        sums = all_reduce_sum(torch.cat([xf.sum(dim=(0, 2, 3)),
                                         (xf * xf).sum(dim=(0, 2, 3)), count]), self.replica)
        mean, mean_sq = sums[:c] / sums[-1], sums[c:2 * c] / sums[-1]
        return mean, torch.clamp(mean_sq - mean * mean, min=0.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean, var = self._moments(xf)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(m * mean)
            self.running_var.mul_(1.0 - m).add_(m * var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[None, :, None, None]) * mul[None, :, None, None] \
            + self.bias[None, :, None, None]
        return y.to(x.dtype)


class ConvBlock(nn.Module):
    """Conv (k4 s2 p1, no bias unless ``use_bias``) + optional BatchNorm +
    LeakyReLU(``slope``): one DCGAN discriminator stage
    (``layers.py:68-110``)."""

    def __init__(self, in_ch: int, out_ch: int, use_bn: bool = True,
                 slope: float = 0.2, use_bias: bool = False):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, 4, 2, 1, bias=use_bias)
        self.bn = BatchNorm2d(out_ch) if use_bn else None
        self.slope = slope

    def forward(self, x):
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        return F.leaky_relu(x, self.slope)


class ConvTransposeBlock(nn.Module):
    """ConvTranspose (k4, no bias) + BatchNorm + ReLU: one DCGAN generator
    stage (``layers.py:113-149``).  stride 1 / padding 0 maps 1x1 -> 4x4
    (flax 'VALID'); stride 2 / padding 1 doubles the size (flax 'SAME')."""

    def __init__(self, in_ch: int, out_ch: int, stride: int = 2, padding: int = 1):
        super().__init__()
        self.conv = nn.ConvTranspose2d(in_ch, out_ch, 4, stride, padding, bias=False)
        self.bn = BatchNorm2d(out_ch)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _uniform_(t: torch.Tensor, bound: float, gen: torch.Generator) -> None:
    t.copy_((torch.rand(t.shape, generator=gen) * 2.0 - 1.0) * bound)


@torch.no_grad()
def dcgan_init_(module: nn.Module, gen: torch.Generator) -> nn.Module:
    """DCGAN init in place, from ``gen``, in ``named_modules`` order."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            m.weight.copy_(torch.randn(m.weight.shape, generator=gen) * DCGAN_W_STD)
            if m.bias is not None:
                fan_in = m.weight.shape[1] * m.weight.shape[2] * m.weight.shape[3]
                _uniform_(m.bias, fan_in ** -0.5, gen)
        elif isinstance(m, BatchNorm2d):
            m.weight.copy_(1.0 + torch.randn(m.weight.shape, generator=gen) * DCGAN_W_STD)
            m.bias.zero_()
    return module


@torch.no_grad()
def torch_linear_init_(module: nn.Module, gen: torch.Generator) -> nn.Module:
    """torch's default Linear init in place, from ``gen``: weight and bias
    ~ U(-1/sqrt(fan_in), 1/sqrt(fan_in)) (``layers.py:43-63``)."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            bound = m.in_features ** -0.5
            _uniform_(m.weight, bound, gen)
            if m.bias is not None:
                _uniform_(m.bias, bound, gen)
    return module
