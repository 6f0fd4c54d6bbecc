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
  Its arithmetic is :func:`batch_norm`, which the stacked discriminators
  call too.

**Stacked discriminators.**  n copies of a DCGAN discriminator (ConvBlock
stages, then one Conv2d; :func:`stackable`) run as one network on
channel-stacked batches: (n, b, C, H, W) becomes (b, n*C, H, W)
(:func:`stack_batches`), every conv a grouped conv with weight
(n*Cout, Cin, k, k), run as one batched GEMM over im2col columns, and
BatchNorm unchanged over n*C channels,
whose per-channel statistics over (b, H, W) are each copy's own (and one
all-reduce covers all n copies on a replica axis).  The copies' leaves come
in as (n, *shape) tensors made dense by :func:`stacked_weights`, and their
running statistics as (n, *shape) views updated in place
(:func:`stacked_forward`).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from mdgan_tpu_torch.core.distributed import all_reduce_sum

DCGAN_W_STD = 0.02
# flax momentum 0.9 == torch momentum 0.1 (layers.py:26-30)
BN_MOMENTUM = 0.1
BN_EPS = 1e-5


def moments(xf: torch.Tensor, replica=None):
    """The batch's per-channel mean and flax's fast variance of float32
    ``xf`` (b, C, H, W), over every replica's rows when ``replica`` is an
    active axis."""
    if replica is None or not replica.active:
        mean = xf.mean(dim=(0, 2, 3))
        return mean, torch.clamp((xf * xf).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
    c = xf.shape[1]
    count = xf.new_full((1,), xf.numel() // c)
    sums = all_reduce_sum(torch.cat([xf.sum(dim=(0, 2, 3)),
                                     (xf * xf).sum(dim=(0, 2, 3)), count]), replica)
    mean, mean_sq = sums[:c] / sums[-1], sums[c:2 * c] / sums[-1]
    return mean, torch.clamp(mean_sq - mean * mean, min=0.0)


def batch_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               running_mean: torch.Tensor, running_var: torch.Tensor, momentum: float,
               eps: float, replica=None) -> torch.Tensor:
    """Train-mode BatchNorm of (b, C, H, W) ``x`` with flax's conventions:
    float32 statistics (:func:`moments`), the running averages updated in
    place (each of C elements, in any shape: (n, C/n) views for n stacked
    copies), the result in ``x``'s dtype."""
    xf = x.float()
    mean, var = moments(xf, replica)
    with torch.no_grad():
        running_mean.mul_(1.0 - momentum).add_((momentum * mean).view_as(running_mean))
        running_var.mul_(1.0 - momentum).add_((momentum * var).view_as(running_var))
    mul = torch.rsqrt(var + eps) * weight
    y = (xf - mean[None, :, None, None]) * mul[None, :, None, None] \
        + bias[None, :, None, None]
    return y.to(x.dtype)


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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return batch_norm(x, self.weight, self.bias, self.running_mean, self.running_var,
                          self.momentum, self.eps, self.replica)


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


def stackable(d: nn.Module) -> bool:
    """Whether copies of discriminator ``d`` run as one grouped network:
    its children are :class:`ConvBlock` stages and then one ``nn.Conv2d``,
    every conv plain (no groups, no dilation, zero padding), and it has no
    dropout (DCGAN-32 and DCGAN-64)."""
    kids = list(d.children())
    convs = [b.conv for b in kids[:-1] if type(b) is ConvBlock] + kids[-1:]
    return (not getattr(d, "uses_dropout", False) and len(kids) > 1
            and len(convs) == len(kids) and all(
                type(c) is nn.Conv2d and c.groups == 1 and c.dilation == (1, 1)
                and c.padding_mode == "zeros" for c in convs))


def _compute_dtype(device: torch.device, own: torch.dtype) -> torch.dtype:
    """Autocast's dtype on ``device`` where it is on, else ``own``."""
    if torch.is_autocast_enabled(device.type):
        return torch.get_autocast_dtype(device.type)
    return own


def stack_batches(x: torch.Tensor) -> torch.Tensor:
    """(n, b, C, H, W) batches, copy i's at i, as the stacked network's
    (b, n*C, H, W) input in the conv's compute dtype: one copy, in the
    autograd graph of ``x``."""
    n, b = x.shape[:2]
    dtype = _compute_dtype(x.device, x.dtype)
    return x.transpose(0, 1).to(dtype, memory_format=torch.contiguous_format).reshape(
        b, n * x.shape[2], *x.shape[3:])


def stacked_weights(d: nn.Module, leaves: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The parameters of n copies of stackable ``d``, (n, *shape) each by
    their names in ``d``, as the grouped network's dense tensors, every one
    of them: conv weights (n*Cout, Cin, k, k) and biases in the conv's
    compute dtype, BatchNorm's scale and offset (n*C,) in float32; one copy
    a leaf (a view where one is dense already)."""
    out = {}
    for name, m in d.named_modules():
        if isinstance(m, nn.Conv2d):
            for key in ("weight", "bias"):
                t = leaves.get(f"{name}.{key}")
                if t is not None:
                    dtype = _compute_dtype(t.device, t.dtype)
                    out[f"{name}.{key}"] = t.to(dtype, memory_format=torch.contiguous_format
                                                ).reshape(-1, *t.shape[2:])
        elif isinstance(m, BatchNorm2d):
            for key in ("weight", "bias"):
                out[f"{name}.{key}"] = leaves[f"{name}.{key}"].reshape(-1)
    return out


def _grouped_conv(conv: nn.Conv2d, name: str, x: torch.Tensor, w: Dict[str, torch.Tensor],
                  n: int) -> torch.Tensor:
    """``conv``'s n copies on stacked ``x`` (b, n*Cin, H, W), as one batched
    GEMM: copy i's weight (Cout, Cin*kh*kw) times the im2col columns of its
    channels (Cin*kh*kw, b*Ho*Wo).  cuDNN runs a grouped conv of these
    shapes as a loop over its groups, with layout transposes for each; the
    columns are one copy of a strided view of the padded input."""
    weight, bias = w[f"{name}.weight"], w.get(f"{name}.bias")
    (kh, kw), (sh, sw), (ph, pw) = conv.kernel_size, conv.stride, conv.padding
    b = x.shape[0]
    if ph or pw:
        x = F.pad(x, (pw, pw, ph, ph))
    cols = x.unfold(2, kh, sh).unfold(3, kw, sw)        # (b, n*Cin, Ho, Wo, kh, kw)
    c, ho, wo = cols.shape[1:4]
    cols = cols.reshape(b, n, c // n, ho, wo, kh, kw).permute(1, 2, 5, 6, 0, 3, 4)
    cols = cols.reshape(n, c // n * kh * kw, b * ho * wo)
    y = torch.bmm(weight.reshape(n, -1, cols.shape[1]), cols)  # (n, Cout, b*Ho*Wo)
    y = y.reshape(n, -1, b, ho, wo).permute(2, 0, 1, 3, 4).reshape(b, -1, ho, wo)
    return y if bias is None else y + bias[:, None, None]


def stacked_forward(d: nn.Module, x: torch.Tensor, w: Dict[str, torch.Tensor],
                    stats: Dict[str, torch.Tensor]) -> torch.Tensor:
    """n copies of stackable ``d`` in train mode on their own batches, as
    one network: ``x`` (b, n*C, H, W) from :func:`stack_batches`, ``w``
    from :func:`stacked_weights`, ``stats`` the copies' running statistics
    as (n, *shape) views by their names in ``d``, updated in place.
    ``d`` (any one copy) gives the structure.  Returns (b, n) float32
    logits, copy i's in column i."""
    first, *_, out = d.children()
    n = x.shape[1] // first.conv.in_channels
    for name, m in d.named_children():
        if m is out:
            x = _grouped_conv(m, name, x, w, n)
            break
        x = _grouped_conv(m.conv, f"{name}.conv", x, w, n)
        if m.bn is not None:
            bn = f"{name}.bn."
            x = batch_norm(x, w[bn + "weight"], w[bn + "bias"], stats[bn + "running_mean"],
                           stats[bn + "running_var"], m.bn.momentum, m.bn.eps, m.bn.replica)
        x = F.leaky_relu(x, m.slope)
    return x.reshape(x.shape[0], n).float()


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
