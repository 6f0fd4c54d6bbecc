"""StyleGAN2-style pair for 128x128 images (FFHQ-128), NCHW.

Port of ``mdgan_tpu/models/stylegan2.py:1-243``:

* an 8-layer mapping network z -> w with pixel-norm and equalized-lr dense
  layers (runtime He scaling, ``lr_mul`` 0.01, so the stored kernels are
  drawn with std 1/0.01 = 100);
* synthesis from a learned 4x4 constant through 3x3 modulated convolutions
  in the input-scale / output-demodulate form (``:78-113``): scale the input
  channels by the style s, convolve with the shared kernel, scale the output
  channels by d = rsqrt(sum w^2 s^2 + 1e-8) — no per-sample kernels;
  nearest x2 upsampling, and a tRGB skip sum;
* a residual discriminator with a minibatch-stddev channel and a dense head.

JAX conventions kept here:

* a flax 3x3 stride-2 ``'SAME'`` conv pads (0, 1) at an even size, not
  torch's (1, 1), so :class:`ResBlock` pads explicitly; the 1x1 stride-2 skip
  pads nothing;
* the discriminator's ``nn.Conv`` layers have flax's default zero-init bias,
  except the skip conv;
* the head flattens NHWC (h, w, c) before its dense layer;
* the minibatch statistic is tiled over the batch, not repeated (``:198-213``).

Split over ranks (``core/mesh.py``): the tensor-parallel generator
(``parallel/tensor.py``) holds slices of the synthesis biases and of the
constant, which the forwards take whole through ``distributed.whole``; with
the batch split over replicas (``replica``, set by the MD-GAN engine) the
minibatch statistic is taken over every replica's rows.

Noise injection is off on every training path of the JAX engines (they apply
the generator without a ``dropout`` rng), so it is not ported; the
``noise_gain*`` scalars stay as parameters (zero gradient) so that leaf names
and checkpoints match the JAX package's.  Weights init with
:func:`stylegan2_init_`.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mdgan_tpu_torch.core.distributed import copy_to_group, gather_rows, whole

SHAPE = (128, 128, 3)
Z_DIM = 512
_SQRT2 = math.sqrt(2.0)
# XLA turns ``x / sqrt(2)`` into a multiply by the float32 reciprocal under jit
_INV_SQRT2 = float(np.float32(1.0) / np.float32(_SQRT2))


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    """LeakyReLU(0.2) with StyleGAN2's sqrt(2) gain."""
    return F.leaky_relu(x, 0.2) * _SQRT2


def channels_last(x: torch.Tensor) -> bool:
    """Whether ``x`` (N, C, H, W) lies channels_last (and not also NCHW,
    as a tensor with one channel or one pixel does)."""
    return x.is_contiguous(memory_format=torch.channels_last) and not x.is_contiguous()


class _ChannelsLastCast(torch.autograd.Function):
    """``w`` cast to ``dtype`` and laid out channels_last in one copy; its
    gradient cast back and laid out as ``w`` in one copy, so that it adds
    into the parameter's gradient as a dense tensor of the same strides."""

    @staticmethod
    def forward(ctx, w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        ctx.dtype = w.dtype
        return w.to(dtype, memory_format=torch.channels_last)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad.to(ctx.dtype, memory_format=torch.contiguous_format), None


def conv_weight(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A convolution's run-time weight ``w`` (contiguous) for the input
    ``x``: ``w`` as it is for an NCHW ``x``; for a channels_last ``x``,
    ``w`` cast to the dtype the convolution computes in (autocast's, else
    ``x``'s) and laid out channels_last in that same copy, so that cuDNN's
    NHWC kernels read it without a transpose of their own (the cast is the
    one autocast would make), and its gradient comes back contiguous."""
    if not channels_last(x):
        return w
    kind = x.device.type
    dtype = torch.get_autocast_dtype(kind) if torch.is_autocast_enabled(kind) else x.dtype
    return _ChannelsLastCast.apply(w, dtype)


def feats(base_features: int, res: int) -> int:
    """Channels at resolution ``res``: ``base_features`` down to 64
    (``stylegan2.py:135-137``)."""
    return max(min(base_features, 16 * base_features // res), min(64, base_features))


class EqualDense(nn.Module):
    """Equalized-lr dense: unit-normal (std 1/lr_mul) init, He scale at run
    time: ``x @ (w * lr_mul/sqrt(fan_in)) + b * lr_mul``."""

    def __init__(self, in_features: int, features: int, lr_mul: float = 1.0,
                 bias_init: float = 0.0):
        super().__init__()
        self.lr_mul = lr_mul
        self.bias_init = bias_init
        self.scale = lr_mul / math.sqrt(in_features)
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.empty(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight * self.scale, self.bias * self.lr_mul)


class MappingNetwork(nn.Module):
    def __init__(self, z_dim: int, layers: int, w_dim: int):
        super().__init__()
        dims = [z_dim] + [w_dim] * layers
        self.layers = nn.ModuleList(EqualDense(i, o, lr_mul=0.01)
                                    for i, o in zip(dims, dims[1:]))

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = z * torch.rsqrt((z * z).mean(dim=-1, keepdim=True) + 1e-8)
        for layer in self.layers:
            x = _lrelu(layer(x))
        return x


class ModulatedConv(nn.Module):
    """k x k modulated conv; with ``demodulate`` the output is exactly that
    of the per-sample weight-demodulated kernel.  The output keeps the
    input's memory format (:func:`conv_weight`)."""

    def __init__(self, in_ch: int, out_ch: int, w_dim: int, kernel: int = 3,
                 demodulate: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel, kernel))
        self.mod = EqualDense(w_dim, in_ch, bias_init=1.0)
        self.he = 1.0 / math.sqrt(kernel * kernel * in_ch)
        self.padding = kernel // 2
        self.demodulate = demodulate

    def forward(self, x: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
        # the style path in float32, as the JAX module computes it
        with torch.autocast(device_type=x.device.type, enabled=False):
            s = self.mod(style.float())                     # (b, in)
            wk = self.weight * self.he
            if self.demodulate:
                d = torch.rsqrt((s * s) @ (wk * wk).sum(dim=(2, 3)).t() + 1e-8)  # (b, out)
        x = x * s[:, :, None, None].to(x.dtype)
        y = F.conv2d(x, conv_weight(wk, x), padding=self.padding)
        if self.demodulate:
            y = y * d[:, :, None, None].to(y.dtype)
        return y


class SynthesisBlock(nn.Module):
    """Optional nearest x2 upsample, then two modulated 3x3 convs, each with
    a bias and the gained LeakyReLU (``stylegan2.py:116-133``)."""

    def __init__(self, in_ch: int, features: int, w_dim: int, up: bool):
        super().__init__()
        self.up = up
        self.conv0 = ModulatedConv(in_ch, features, w_dim)
        self.noise_gain0 = nn.Parameter(torch.zeros(()))
        self.bias0 = nn.Parameter(torch.zeros(features))
        self.conv1 = ModulatedConv(features, features, w_dim)
        self.noise_gain1 = nn.Parameter(torch.zeros(()))
        self.bias1 = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
        if self.up:
            x = F.interpolate(x, scale_factor=2, mode="nearest")
        for conv, bias in ((self.conv0, self.bias0), (self.conv1, self.bias1)):
            y = conv(x, style)
            x = _lrelu(y + whole(bias)[None, :, None, None].to(y.dtype))
        return x


class StyleGAN2Generator(nn.Module):
    def __init__(self, channels: int = 3, base_features: int = 512, max_res: int = 128,
                 map_layers: int = 8, z_dim: int = Z_DIM):
        super().__init__()
        self.resolutions = [4 * 2 ** i for i in range(int(math.log2(max_res // 4)) + 1)]
        if self.resolutions[-1] != max_res:
            raise ValueError(f"max_res {max_res} is not 4 * 2^k")
        self.mapping = MappingNetwork(z_dim, map_layers, base_features)
        self.const = nn.Parameter(torch.empty(feats(base_features, 4), 4, 4))
        cin = feats(base_features, 4)
        for res in self.resolutions:
            f = feats(base_features, res)
            self.add_module(f"b{res}", SynthesisBlock(cin, f, base_features, up=res > 4))
            self.add_module(f"trgb{res}", ModulatedConv(f, channels, base_features, kernel=1,
                                                        demodulate=False))
            cin = f

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        style = self.mapping(z)
        x = whole(self.const)[None].expand(z.shape[0], -1, -1, -1)
        rgb = None
        for res in self.resolutions:
            x = getattr(self, f"b{res}")(x, style)
            t = getattr(self, f"trgb{res}")(x, style)
            rgb = t if rgb is None else F.interpolate(rgb, scale_factor=2, mode="nearest") + t
        return torch.tanh(rgb.float())


class ResBlock(nn.Module):
    """Residual downsampling block: 1x1 stride-2 skip (no bias), 3x3 conv,
    3x3 stride-2 conv padded (0, 1) as flax's 'SAME', summed / sqrt(2)."""

    def __init__(self, in_ch: int, features: int):
        super().__init__()
        self.skip = nn.Conv2d(in_ch, features, 1, stride=2, bias=False)
        self.conv1 = nn.Conv2d(in_ch, in_ch, 3, padding=1)
        self.conv2 = nn.Conv2d(in_ch, features, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _lrelu(self.conv1(x))
        y = _lrelu(self.conv2(F.pad(y, (0, 1, 0, 1))))
        return (y + self.skip(x)) * _INV_SQRT2


def minibatch_stddev(x: torch.Tensor, group_size: int = 4, replica=None) -> torch.Tensor:
    """Append the cross-sample feature stddev as one channel
    (``stylegan2.py:198-213``): groups of g samples strided b//g apart, the
    group statistic tiled over the batch.  With a replica axis, ``x`` is
    this rank's rows of the batch: the statistic is taken over every
    replica's rows (gathered; the gradient summed back) and this rank's rows
    are returned."""
    if replica is not None and replica.active:
        sizes = [int(n) for n in gather_rows(x.new_full((1,), x.shape[0]), replica)]
        start = sum(sizes[:replica.index])
        full = minibatch_stddev(copy_to_group(gather_rows(x, replica, sizes), replica),
                                group_size)
        return full[start:start + x.shape[0]]
    b, c, h, w = x.shape
    g = min(group_size, b)
    g = b // (b // g) if b % g else g
    while b % g:
        g -= 1
    y = x.reshape(g, b // g, c, h, w).float()
    y = y - y.mean(dim=0, keepdim=True)
    y = torch.sqrt((y * y).mean(dim=0) + 1e-8).mean(dim=(1, 2, 3))  # (b//g,)
    y = y.repeat(g)[:, None, None, None].to(x.dtype).expand(b, 1, h, w)
    if channels_last(x):  # the concatenation is channels_last only if each part is
        y = y.contiguous(memory_format=torch.channels_last)
    return torch.cat([x, y], dim=1)


class StyleGAN2Discriminator(nn.Module):
    def __init__(self, channels: int = 3, max_res: int = 128, base_features: int = 512):
        super().__init__()
        self.from_rgb = nn.Conv2d(channels, feats(base_features, max_res), 1)
        self.resolutions = []
        res = max_res
        while res > 4:
            self.add_module(f"b{res}", ResBlock(feats(base_features, res),
                                                feats(base_features, res // 2)))
            self.resolutions.append(res)
            res //= 2
        f4 = feats(base_features, 4)
        self.replica = None  # the mesh's replica axis, when the batch is split
        self.conv_out = nn.Conv2d(f4 + 1, f4, 3, padding=1)
        self.fc = EqualDense(f4 * 16, f4)
        self.out = EqualDense(f4, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        y = _lrelu(self.from_rgb(x))
        for res in self.resolutions:
            y = getattr(self, f"b{res}")(y)
        y = _lrelu(self.conv_out(minibatch_stddev(y, replica=self.replica)))
        y = y.permute(0, 2, 3, 1).reshape(b, -1)  # flatten NHWC, as the JAX head
        return self.out(_lrelu(self.fc(y))).reshape(b).float()


@torch.no_grad()
def stylegan2_init_(module: nn.Module, gen: torch.Generator) -> nn.Module:
    """Init in place from ``gen`` with the JAX module's initializers:
    equalized dense N(0, 1/lr_mul) and a constant bias, modulated-conv
    kernels and the constant N(0, 1), discriminator convs N(0, 0.02) with
    zero bias, noise gains and synthesis biases 0."""
    def normal_(t, std):
        t.copy_(torch.randn(t.shape, generator=gen) * std)

    for m in module.modules():
        if isinstance(m, EqualDense):
            normal_(m.weight, 1.0 / m.lr_mul)
            m.bias.fill_(m.bias_init)
        elif isinstance(m, ModulatedConv):
            normal_(m.weight, 1.0)
        elif isinstance(m, SynthesisBlock):
            for p in (m.noise_gain0, m.bias0, m.noise_gain1, m.bias1):
                p.zero_()
        elif isinstance(m, StyleGAN2Generator):
            normal_(m.const, 1.0)
        elif isinstance(m, nn.Conv2d):
            normal_(m.weight, 0.02)
            if m.bias is not None:
                m.bias.zero_()
    return module
