"""StyleGAN2 config-f (Karras et al., "Analyzing and Improving the Image
Quality of StyleGAN", CVPR 2020), as NVlabs/stylegan2 builds it
(``training/networks_stylegan2.py``, ``run_training.py --config=config-f``):
a skip generator and a residual discriminator, at 256x256 by default (LSUN
Church).

* **Widths.** nf(s) = min(fmap_base / 2^s, fmap_max) channels at
  resolution 2^(s+1): at config-f (fmap_base 16384, fmap_max 512) 512 from 4
  to 64 px, 256 at 128, 128 at 256.  z = w = 512.
* **Mapping.** Pixel-norm, ``map_layers`` equalized dense layers of 512 at
  lr_mul 0.01, each with lrelu(0.2)*sqrt(2) (``models/stylegan2.py``).
* **Synthesis.** A learned 4x4 constant, one modulated 3x3 conv, then per
  block from 8 px: an up-modconv (modulate, transposed conv of stride 2 with
  the kernel flipped, the [1,3,3,1] FIR at gain 4 padded (1,1), demodulate)
  and a modconv 3x3.  Each conv is followed by per-pixel noise
  (x += strength * n, n ~ N(0,1) of shape (b, 1, H, W), one scalar strength
  a layer), a bias and the gained lrelu.  Skip output: every block's tRGB
  (a 1x1 modconv, no demodulation, plus a bias) added to the previous RGB
  upsampled through ``upfirdn2d`` (up 2, pad (2, 1), gain 4); the image is
  that sum, linear.
* **Discriminator.** fromRGB (a 1x1 conv, bias, act), then per block from
  the top resolution down to 8 px: a 3x3 conv to nf(s), bias, act; a blur
  padded (2, 2) and a 3x3 stride-2 conv to nf(s-1), bias, act; a skip branch
  of a blur padded (1, 1) and a 1x1 stride-2 conv with no bias; the sum times
  1/sqrt(2).  At 4x4: the minibatch stddev (group 4, one feature), a 3x3 conv
  to nf(1), bias, act, a dense layer on the NCHW-flattened map to nf(0), act,
  and a dense layer to one logit.  Every conv and dense layer is
  equalized-lr: N(0, 1) weights scaled by 1/sqrt(fan_in) at run time.

The blur and the FIR upsampling are ``ops/upfirdn2d.py`` (its CUDA kernel on
the card); the transposed and strided convs stay with cuDNN.  Tensors are
logically (N, C, H, W) at every interface.  On a CUDA card both networks
keep their activations channels_last inside (:func:`activation_format`),
from the generator's constant and the discriminator's input image on, and
every later op follows its input's layout: cuDNN's convolutions on the H100
are NHWC kernels, which would otherwise transpose every NCHW input, weight
and output (``models/stylegan2.py`` ``conv_weight`` casts each run-time
weight channels_last in the copy autocast makes anyway), and the FIR kernel
takes channels_last input as it lies (its ``nhwc`` plan).  The generator's
3-channel RGB skip runs NCHW (the FIR's NCHW plans), and the image it
returns is NCHW-contiguous float32.  The noise
inputs are the generator's :meth:`StyleGAN2FGenerator.noise_shapes`, in
forward order, and every forward is handed them: a round's from lane NOISE
(``engine/mdgan.py`` ``g_inputs``), a sample's from the sampler's generator
(``sample_generator``), as NVlabs' ``randomize_noise`` draws them afresh.
Under bfloat16 autocast the style path stays float32, as in
``models/stylegan2.py``.  With the batch split over replicas the minibatch
statistic is the whole batch's.  There is no tensor-parallel form
(``parallel/tensor.py`` refuses one).  :func:`upfirdn2d_sites` lists the
resampling calls of one forward of each network.

Departures from NVlabs' training, which the MD-GAN round replaces: no lazy
R1 or path-length regularization, no style mixing, no generator EMA, no
truncation.  Weights init with :func:`stylegan2f_init_`.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mdgan_tpu_torch.models.stylegan2 import (EqualDense, MappingNetwork, ModulatedConv,
                                              _lrelu, conv_weight, minibatch_stddev)
from mdgan_tpu_torch.ops.upfirdn2d import setup_kernel, upfirdn2d

SHAPE = (256, 256, 3)
Z_DIM = 512
# config-f's widths (run_training.py --config=config-f)
FMAP_BASE, FMAP_MAX = 16384, 512
RESAMPLE = (1, 3, 3, 1)
_FIR_UP = setup_kernel(RESAMPLE, gain=4.0)    # after zero insertion: gain up^2
_FIR = setup_kernel(RESAMPLE)
_INV_SQRT2 = 1.0 / math.sqrt(2.0)


def nf(stage: int, fmap_base: int = FMAP_BASE, fmap_max: int = FMAP_MAX) -> int:
    """Channels of stage ``stage`` (resolution 2^(stage+1))."""
    return min(int(fmap_base / 2.0 ** stage), fmap_max)


def _channels(res: int, fmap_base: int, fmap_max: int) -> int:
    return nf(int(math.log2(res)) - 1, fmap_base, fmap_max)


def activation_format(t: torch.Tensor) -> torch.memory_format:
    """The layout the networks keep their activations in, for inputs on
    ``t``'s device: channels_last on a CUDA card, where cuDNN's convolutions
    are NHWC kernels and the FIR kernel has its ``nhwc`` plan; NCHW
    elsewhere, where no kernel gains by it and NCHW keeps the CPU's float32
    sums in the reference's order."""
    return torch.channels_last if t.is_cuda else torch.contiguous_format


def _resolutions(max_res: int) -> List[int]:
    out = [4 * 2 ** i for i in range(int(math.log2(max(max_res, 4) // 4)) + 1)]
    if out[-1] != max_res:
        raise ValueError(f"max_res {max_res} is not 4 * 2^k")
    return out


class UpModulatedConv(ModulatedConv):
    """3x3 modulated conv with x2 upsampling (NVlabs' ``upsample_conv_2d``):
    the modulated input through a transposed conv of stride 2 with the
    kernel flipped, the FIR at gain 4 padded (1, 1) (2H+1 -> 2H), then the
    demodulation."""

    def forward(self, x: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
        with torch.autocast(device_type=x.device.type, enabled=False):
            s = self.mod(style.float())
            wk = self.weight * self.he
            d = torch.rsqrt((s * s) @ (wk * wk).sum(dim=(2, 3)).t() + 1e-8)
        x = x * s[:, :, None, None].to(x.dtype)
        y = F.conv_transpose2d(x, conv_weight(wk.transpose(0, 1).flip(2, 3), x), stride=2)
        y = upfirdn2d(y, _FIR_UP, pad=(1, 1, 1, 1))
        return y * d[:, :, None, None].to(y.dtype)


class NoisyLayer(nn.Module):
    """A modulated conv (up or not), then per-pixel noise times a learned
    strength, a bias and the gained lrelu (NVlabs' ``layer``)."""

    def __init__(self, in_ch: int, out_ch: int, w_dim: int, up: bool = False):
        super().__init__()
        self.conv = (UpModulatedConv if up else ModulatedConv)(in_ch, out_ch, w_dim)
        self.noise_strength = nn.Parameter(torch.zeros(()))
        self.bias = nn.Parameter(torch.zeros(out_ch))

    def forward(self, x: torch.Tensor, style: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        y = self.conv(x, style)
        y = y + (noise * self.noise_strength).to(y.dtype)
        return _lrelu(y + self.bias[None, :, None, None].to(y.dtype))


class ToRGB(nn.Module):
    """1x1 modulated conv, no demodulation, plus a bias."""

    def __init__(self, in_ch: int, channels: int, w_dim: int):
        super().__init__()
        self.conv = ModulatedConv(in_ch, channels, w_dim, kernel=1, demodulate=False)
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
        y = self.conv(x, style)
        return y + self.bias[None, :, None, None].to(y.dtype)


class StyleGAN2FGenerator(nn.Module):
    def __init__(self, channels: int = 3, fmap_base: int = FMAP_BASE, fmap_max: int = FMAP_MAX,
                 max_res: int = SHAPE[0], map_layers: int = 8, z_dim: int = Z_DIM):
        super().__init__()
        self.resolutions = _resolutions(max_res)
        self.mapping = MappingNetwork(z_dim, map_layers, z_dim)
        c4 = _channels(4, fmap_base, fmap_max)
        self.const = nn.Parameter(torch.empty(c4, 4, 4))
        self.b4 = NoisyLayer(c4, c4, z_dim)
        self.trgb4 = ToRGB(c4, channels, z_dim)
        cin = c4
        for res in self.resolutions[1:]:
            f = _channels(res, fmap_base, fmap_max)
            self.add_module(f"b{res}", nn.ModuleList([NoisyLayer(cin, f, z_dim, up=True),
                                                      NoisyLayer(f, f, z_dim)]))
            self.add_module(f"trgb{res}", ToRGB(f, channels, z_dim))
            cin = f

    def noise_shapes(self) -> List[Tuple[int, int, int]]:
        """Per-sample shapes of the noise inputs, in forward order: one at
        4x4, two at each higher resolution."""
        return [(1, 4, 4)] + [(1, r, r) for r in self.resolutions[1:] for _ in range(2)]

    def forward(self, z: torch.Tensor, noise: Sequence[torch.Tensor]) -> torch.Tensor:
        """z (b, z_dim) -> (b, C, H, W) float32, NCHW-contiguous; ``noise``:
        one (b, 1, r, r) tensor a noise input (:meth:`noise_shapes`)."""
        if len(noise) != len(self.noise_shapes()):
            raise ValueError(f"{len(noise)} noise inputs, want {len(self.noise_shapes())}")
        style = self.mapping(z)
        x = self.const[None].expand(z.shape[0], -1, -1, -1).contiguous(
            memory_format=activation_format(z))
        x = self.b4(x, style, noise[0])
        rgb = self.trgb4(x, style)
        for i, res in enumerate(self.resolutions[1:]):
            up, same = getattr(self, f"b{res}")
            x = same(up(x, style, noise[1 + 2 * i]), style, noise[2 + 2 * i])
            t = getattr(self, f"trgb{res}")(x, style)
            rgb = upfirdn2d(rgb, _FIR_UP, up=2, pad=(2, 1, 2, 1)).to(t.dtype) + t
        return rgb.to(torch.float32, memory_format=torch.contiguous_format)


def upfirdn2d_sites(b_g: int = 8, b_d: int = 4):
    """Every resampling call of one config-f generator forward (b_g images)
    and one discriminator forward (b_d): (name, input shape, up, pad)."""

    def ch(res):
        return nf(int(math.log2(res)) - 1)

    sites = []
    for res in (8, 16, 32, 64, 128, 256):
        sites.append((f"g_up{res}", (b_g, ch(res), res + 1, res + 1), 1, (1, 1, 1, 1)))
        sites.append((f"g_rgb{res}", (b_g, 3, res // 2, res // 2), 2, (2, 1, 2, 1)))
        sites.append((f"d_blur{res}", (b_d, ch(res), res, res), 1, (2, 2, 2, 2)))
        sites.append((f"d_skip{res}", (b_d, ch(res), res, res), 1, (1, 1, 1, 1)))
    return sites


class EqualConv2d(nn.Module):
    """Equalized-lr conv: N(0, 1) weights times 1/sqrt(fan_in) at run time."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 padding: int = 0, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None
        self.scale = 1.0 / math.sqrt(in_ch * kernel * kernel)
        self.stride, self.padding = stride, padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, conv_weight(self.weight * self.scale, x), self.bias, self.stride,
                        self.padding)


class DBlock(nn.Module):
    """Residual down block: conv 3x3, blur (2, 2) and a 3x3 stride-2 conv,
    beside a blur (1, 1) and a 1x1 stride-2 skip conv; summed / sqrt(2)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv0 = EqualConv2d(in_ch, in_ch, 3, padding=1)
        self.conv1 = EqualConv2d(in_ch, out_ch, 3, stride=2)
        self.skip = EqualConv2d(in_ch, out_ch, 1, stride=2, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _lrelu(self.conv0(x))
        y = _lrelu(self.conv1(upfirdn2d(y, _FIR, pad=(2, 2, 2, 2))))
        t = self.skip(upfirdn2d(x, _FIR, pad=(1, 1, 1, 1)))
        return (y + t) * _INV_SQRT2


class StyleGAN2FDiscriminator(nn.Module):
    def __init__(self, channels: int = 3, fmap_base: int = FMAP_BASE, fmap_max: int = FMAP_MAX,
                 max_res: int = SHAPE[0]):
        super().__init__()
        self.resolutions = _resolutions(max_res)[:0:-1]      # max_res down to 8
        self.from_rgb = EqualConv2d(channels, _channels(max_res, fmap_base, fmap_max), 1)
        for res in self.resolutions:
            self.add_module(f"b{res}", DBlock(_channels(res, fmap_base, fmap_max),
                                              _channels(res // 2, fmap_base, fmap_max)))
        c4 = nf(1, fmap_base, fmap_max)
        self.replica = None  # the mesh's replica axis, when the batch is split
        self.conv_out = EqualConv2d(c4 + 1, c4, 3, padding=1)
        self.fc = EqualDense(c4 * 16, nf(0, fmap_base, fmap_max))
        self.out = EqualDense(nf(0, fmap_base, fmap_max), 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (b, C, H, W) -> (b,) float32 logits."""
        b = x.shape[0]
        y = _lrelu(self.from_rgb(x.contiguous(memory_format=activation_format(x))))
        for res in self.resolutions:
            y = getattr(self, f"b{res}")(y)
        y = _lrelu(self.conv_out(minibatch_stddev(y, replica=self.replica)))
        # the dense layer takes the map flattened in NCHW order
        return self.out(_lrelu(self.fc(y.reshape(b, -1)))).reshape(b).float()


@torch.no_grad()
def stylegan2f_init_(module: nn.Module, gen: torch.Generator) -> nn.Module:
    """Init in place from ``gen``: equalized weights N(0, 1) (the mapping's
    N(0, 1/lr_mul)), modulation biases 1, the constant N(0, 1), every other
    bias and the noise strengths 0."""
    def normal_(t, std):
        t.copy_(torch.randn(t.shape, generator=gen) * std)

    for m in module.modules():
        if isinstance(m, EqualDense):
            normal_(m.weight, 1.0 / m.lr_mul)
            m.bias.fill_(m.bias_init)
        elif isinstance(m, (ModulatedConv, EqualConv2d)):
            normal_(m.weight, 1.0)
            if getattr(m, "bias", None) is not None:
                m.bias.zero_()
        elif isinstance(m, (NoisyLayer, ToRGB)):
            m.bias.zero_()
            if isinstance(m, NoisyLayer):
                m.noise_strength.zero_()
        elif isinstance(m, StyleGAN2FGenerator):
            normal_(m.const, 1.0)
    return module
