"""FIR resampling (upfirdn2d): the CUDA kernel's wrapper, its plain version
and its gradient.

StyleGAN2 config-f (``models/stylegan2f.py``) upsamples and blurs through
``upfirdn2d`` (NVlabs/stylegan2, ``dnnlib/tflib/ops/upfirdn_2d.py``): each
plane of an NCHW tensor is upsampled by ``up`` (zeros inserted), padded by
``pad = (x0, x1, y0, y1)`` (negative pads crop), convolved with the 2-D FIR
``k`` (a true convolution) and downsampled by ``down``:

    out = (in * up + pad0 + pad1 - k) // down + 1      (each direction)

For a CUDA tensor (float32 or bfloat16) :func:`upfirdn2d` launches the
kernel of ``csrc/upfirdn2d.cu`` (a float32 sum, one rounding) or raises: the
kernel is compiled for the models' resamplings only, a 4x4 filter with
(up, down) in ``KERNEL_FACTORS``.  The plain version (``F.pad`` and a depthwise ``F.conv2d``, in float32, or float64
for float64 input) runs only for CPU tensors.  The gradient is the same
operation with the filter flipped, ``up`` and ``down`` swapped and the pads
that give back the input's size (NVlabs' ``_upfirdn_2d_cuda``), so the
backward launches the same kernel.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mdgan_tpu_torch.ops import _build

Pad = Tuple[int, int, int, int]
KERNEL_TAPS = (4, 4)
KERNEL_FACTORS = ((1, 1), (2, 1), (1, 2))  # (up, down); a gradient swaps them


def setup_kernel(taps: Sequence[float], gain: float = 1.0) -> np.ndarray:
    """The separable 2-D FIR of the 1-D ``taps``, normalized to sum 1, times
    ``gain`` (NVlabs' ``_setup_kernel``): [1, 3, 3, 1] gives StyleGAN2's."""
    t = np.asarray(taps, np.float64)
    k = np.outer(t, t)
    return (k / k.sum() * gain).astype(np.float32)


def out_size(n: int, up: int, down: int, pad0: int, pad1: int, taps: int) -> int:
    return (n * up + pad0 + pad1 - taps) // down + 1


def upfirdn2d_plain(x: torch.Tensor, k: np.ndarray, up: int = 1, down: int = 1,
                    pad: Pad = (0, 0, 0, 0)) -> torch.Tensor:
    """The operation in PyTorch: zeros inserted by reshape and ``F.pad``,
    the pads, then a depthwise ``F.conv2d`` with the flipped filter, in
    float32 (float64 for float64 input), cast back to ``x``'s dtype.  ``k``
    may be a tensor: one already on ``x``'s device in the sum's dtype takes
    no copy from the host."""
    n, c, h, w = x.shape
    dtype = torch.float64 if x.dtype == torch.float64 else torch.float32
    y = x.to(dtype).reshape(n * c, 1, h, 1, w, 1)
    y = F.pad(y, (0, up - 1, 0, 0, 0, up - 1)).reshape(n * c, 1, h * up, w * up)
    y = F.pad(y, tuple(pad))
    taps = k if isinstance(k, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(k))
    weight = taps.to(y).flip(0, 1)[None, None]
    y = F.conv2d(y, weight, stride=down)
    return y.reshape(n, c, y.shape[2], y.shape[3]).to(x.dtype)


def _launch(x: torch.Tensor, k: np.ndarray, up: int, down: int, pad: Pad) -> torch.Tensor:
    if k.shape != KERNEL_TAPS or (up, down) not in KERNEL_FACTORS:
        raise ValueError(f"upfirdn2d: the CUDA kernel takes a {KERNEL_TAPS} filter with "
                         f"(up, down) in {KERNEL_FACTORS}, got {k.shape} and ({up}, {down})")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"upfirdn2d: CUDA input must be float32 or bfloat16, got {x.dtype}")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"upfirdn2d: input on {x.device}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    x = x.contiguous()
    n, c, h, w = x.shape
    kh, kw = k.shape
    oh = out_size(h, up, down, pad[2], pad[3], kh)
    ow = out_size(w, up, down, pad[0], pad[1], kw)
    y = torch.empty((n, c, oh, ow), dtype=x.dtype, device=x.device)
    taps = np.ascontiguousarray(k, np.float32)
    err = _build.lib().mdgan_upfirdn2d(
        x.data_ptr(), y.data_ptr(), int(x.dtype == torch.bfloat16), n * c, h, w, oh, ow, up,
        down, pad[0], pad[2], taps.ctypes.data, kh, kw,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "upfirdn2d")
    upfirdn2d.launches += 1
    return y


def _apply(x: torch.Tensor, k: np.ndarray, up: int, down: int, pad: Pad) -> torch.Tensor:
    if x.device.type == "cpu":
        return upfirdn2d_plain(x, k, up, down, pad)
    if x.device.type != "cuda":
        raise ValueError(f"upfirdn2d: unsupported device {x.device}")
    return _launch(x, k, up, down, pad)


class _UpFirDn2d(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, k, up, down, pad):
        ctx.k, ctx.up, ctx.down, ctx.pad = k, up, down, pad
        ctx.in_hw = x.shape[2:]
        y = _apply(x, k, up, down, pad)
        ctx.out_hw = y.shape[2:]
        return y

    @staticmethod
    def backward(ctx, dy):
        (h, w), (oh, ow) = ctx.in_hw, ctx.out_hw
        kh, kw = ctx.k.shape
        up, down, (x0, _, y0, _) = ctx.up, ctx.down, ctx.pad
        gpad = (kw - x0 - 1, w * up - ow * down + x0 - up + 1,
                kh - y0 - 1, h * up - oh * down + y0 - up + 1)
        dx = upfirdn2d(dy, ctx.k[::-1, ::-1], up=down, down=up, pad=gpad)
        return dx, None, None, None, None


def upfirdn2d(x: torch.Tensor, k: np.ndarray, up: int = 1, down: int = 1,
              pad: Pad = (0, 0, 0, 0)) -> torch.Tensor:
    """x (N, C, H, W) -> (N, C, out_h, out_w): upsample by ``up``, pad by
    ``pad`` = (x0, x1, y0, y1), convolve with the 2-D FIR ``k`` (a numpy
    array; :func:`setup_kernel`), downsample by ``down``; differentiable."""
    if x.dim() != 4:
        raise ValueError(f"upfirdn2d: x must be (N, C, H, W), got {tuple(x.shape)}")
    k = np.ascontiguousarray(k, np.float32)
    if k.ndim != 2:
        raise ValueError(f"upfirdn2d: the filter must be 2-D, got shape {k.shape}")
    return _UpFirDn2d.apply(x, k, int(up), int(down), tuple(int(p) for p in pad))


upfirdn2d.launches = 0  # kernel launches since the last reset (forward and backward)
