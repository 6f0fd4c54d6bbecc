"""The reference's convolutions and matrix products, in one of two precisions.

``Ops("float32")`` runs them in float32 (the caller turns TF32 off: see
:func:`float32_exact`).  ``Ops("fp8")`` is the control, the step below the
configurations' bfloat16 that would tempt a later change: where the
program under bfloat16 autocast keeps a tensor in bfloat16, the control
keeps it in float8.  The round runs under the same autocast
(:meth:`Ops.context`), and on top of it every operand and every output of a
convolution or matrix product, and every activation the family module
passes through :meth:`Ops.act`, is rounded to float8 e4m3 with a per-tensor
scale (its largest magnitude maps to 448, e4m3's largest finite value);
the gradients arriving at those outputs and activations are rounded to
float8 e5m2 the same way (largest 57344), as float8 training does.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def round_fp8(x: torch.Tensor, dtype, largest: float) -> torch.Tensor:
    """``x`` through ``dtype`` with a per-tensor scale, back in x's dtype."""
    scale = largest / x.detach().abs().amax().clamp(min=1e-30)
    return (x * scale).to(dtype).to(x.dtype) / scale


class _RoundE4M3(torch.autograd.Function):
    """Forward: the operand in e4m3; backward: the gradient passes."""

    @staticmethod
    def forward(ctx, x):
        return round_fp8(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return g


class _RoundBoth(torch.autograd.Function):
    """Forward: the tensor in e4m3; backward: its gradient in e5m2."""

    @staticmethod
    def forward(ctx, y):
        return round_fp8(y, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return round_fp8(g, torch.float8_e5m2, E5M2_MAX)


class Ops:
    """conv2d, conv_transpose2d and linear in the precision ``precision``
    ("float32" or "fp8")."""

    def __init__(self, precision: str = "float32"):
        if precision not in ("float32", "fp8"):
            raise ValueError(f"precision must be float32 or fp8, got {precision!r}")
        self.precision = precision

    def context(self, device: torch.device):
        """The autocast the round runs under: none in float32, bfloat16
        under the control."""
        if self.precision == "fp8":
            return torch.autocast(device_type=device.type, dtype=torch.bfloat16)
        return contextlib.nullcontext()

    def _q(self, x: torch.Tensor) -> torch.Tensor:
        return _RoundE4M3.apply(x) if self.precision == "fp8" else x

    def act(self, y: torch.Tensor) -> torch.Tensor:
        """A stored activation: itself in float32, float8 under the control."""
        return _RoundBoth.apply(y) if self.precision == "fp8" else y

    def conv2d(self, x, w, b=None, stride=1, padding=0):
        return self.act(F.conv2d(self._q(x), self._q(w), b, stride, padding))

    def conv_transpose2d(self, x, w, stride=1, padding=0):
        return self.act(F.conv_transpose2d(self._q(x), self._q(w), None, stride, padding))

    def linear(self, x, w, b=None):
        return self.act(F.linear(self._q(x), self._q(w), b))


@contextlib.contextmanager
def float32_exact():
    """TF32 off for cuBLAS and cuDNN in the body (restored after)."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
