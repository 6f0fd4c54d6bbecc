"""Fused Adam: the CUDA kernel's wrapper and its plain PyTorch version.

Port of ``mdgan_tpu/ops/adam.py`` (the Pallas ``_adam_kernel``, ``:43-54``,
driven per leaf by ``FusedAdam.update_in_place``, ``:108-162``).  Here one
call updates one flat float32 arena — a whole network, or all N stacked
discriminators — in place:

    mu' = b1*mu + (1-b1)*g
    nu' = b2*nu + (1-b2)*g*g
    p'  = p - lr_c1 * mu' / (sqrt(nu' * inv_c2) + eps)

with ``lr_c1 = lr/(1-b1^t)`` and ``inv_c2 = 1/(1-b2^t)`` from
:func:`bias_scalars`.  For a CUDA tensor :func:`adam_update` launches
``csrc/adam.cu`` or raises; the plain version runs only for CPU tensors.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from mdgan_tpu_torch.ops import _build


def bias_scalars(lr: float, b1: float, b2: float, count: int) -> Tuple[float, float]:
    """(lr/(1-b1^t), 1/(1-b2^t)) in float32, as ``adam.py:114-118``."""
    t = np.float32(count)
    c1 = np.float32(1.0) - np.power(np.float32(b1), t)
    c2 = np.float32(1.0) - np.power(np.float32(b2), t)
    return float(np.float32(lr) / c1), float(np.float32(1.0) / c2)


def adam_plain(p, g, mu, nu, lr_c1, inv_c2, b1, b2, eps) -> None:
    """The same update in PyTorch, one rounding per operation, in place."""
    mu2 = b1 * mu + (1.0 - b1) * g
    nu2 = b2 * nu + (1.0 - b2) * g * g
    p2 = p - lr_c1 * mu2 / (torch.sqrt(nu2 * inv_c2) + eps)
    p.copy_(p2)
    mu.copy_(mu2)
    nu.copy_(nu2)


def _check(p, g, mu, nu) -> None:
    for name, t in (("p", p), ("g", g), ("mu", mu), ("nu", nu)):
        if t.dtype != torch.float32:
            raise TypeError(f"adam_update: {name} must be float32, got {t.dtype}")
        if t.dim() != 1 or t.numel() != p.numel():
            raise ValueError(f"adam_update: {name} must be flat with {p.numel()} "
                             f"elements, got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"adam_update: {name} must be contiguous")
        if t.device != p.device:
            raise ValueError(f"adam_update: {name} on {t.device}, p on {p.device}")


def adam_update(p, g, mu, nu, lr_c1: float, inv_c2: float,
                b1: float, b2: float, eps: float) -> None:
    """Update flat float32 ``p``, ``mu``, ``nu`` in place from gradient ``g``."""
    _check(p, g, mu, nu)
    if p.device.type == "cpu":
        adam_plain(p, g, mu, nu, lr_c1, inv_c2, b1, b2, eps)
        return
    if p.device.type != "cuda":
        raise ValueError(f"adam_update: unsupported device {p.device}")
    if p.device.index != torch.cuda.current_device():
        raise ValueError(f"adam_update: tensors on {p.device}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    if any(t.data_ptr() % 16 for t in (p, g, mu, nu)):
        raise ValueError("adam_update: arenas must be 16-byte aligned")
    lib = _build.lib()
    err = lib.mdgan_adam_f32(
        p.data_ptr(), g.data_ptr(), mu.data_ptr(), nu.data_ptr(), p.numel(),
        lr_c1, inv_c2, b1, 1.0 - b1, b2, 1.0 - b2, eps,
        torch.cuda.current_stream(p.device).cuda_stream)
    _build.check(err, "adam_update")
    adam_update.launches += 1


adam_update.launches = 0  # kernel launches since the last reset
