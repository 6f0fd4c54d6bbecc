"""Fused Adam: the CUDA kernels' wrapper and their plain PyTorch versions.

Port of ``mdgan_tpu/ops/adam.py`` (the Pallas ``_adam_kernel``, ``:43-54``,
driven per leaf by ``FusedAdam.update_in_place``, ``:108-162``).  Here one
call updates one flat float32 arena — a whole network, or all N stacked
discriminators — in place:

    mu' = b1*mu + (1-b1)*g
    nu' = b2*nu + (1-b2)*g*g
    p'  = p - lr_c1 * mu' / (sqrt(nu' * inv_c2) + eps)

with ``lr_c1 = lr/(1-b1^t)`` and ``inv_c2 = 1/(1-b2^t)`` from
:func:`bias_scalars`.  The moments are float32, or bfloat16 under
``--moment_dtype bfloat16``: then the update follows optax's rounding points,
as the JAX package runs bf16 moments through optax (:func:`adam_plain_bf16m`).
For a CUDA tensor :func:`adam_update` launches the kernel of the moments'
dtype in ``csrc/adam.cu`` or raises; the plain versions run only for CPU
tensors.
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


def adam_plain_bf16m(p, g, mu, nu, lr_c1, inv_c2, b1, b2, eps) -> None:
    """The update with bfloat16 ``mu``/``nu``, at optax's rounding points
    (``optax.tree.update_moment``: ``(1-b)*g**k + b*t``): the stored
    moment times ``b`` rounds to bfloat16, the sum with the float32 gradient
    term is float32, the parameter step uses those unrounded moments, and
    they are stored rounded to nearest even."""
    m = (b1 * mu).float() + (1.0 - b1) * g
    v = (b2 * nu).float() + (1.0 - b2) * (g * g)
    p.copy_(p - lr_c1 * m / (torch.sqrt(v * inv_c2) + eps))
    mu.copy_(m)
    nu.copy_(v)


def _check(p, g, mu, nu) -> None:
    for name, t, dtypes in (("p", p, (torch.float32,)), ("g", g, (torch.float32,)),
                            ("mu", mu, (torch.float32, torch.bfloat16)),
                            ("nu", nu, (mu.dtype,))):
        if t.dtype not in dtypes:
            raise TypeError(f"adam_update: {name} must be "
                            f"{' or '.join(map(str, dtypes))}, got {t.dtype}")
        if t.dim() != 1 or t.numel() != p.numel():
            raise ValueError(f"adam_update: {name} must be flat with {p.numel()} "
                             f"elements, got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"adam_update: {name} must be contiguous")
        if t.device != p.device:
            raise ValueError(f"adam_update: {name} on {t.device}, p on {p.device}")


def adam_update(p, g, mu, nu, lr_c1: float, inv_c2: float,
                b1: float, b2: float, eps: float) -> None:
    """Update flat float32 ``p`` and ``mu``, ``nu`` (both float32 or both
    bfloat16) in place from gradient ``g``."""
    _check(p, g, mu, nu)
    bf16m = mu.dtype == torch.bfloat16
    if p.device.type == "cpu":
        (adam_plain_bf16m if bf16m else adam_plain)(p, g, mu, nu, lr_c1, inv_c2, b1, b2, eps)
        return
    if p.device.type != "cuda":
        raise ValueError(f"adam_update: unsupported device {p.device}")
    if p.device.index != torch.cuda.current_device():
        raise ValueError(f"adam_update: tensors on {p.device}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    if any(t.data_ptr() % 16 for t in (p, g)) or any(
            t.data_ptr() % (8 if bf16m else 16) for t in (mu, nu)):
        raise ValueError("adam_update: arenas must be 16-byte aligned (8 for bf16 moments)")
    _build.launch("mdgan_adam_f32_bf16m" if bf16m else "mdgan_adam_f32",
                  p.data_ptr(), g.data_ptr(), mu.data_ptr(), nu.data_ptr(), p.numel(),
                  lr_c1, inv_c2, b1, 1.0 - b1, b2, 1.0 - b2, eps,
                  torch.cuda.current_stream(p.device).cuda_stream)
