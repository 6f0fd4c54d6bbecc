"""GAN losses and image normalization (port of ``mdgan_tpu/ops/losses.py``).

Discriminators emit logits; the reference's ``BCELoss`` on sigmoid outputs
becomes the numerically stable softplus forms

    BCE(sigmoid(x), 1) = softplus(-x)
    BCE(sigmoid(x), 0) = softplus(x)

Each loss is a mean over the batch, or, with ``total`` (a batch split over
replica ranks), this rank's part of the whole batch's mean: its rows' sum
over ``total``, which the replicas' parts add up to.  The batch is the
logits' first axis: (b,) logits give one loss, the (b, n) logits of n
stacked discriminators give n.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def _mean(x: torch.Tensor, total: Optional[int]) -> torch.Tensor:
    return x.mean(0) if total is None else x.sum(0) / total


def bce_real(logits: torch.Tensor, total: Optional[int] = None) -> torch.Tensor:
    """Mean BCE against label 1."""
    return _mean(F.softplus(-logits), total)


def bce_fake(logits: torch.Tensor, total: Optional[int] = None) -> torch.Tensor:
    """Mean BCE against label 0."""
    return _mean(F.softplus(logits), total)


def d_loss(logits_real: torch.Tensor, logits_fake: torch.Tensor,
           total: Optional[int] = None) -> torch.Tensor:
    """BCE(D(real), 1) + BCE(D(fake), 0) (reference ``worker.py:197-204``)."""
    return bce_real(logits_real, total) + bce_fake(logits_fake, total)


def g_loss(logits_on_fake: torch.Tensor, total: Optional[int] = None) -> torch.Tensor:
    """Feedback loss BCE(D(X_g), 1) (reference ``worker.py:220-225``)."""
    return bce_real(logits_on_fake, total)


# 2/255 as the float32 constant the JAX form multiplies by
SCALE_2_255 = float(np.float32(2.0 / 255.0))


def normalize_uint8(x: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """uint8 [0, 255] -> [-1, 1]: ``x * (2/255) - 1`` rounded ONCE.

    XLA contracts the JAX form into one fused multiply-add under ``jit``
    (the engine's path, and the Pallas kernel in interpret mode), so the
    reference result is fma(x, 2/255, -1).  In float64 the product and the
    sum are exact for uint8 x, and the one rounding to float32 gives that
    result bit for bit; the sampling kernel computes ``__fmaf_rn``.
    """
    return (x.to(torch.float64) * SCALE_2_255 - 1.0).to(dtype)


def denormalize_to_unit(x: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> [0, 1]."""
    return (x + 1.0) * 0.5
