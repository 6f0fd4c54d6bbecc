"""MLP GAN pair for MNIST (28x28x1), NCHW.

Port of ``mdgan_tpu/models/mlp_gan.py:1-74``:

Discriminator:
    784 -> 1024 -> 512 -> 256 -> 1, LeakyReLU(0.2) + Dropout(0.3) after each
    hidden layer, returning logits
Generator:
    100 -> 256 -> 512 -> 1024 -> 784, LeakyReLU(0.2), tanh

Linear layers keep torch's default init (:func:`layers.torch_linear_init_`).
At C=1 the NHWC flatten of the JAX model and the NCHW flatten here read the
pixels in the same order, so weights cross over without a permutation.

Dropout takes its randomness from the caller: ``dropout`` is a
``torch.Generator`` (the engines' DROPOUT lane), or the three layers' keep
masks (the parity tests inject the JAX side's), or None (no dropout).  A kept
activation is ``x * (1/0.7)`` with the reciprocal rounded to float32 first:
flax writes ``where(mask, x / keep_prob, 0)``, and XLA turns that division by
a constant into this multiply under ``jit``, the engine's path (a test holds
the two equal).
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

SHAPE = (28, 28, 1)  # stored uint8 image shape (H, W, C)
Z_DIM = 100
D_DIMS = (1024, 512, 256)
G_DIMS = (256, 512, 1024)
KEEP = 0.7  # 1 - the dropout rate 0.3
_KEEP_SCALE = float(np.float32(1.0) / np.float32(KEEP))

Dropout = Union[None, torch.Generator, Sequence[torch.Tensor]]


def keep_masks(gen: torch.Generator, batch: int, device) -> list:
    """The discriminator's three keep masks for a batch, drawn from ``gen``."""
    return [torch.rand((batch, d), generator=gen, device=device) < KEEP for d in D_DIMS]


class MLPDiscriminator(nn.Module):
    uses_dropout = True
    draw_masks = staticmethod(keep_masks)

    def __init__(self):
        super().__init__()
        dims = (SHAPE[0] * SHAPE[1] * SHAPE[2],) + D_DIMS
        self.hidden = nn.ModuleList(nn.Linear(i, o) for i, o in zip(dims, dims[1:]))
        self.out = nn.Linear(D_DIMS[-1], 1)

    def forward(self, x: torch.Tensor, dropout: Dropout = None) -> torch.Tensor:
        b = x.shape[0]
        x = x.reshape(b, -1)
        masks: Optional[Sequence[torch.Tensor]] = dropout
        if isinstance(dropout, torch.Generator):
            masks = keep_masks(dropout, b, x.device)
        for i, layer in enumerate(self.hidden):
            x = F.leaky_relu(layer(x), 0.2)
            if masks is not None:
                x = torch.where(masks[i], x * _KEEP_SCALE, 0.0)
        return self.out(x).reshape(b).float()


class MLPGenerator(nn.Module):
    def __init__(self, z_dim: int = Z_DIM):
        super().__init__()
        dims = (z_dim,) + G_DIMS
        self.hidden = nn.ModuleList(nn.Linear(i, o) for i, o in zip(dims, dims[1:]))
        self.out = nn.Linear(G_DIMS[-1], SHAPE[0] * SHAPE[1] * SHAPE[2])

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        b = z.shape[0]
        x = z.reshape(b, -1)
        for layer in self.hidden:
            x = F.leaky_relu(layer(x), 0.2)
        h, w, c = SHAPE
        return torch.tanh(self.out(x).float()).reshape(b, c, h, w)
