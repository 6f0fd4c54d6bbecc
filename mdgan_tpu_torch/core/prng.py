"""Random lanes (port of ``mdgan_tpu/core/prng.py``).

The JAX package folds one root key along fixed tags, so each consumer has its
own reproducible stream.  Here each lane is a ``torch.Generator`` seeded from
``(seed, tag, step)`` through numpy's ``SeedSequence``, so a stream depends on
the global step and not on how rounds were grouped.  The numbers differ from
JAX's threefry streams: parity tests hand the JAX side's draws to the port.
"""

from __future__ import annotations

import numpy as np
import torch

# Same tags as mdgan_tpu/core/prng.py:16-23.
INIT_G = 0
INIT_D = 1
LATENT = 2
DATA = 3
DROPOUT = 4
SWAP = 5
EVAL = 6
STRAGGLER = 7
# The port's own: a generator's per-pixel noise (StyleGAN2 config-f), keyed
# by (step, noise input).  The JAX engines draw none.
NOISE = 8


def seed_for(seed: int, tag: int, step: int = 0, *path: int) -> int:
    """A 63-bit seed for lane ``tag`` at ``step`` (a worker index for the
    per-worker init lanes), and below it at ``path``: the DROPOUT lane keys
    each forward by (local epoch, worker, half) as the JAX engines fold their
    dropout key."""
    state = np.random.SeedSequence((seed, tag, step, *path)).generate_state(2, np.uint32)
    return ((int(state[0]) << 32) | int(state[1])) & (2**63 - 1)


def generator(seed: int, tag: int, step: int = 0, device="cpu") -> torch.Generator:
    """A fresh generator for lane ``tag`` at ``step`` on ``device``."""
    g = torch.Generator(device=device)
    g.manual_seed(seed_for(seed, tag, step))
    return g


def reseed(g: torch.Generator, seed: int, tag: int, step: int, *path: int) -> torch.Generator:
    """Re-seed an existing generator in place (one per device and lane is
    kept by the engine, so a round allocates no generator)."""
    g.manual_seed(seed_for(seed, tag, step, *path))
    return g
