"""Built-in dataset plugins: CIFAR-10 and Synthetic32.

Copies of ``mdgan_tpu/data/builtin.py:36-77`` (:func:`synthesize`),
``:132-163`` (:func:`load_cifar10`, python-pickle path and synthetic
fallback) and ``:219-241`` (the two registry entries).  Output bytes are
identical to the JAX package's (a test holds them equal).  Images are uint8
NHWC; normalization to [-1, 1] happens on the device at sample time.
"""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from mdgan_tpu_torch.core import registry
from mdgan_tpu_torch.models import dcgan32


def synthesize(
    shape: Tuple[int, int, int],
    num_examples: int,
    num_classes: int = 10,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic class-conditional toy images (uint8 NHWC): one 2-D
    Gaussian blob per class with per-example jitter (``builtin.py:36-73``)."""
    h, w, c = shape
    rng = np.random.default_rng(seed)
    labels = np.arange(num_examples, dtype=np.int64) % num_classes
    cy = rng.uniform(0.25, 0.75, num_classes)
    cx = rng.uniform(0.25, 0.75, num_classes)
    sigma = rng.uniform(0.08, 0.2, num_classes)
    color = rng.uniform(0.3, 1.0, (num_classes, c))
    jy = rng.normal(0, 0.05, num_examples)
    jx = rng.normal(0, 0.05, num_examples)
    js = rng.normal(1.0, 0.1, num_examples).clip(0.6, 1.4)
    yy = np.linspace(0, 1, h)[None, :, None]
    xx = np.linspace(0, 1, w)[None, None, :]
    out = np.empty((num_examples, h, w, c), dtype=np.uint8)
    chunk = 2048
    for s in range(0, num_examples, chunk):
        e = min(s + chunk, num_examples)
        lab = labels[s:e]
        d2 = (yy - (cy[lab] + jy[s:e])[:, None, None]) ** 2 + (
            xx - (cx[lab] + jx[s:e])[:, None, None]
        ) ** 2
        blob = np.exp(-d2 / (2 * (sigma[lab] * js[s:e])[:, None, None] ** 2))
        img = blob[..., None] * color[lab][:, None, None, :]
        out[s:e] = (img * 255).astype(np.uint8)
    return out, labels


def _find(data_dir: str, *candidates: str) -> Optional[Path]:
    for cand in candidates:
        p = Path(data_dir) / cand
        if p.exists():
            return p
    return None


def load_cifar10(data_dir: str, split: str = "train", fallback: str = "synthetic",
                 max_examples: Optional[int] = None):
    """CIFAR-10 from the python pickle batches, else synthetic."""
    base = _find(data_dir, "cifar10/cifar-10-batches-py", "cifar-10-batches-py")
    if base is None:
        if _find(data_dir, "cifar10/cifar-10-batches-bin", "cifar-10-batches-bin"):
            raise NotImplementedError(
                "the CIFAR-10 binary-format decoder (mdgan_tpu/data/native) is "
                "not ported yet (ROADMAP.md A.9); provide cifar-10-batches-py")
        if fallback != "synthetic":
            raise FileNotFoundError(f"CIFAR-10 raw files not found under {data_dir}")
        n = max_examples or (50000 if split == "train" else 10000)
        return synthesize((32, 32, 3), n, seed=32)
    files = ([f"data_batch_{i}" for i in range(1, 6)] if split == "train"
             else ["test_batch"])
    xs, ys = [], []
    for name in files:
        with open(base / name, "rb") as f:
            d = pickle.load(f, encoding="bytes")
        xs.append(np.asarray(d[b"data"], np.uint8))
        ys.append(np.asarray(d[b"labels"], np.int64))
    data = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)  # NCHW->NHWC
    labels = np.concatenate(ys)
    if max_examples:
        data, labels = data[:max_examples], labels[:max_examples]
    return np.ascontiguousarray(data), labels


def load_synthetic32(data_dir: str, split: str = "train", fallback: str = "synthetic",
                     max_examples: Optional[int] = None):
    """Always procedural, whatever is on disk (``builtin.py:233-241``)."""
    return synthesize((32, 32, 3), max_examples or 50000, seed=32)


registry.register(registry.DatasetSpec(
    name="CIFAR10", shape=dcgan32.SHAPE, z_dim=dcgan32.Z_DIM,
    make_generator=dcgan32.DCGANGenerator32,
    make_discriminator=dcgan32.DCGANDiscriminator32,
    load=load_cifar10,
))

registry.register(registry.DatasetSpec(
    name="Synthetic32", shape=dcgan32.SHAPE, z_dim=dcgan32.Z_DIM,
    make_generator=dcgan32.DCGANGenerator32,
    make_discriminator=dcgan32.DCGANDiscriminator32,
    load=load_synthetic32,
))
