"""Dataset/model registry (port of ``mdgan_tpu/core/registry.py``).

Its own :class:`DatasetSpec`, :func:`register` and :func:`get`: the JAX
registry imports its built-ins, which pull in flax.  The port registers
``CIFAR10`` and ``Synthetic32`` (``data/builtin.py``); the other datasets of
the JAX package wait for their model families.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

# Datasets the JAX package has and the port does not yet.
_NOT_PORTED = {
    "MNIST": "ROADMAP.md A.5 (MLP-GAN)",
    "SyntheticMNIST": "ROADMAP.md A.5 (MLP-GAN)",
    "CelebA": "ROADMAP.md A.5 (DCGAN-64)",
    "FFHQ128": "ROADMAP.md A.5 (StyleGAN2)",
}


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    """Everything the engine needs to train on a dataset.

    ``shape`` is the stored image shape (H, W, C) of the uint8 data (the
    loaders return NHWC bytes, as in the JAX package); the models take NCHW.
    ``make_generator``/``make_discriminator`` build ``nn.Module``s and accept
    width keywords (``ngf``/``ndf``).
    """

    name: str
    shape: Tuple[int, int, int]
    z_dim: int
    make_generator: Callable[..., object]
    make_discriminator: Callable[..., object]
    load: Callable[..., Tuple[object, object]]


_REGISTRY: Dict[str, DatasetSpec] = {}


def register(spec: DatasetSpec) -> DatasetSpec:
    if spec.name in _REGISTRY:
        raise ValueError(f"dataset {spec.name!r} already registered")
    _REGISTRY[spec.name] = spec
    return spec


def get(name: str) -> DatasetSpec:
    _ensure_builtin()
    if name in _REGISTRY:
        return _REGISTRY[name]
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"dataset {name!r} is not ported to mdgan_tpu_torch yet: "
            f"{_NOT_PORTED[name]}")
    raise KeyError(f"unknown dataset {name!r}; available: {sorted(_REGISTRY)}")


def _ensure_builtin() -> None:
    """Import the built-in dataset module, which registers on first import."""
    from mdgan_tpu_torch.data import builtin  # noqa: F401
