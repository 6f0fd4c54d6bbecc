"""Dataset/model registry (port of ``mdgan_tpu/core/registry.py``).

Its own :class:`DatasetSpec`, :func:`register` and :func:`get`: the JAX
registry imports its built-ins, which pull in flax.  The port registers the
JAX package's six datasets (``data/builtin.py``): ``MNIST`` and
``SyntheticMNIST`` (MLP-GAN), ``CIFAR10`` and ``Synthetic32`` (DCGAN-32),
``CelebA`` (DCGAN-64) and ``FFHQ128`` (StyleGAN2); and its own
``LSUNChurch256`` (StyleGAN2 config-f).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    """Everything the engine needs to train on a dataset.

    ``shape`` is the stored image shape (H, W, C) of the uint8 data (the
    loaders return NHWC bytes, as in the JAX package); the models take NCHW.
    ``make_generator``/``make_discriminator`` build ``nn.Module``s; the
    width keywords each accepts are named in ``g_widths``/``d_widths`` (the
    engines pass those of their ``model_kwargs``).  ``init_weights(module,
    gen)`` draws a module's weights in place from a ``torch.Generator``
    (None: the DCGAN init, ``models/layers.py:dcgan_init_``).
    """

    name: str
    shape: Tuple[int, int, int]
    z_dim: int
    make_generator: Callable[..., object]
    make_discriminator: Callable[..., object]
    load: Callable[..., Tuple[object, object]]
    init_weights: Optional[Callable[..., object]] = None
    g_widths: Tuple[str, ...] = ("ngf",)
    d_widths: Tuple[str, ...] = ("ndf",)


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
    raise KeyError(f"unknown dataset {name!r}; available: {sorted(_REGISTRY)}")


def _ensure_builtin() -> None:
    """Import the built-in dataset module, which registers on first import."""
    from mdgan_tpu_torch.data import builtin  # noqa: F401
