"""Configuration dataclasses (copy of ``mdgan_tpu/core/config.py:1-219``).

Same dataclasses, field names, defaults and :func:`k_batches` as the JAX
package, so a flag means the same thing on both sides.  Added: ``device`` on
:class:`TrainConfig` (``None`` means ``cuda``) and :func:`resolve_device`.

Fields that name TPU machinery keep their names for compatibility but change
meaning here: on a CUDA device Adam and the real-batch sampling ALWAYS run
through the CUDA kernels of ``ops/`` whatever ``use_pallas``, ``fused_adam``
and ``pallas_sampling`` say; ``scan_unroll`` and ``donate`` have no effect
on an eager PyTorch run.  ``chunk_size`` means what it means in JAX: the most
rounds the host loop runs as one chunk, here the span of one real-batch
gather (one sampling launch per chunk); ``metrics_flush`` is the number of
chunks whose losses the worker-CSV writer fetches in one copy.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """Adam hyperparameters (``mdgan_tpu/core/config.py:17-39``).

    Defaults are the reference's effective values: lr 2e-4, betas
    (0.0, 0.999), eps 1e-8 (torch.optim.Adam's eps).
    """

    lr: float = 2e-4
    beta_1: float = 0.0
    beta_2: float = 0.999
    eps: float = 1e-8
    # Storage dtypes of the Adam moments, "float32" or "bfloat16"; the CLI's
    # --moment_dtype sets both (mdgan_tpu/cli/train.py:129-137), and the
    # port's kernels take them only together.
    mu_dtype: str = "float32"
    nu_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Dataset selection and partitioning (``mdgan_tpu/core/config.py:42-59``)."""

    dataset: str = "CIFAR10"
    data_dir: str = "data"
    iid: bool = True
    # "synthetic" substitutes deterministic procedural data when the raw
    # files are absent; "error" raises.
    fallback: str = "synthetic"
    max_examples: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device layout (``mdgan_tpu/core/config.py:62-88``).

    ``num_workers`` is N, the number of discriminators.  Under
    ``torch.distributed`` the ranks form the (replica, workers, tensor) mesh
    of ``core/mesh.py``: N/W discriminators a worker slot, every batch split
    over ``num_replicas`` ranks, the generator over ``num_tensor``.
    ``num_devices`` and the axis names have no effect.
    """

    num_workers: int = 8
    num_devices: Optional[int] = None
    replica_axis: str = "replica"
    worker_axis: str = "workers"
    num_replicas: int = 1
    tensor_axis: str = "tensor"
    num_tensor: int = 1


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """One MD-GAN training run (``mdgan_tpu/core/config.py:91-197``).

    ``epochs`` is the number of rounds, ``local_epochs`` the discriminator
    steps per round, ``swap_interval`` the round period of the discriminator
    swap, ``log_interval`` the period of the printed metrics.
    """

    batch_size: int = 10
    epochs: int = 30000
    local_epochs: int = 1
    swap_interval: int = 5000
    log_interval: int = 300
    seed: int = 1

    generator_opt: OptimizerConfig = dataclasses.field(default_factory=OptimizerConfig)
    discriminator_opt: OptimizerConfig = dataclasses.field(default_factory=OptimizerConfig)

    chunk_size: int = 100
    scan_unroll: int = 1
    # "bfloat16": autocast around the G and D forwards; params, Adam state
    # and the kernels stay float32.  "float32" is the parity path.
    compute_dtype: str = "bfloat16"
    donate: bool = True
    use_pallas: bool = True
    fused_adam: bool = False
    pallas_sampling: bool = False
    metrics_flush: int = 8
    swap_impl: str = "auto"
    # Swap the discriminator Adam moments along with params and BN stats
    # (the reference moves only the state dict).
    swap_opt_state: bool = False
    straggler_rate: float = 0.0

    n_samples: int = 5
    eval_n_samples: int = 0
    eval_standard_interval: int = 1
    async_eval: bool = True

    checkpoint_interval: int = 3000
    log_dir: str = "logs"
    image_dir: str = "saved_images"
    weights_dir: str = "weights"
    checkpoint_dir: str = "checkpoints"
    resume: bool = False

    # Torch device of the run; None means "cuda".
    device: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Top-level bundle: what to train, on what data, over what layout."""

    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    mode: str = "mdgan"


def k_batches(num_workers: int) -> int:
    """Distinct fake batches per round, ``k = max(floor(ln N), 2)``
    (``mdgan_tpu/core/config.py:210-219``)."""
    return max(math.floor(math.log(num_workers)), 2) if num_workers > 0 else 2


def resolve_device(device: Optional[str] = None):
    """The torch device of an entry point: ``cuda`` unless ``device`` says
    otherwise.  Raises when CUDA is asked for (explicitly or by default) and
    no GPU is present — a run never carries on quietly on the CPU."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "mdgan_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' (CLI: --device cpu) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
