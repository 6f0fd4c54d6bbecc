"""mdgan_tpu_torch — the MD-GAN framework on PyTorch and CUDA (NVIDIA Hopper).

A port of ``mdgan_tpu`` (the JAX/TPU package beside it, which stays the
reference): one generator trained against N discriminators, each on its own
shard of the data, with image-gradient error feedback aggregated into the
generator step and periodic discriminator swaps.

Models are NCHW ``nn.Module``s with OIHW weights.  The two Pallas kernels of
the JAX package (fused Adam, uint8 gather + normalize) are hand-written CUDA
kernels here (``csrc/``), built with ``nvcc`` on first use and bound with
``ctypes``; on a CUDA device they are the only implementation, and their
plain PyTorch versions run only for CPU tensors.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no GPU present they raise.  Under ``python -m torch.distributed.run`` the
MD-GAN run shards its discriminators over the ranks, one process a GPU.

Layout (mirrors ``mdgan_tpu``):
    core/      config dataclasses, dataset registry, random lanes, device choice,
               the rank layout and the process group
    data/      MNIST / CIFAR-10 / CelebA / FFHQ-128 / synthetic loaders (a C++
               host decoder and threaded gather in native/), partitioner,
               sampler, checksum-verified downloads
    models/    DCGAN-32, MLP-GAN, DCGAN-64, StyleGAN2, flax-convention
               BatchNorm, JAX weight import/export, reference torch
               checkpoint interop
    ops/       losses and the CUDA kernel wrappers (+ their build)
    engine/    arena-backed network state, the MD-GAN and standalone rounds,
               the trainers (host loop, evals, exports, checkpoints)
    metrics/   InceptionV3, FID and IS
    obs/       span CSVs, image grids, host monitor
    parallel/  discriminator swaps across ranks (gather and pair)
    utils/     checkpoints and weight exports
    cli/       train, generate, convert_weights, analyze, Inception weight
               conversion

This package imports neither JAX nor any module of ``mdgan_tpu``.
"""

__version__ = "0.1.0"


def __getattr__(name):
    """Lazy convenience exports (kept lazy so ``import mdgan_tpu_torch`` is cheap)."""
    lazy = {
        "TrainConfig": "mdgan_tpu_torch.core.config",
        "DataConfig": "mdgan_tpu_torch.core.config",
        "MeshConfig": "mdgan_tpu_torch.core.config",
        "RunConfig": "mdgan_tpu_torch.core.config",
        "MDGANEngine": "mdgan_tpu_torch.engine.mdgan",
        "StandaloneEngine": "mdgan_tpu_torch.engine.standalone",
        "MDGANTrainer": "mdgan_tpu_torch.engine.train_loop",
        "StandaloneTrainer": "mdgan_tpu_torch.engine.train_loop",
        "get_dataset": "mdgan_tpu_torch.core.registry",
    }
    if name in lazy:
        import importlib

        module = importlib.import_module(lazy[name])
        return getattr(module, "get" if name == "get_dataset" else name)
    raise AttributeError(name)
