"""Sample-generation CLI — the reference's ``src/gen_images.ipynb`` as a command.

Port of ``mdgan_tpu/cli/generate.py:1-116``.  Loads a generator (a weights
npz written by either package, or the generator of one of the port's
training checkpoints), samples latents, and writes an image grid; with
``--filmstrip`` it renders one sample per weights export into a
training-progress strip.

Usage:
    python -m mdgan_tpu_torch.cli.generate --dataset CIFAR10 \\
        --weights weights/generator_final.npz --num 100 --out grid.png
    python -m mdgan_tpu_torch.cli.generate --dataset CIFAR10 \\
        --weights_glob 'weights/generator_*.npz' --filmstrip progress.png
    python -m mdgan_tpu_torch.cli.generate --dataset CIFAR10 \\
        --checkpoint checkpoints/mdgan.8.CIFAR10 --num 64 --out grid.png

``--checkpoint`` reads the port's ``ckpt_<step>.pt`` files
(``utils/checkpoint.py``; the latest step unless ``--step``), of either
trainer mode.  The forward runs with train-mode BatchNorm, as JAX's
``_sample`` (``generate.py:33-37``) and the trainers' samples do, and leaves
the generator's stored statistics as they were.  Latents, then a config-f
generator's noise inputs, come from the port's EVAL lane seeded by
``--seed``, so a seed gives the same images on every run (JAX's threefry
draws cannot be reproduced; :func:`sample_images` takes injected latents
instead).
``--device`` defaults to ``cuda``.
"""

from __future__ import annotations

import argparse
import glob
import re
from pathlib import Path
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from mdgan_tpu_torch.core import prng
from mdgan_tpu_torch.core.config import resolve_device
from mdgan_tpu_torch.core.registry import DatasetSpec, get as get_spec
from mdgan_tpu_torch.engine.mdgan import generate_kept, sample_generator
from mdgan_tpu_torch.models import from_jax
from mdgan_tpu_torch.obs import images as images_lib
from mdgan_tpu_torch.ops import losses
from mdgan_tpu_torch.utils import checkpoint as ckpt_lib


def latents(spec: DatasetSpec, num: int, seed: int, device) -> torch.Tensor:
    """``num`` latents from lane (EVAL, seed) on ``device``: the latents
    :func:`sample_images` draws for ``seed``."""
    return torch.randn(num, spec.z_dim, generator=_lane(seed, device), device=device)


def _lane(seed: int, device) -> torch.Generator:
    return prng.generator(seed, prng.EVAL, 0, device=device)


def load_generator(spec: DatasetSpec, params: Mapping, stats: Mapping,
                   device) -> torch.nn.Module:
    """The dataset's generator with flax-named (params, stats), in train mode."""
    return from_jax.load_into(spec.make_generator(), params, stats).to(device).train()


def _images(x: torch.Tensor) -> np.ndarray:
    return losses.denormalize_to_unit(x).permute(0, 2, 3, 1).float().cpu().numpy()


def sample(g: torch.nn.Module, z: torch.Tensor) -> np.ndarray:
    """G(z) of a generator that takes no noise, in train-mode BN, as (num,
    H, W, C) float32 images in [0, 1]; G's stored statistics are left as
    they were (``engine/mdgan.py`` :func:`generate_kept`)."""
    return _images(generate_kept(g, [z]))


def sample_images(spec: DatasetSpec, params: Mapping, stats: Mapping, num: int, seed: int,
                  device="cuda", z: Optional[torch.Tensor] = None) -> np.ndarray:
    """``num`` images from the generator with (params, stats): its latents
    and any noise inputs from lane (EVAL, seed) (``engine/mdgan.py``
    :func:`sample_generator`), or G(``z``) where ``z`` is given."""
    device = resolve_device(device)
    g = load_generator(spec, params, stats, device)
    if z is not None:
        return sample(g, z.to(device))
    return _images(sample_generator(g, num, spec.z_dim, _lane(seed, device)))


def load_from_checkpoint(directory: str, step: Optional[int]) -> Tuple[Dict, Dict]:
    """The generator's (params, stats) out of a port training checkpoint;
    both trainer modes store it as ``nets.g``."""
    payload, step = ckpt_lib.load_payload(directory, step)
    trees = ckpt_lib.net_trees(payload["nets"]["g"])
    print(f"loaded generator from step {step} of {directory}")
    return trees["params"], trees["batch_stats"]


def _epoch_of(path: str) -> int:
    found = re.findall(r"(\d+)", Path(path).stem)
    return int(found[-1]) if found else -1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dataset", type=str, default="CIFAR10")
    p.add_argument("--weights", type=str, default=None,
                   help="single generator npz (save_weights_only format)")
    p.add_argument("--weights_glob", type=str, default=None,
                   help="glob over generator_<epoch>.npz for --filmstrip")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="a training checkpoint directory of the port (e.g. "
                        "checkpoints/mdgan.8.CIFAR10); samples from the generator "
                        "of its latest (or --step) checkpoint")
    p.add_argument("--step", type=int, default=None,
                   help="checkpoint step to load (default: latest)")
    p.add_argument("--num", type=int, default=100)
    p.add_argument("--nrow", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", type=str, default="generated_grid.png")
    p.add_argument("--filmstrip", type=str, default=None,
                   help="output path for the per-epoch progress strip")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default cuda)")
    args = p.parse_args(argv)

    spec = get_spec(args.dataset)
    device = resolve_device(args.device)

    if args.filmstrip:
        paths = sorted(glob.glob(args.weights_glob or "weights/generator_*.npz"),
                       key=_epoch_of)
        if not paths:
            raise FileNotFoundError(f"no weights matched {args.weights_glob}")
        frames = [sample_images(spec, *from_jax.load_npz(path), 1, args.seed, device)[0]
                  for path in paths]
        images_lib.save_image_grid(np.stack(frames), args.filmstrip, nrow=len(frames))
        print(f"wrote {args.filmstrip} ({len(frames)} frames)")
        return 0

    if args.checkpoint:
        params, stats = load_from_checkpoint(args.checkpoint, args.step)
    elif args.weights:
        params, stats = from_jax.load_npz(args.weights)
    else:
        raise SystemExit("--weights or --checkpoint is required (or use --filmstrip)")
    imgs = sample_images(spec, params, stats, args.num, args.seed, device)
    images_lib.save_image_grid(imgs, args.out, nrow=args.nrow)
    print(f"wrote {args.out} ({args.num} samples)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
