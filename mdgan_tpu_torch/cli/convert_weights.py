"""Convert reference torch checkpoints to npz weights and back.

Port of ``mdgan_tpu/cli/convert_weights.py:1-86``.  The reference's trained
artifacts are plain ``torch.save(state_dict())`` files; the npz side is the
flax-named weights export that both packages read and write
(``utils/checkpoint.save_weights_only``, ``models/from_jax.load_npz``).  The
direction is inferred from the extensions, ``.pt``/``.pth`` <-> ``.npz``:

    # import a reference checkpoint (torch -> npz); feed cli.generate with it
    python -m mdgan_tpu_torch.cli.convert_weights --dataset CIFAR10 \\
        --role generator --input generator.pt --out generator.npz
    python -m mdgan_tpu_torch.cli.generate --dataset CIFAR10 --weights generator.npz

    # export npz weights for the reference's tooling (npz -> torch)
    python -m mdgan_tpu_torch.cli.convert_weights --dataset CIFAR10 \\
        --role generator --input weights/generator_final.npz --out generator.pt

Converted trees are checked against the port's own model (keys and shapes)
unless ``--no_validate``.  Weights only: optimizer moments are in neither
format.  Runs on the host; no device is used.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from mdgan_tpu_torch.models import from_jax
from mdgan_tpu_torch.models.torch_interop import (flax_to_torch, torch_to_flax,
                                                  validate_against_model)
from mdgan_tpu_torch.utils.checkpoint import save_weights_only

TORCH_EXTS = {".pt", ".pth"}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dataset", required=True, help="registry name: MNIST | CIFAR10 | CelebA")
    p.add_argument("--role", required=True, choices=["generator", "discriminator"])
    p.add_argument("--input", required=True,
                   help="source checkpoint (.pt/.pth = torch, .npz = weights export)")
    p.add_argument("--out", required=True, help="destination (the opposite format)")
    p.add_argument("--no_validate", action="store_true",
                   help="skip structural validation against the model")
    args = p.parse_args(argv)

    src, dst = Path(args.input), Path(args.out)
    if src.suffix in TORCH_EXTS and dst.suffix == ".npz":
        sd = torch.load(src, map_location="cpu", weights_only=True)
        params, stats = torch_to_flax(sd, args.dataset, args.role)
        if not args.no_validate:
            validate_against_model(params, stats, args.dataset, args.role)
        save_weights_only(dst, params, stats or None)
        print(f"wrote {dst} ({len(sd)} torch keys -> npz)")
    elif src.suffix == ".npz" and dst.suffix in TORCH_EXTS:
        params, stats = from_jax.load_npz(src)
        if not args.no_validate:
            validate_against_model(params, stats, args.dataset, args.role)
        sd = flax_to_torch(params, stats, args.dataset, args.role)
        dst.parent.mkdir(parents=True, exist_ok=True)
        torch.save({k: torch.tensor(np.asarray(v)) for k, v in sd.items()}, dst)
        print(f"wrote {dst} ({len(sd)} torch keys)")
    else:
        p.error(f"cannot infer direction from {src.suffix!r} -> {dst.suffix!r}"
                f" (expected .pt/.pth <-> .npz)")


if __name__ == "__main__":
    main()
