"""Convert torchvision InceptionV3 weights to the npz format metrics/ loads.

Port of ``mdgan_tpu/cli/convert_inception.py``: the same npz (torch
state-dict keys, aux logits and ``num_batches_tracked`` left out), verified
by loading it into ``mdgan_tpu_torch/metrics/inception.py``.

The package fetches no weights.  Users with a torchvision checkpoint
(``inception_v3_google-*.pth``) can convert it once and drop the result at
``data/inception_v3.npz``; FID/IS then run with pretrained features
and are literature-comparable (see metrics/inception.py).

Usage:
    python -m mdgan_tpu_torch.cli.convert_inception inception_v3_google.pth \
        --out data/inception_v3.npz
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def convert(pth_path: str, out_path: str) -> int:
    import torch

    state = torch.load(pth_path, map_location="cpu", weights_only=True)
    if hasattr(state, "state_dict"):
        state = state.state_dict()
    arrays = {}
    skipped = []
    for key, tensor in state.items():
        if key.startswith("AuxLogits") or key.endswith("num_batches_tracked"):
            skipped.append(key)
            continue
        arrays[key] = tensor.numpy().astype(np.float32)
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    np.savez(out_path, **arrays)
    print(f"wrote {out_path}: {len(arrays)} tensors "
          f"({sum(a.size for a in arrays.values())/1e6:.1f}M params, "
          f"{len(skipped)} aux/bookkeeping entries skipped)")
    # sanity-load through the metrics stack (load_state_dict is strict)
    from mdgan_tpu_torch.metrics import inception

    _, source = inception.get_inception(out_path)
    print(f"verified: feature source = {source}")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("pth", help="torchvision inception_v3 .pth state dict")
    p.add_argument("--out", default="data/inception_v3.npz")
    args = p.parse_args(argv)
    return convert(args.pth, args.out)


if __name__ == "__main__":
    raise SystemExit(main())
