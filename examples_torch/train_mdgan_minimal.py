"""Minimal MD-GAN training through the port's library API (no CLI).

Trains 1 generator against 8 discriminators on CIFAR-10 (a synthetic
stand-in if the raw files are absent) for 500 rounds on the card, swaps
every 250 rounds, and writes a 64-sample grid.

    python examples_torch/train_mdgan_minimal.py

Every knob has a flag with the defaults above, so the same file doubles as a
tiny smoke run on the CPU:

    python examples_torch/train_mdgan_minimal.py --device cpu --dataset SyntheticMNIST \\
        --rounds 10 --chunk_size 5 --num_workers 2 --batch_size 2

(the port of ``examples/train_mdgan_minimal.py``).
"""

import argparse

import numpy as np

from mdgan_tpu_torch.core.config import TrainConfig
from mdgan_tpu_torch.core.registry import get as get_dataset
from mdgan_tpu_torch.data.partitioner import shard_data
from mdgan_tpu_torch.data.sampler import ShardSampler
from mdgan_tpu_torch.engine.mdgan import MDGANEngine
from mdgan_tpu_torch.obs.images import save_image_grid
from mdgan_tpu_torch.ops.losses import denormalize_to_unit


def main():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dataset", default="CIFAR10")
    p.add_argument("--rounds", type=int, default=500)
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--batch_size", type=int, default=10)
    p.add_argument("--chunk_size", type=int, default=100)
    p.add_argument("--swap_interval", type=int, default=250)
    p.add_argument("--compute_dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--out", default="mdgan_samples.png")
    p.add_argument("--device", default=None, help="torch device (default cuda)")
    args = p.parse_args()

    n_workers = args.num_workers
    cfg = TrainConfig(batch_size=args.batch_size, chunk_size=args.chunk_size,
                      swap_interval=args.swap_interval, compute_dtype=args.compute_dtype,
                      device=args.device)
    spec = get_dataset(args.dataset)
    data, _ = spec.load("data")
    shards_np, _ = shard_data(data, n_workers, iid=True, seed=0)

    engine = MDGANEngine(spec, cfg, num_workers=n_workers)
    state = engine.init_state(seed=1)
    shards = engine.shard_data(shards_np)
    sampler = ShardSampler(n_workers, shards_np.shape[1], cfg.batch_size, seed=0)
    swap_rng = np.random.default_rng(1)

    for _ in range(0, args.rounds, cfg.chunk_size):
        metrics = engine.run_rounds(state, shards, sampler, cfg.chunk_size)
        step = state.step
        print(f"round {step:4d}  d_loss={float(metrics['mean_d_loss'][-1].mean()):.4f}  "
              f"g_feedback_loss={float(metrics['g_feedback_loss'][-1].mean()):.4f}")
        if step % cfg.swap_interval == 0:
            engine.swap(state, engine.sample_swap_perm(swap_rng))
            print("  swapped discriminator pairs")

    fakes = engine.sample(state.g, 64, seed=7)
    save_image_grid(denormalize_to_unit(fakes.float()).permute(0, 2, 3, 1).cpu().numpy(),
                    args.out, nrow=8)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
