"""MD-GAN over the rank mesh: workers sharded, optional replica and tensor axes.

Every rank runs this same script under ``torch.distributed.run``, one rank a
card; with ``--device cpu`` the ranks run on the CPU over gloo, a dry run
anywhere:

    python -m torch.distributed.run --standalone --nproc_per_node 8 \\
        examples_torch/multichip_mesh.py --device cpu
    python -m torch.distributed.run --standalone --nproc_per_node 4 \\
        examples_torch/multichip_mesh.py --device cpu --num_replicas 2 --num_tensor 2

Rank 0 prints the (replica, workers, tensor) layout of ``core/mesh.py``,
then three chunks' losses and a swap.  Ranks past the mesh are idle and
exit 0.  (The port of ``examples/multichip_mesh.py``, whose ``--force_cpu``
becomes ``--device cpu``.)
"""

import argparse

import numpy as np


def main():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' runs the ranks over gloo)")
    p.add_argument("--num_workers", type=int, default=None)
    p.add_argument("--num_replicas", type=int, default=1)
    p.add_argument("--num_tensor", type=int, default=1,
                   help="generator tensor parallelism (column-sharded G params and "
                        "Adam moments over a third mesh axis)")
    args = p.parse_args()

    from mdgan_tpu_torch.core import distributed
    from mdgan_tpu_torch.core.config import TrainConfig
    from mdgan_tpu_torch.core.mesh import rank_layout
    from mdgan_tpu_torch.core.registry import get as get_dataset
    from mdgan_tpu_torch.data.partitioner import shard_data
    from mdgan_tpu_torch.data.sampler import ShardSampler
    from mdgan_tpu_torch.engine.mdgan import MDGANEngine

    joined = distributed.maybe_initialize(args.device)
    try:
        n_dev = distributed.world_size()
        n_workers = args.num_workers or max(1, n_dev // (args.num_replicas * args.num_tensor))
        layout = rank_layout(n_workers, args.num_replicas, args.num_tensor)
        r, w, t = layout.shape
        if layout.is_main:
            print(f"devices: {n_dev}, mesh: {dict(replica=r, workers=w, tensor=t)}, "
                  f"workers: {n_workers}", flush=True)
        if layout.idle:
            return

        cfg = TrainConfig(batch_size=4, chunk_size=10, compute_dtype="float32",
                          device=args.device)
        spec = get_dataset("SyntheticMNIST")
        data, _ = spec.load("data", max_examples=max(256, n_workers * 16))
        shards_np, _ = shard_data(data, n_workers, iid=True, seed=0)

        engine = MDGANEngine(spec, cfg, num_workers=n_workers, layout=layout)
        state = engine.init_state(seed=0)
        shards = engine.shard_data(shards_np)
        sampler = ShardSampler(n_workers, shards_np.shape[1], cfg.batch_size, seed=0)

        for _ in range(3):
            metrics = engine.run_rounds(state, shards, sampler, cfg.chunk_size)
            if layout.is_main:
                print(f"round {state.step:3d}  "
                      f"d_loss={float(metrics['mean_d_loss'][-1].mean()):.4f}", flush=True)

        if n_workers % 2 == 0 and n_workers > 1:
            engine.swap(state, engine.sample_swap_perm(np.random.default_rng(0)))
            if layout.is_main:
                print("swap OK (point to point with one worker a rank, gather otherwise)")
    finally:
        if joined:
            distributed.shutdown()


if __name__ == "__main__":
    main()
