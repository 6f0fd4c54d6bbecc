"""The full MDGANTrainer over ranks: run this SAME script as every rank.

The reference scaled across machines by launching its script with other
rank subsets on each machine, meeting at a TCP rendezvous (reference
``run-distributed.sh:5-11``, ``bootstrap.py:57-68``).  Here every rank runs
the identical program: ``torch.distributed`` joins them, the trainer runs the
sharded round in lockstep, and rank 0 alone writes the CSVs, evals, grids,
weight exports and checkpoints.

On one host, one rank a card:

    python -m torch.distributed.run --standalone --nproc_per_node 8 \\
        examples_torch/multihost_trainer.py

Across hosts, give every process the same rendezvous and its own rank:

    MASTER_ADDR=host0 MASTER_PORT=1234 WORLD_SIZE=2 RANK=0 LOCAL_RANK=0 \\
        python examples_torch/multihost_trainer.py     # on host 0
    MASTER_ADDR=host0 MASTER_PORT=1234 WORLD_SIZE=2 RANK=1 LOCAL_RANK=0 \\
        python examples_torch/multihost_trainer.py     # on host 1

(the port of ``examples/multihost_trainer.py``).
"""

import json
import sys

from mdgan_tpu_torch.core import distributed

# The headline experiment config; any flag can be overridden from the command
# line (argparse keeps the LAST occurrence, so trailing sys.argv wins), e.g.
# ``--epochs 100 --log_interval 0 --device cpu`` for a short run.
DEFAULT_ARGV = [
    "--mode", "mdgan", "--dataset", "CIFAR10", "--num_workers", "8",
    "--epochs", "30000", "--batch_size", "10", "--swap_interval", "5000",
    "--log_interval", "300",
]


def main() -> None:
    from mdgan_tpu_torch.cli.train import build_parser, config_from_args
    from mdgan_tpu_torch.core.mesh import rank_layout
    from mdgan_tpu_torch.engine.train_loop import MDGANTrainer

    args = build_parser().parse_args(DEFAULT_ARGV + sys.argv[1:])
    joined = distributed.maybe_initialize(args.device)
    try:
        cfg = config_from_args(args)
        layout = rank_layout(cfg.mesh.num_workers, cfg.mesh.num_replicas, cfg.mesh.num_tensor)
        if layout.idle:  # a rank past the mesh holds no worker
            return
        trainer = MDGANTrainer(cfg, layout)
        try:
            summary = trainer.train()
        finally:
            trainer.close()
        if distributed.is_main():
            print(json.dumps(summary), flush=True)
    finally:
        if joined:
            distributed.shutdown()


if __name__ == "__main__":
    main()
