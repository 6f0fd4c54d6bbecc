"""Training CLI (port of ``mdgan_tpu/cli/train.py:28-206``).

The same flag surface as the JAX CLI, plus ``--device`` (default ``cuda``;
``--device cpu`` runs the plain PyTorch versions of the kernels).
``--mode mdgan`` runs ``MDGANTrainer`` and ``--mode standalone``
``StandaloneTrainer`` (``engine/train_loop.py``), as
``mdgan_tpu/cli/train.py:179-201`` does: span CSVs under ``--log_dir``,
image grids under ``--image_dir``, npz weight exports under
``--weights_dir``, full-state checkpoints under ``--checkpoint_dir``
(``--resume`` continues from the latest), FID/IS at every log event.  It
prints one JSON line of metrics per log event and ends with a JSON summary.

Usage:
    python -m mdgan_tpu_torch.cli.train --mode mdgan --dataset CIFAR10 \
        --num_workers 8 --batch_size 10 --epochs 30000 --swap_interval 5000
    python -m mdgan_tpu_torch.cli.train --mode standalone --dataset CIFAR10 \
        --batch_size 10 --epochs 30000

On several cards, one process a card, the N discriminators sharded over them
(N/W each; NCCL, or gloo with ``--device cpu``):
    python -m torch.distributed.run --standalone --nproc_per_node <cards> \
        -m mdgan_tpu_torch.cli.train --mode mdgan --num_workers 8 ...
Rank 0 prints and writes every file; ``--swap_impl ppermute`` (or ``auto``
with one worker a rank) swaps discriminators point to point.

``--moment_dtype bfloat16`` keeps the Adam moments in bfloat16 (optax's
rounding, through the bf16-moment CUDA kernel); ``--straggler_rate r`` drops
each worker's feedback with probability r a round, keeping at least one, and
averages the generator's step over the kept ones (``n_feedbacks`` column).

Flags that name TPU machinery (``--scan_unroll``, ``--no_pallas``,
``--fused_adam``, ``--pallas_sampling``) are accepted and change nothing: on
a CUDA device Adam and sampling always run through the CUDA kernels.
``--profile_dir`` writes a ``torch.profiler`` trace of the first chunks
(``trace.json``); ``--host_metrics`` samples host cpu/mem/net to a CSV.
``--download`` fetches MNIST or CIFAR-10 into ``--data_dir`` first,
checksum-verified (``data/download.py``); CIFAR-10 is also read from its
binary batches, ``<data_dir>/cifar10/cifar-10-batches-bin/data_batch_*.bin``.
"""

from __future__ import annotations

import argparse
import json
import logging
from pathlib import Path

from mdgan_tpu_torch.core import distributed
from mdgan_tpu_torch.core.config import (
    DataConfig, MeshConfig, OptimizerConfig, RunConfig, TrainConfig,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--mode", choices=["mdgan", "standalone"], default="mdgan")
    p.add_argument("--dataset", type=str, default="CIFAR10")
    p.add_argument("--num_workers", type=int, default=8,
                   help="number of discriminators N (reference world_size - 1)")
    p.add_argument("--num_replicas", type=int, default=1)
    p.add_argument("--num_tensor", type=int, default=1)
    p.add_argument("--epochs", type=int, default=30000,
                   help="training rounds (single-batch steps, reference naming)")
    p.add_argument("--swap_interval", type=int, default=5000)
    p.add_argument("--local_epochs", type=int, default=1)
    p.add_argument("--batch_size", type=int, default=10)
    p.add_argument("--log_interval", type=int, default=300)
    p.add_argument("--checkpoint_interval", type=int, default=3000)
    p.add_argument("--generator_lr", type=float, default=2e-4)
    p.add_argument("--discriminator_lr", type=float, default=2e-4)
    p.add_argument("--iid", type=int, default=1)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--beta_1", type=float, default=0.0)
    p.add_argument("--beta_2", type=float, default=0.999)
    p.add_argument("--moment_dtype", choices=["float32", "bfloat16"], default="float32")
    p.add_argument("--n_samples", type=int, default=5)
    p.add_argument("--eval_n_samples", type=int, default=0)
    p.add_argument("--eval_standard_interval", type=int, default=1)
    p.add_argument("--data_dir", type=str, default="data")
    p.add_argument("--download", action="store_true")
    p.add_argument("--max_examples", type=int, default=None)
    p.add_argument("--chunk_size", type=int, default=100,
                   help="most rounds per chunk (one real-batch gather each)")
    p.add_argument("--metrics_flush", type=int, default=8)
    p.add_argument("--scan_unroll", type=int, default=1)
    p.add_argument("--compute_dtype", choices=["bfloat16", "float32"], default="bfloat16")
    p.add_argument("--no_pallas", action="store_true")
    p.add_argument("--fused_adam", action="store_true")
    p.add_argument("--pallas_sampling", action="store_true")
    p.add_argument("--swap_impl", choices=["auto", "gather", "ppermute"], default="auto")
    p.add_argument("--straggler_rate", type=float, default=0.0)
    p.add_argument("--sync_eval", action="store_true")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--profile_dir", type=str, default=None)
    p.add_argument("--host_metrics", type=str, default=None)
    p.add_argument("--log_dir", type=str, default="logs")
    p.add_argument("--image_dir", type=str, default="saved_images")
    p.add_argument("--weights_dir", type=str, default="weights")
    p.add_argument("--checkpoint_dir", type=str, default="checkpoints")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default cuda; 'cpu' runs the kernels' "
                        "plain PyTorch versions)")
    return p


# flags whose feature waits for a later slice -> the ROADMAP item
_NOT_PORTED = [
    (lambda a: a.num_replicas > 1 or a.num_tensor > 1,
     "--num_replicas/--num_tensor > 1", "ROADMAP.md A.8b"),
]
# chunks of the run that --profile_dir traces, after one warm-up chunk
_PROFILED_CHUNKS = 3


def config_from_args(args: argparse.Namespace) -> RunConfig:
    for pred, what, item in _NOT_PORTED:
        if pred(args):
            raise NotImplementedError(f"{what} is not ported to mdgan_tpu_torch yet ({item})")

    def opt(lr):
        return OptimizerConfig(lr=lr, beta_1=args.beta_1, beta_2=args.beta_2,
                               mu_dtype=args.moment_dtype, nu_dtype=args.moment_dtype)

    train = TrainConfig(
        batch_size=args.batch_size, epochs=args.epochs, local_epochs=args.local_epochs,
        swap_interval=args.swap_interval, log_interval=args.log_interval,
        checkpoint_interval=args.checkpoint_interval, seed=args.seed,
        generator_opt=opt(args.generator_lr), discriminator_opt=opt(args.discriminator_lr),
        chunk_size=args.chunk_size, metrics_flush=args.metrics_flush,
        scan_unroll=args.scan_unroll, compute_dtype=args.compute_dtype,
        use_pallas=not args.no_pallas, fused_adam=args.fused_adam,
        pallas_sampling=args.pallas_sampling, swap_impl=args.swap_impl,
        straggler_rate=args.straggler_rate, n_samples=args.n_samples,
        eval_n_samples=args.eval_n_samples,
        eval_standard_interval=args.eval_standard_interval,
        async_eval=not args.sync_eval, log_dir=args.log_dir, image_dir=args.image_dir,
        weights_dir=args.weights_dir, checkpoint_dir=args.checkpoint_dir,
        resume=args.resume, device=args.device,
    )
    data = DataConfig(dataset=args.dataset, data_dir=args.data_dir,
                      iid=args.iid == 1, max_examples=args.max_examples)
    mesh = MeshConfig(num_workers=args.num_workers, num_replicas=args.num_replicas,
                      num_tensor=args.num_tensor)
    return RunConfig(train=train, data=data, mesh=mesh, mode=args.mode)


def _profiler(profile_dir: str):
    """A ``torch.profiler`` over the first chunks, written as
    ``<profile_dir>/trace.json`` (the ``jax.profiler`` trace of the JAX CLI)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    out = Path(profile_dir)
    out.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities,
                   schedule=schedule(wait=0, warmup=1, active=_PROFILED_CHUNKS, repeat=1),
                   on_trace_ready=lambda p: p.export_chrome_trace(str(out / "trace.json")))


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s - %(message)s")
    args = build_parser().parse_args(argv)
    # join torch.distributed.run's process group first (mdgan_tpu/cli/train.py
    # calls maybe_initialize first too); a no-op in a single process
    joined = distributed.maybe_initialize(args.device)
    try:
        return _run(args)
    finally:
        if joined:
            distributed.shutdown()


def _run(args: argparse.Namespace) -> int:
    cfg = config_from_args(args)
    if args.download:  # every rank: the fetch and the extraction are atomic
        from mdgan_tpu_torch.data.download import ensure_dataset

        ensure_dataset(args.dataset, args.data_dir)
    from mdgan_tpu_torch.engine.train_loop import MDGANTrainer, StandaloneTrainer

    monitor = None
    if args.host_metrics:
        from mdgan_tpu_torch.obs.hostmon import HostMonitor

        monitor = HostMonitor(args.host_metrics).start()
    prof = _profiler(args.profile_dir) if args.profile_dir else None
    try:
        trainer = MDGANTrainer(cfg) if cfg.mode == "mdgan" else StandaloneTrainer(cfg)
        try:
            if prof is not None:
                prof.start()
            summary = trainer.train(on_chunk=prof.step if prof is not None else None)
        finally:
            trainer.close()
            if prof is not None:
                prof.stop()
    finally:
        if monitor is not None:
            monitor.stop()
    if distributed.is_main():
        print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
