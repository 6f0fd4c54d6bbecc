"""Training CLI (port of ``mdgan_tpu/cli/train.py:28-206``).

The same flag surface as the JAX CLI, plus ``--device`` (default ``cuda``;
``--device cpu`` runs the plain PyTorch versions of the kernels).  The host
loop is a minimal port of ``MDGANTrainer.train`` (``engine/train_loop.py``):
rounds in chunks of at most ``--chunk_size``, clipped at swap and log
boundaries as ``train_loop.py:625`` clips them, a pair swap every
``--swap_interval`` rounds from ``np.random.default_rng(seed)``, and one JSON
line of metrics every ``--log_interval`` rounds and at the last round.  It
ends by printing a JSON summary.  A chunk is the span of one real-batch
gather: one sampling launch covers all its rounds.

Usage:
    python -m mdgan_tpu_torch.cli.train --mode mdgan --dataset CIFAR10 \
        --num_workers 8 --batch_size 10 --epochs 30000 --swap_interval 5000

Flags that name TPU machinery (``--scan_unroll``, ``--metrics_flush``,
``--no_pallas``, ``--fused_adam``, ``--pallas_sampling``) are accepted and
change nothing: on a CUDA device Adam and sampling always run through the
CUDA kernels.  Span CSVs, weight exports and checkpoints
(``--log_dir``, ``--weights_dir``, ``--checkpoint_*``) are not written yet
(ROADMAP.md A.2, A.3).
"""

from __future__ import annotations

import argparse
import json
import math
import time

import numpy as np
import torch

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
    (lambda a: a.mode == "standalone", "--mode standalone", "ROADMAP.md A.1"),
    (lambda a: a.num_replicas > 1 or a.num_tensor > 1,
     "--num_replicas/--num_tensor > 1", "ROADMAP.md A.8"),
    (lambda a: a.eval_n_samples > 0 or a.sync_eval, "FID/IS eval", "ROADMAP.md A.4"),
    (lambda a: a.resume, "--resume (checkpoints)", "ROADMAP.md A.3"),
    (lambda a: a.download, "--download", "ROADMAP.md A.9"),
    (lambda a: a.profile_dir or a.host_metrics,
     "--profile_dir/--host_metrics (host loop observability)", "ROADMAP.md A.2"),
]


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


def next_event(cur: int, epochs: int, swap_interval: int, log_interval: int,
               n_workers: int) -> int:
    """Smallest round e >= cur whose end triggers a host event
    (``train_loop.py:54-70``, without checkpoints)."""
    candidates = [epochs - 1]
    if n_workers > 1 and swap_interval > 0:
        nxt = ((cur + swap_interval - 1) // swap_interval) * swap_interval
        candidates.append(nxt if nxt > 0 else swap_interval)
    if log_interval > 0:
        candidates.append(((cur + log_interval - 1) // log_interval) * log_interval)
    return min(c for c in candidates if c >= cur)


def train(cfg: RunConfig) -> dict:
    """Run ``cfg``, printing one JSON metrics line per log event; return
    the summary."""
    from mdgan_tpu_torch.core.registry import get as get_spec
    from mdgan_tpu_torch.data.partitioner import shard_data
    from mdgan_tpu_torch.data.sampler import ShardSampler
    from mdgan_tpu_torch.engine.mdgan import MDGANEngine

    tc, n = cfg.train, cfg.mesh.num_workers
    if tc.chunk_size < 1:
        raise ValueError(f"chunk_size must be at least 1, got {tc.chunk_size}")
    if n > 1 and tc.swap_interval > 0 and n % 2 != 0:
        raise ValueError(f"num_workers={n} must be even when discriminator swaps "
                         "are enabled (set --swap_interval 0 to disable)")
    spec = get_spec(cfg.data.dataset)
    engine = MDGANEngine(spec, tc, n)
    data, _ = spec.load(cfg.data.data_dir, fallback=cfg.data.fallback,
                        max_examples=cfg.data.max_examples)
    # seed 0 == the reference's device_generator.manual_seed(0)
    shards_np, _ = shard_data(data, n, iid=cfg.data.iid, seed=0)
    shards = engine.shard_data(shards_np)
    sampler = ShardSampler(n, shards_np.shape[1], tc.batch_size, seed=0)
    st = engine.init_state(tc.seed)
    swap_rng = np.random.default_rng(tc.seed)

    dev = engine.device
    if dev.type == "cuda":
        from mdgan_tpu_torch.ops import _build

        _build.lib()  # build the kernels before the clock starts
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    cur, swaps, last = 0, 0, {}
    finite = torch.ones((), dtype=torch.bool, device=dev)  # read once, at the end
    while cur < tc.epochs:
        e = next_event(cur, tc.epochs, tc.swap_interval, tc.log_interval, n)
        clen = min(tc.chunk_size, e - cur + 1, tc.epochs - cur)
        m = engine.run_rounds(st, shards, sampler, clen)
        end, cur = cur + clen - 1, cur + clen  # end: the chunk's last round
        for key in ("mean_d_loss", "g_feedback_loss", "feedback_norm"):
            finite &= torch.isfinite(m[key]).all()
        if n > 1 and tc.swap_interval > 0 and end > 0 and end % tc.swap_interval == 0:
            engine.swap(st, engine.sample_swap_perm(swap_rng))
            swaps += 1
        if (tc.log_interval > 0 and end % tc.log_interval == 0) or end == tc.epochs - 1:
            last = {"round": end,
                    "mean_d_loss": float(m["mean_d_loss"][-1].mean()),
                    "g_feedback_loss": float(m["g_feedback_loss"][-1].mean()),
                    "feedback_norm": float(m["feedback_norm"][-1])}
            last["elapsed_s"] = time.perf_counter() - t0  # after the reads synced
            print(json.dumps(last), flush=True)
    all_finite = bool(finite)
    seconds = time.perf_counter() - t0
    return {
        "rounds": tc.epochs, "seconds": seconds,
        "rounds_per_s": tc.epochs / seconds if seconds > 0 else math.inf,
        "swaps": swaps, "all_finite": all_finite,
        "final_mean_d_loss": last.get("mean_d_loss"),
        "final_g_feedback_loss": last.get("g_feedback_loss"),
        "final_feedback_norm": last.get("feedback_norm"),
        "compute_dtype": tc.compute_dtype,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"),
    }


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    summary = train(config_from_args(args))
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
