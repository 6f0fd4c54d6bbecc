"""Benchmark: MD-GAN rounds/s on the card (port of the root ``bench.py``).

    python -m mdgan_tpu_torch.cli.bench [--config headline] [--moment_dtype float32]
    python -m mdgan_tpu_torch.cli.bench --device cpu ...   # the plain versions, on the CPU

The root ``bench.py`` is the JAX package's; this is the port's.  The default
prints ONE JSON line for the headline config: MD-GAN CIFAR-10 with 8
discriminators at the reference's hyperparameters (b=10, ``local_epochs``
1, ``shared-args.sh``), in bfloat16 as JAX's bench runs it.  One "round"
is one MD-GAN round: k fake batches from one G forward, N discriminator
Adam updates on their shards, the error-feedback VJP, the G Adam step.

Timing (``bench.py:153-180``): one warm chunk of ``MDGANEngine.run_rounds``,
then ``timed_chunks`` chunks; the wall time runs from before the first timed
chunk to a host read of the last chunk's ``mean_d_loss``, which waits for
the card, and that value must be finite.  ``--config all`` also times the
other configs, standalone MNIST and the sustained trainer loop, one line
each; ``scaling`` sweeps the worker count; ``--moment_dtype bfloat16`` keeps
the Adam moments in bfloat16.

Baseline: the reference's best measured round rate, 7.63 rounds/s, its
2-worker all-local CPU run (median 0.131 s/round, BASELINE.md).

Utilization: ``flops_per_round`` counts one round of the same config under
``torch.utils.flop_counter.FlopCounterMode`` (convolutions and matrix
products, forward and backward), outside the timed window.  On an H100,
``mfu`` divides the achieved rate by the dense tensor-core peak of the
compute dtype from NVIDIA's H100 SXM data sheet: bfloat16 989 TFLOP/s, and
TF32 494.7 TFLOP/s for float32, whose convolutions cuDNN runs in TF32 by
default.  Elsewhere the line has no peak and no ``mfu``.  JAX's
``bytes_per_round`` and ``hbm_util_analytical`` come from XLA's
fusion-boundary count, which has no counterpart here, so the line has
neither.  Every line carries the card's name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import tempfile
import time
from typing import Dict, Optional

REFERENCE_STEPS_PER_SEC = 7.63  # 2-worker reference, best published rate
BASELINE_SOURCE = "reference 2-worker local run, median 0.131 s/round (BASELINE.md)"

# name -> (dataset, workers, batch, chunk, timed_chunks, max_examples)
# (bench.py:39-49)
CONFIGS = {
    "headline": ("CIFAR10", 8, 10, 500, 6, 50000),
    "mnist4": ("MNIST", 4, 10, 500, 6, 60000),
    "celeba16": ("CelebA", 16, 10, 200, 4, 32000),
    "ffhq128_stylegan": ("FFHQ128", 8, 4, 20, 3, 4000),
    # a batch-size probe, not a parity config: the reference fixes b=10
    "bigbatch": ("CIFAR10", 8, 256, 50, 4, 50000),
}
# the standalone bench: (dataset, batch, chunk, timed_chunks, max_examples)
# (bench.py:203)
STANDALONE = ("MNIST", 128, 500, 6, 60000)
# the scaling sweep's worker counts on the headline config (bench.py:346)
SCALING_WORKERS = (2, 4, 8, 16, 32)

# dense tensor-core peaks of the H100 SXM (NVIDIA data sheet) by compute dtype
H100_PEAK_FLOPS = {"bfloat16": 989e12, "float32": 494.7e12}
FLOPS_COUNTED = ("convolutions and matrix products, forward and backward, of one round "
                 "(torch.utils.flop_counter.FlopCounterMode)")


def card(device) -> Dict:
    """``device`` (the card's name, or "cpu") and ``power_limit_w`` (from
    ``nvidia-smi``'s "name, limit W" line; None on the CPU)."""
    import torch

    from mdgan_tpu_torch.core.timing import card_line

    if device.type != "cuda":
        return {"device": "cpu", "power_limit_w": None}
    line = card_line()
    if line is None or "," not in line:
        raise RuntimeError(f"nvidia-smi gave no power limit: {line!r}")
    return {"device": torch.cuda.get_device_name(device),
            "power_limit_w": float(line.rsplit(",", 1)[1].split()[0])}


def utilization_fields(flops: float, steps_per_sec: float, device_name: str,
                       compute_dtype: str) -> Dict:
    """``flops_per_round`` and what it counts; on an H100 also ``mfu``
    against the dense tensor-core peak of ``compute_dtype``."""
    from mdgan_tpu_torch.core.timing import HBM_BYTES_PER_S

    out = {"flops_per_round": flops, "flops_counted": FLOPS_COUNTED}
    if "H100" in device_name:
        peak = H100_PEAK_FLOPS[compute_dtype]
        out.update(mfu=flops * steps_per_sec / peak, peak_flops_per_sec=peak,
                   peak_hbm_bytes_per_sec=HBM_BYTES_PER_S)
    return out


def round_flops(eng, st, data, sampler) -> float:
    """The FLOPs of one round (``run_rounds(1)``, which advances ``st``)
    as ``FlopCounterMode`` counts them."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        eng.run_rounds(st, data, sampler, 1)
    return float(counter.get_total_flops())


def timed_chunks(eng, st, data, sampler, chunk: int, n_chunks: int) -> float:
    """Wall seconds of ``n_chunks`` chunks of ``chunk`` rounds after a warm
    chunk, up to a host read of the last chunk's ``mean_d_loss``."""
    m = eng.run_rounds(st, data, sampler, chunk)
    m["mean_d_loss"].cpu()
    t0 = time.perf_counter()
    for _ in range(n_chunks):
        m = eng.run_rounds(st, data, sampler, chunk)
    last = m["mean_d_loss"].cpu()  # waits for the whole chain
    dt = time.perf_counter() - t0
    if not bool(last.isfinite().all()):
        raise RuntimeError(f"non-finite mean_d_loss after the timed chunks: {last}")
    return dt


def _setup_mdgan(name: str, moment_dtype: str, compute_dtype: str, device: Optional[str]):
    """(engine, state, device shards, sampler) for a named config
    (``bench.py:108-132``).  JAX's ``scan_unroll=2`` has no counterpart:
    the port's rounds run eagerly."""
    from mdgan_tpu_torch.core.config import OptimizerConfig, TrainConfig
    from mdgan_tpu_torch.core.registry import get as get_spec
    from mdgan_tpu_torch.data.partitioner import shard_data
    from mdgan_tpu_torch.data.sampler import ShardSampler
    from mdgan_tpu_torch.engine.mdgan import MDGANEngine

    dataset, n_workers, batch, chunk, _, max_ex = CONFIGS[name]
    opt = OptimizerConfig(mu_dtype=moment_dtype, nu_dtype=moment_dtype)
    cfg = TrainConfig(batch_size=batch, local_epochs=1, chunk_size=chunk,
                      compute_dtype=compute_dtype, generator_opt=opt,
                      discriminator_opt=opt, device=device)
    spec = get_spec(dataset)  # falls back to synthetic pixels; compute identical
    data, _ = spec.load("data", max_examples=max_ex)
    shards_np, _ = shard_data(data, n_workers, iid=True, seed=0)
    eng = MDGANEngine(spec, cfg, num_workers=n_workers)
    st = eng.init_state(seed=1)
    shards = eng.shard_data(shards_np)
    sampler = ShardSampler(n_workers, shards_np.shape[1], batch, seed=0)
    return eng, st, shards, sampler


def _baseline(steps_per_sec: float) -> Dict:
    return {"vs_baseline": steps_per_sec / REFERENCE_STEPS_PER_SEC,
            "baseline_steps_per_sec": REFERENCE_STEPS_PER_SEC,
            "baseline_source": BASELINE_SOURCE}


def bench_mdgan(name: str, moment_dtype: str = "float32", compute_dtype: str = "bfloat16",
                device: Optional[str] = None) -> Dict:
    """One JSON line for ``CONFIGS[name]`` (``bench.py:153-200``)."""
    dataset, n_workers, batch, chunk, n_chunks, _ = CONFIGS[name]
    eng, st, shards, sampler = _setup_mdgan(name, moment_dtype, compute_dtype, device)
    dt = timed_chunks(eng, st, shards, sampler, chunk, n_chunks)
    steps = n_chunks * chunk
    steps_per_sec = steps / dt
    where = card(eng.device)
    out = {
        "metric": f"mdgan_{dataset.lower()}_{n_workers}worker_steps_per_sec",
        "value": steps_per_sec,
        "unit": "rounds/s",
        # one process runs on one card
        "images_per_sec_per_chip": steps_per_sec * batch * n_workers,
        "batch_size": batch,
        "num_workers": n_workers,
        "device": where["device"],
        "steps_timed": steps,
        "wall_s": dt,
    }
    if moment_dtype != "float32":
        out["moment_dtype"] = moment_dtype
    out.update(compute_dtype=compute_dtype, power_limit_w=where["power_limit_w"])
    out.update(utilization_fields(round_flops(eng, st, shards, sampler), steps_per_sec,
                                  where["device"], compute_dtype))
    if name == "headline":
        out["metric"] = "mdgan_cifar10_8worker_steps_per_sec"
        out.update(_baseline(steps_per_sec))
    elif name == "bigbatch":
        # its own name: the headline's dataset and worker count, another batch
        out["metric"] = f"mdgan_{dataset.lower()}_{n_workers}worker_b{batch}_steps_per_sec"
    return out


def bench_standalone(device: Optional[str] = None) -> Dict:
    """The standalone baseline on MNIST (``bench.py:203-238``)."""
    from mdgan_tpu_torch.core.config import TrainConfig
    from mdgan_tpu_torch.core.registry import get as get_spec
    from mdgan_tpu_torch.data.sampler import ShardSampler
    from mdgan_tpu_torch.engine.standalone import StandaloneEngine

    dataset, batch, chunk, n_chunks, max_ex = STANDALONE
    cfg = TrainConfig(batch_size=batch, local_epochs=1, chunk_size=chunk,
                      compute_dtype="bfloat16", device=device)
    spec = get_spec(dataset)
    data, _ = spec.load("data", max_examples=max_ex)
    eng = StandaloneEngine(spec, cfg)
    st = eng.init_state(seed=1)
    arr = eng.put_data(data)
    sampler = ShardSampler(1, len(data), batch, seed=0)
    dt = timed_chunks(eng, st, arr, sampler, chunk, n_chunks)
    steps_per_sec = n_chunks * chunk / dt
    where = card(eng.device)
    out = {
        "metric": f"standalone_{dataset.lower()}_steps_per_sec",
        "value": steps_per_sec,
        "unit": "rounds/s",
        "batch_size": batch,
        "device": where["device"],
        "wall_s": dt,
        "compute_dtype": cfg.compute_dtype,
        "power_limit_w": where["power_limit_w"],
    }
    out.update(utilization_fields(round_flops(eng, st, arr, sampler), steps_per_sec,
                                  where["device"], cfg.compute_dtype))
    return out


def bench_sustained(rounds: int = 30000, warm_rounds: int = 1500,
                    device: Optional[str] = None) -> Dict:
    """The real trainer loop, not just the rounds (``bench.py:241-318``):
    ``MDGANTrainer.train()`` at the headline config for ``rounds`` rounds
    (30,000: the reference's full experiment) with periodic evals and
    checkpoints off.  The timed run includes the host sampler, chunk
    scheduling, the batched metrics copies, span and worker CSVs, swaps,
    the run's final FID/IS eval and the final weight exports.  A warm run
    of ``warm_rounds`` (a swap at 1,000, as JAX's) first loads the kernels,
    sets up cuDNN and builds the Inception network."""
    from mdgan_tpu_torch.cli.train import build_parser, config_from_args
    from mdgan_tpu_torch.engine.train_loop import MDGANTrainer

    dataset, n_workers, batch, chunk, _, max_ex = CONFIGS["headline"]

    def argv_for(n_rounds: int, swap: int, tmp: str):
        argv = ["--mode", "mdgan", "--dataset", dataset, "--num_workers", str(n_workers),
                "--epochs", str(n_rounds), "--batch_size", str(batch),
                "--swap_interval", str(swap), "--log_interval", "0",
                "--checkpoint_interval", "0", "--chunk_size", str(chunk),
                "--scan_unroll", "2",  # accepted, no effect: the rounds run eagerly
                "--max_examples", str(max_ex),
                "--log_dir", f"{tmp}/logs", "--image_dir", f"{tmp}/imgs",
                "--weights_dir", f"{tmp}/weights", "--checkpoint_dir", f"{tmp}/ckpt"]
        return argv + (["--device", device] if device is not None else [])

    def run(argv, flops: bool = False):
        trainer = MDGANTrainer(config_from_args(build_parser().parse_args(argv)))
        try:
            # the trainer prints one metrics line at the final round
            with contextlib.redirect_stdout(io.StringIO()):
                summary = trainer.train()
            if flops:
                summary["flops_per_round"] = round_flops(
                    trainer.engine, trainer.state, trainer.shards, trainer.sampler)
        finally:
            trainer.close()
        return summary, trainer.engine.device

    with tempfile.TemporaryDirectory(prefix="mdgan_bench_warm_") as tmp:
        run(argv_for(warm_rounds, 1000, tmp))
    with tempfile.TemporaryDirectory(prefix="mdgan_bench_") as tmp:
        summary, dev = run(argv_for(rounds, 5000, tmp), flops=True)

    if summary["rounds"] != rounds or not math.isfinite(summary["final_mean_d_loss"]):
        raise RuntimeError(f"sustained run ended badly: {summary}")
    sps = summary["steps_per_sec"]
    where = card(dev)
    out = {
        "metric": "mdgan_cifar10_8worker_sustained_steps_per_sec",
        "value": sps,
        "unit": "rounds/s",
        "images_per_sec_per_chip": sps * batch * n_workers,
        "batch_size": batch,
        "num_workers": n_workers,
        "device": where["device"],
        "steps_timed": rounds,
        "wall_s": summary["wall_time_s"],
        "includes": "host sampler + chunk dispatch + metrics copies + "
                    "CSV logging + swap + final eval + weight export",
        "compute_dtype": summary["compute_dtype"],
        "power_limit_w": where["power_limit_w"],
        **_baseline(sps),
    }
    out.update(utilization_fields(summary["flops_per_round"], sps, where["device"],
                                  summary["compute_dtype"]))
    return out


def bench_scaling(moment_dtype: str = "float32", device: Optional[str] = None) -> list:
    """The headline config at each of ``SCALING_WORKERS`` worker counts
    (``bench.py:322-355``)."""
    dataset, _, *rest = CONFIGS["headline"]
    out = []
    try:
        for n_workers in SCALING_WORKERS:
            CONFIGS["_scaling"] = (dataset, n_workers, *rest)
            row = bench_mdgan("_scaling", moment_dtype, device=device)
            row["metric"] = f"mdgan_{dataset.lower()}_scaling_steps_per_sec"
            out.append(row)
    finally:
        CONFIGS.pop("_scaling", None)
    return out


def main(argv=None) -> int:
    from mdgan_tpu_torch.core.config import resolve_device

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", default="headline",
                   choices=list(CONFIGS) + ["standalone", "sustained", "scaling", "all"])
    p.add_argument("--sustained", action="store_true",
                   help="alias for --config sustained (the real trainer loop with all "
                        "its host work)")
    p.add_argument("--moment_dtype", choices=["float32", "bfloat16"], default="float32",
                   help="Adam moment storage dtype for the MD-GAN configs")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' runs the kernels' plain "
                        "PyTorch versions)")
    args = p.parse_args(argv)
    resolve_device(args.device)  # no card and no --device cpu: raise before any work
    if args.sustained:
        args.config = "sustained"

    def emit(row: Dict) -> None:
        print(json.dumps(row), flush=True)

    if args.config == "all":
        for name in CONFIGS:
            emit(bench_mdgan(name, args.moment_dtype, device=args.device))
        emit(bench_standalone(args.device))
        emit(bench_sustained(device=args.device))
    elif args.config == "standalone":
        emit(bench_standalone(args.device))
    elif args.config == "sustained":
        emit(bench_sustained(device=args.device))
    elif args.config == "scaling":
        for row in bench_scaling(args.moment_dtype, args.device):
            emit(row)
    else:
        emit(bench_mdgan(args.config, args.moment_dtype, device=args.device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
