#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``mdgan_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line with its seconds:

  env      torch/CUDA versions and ``nvidia-smi`` name and power limit
  build    the one ``nvcc`` build of ``mdgan_tpu_torch/csrc/*.cu``, timed
  kernels  each CUDA kernel at the main path's shapes against its plain
           PyTorch version on the card (Adam: G arena and the 8-D arena,
           3 steps, rtol 1e-6; sampling: the full CIFAR-10 shard stack,
           bit-equal), with kernel, plain and library times (CUDA events)
  golden   the committed JAX-trained generator through ``from_jax``: a
           train-mode forward on the card equals the CPU's (float32, TF32 off)
  round    two narrow MD-GAN rounds (N=2, width 8) on the card against the
           same rounds on the CPU (plain versions), float32, TF32 off
  mdgan    the CLI's ``main`` at the headline config (CIFAR10, N=8, b=10,
           full width): 20 rounds with --swap_interval 10 in float32, then
           20 in bfloat16; losses finite, launch counters read from the run
  profile  the headline round's host time over 20 warm rounds, and its
           device time by kernel from a torch.profiler window

Then one JSON line with every kernel's record, the card's name and power
limit, and as the last line ``{"ok": true, "device": {...}}``.  Any failure
exits nonzero before that line.  Imports nothing of JAX or of ``mdgan_tpu``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12   # H100 SXM (NVIDIA data sheet)
F32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
ADAM_BYTES_PER_ELEM = 28    # read p, g, mu, nu; write p, mu, nu (float32)
ADAM_OPS_PER_ELEM = 13      # see csrc/adam.cu
ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "artifacts/golden/cifar10_w8_r2000/weights/generator_final.npz"


class SmokeFailure(RuntimeError):
    pass


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def nvidia_smi() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    require(proc.returncode == 0, f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def bound_ms(nbytes: float, ops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds of ``fn`` on the card, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_kernels():
    """Both kernels at the main path's shapes against their plain versions."""
    import torch

    from mdgan_tpu_torch.models.dcgan32 import DCGANDiscriminator32, DCGANGenerator32
    from mdgan_tpu_torch.ops import adam, sampling

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    n_g = sum(p.numel() for p in DCGANGenerator32().parameters())
    n_d = 8 * sum(p.numel() for p in DCGANDiscriminator32().parameters())
    lr, b1, b2, eps = 2e-4, 0.0, 0.999, 1e-8

    adam_rec = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0,
                "bound_ms": 0.0, "max_abs_err": 0.0, "max_rel_err": 0.0, "arenas": {}}
    for name, n in (("G", n_g), ("D x8", n_d)):
        def rand(scale, positive=False):
            t = torch.randn(n, generator=gen, device=dev) * scale
            return t.abs() if positive else t
        start = [rand(0.02), rand(1e-2), rand(1e-3), rand(1e-5, positive=True)]
        ker = [t.clone() for t in start]
        ref = [t.clone() for t in start]
        for count in (1, 2, 3):
            lr_c1, inv_c2 = adam.bias_scalars(lr, b1, b2, count)
            adam.adam_update(ker[0], ker[1], ker[2], ker[3], lr_c1, inv_c2, b1, b2, eps)
            adam.adam_plain(ref[0], ref[1], ref[2], ref[3], lr_c1, inv_c2, b1, b2, eps)
        torch.cuda.synchronize()
        for i in (0, 2, 3):  # p, mu, nu
            err = (ker[i] - ref[i]).abs()
            rel = float((err / (1e-30 + ref[i].abs())).max())
            require(bool((err <= 1e-9 + 1e-6 * ref[i].abs()).all()),
                    f"adam kernel vs plain on {name}: max rel err {rel}")
            adam_rec["max_abs_err"] = max(adam_rec["max_abs_err"], float(err.max()))
            adam_rec["max_rel_err"] = max(adam_rec["max_rel_err"], rel)

        lr_c1, inv_c2 = adam.bias_scalars(lr, b1, b2, 4)
        k_ms = time_ms(lambda: adam.adam_update(*ker, lr_c1, inv_c2, b1, b2, eps), 50)
        p_ms = time_ms(lambda: adam.adam_plain(*ref, lr_c1, inv_c2, b1, b2, eps), 20)
        param = torch.nn.Parameter(start[0].clone())
        param.grad = start[1].clone()
        opt = torch.optim.Adam([param], lr=lr, betas=(b1, b2), eps=eps, fused=True)
        l_ms = time_ms(opt.step, 50)
        b_ms, b_by = bound_ms(ADAM_BYTES_PER_ELEM * n, ADAM_OPS_PER_ELEM * n)
        adam_rec["arenas"][name] = {"elements": n, "ms": k_ms, "plain_ms": p_ms,
                                    "library_ms": l_ms, "bound_ms": b_ms, "bound_by": b_by}
        adam_rec["ms"] += k_ms
        adam_rec["plain_ms"] += p_ms
        adam_rec["library_ms"] += l_ms
        adam_rec["bound_ms"] += b_ms
        adam_rec["bytes"] += ADAM_BYTES_PER_ELEM * n
        adam_rec["bound_by"] = b_by
        del start, ker, ref, param, opt

    shards = torch.randint(0, 256, (8, 6250, 32, 32, 3), dtype=torch.uint8,
                           generator=gen, device=dev)
    idx = torch.randint(0, 6250, (8, 10), dtype=torch.int32, generator=gen, device=dev)
    out_k = sampling.sample_normalize(shards, idx)
    out_p = sampling.sample_normalize_plain(shards, idx)
    torch.cuda.synchronize()
    require(out_k.shape == (8, 10, 3, 32, 32), f"sampling shape {tuple(out_k.shape)}")
    require(torch.equal(out_k, out_p), "sampling kernel differs from its plain version")
    s_bytes = idx.numel() * (3072 + 3072 * 4) + idx.numel() * 4
    s_bound, s_by = bound_ms(s_bytes, 2 * idx.numel() * 3072)
    samp_rec = {"ms": time_ms(lambda: sampling.sample_normalize(shards, idx), 200),
                "plain_ms": time_ms(lambda: sampling.sample_normalize_plain(shards, idx), 50),
                "library_ms": None, "bytes": s_bytes, "bound_ms": s_bound, "bound_by": s_by,
                "max_abs_err": float((out_k - out_p).abs().max())}
    del shards
    torch.cuda.empty_cache()
    return adam_rec, samp_rec


def phase_golden():
    """The committed JAX generator: card and CPU train-mode forwards agree."""
    import numpy as np
    import torch

    from mdgan_tpu_torch.models import from_jax
    from mdgan_tpu_torch.models.dcgan32 import DCGANGenerator32

    params, stats = from_jax.load_npz(GOLDEN)
    z = torch.from_numpy(np.random.default_rng(0).standard_normal((64, 100), np.float32))
    outs = {}
    for dev in ("cpu", "cuda"):
        g = from_jax.load_into(DCGANGenerator32(), params, stats).to(dev).train()
        with torch.no_grad():
            x = g(z.to(dev))
        outs[dev] = (x.cpu(), g.block0.bn.running_var.cpu())
    err = float((outs["cpu"][0] - outs["cuda"][0]).abs().max())
    stat_err = float((outs["cpu"][1] - outs["cuda"][1]).abs().max())
    require(bool(torch.isfinite(outs["cuda"][0]).all()), "golden forward not finite")
    require(err <= 2e-4, f"golden forward card vs CPU max abs err {err} > 2e-4")
    require(stat_err <= 1e-4 * (1 + float(outs["cpu"][1].abs().max())),
            f"golden running_var card vs CPU err {stat_err}")
    return {"max_abs_err": err, "running_var_err": stat_err, "shape": list(outs["cuda"][0].shape)}


def phase_round():
    """Two narrow rounds on the card against the same rounds on the CPU."""
    import numpy as np
    import torch

    from mdgan_tpu_torch.core.config import TrainConfig
    from mdgan_tpu_torch.core.registry import get as get_spec
    from mdgan_tpu_torch.data.builtin import synthesize
    from mdgan_tpu_torch.data.partitioner import shard_data
    from mdgan_tpu_torch.data.sampler import ShardSampler
    from mdgan_tpu_torch.engine.mdgan import MDGANEngine

    n, b, rounds, lr = 2, 4, 2, 2e-4
    spec = get_spec("Synthetic32")
    cfg = TrainConfig(batch_size=b, compute_dtype="float32")
    shards_np, _ = shard_data(synthesize((32, 32, 3), 64, seed=32)[0], n, iid=True)
    idx = ShardSampler(n, shards_np.shape[1], b, seed=0).next_chunk(rounds)
    zs = np.random.default_rng(1).standard_normal((rounds, 2 * b, 100), np.float32)
    res = {}
    for dev in ("cpu", "cuda"):
        eng = MDGANEngine(spec, dataclasses.replace(cfg, device=dev), n,
                          model_kwargs={"ngf": 8, "ndf": 8})
        st = eng.init_state(3)
        data = eng.shard_data(shards_np)
        ms = [eng.step(st, data, eng.put_indices(idx[t], shards_np.shape[1]),
                       z=torch.from_numpy(zs[t]).to(dev)) for t in range(rounds)]
        res[dev] = ({k: np.stack([m[k].cpu().numpy() for m in ms])
                     for k in ("mean_d_loss", "g_feedback_loss", "feedback_norm")},
                    st.g.params.cpu(), st.d.params.cpu())
    worst = 0.0
    for k, a in res["cpu"][0].items():
        rel = float(np.max(np.abs(a - res["cuda"][0][k]) / np.abs(a)))
        worst = max(worst, rel)
        require(rel <= 1e-3, f"round metric {k}: card vs CPU rel err {rel}")
    dp = max(float((res["cpu"][1] - res["cuda"][1]).abs().max()),
             float((res["cpu"][2] - res["cuda"][2]).abs().max()))
    require(dp <= 2.05 * lr * rounds, f"round params: card vs CPU max |diff| {dp}")
    return {"metric_max_rel_err": worst, "param_max_abs_diff": dp}


def run_main(argv):
    """The CLI's main in-process; returns its summary (last stdout line)."""
    from mdgan_tpu_torch.cli import train

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = train.main(argv)
    require(rc == 0, f"train.main returned {rc}")
    lines = buf.getvalue().strip().splitlines()
    return json.loads(lines[-1]), [json.loads(ln) for ln in lines[:-1]]


def phase_mdgan(rounds: int = 20):
    """The headline config through the CLI, float32 then bfloat16."""
    from mdgan_tpu_torch.ops import adam, sampling

    base = ["--mode", "mdgan", "--dataset", "CIFAR10", "--num_workers", "8",
            "--batch_size", "10", "--epochs", str(rounds), "--swap_interval", "10",
            "--log_interval", "10"]
    adam.adam_update.launches = 0
    sampling.sample_normalize.launches = 0
    runs, prev = {}, (0, 0)
    for dtype in ("float32", "bfloat16"):
        summary, logs = run_main(base + ["--compute_dtype", dtype])
        now = (adam.adam_update.launches, sampling.sample_normalize.launches)
        launched = (now[0] - prev[0], now[1] - prev[1])
        prev = now
        require(summary["all_finite"], f"{dtype}: non-finite metrics")
        require(summary["swaps"] == (rounds - 1) // 10,
                f"{dtype}: {summary['swaps']} swaps, want {(rounds - 1) // 10}")
        require(launched == (2 * rounds, rounds),
                f"{dtype}: launches adam={launched[0]} (want {2 * rounds}), "
                f"sampling={launched[1]} (want {rounds})")
        r0, r1 = logs[-2], logs[-1]  # rounds 10 and 19: past the warm-up
        summary["steady_rounds_per_s"] = ((r1["round"] - r0["round"])
                                          / (r1["elapsed_s"] - r0["elapsed_s"]))
        runs[dtype] = {**summary, "adam_launches": launched[0],
                       "sampling_launches": launched[1], "log": logs}
    return runs, {"adam": prev[0], "sampling": prev[1]}


def phase_profile(rounds: int = 5):
    """Where a headline round's time goes (CIFAR10, N=8, b=10, full width):
    host wall per round over 20 warm rounds, then one torch.profiler window
    of ``rounds`` rounds for device time by kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mdgan_tpu_torch.core.config import TrainConfig
    from mdgan_tpu_torch.core.registry import get as get_spec
    from mdgan_tpu_torch.data.partitioner import shard_data
    from mdgan_tpu_torch.data.sampler import ShardSampler
    from mdgan_tpu_torch.engine.mdgan import MDGANEngine

    spec = get_spec("CIFAR10")
    shards_np, _ = shard_data(spec.load("data")[0], 8, iid=True, seed=0)
    out = {}
    for dtype in ("float32", "bfloat16"):
        eng = MDGANEngine(spec, TrainConfig(compute_dtype=dtype), 8)
        shards = eng.shard_data(shards_np)
        sampler = ShardSampler(8, shards_np.shape[1], 10, seed=0)
        st = eng.init_state(1)
        eng.run_rounds(st, shards, sampler, 10)  # warm-up
        torch.cuda.synchronize()
        t = time.perf_counter()
        eng.run_rounds(st, shards, sampler, 20)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t) / 20 * 1e3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            eng.run_rounds(st, shards, sampler, rounds)
            torch.cuda.synchronize()
        kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        dev_ms = sum(e.self_device_time_total for e in kern) / 1e3 / rounds
        top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
        out[dtype] = {
            "host_ms_per_round": host_ms, "rounds_per_s": 1e3 / host_ms,
            "device_ms_per_round": dev_ms if kern else None,
            "device_busy_share": dev_ms / host_ms if kern else None,
            "kernels_per_round": sum(e.count for e in kern) / rounds,
            "top": [{"name": e.key[:80], "ms_per_round": e.self_device_time_total / 1e3 / rounds,
                     "per_round": e.count / rounds} for e in top]}
        del st, shards
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke test "
              "needs one CUDA GPU", file=sys.stderr)
        return 2
    import mdgan_tpu_torch  # noqa: F401  (fails when run outside the repository)
    from mdgan_tpu_torch.ops import _build

    t = time.perf_counter()
    smi = nvidia_smi()
    emit({"phase": "env", "seconds": time.perf_counter() - t, "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
          "nvidia_smi": smi})

    t = time.perf_counter()
    built = not _build.library_path().is_file()
    path = _build.build()
    _build.lib()
    log = path.with_suffix(".log")
    ptxas = [ln.strip() for ln in log.read_text().splitlines()
             if "registers" in ln or "spill" in ln] if log.is_file() else []
    emit({"phase": "build", "seconds": time.perf_counter() - t, "built": built,
          "library": path.name, "ptxas": ptxas})

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t = time.perf_counter()
    adam_rec, samp_rec = phase_kernels()
    emit({"phase": "kernels", "seconds": time.perf_counter() - t,
          "adam": adam_rec, "sampling": samp_rec})

    t = time.perf_counter()
    rec = phase_golden()
    emit({"phase": "golden", "seconds": time.perf_counter() - t, **rec})

    t = time.perf_counter()
    rec = phase_round()
    emit({"phase": "round", "seconds": time.perf_counter() - t, **rec})

    torch.backends.cudnn.allow_tf32 = True  # the library default, as a user runs
    t = time.perf_counter()
    runs, launches = phase_mdgan()
    emit({"phase": "mdgan", "seconds": time.perf_counter() - t,
          "card": smi, "runs": runs})

    t = time.perf_counter()
    rec = phase_profile()
    emit({"phase": "profile", "seconds": time.perf_counter() - t, "card": smi, **rec})

    kernels = [
        {"name": "adam", "route": "cuda", "source": "mdgan_tpu_torch/csrc/adam.cu",
         "replaces": "mdgan_tpu/ops/adam.py:43", "launches": launches["adam"],
         "max_abs_err": adam_rec["max_abs_err"], "ms": adam_rec["ms"],
         "plain_ms": adam_rec["plain_ms"], "bound_ms": adam_rec["bound_ms"],
         "bound_by": adam_rec["bound_by"], "library_ms": adam_rec["library_ms"]},
        {"name": "sample_normalize", "route": "cuda",
         "source": "mdgan_tpu_torch/csrc/sampling.cu",
         "replaces": "mdgan_tpu/ops/sampling.py:27", "launches": launches["sampling"],
         "max_abs_err": samp_rec["max_abs_err"], "ms": samp_rec["ms"],
         "plain_ms": samp_rec["plain_ms"], "bound_ms": samp_rec["bound_ms"],
         "bound_by": samp_rec["bound_by"], "library_ms": samp_rec["library_ms"]},
    ]
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
