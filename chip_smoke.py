#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``mdgan_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line with its seconds:

  env      torch/CUDA versions and ``nvidia-smi`` name and power limit
  build    the one ``nvcc`` build of ``mdgan_tpu_torch/csrc/*.cu``, timed
  kernels  each CUDA kernel at the main paths' shapes against its plain
           PyTorch version on the card (Adam: the G arena, the 8-D arena of
           the MD-GAN round and the 1-D arena of the standalone round, 3
           steps, rtol 1e-6; sampling: bit-equal on the full CIFAR-10 shard
           stack at the MD-GAN chunk T=100 and at T=1, on the standalone
           run's one-shard stack of 50,000 rows at T=100 and T=1, and on
           64x64x3, 128x128x3, 5x5x3, 2x2x3 and 3x3x16 rows, an unaligned
           shard stack and out-of-range indices, which must give NaN rows),
           with kernel, plain and library device times (CUDA events, the
           host's issue hidden behind a device sleep, see
           ``mdgan_tpu_torch.core.timing.time_ms``; a reading the host's
           issue could reach fails the phase) and the host's issue time per
           call
  golden   the committed JAX-trained generator through ``from_jax``: a
           train-mode forward on the card equals the CPU's (float32, TF32 off)
  round    two narrow MD-GAN rounds (N=2, width 8) on the card against the
           same rounds on the CPU (plain versions), float32, TF32 off
  mdgan    the CLI's ``main`` at the headline config (CIFAR10, N=8, b=10,
           full width), its files in a temporary directory: 20 rounds with
           --swap_interval 10 in float32 with the default --chunk_size, then
           20 in bfloat16 with --chunk_size 4; losses finite, FID/IS finite
           at rounds 0, 10 and 19, launch counters read from the run: 2 Adam
           launches a round and one sampling launch a chunk
  standalone  the CLI in --mode standalone (CIFAR10, b=10, full width, 30
           rounds, float32): 2 Adam launches a local epoch and one sampling
           launch a chunk, counted from the run; then two narrow standalone
           rounds on the card against the same rounds on the CPU, and both
           modes for 5 rounds with every other flag at its default
  trainer  both trainers at full width with cadences of 2 rounds: the span
           CSVs carry the JAX columns, FID/IS finite, 8 rounds equal 4 plus
           --resume for 4 on every arena (deterministic algorithms on);
           Inception forward, eval and checkpoint save times
  profile  the MD-GAN round's (float32, bfloat16) and the standalone
           round's host time over 20 warm rounds, and device time by kernel
           from a torch.profiler window

Then one JSON line with every kernel's record, the card's name and power
limit, and as the last line ``{"ok": true, "device": {...}}``.  Any failure
exits nonzero before that line.  Imports nothing of JAX or of ``mdgan_tpu``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import itertools
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ADAM_BYTES_PER_ELEM = 28    # read p, g, mu, nu; write p, mu, nu (float32)
ADAM_OPS_PER_ELEM = 13      # see csrc/adam.cu
L2_BYTES = 50 * 2 ** 20     # H100 SXM L2 cache
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


def phase_kernels():
    """Both kernels at the main path's shapes against their plain versions."""
    import torch

    from mdgan_tpu_torch.core.timing import bound_ms, time_ms
    from mdgan_tpu_torch.models.dcgan32 import DCGANDiscriminator32, DCGANGenerator32
    from mdgan_tpu_torch.ops import adam

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    n_g = sum(p.numel() for p in DCGANGenerator32().parameters())
    n_d1 = sum(p.numel() for p in DCGANDiscriminator32().parameters())
    lr, b1, b2, eps = 2e-4, 0.0, 0.999, 1e-8

    adam_rec = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0,
                "bound_ms": 0.0, "max_abs_err": 0.0, "max_rel_err": 0.0, "arenas": {}}
    # the MD-GAN round's arenas (G, 8 D) add up to the record's totals; the
    # standalone round's single-D arena is checked and timed beside them
    for name, n in (("G", n_g), ("D x8", 8 * n_d1), ("D x1", n_d1)):
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
        # consecutive timed calls rotate over enough copies of the arenas
        # that each finds its inputs outside the L2, as a launch inside a
        # round does (the 1-D arena alone would stay L2-resident)
        copies = max(1, math.ceil(2 * L2_BYTES / (16 * n)))
        sets = [ker] + [[t.clone() for t in ker] for _ in range(copies - 1)]
        refs = [ref] + [[t.clone() for t in ref] for _ in range(copies - 1)]
        opts = []
        for _ in range(copies):
            param = torch.nn.Parameter(start[0].clone())
            param.grad = start[1].clone()
            opts.append(torch.optim.Adam([param], lr=lr, betas=(b1, b2), eps=eps, fused=True))
        it = itertools.count()
        k_t = time_ms(lambda: adam.adam_update(*sets[next(it) % copies], lr_c1, inv_c2,
                                               b1, b2, eps), 50)
        p_t = time_ms(lambda: adam.adam_plain(*refs[next(it) % copies], lr_c1, inv_c2,
                                              b1, b2, eps), 20)
        l_t = time_ms(lambda: opts[next(it) % copies].step(), 50)
        b_ms, b_by = bound_ms(ADAM_BYTES_PER_ELEM * n, ADAM_OPS_PER_ELEM * n)
        adam_rec["arenas"][name] = {"elements": n, "ms": k_t["ms"], "plain_ms": p_t["ms"],
                                    "library_ms": l_t["ms"], "bound_ms": b_ms, "bound_by": b_by,
                                    "share_of_bound": b_ms / k_t["ms"], "copies": copies,
                                    "host_us_per_call": k_t["host_us_per_call"]}
        if name != "D x1":
            adam_rec["ms"] += k_t["ms"]
            adam_rec["plain_ms"] += p_t["ms"]
            adam_rec["library_ms"] += l_t["ms"]
            adam_rec["bound_ms"] += b_ms
            adam_rec["bytes"] += ADAM_BYTES_PER_ELEM * n
            adam_rec["bound_by"] = b_by
        del start, ker, ref, sets, refs, opts
    adam_rec["share_of_bound"] = adam_rec["bound_ms"] / adam_rec["ms"]
    g, d1 = adam_rec["arenas"]["G"], adam_rec["arenas"]["D x1"]
    adam_rec["standalone"] = {  # one local epoch: one launch on G, one on D
        key: g[key] + d1[key] for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    adam_rec["standalone"]["bytes"] = ADAM_BYTES_PER_ELEM * (n_g + n_d1)
    torch.cuda.empty_cache()
    return adam_rec, phase_sampling(gen)


def phase_sampling(gen):
    """The sampling kernel bit-equal to its plain version at the main path's
    chunk, one round, larger and odd rows, an unaligned shard stack and
    out-of-range indices; timed at the chunk and at one round."""
    import torch

    from mdgan_tpu_torch.core.timing import bound_ms, time_ms
    from mdgan_tpu_torch.ops import sampling

    dev = torch.device("cuda")

    def shards_of(n, s, shape, offset=0):
        numel = n * s * shape[0] * shape[1] * shape[2]
        buf = torch.randint(0, 256, (numel + offset,), dtype=torch.uint8, generator=gen,
                            device=dev)
        return buf[offset:].view(n, s, *shape)

    def indices(t, n, b, s):
        return torch.randint(0, s, (t, n, b), dtype=torch.int32, generator=gen, device=dev)

    def check(name, shards, idx, bad=None):
        """Kernel against plain on the same inputs; ``bad`` marks rows whose
        index is out of range: NaN from the kernel, and left out of the
        comparison (the plain gather would fault on them)."""
        out_k = sampling.sample_normalize(shards, idx)
        good_idx = idx if bad is None else torch.where(bad, 0, idx)
        out_p = sampling.sample_normalize_plain(shards, good_idx)
        torch.cuda.synchronize()
        h, w, c = shards.shape[2:]
        require(out_k.shape == (*idx.shape, c, h, w), f"sampling {name}: shape {tuple(out_k.shape)}")
        if bad is not None:
            require(bool(torch.isnan(out_k[bad]).all()), f"sampling {name}: bad rows not NaN")
            require(not bool(torch.isnan(out_k[~bad]).any()), f"sampling {name}: NaN in good rows")
            out_k, out_p = out_k[~bad], out_p[~bad]
        require(torch.equal(out_k, out_p), f"sampling {name}: kernel differs from plain")
        return {"idx": list(idx.shape), "row": [h, w, c], "bit_equal": True,
                "max_abs_err": float((out_k - out_p).abs().max()) if out_k.numel() else 0.0}

    cifar = shards_of(8, 6250, (32, 32, 3))
    cases = {
        "chunk_T100": check("chunk_T100", cifar, indices(100, 8, 10, 6250)),
        "round_T1": check("round_T1", cifar, indices(1, 8, 10, 6250)),
        "rows_64x64x3": check("rows_64x64x3", shards_of(8, 200, (64, 64, 3)),
                              indices(5, 8, 10, 200)),
        "rows_128x128x3": check("rows_128x128x3", shards_of(2, 20, (128, 128, 3)),
                                indices(3, 2, 4, 20)),
        "rows_5x5x3": check("rows_5x5x3", shards_of(2, 50, (5, 5, 3)), indices(3, 2, 4, 50)),
        "rows_2x2x3": check("rows_2x2x3", shards_of(2, 50, (2, 2, 3)), indices(3, 2, 4, 50)),
        "rows_3x3x16": check("rows_3x3x16", shards_of(2, 50, (3, 3, 16)), indices(3, 2, 4, 50)),
        "unaligned_base": check("unaligned_base", shards_of(8, 500, (32, 32, 3), offset=1),
                                indices(10, 8, 10, 500)),
        "round_idx_2d": check("round_idx_2d", cifar, indices(1, 8, 10, 6250)[0]),
    }
    whole = shards_of(1, 50000, (32, 32, 3))  # the standalone run's one-shard stack
    cases["standalone_T100"] = check("standalone_T100", whole, indices(100, 1, 10, 50000))
    cases["standalone_T1"] = check("standalone_T1", whole, indices(1, 1, 10, 50000))
    idx = indices(10, 8, 10, 6250)
    bad = torch.zeros(idx.shape, dtype=torch.bool, device=dev)
    for pos, value in (((0, 0, 0), -1), ((3, 7, 9), 6250), ((9, 2, 5), 2 ** 31 - 1)):
        idx[pos], bad[pos] = value, True
    cases["out_of_range"] = check("out_of_range", cifar, idx, bad)

    timed = {}
    for name, t, stack in (("chunk_T100", 100, cifar), ("round_T1", 1, cifar),
                           ("standalone_T100", 100, whole)):
        n, s = stack.shape[:2]
        rows = t * n * 10
        # fresh rows each call, more of them than the L2 holds
        k = max(8, math.ceil(2 * L2_BYTES / (rows * 3072)))
        pool = [indices(t, n, 10, s) for _ in range(k)]
        it = itertools.count()
        k_t = time_ms(lambda: sampling.sample_normalize(stack, pool[next(it) % k]), 20)
        p_t = time_ms(lambda: sampling.sample_normalize_plain(stack, pool[next(it) % k]), 10)
        nbytes = rows * (4 + 3072 + 4 * 3072)  # read each index and row, write float32 once
        b_ms, b_by = bound_ms(nbytes, 2 * rows * 3072)
        timed[name] = {"rows": rows, "bytes": nbytes, "ms": k_t["ms"], "plain_ms": p_t["ms"],
                       "bound_ms": b_ms, "bound_by": b_by, "share_of_bound": b_ms / k_t["ms"],
                       "host_us_per_call": k_t["host_us_per_call"]}
    del cifar, whole
    torch.cuda.empty_cache()
    main = timed["chunk_T100"]
    return {"ms": main["ms"], "plain_ms": main["plain_ms"], "library_ms": None,
            "bytes": main["bytes"], "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "max_abs_err": max(c["max_abs_err"] for c in cases.values()),
            "timed": timed, "cases": cases}


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


@contextlib.contextmanager
def no_tf32():
    """float32 convolutions and matmuls without TF32, for card-vs-CPU checks."""
    import torch

    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


@no_tf32()
def phase_standalone_round():
    """Two narrow standalone rounds on the card against the same rounds on
    the CPU (width 8, b=4, float32, TF32 off)."""
    import numpy as np
    import torch

    from mdgan_tpu_torch.core.config import TrainConfig
    from mdgan_tpu_torch.core.registry import get as get_spec
    from mdgan_tpu_torch.data.builtin import synthesize
    from mdgan_tpu_torch.engine.standalone import StandaloneEngine

    b, rounds, lr = 4, 2, 2e-4
    data = synthesize((32, 32, 3), 64, seed=32)[0]
    idx = np.random.default_rng(2).integers(0, 64, (rounds, 1, b)).astype(np.int32)
    zs = np.random.default_rng(1).standard_normal((rounds, b, 100), np.float32)
    res = {}
    for dev in ("cpu", "cuda"):
        eng = StandaloneEngine(get_spec("Synthetic32"), TrainConfig(
            batch_size=b, compute_dtype="float32", device=dev),
            model_kwargs={"ngf": 8, "ndf": 8})
        st = eng.init_state(3)
        shards = eng.put_data(data)
        ms = [eng.step(st, shards, eng.put_indices(idx[t], 64), z=torch.from_numpy(zs[t]).to(dev))
              for t in range(rounds)]
        res[dev] = ({k: np.array([float(m[k]) for m in ms]) for k in ("mean_d_loss", "mean_g_loss")},
                    ms[-1]["x_eval"].cpu(), st.g.params.cpu(), st.d.params.cpu(), st.g.stats.cpu())
    worst = max(float(np.max(np.abs(a - res["cuda"][0][k]) / np.abs(a)))
                for k, a in res["cpu"][0].items())
    require(worst <= 1e-3, f"standalone round metrics: card vs CPU rel err {worst}")
    x_err = float((res["cpu"][1] - res["cuda"][1]).abs().max())
    require(x_err <= 1e-4, f"standalone x_eval: card vs CPU max abs err {x_err}")
    dp = max(float((res["cpu"][i] - res["cuda"][i]).abs().max()) for i in (2, 3))
    require(dp <= 2.05 * lr * rounds, f"standalone params: card vs CPU max |diff| {dp}")
    stat_err = float((res["cpu"][4] - res["cuda"][4]).abs().max())
    return {"metric_max_rel_err": worst, "x_eval_max_abs_err": x_err,
            "param_max_abs_diff": dp, "g_stats_max_abs_diff": stat_err}


def run_main(argv):
    """The CLI's main in-process, writing its files into a temporary
    directory; returns its summary (last stdout line) and log lines."""
    from mdgan_tpu_torch.cli import train

    buf = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(buf):
        rc = train.main(argv + out_dirs(Path(tmp)))
    require(rc == 0, f"train.main returned {rc}")
    lines = buf.getvalue().strip().splitlines()
    return json.loads(lines[-1]), [json.loads(ln) for ln in lines[:-1]]


def out_dirs(root: Path):
    """The CLI's output directories, under ``root``."""
    return [arg for flag in ("log_dir", "image_dir", "weights_dir", "checkpoint_dir")
            for arg in (f"--{flag}", str(root / flag))]


def cli_chunks(rounds: int, swap_interval: int, log_interval: int, chunk: int,
               checkpoint_interval: int = 0):
    """The chunk lengths the CLI runs: a run ends at every log round, every
    swap and checkpoint round after 0 and the last round, and splits into
    chunks of at most ``chunk`` rounds (``mdgan_tpu/engine/train_loop.py:625``).
    ``swap_interval`` 0: no swaps (the standalone run)."""
    events = [e for e in range(rounds) if e % log_interval == 0 or e == rounds - 1
              or (e > 0 and swap_interval and e % swap_interval == 0)
              or (e > 0 and checkpoint_interval and e % checkpoint_interval == 0)]
    out, cur = [], 0
    for e in events:
        while cur <= e:
            out.append(min(chunk, e - cur + 1))
            cur += out[-1]
    return out


def phase_mdgan(rounds: int = 20):
    """The headline config through the CLI, float32 with the default chunk
    size, then bfloat16 with chunks of 4: one sampling launch per chunk."""
    from mdgan_tpu_torch.ops import adam, sampling

    base = ["--mode", "mdgan", "--dataset", "CIFAR10", "--num_workers", "8",
            "--batch_size", "10", "--epochs", str(rounds), "--swap_interval", "10",
            "--log_interval", "10"]
    adam.adam_update.launches = 0
    sampling.sample_normalize.launches = 0
    runs, prev = {}, (0, 0)
    for dtype, chunk in (("float32", 100), ("bfloat16", 4)):
        summary, logs = run_main(base + ["--compute_dtype", dtype, "--chunk_size", str(chunk)])
        now = (adam.adam_update.launches, sampling.sample_normalize.launches)
        launched = (now[0] - prev[0], now[1] - prev[1])
        prev = now
        chunks = cli_chunks(rounds, 10, 10, chunk)
        require(summary["all_finite"], f"{dtype}: non-finite metrics")
        require(summary["swaps"] == (rounds - 1) // 10,
                f"{dtype}: {summary['swaps']} swaps, want {(rounds - 1) // 10}")
        require(launched == (2 * rounds, len(chunks)),
                f"{dtype}: launches adam={launched[0]} (want {2 * rounds}), "
                f"sampling={launched[1]} (want {len(chunks)}, one per chunk {chunks})")
        require([e["epoch"] for e in summary["evals"]] == [0, 10, rounds - 1]
                and all(math.isfinite(e["fid"]) and math.isfinite(e["is"])
                        for e in summary["evals"]), f"{dtype}: evals {summary['evals']}")
        r0, r1 = logs[-2], logs[-1]  # rounds 10 and 19: past the warm-up
        summary["steady_rounds_per_s"] = ((r1["round"] - r0["round"])
                                          / (r1["elapsed_s"] - r0["elapsed_s"]))
        runs[dtype] = {**summary, "chunk_size": chunk, "chunks": chunks,
                       "adam_launches": launched[0], "sampling_launches": launched[1],
                       "log": logs}
    return runs, {"adam": prev[0], "sampling": prev[1]}


def phase_standalone(rounds: int = 30, local_epochs: int = 1):
    """The CLI in --mode standalone at full width (CIFAR10, b=10, DCGAN-32),
    float32 with the default chunk size: the launch counts computed apart
    from the engine, 2 Adam launches a local epoch and one sampling launch a
    chunk; then a narrow standalone round held to the CPU's."""
    from mdgan_tpu_torch.ops import adam, sampling

    argv = ["--mode", "standalone", "--dataset", "CIFAR10", "--batch_size", "10",
            "--epochs", str(rounds), "--log_interval", "10", "--local_epochs",
            str(local_epochs), "--compute_dtype", "float32"]
    adam.adam_update.launches = 0
    sampling.sample_normalize.launches = 0
    summary, logs = run_main(argv)
    launched = {"adam": adam.adam_update.launches, "sampling": sampling.sample_normalize.launches}
    chunks = cli_chunks(rounds, 0, 10, 100, 3000)
    require(summary["all_finite"], "standalone: non-finite metrics")
    require(launched == {"adam": 2 * local_epochs * rounds, "sampling": len(chunks)},
            f"standalone: launches {launched}, want adam {2 * local_epochs * rounds} and "
            f"sampling {len(chunks)} (one per chunk {chunks})")
    require([e["epoch"] for e in summary["evals"]] == list(range(0, rounds, 10))
            and all(math.isfinite(e["fid"]) for e in summary["evals"]),
            f"standalone evals {summary['evals']}")
    r0, r1 = logs[-2], logs[-1]  # rounds 10 and 20: past the warm-up
    summary["steady_rounds_per_s"] = ((r1["round"] - r0["round"])
                                      / (r1["elapsed_s"] - r0["elapsed_s"]))
    return {**summary, "chunks": chunks, "launches": launched, "log": logs,
            "narrow_round": phase_standalone_round(), "defaults": cli_defaults()}, launched


def cli_defaults(rounds: int = 5):
    """Both modes through the CLI with every flag at its default (bfloat16,
    N=8, --log_interval 300, --checkpoint_interval 3000) but --epochs."""
    out = {}
    for mode, evals in (("mdgan", [0, rounds - 1]), ("standalone", [0])):
        summary, _ = run_main(["--mode", mode, "--epochs", str(rounds)])
        require(summary["all_finite"] and [e["epoch"] for e in summary["evals"]] == evals,
                f"{mode} with default flags: {summary}")
        out[mode] = {k: summary[k] for k in ("rounds", "wall_time_s", "compute_dtype", "evals")}
    return out


SPAN_COLUMNS = {  # the JAX package's CSV headers (mdgan_tpu/obs/spans.py:44, :76)
    "server": ["epoch"] + [f"{e}.{op}" for op in (
        "epoch", "epoch_calculation", "send_data", "recv_data", "calc_gradients",
        "agg_gradients", "generate_data", "fid", "is", "swap") for e in ("start", "end")]
    + ["fid", "is", "size.data", "size.feedback", "swap", "size.sent", "size.recv",
       "fid_standard", "is_standard", "start.checkpoint", "end.checkpoint"],
    "worker": ["epoch"] + [f"{e}.{op}" for op in (
        "epoch", "calc_gradients", "recv_data", "send", "swap_recv_instruction",
        "load_state_dict", "swap_recv", "swap_send") for e in ("start", "end")]
    + ["swap_with", "mean_d_loss", "size.model", "size.sent", "size.recv"],
}


def phase_trainer():
    """Both trainers end to end at full width in a temporary directory, with
    cadences of a few rounds: the span CSVs carry the JAX columns, FID/IS are
    finite, and a run of 8 rounds equals 4 rounds plus --resume for 4, bit for
    bit on every arena.  The last needs deterministic kernels on the card
    (cuDNN's and cuBLAS's defaults may use atomics), so this phase runs with
    ``torch.use_deterministic_algorithms(True)``; that each run repeats
    without it is reported, not required.  Also times the Inception forward
    on 5 and 256 images, the 5-sample and 256-image evals, and one
    checkpoint save of the headline MD-GAN state."""
    import torch

    from mdgan_tpu_torch.cli import train as cli
    from mdgan_tpu_torch.engine import train_loop
    from mdgan_tpu_torch.ops import adam, sampling

    def run(root, mode, epochs, *extra):
        argv = ["--mode", mode, "--dataset", "CIFAR10", "--num_workers", "8",
                "--batch_size", "10", "--epochs", str(epochs), "--swap_interval", "3",
                "--log_interval", "2", "--checkpoint_interval", "2", "--chunk_size", "2",
                "--compute_dtype", "float32", "--max_examples", "8000"]
        cfg = cli.config_from_args(cli.build_parser().parse_args(
            argv + out_dirs(root) + list(extra)))
        trainer = (train_loop.MDGANTrainer if mode == "mdgan"
                   else train_loop.StandaloneTrainer)(cfg)
        with contextlib.redirect_stdout(io.StringIO()):
            try:
                summary = trainer.train()
            finally:
                trainer.close()
        return trainer, summary

    def arenas(st):
        return {f"{n}.{a}": getattr(getattr(st, n), a)
                for n in ("g", "d") for a in ("params", "stats", "mu", "nu")}

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        for mode in ("mdgan", "standalone"):
            adam.adam_update.launches = 0
            sampling.sample_normalize.launches = 0
            torch.use_deterministic_algorithms(True)
            try:
                full, summary = run(root / mode / "full", mode, 8)
                run(root / mode / "split", mode, 4)
                resumed, _ = run(root / mode / "split", mode, 8, "--resume")
            finally:
                torch.use_deterministic_algorithms(False)
            launched = {"adam": adam.adam_update.launches,
                        "sampling": sampling.sample_normalize.launches}
            require(min(launched.values()) > 0, f"trainer {mode}: launches {launched}")
            differ = [k for k, t in arenas(full.state).items()
                      if not torch.equal(t, arenas(resumed.state)[k])]
            require(not differ and resumed.state.step == full.state.step == 8,
                    f"trainer {mode}: resumed run differs in {differ}")
            # the library's defaults, twice
            first, _ = run(root / mode / "default0", mode, 8)
            again, _ = run(root / mode / "default1", mode, 8)
            repeats = all(torch.equal(t, arenas(again.state)[k])
                          for k, t in arenas(first.state).items())
            require(summary["all_finite"] and summary["evals"] and all(
                math.isfinite(e["fid"]) and math.isfinite(e["is"]) for e in summary["evals"]),
                f"trainer {mode}: {summary}")
            logs = root / mode / "full" / "log_dir"
            csvs = {}
            for path in sorted(logs.glob("*.csv")):
                header = path.read_text().splitlines()[0].split(",")
                kind = "worker" if ".worker." in path.name else "server"
                require(header == SPAN_COLUMNS[kind], f"{path.name}: columns {header}")
                csvs[path.name] = len(path.read_text().splitlines()) - 1
            want = 1 + 8 if mode == "mdgan" else 1
            require(len(csvs) == want, f"trainer {mode}: csv files {sorted(csvs)}")
            files = sorted(str(p.relative_to(root / mode / "full"))
                           for p in (root / mode / "full").rglob("*") if p.is_file())
            out[mode] = {"evals": summary["evals"], "csv_rows": csvs, "files": files,
                         "resumed_bit_identical": True, "repeats_without_deterministic": repeats,
                         "launches": launched, "feature_source": summary["feature_source"]}
    out["timing"] = _eval_and_checkpoint_times()
    return out


def _eval_and_checkpoint_times():
    """Host seconds (ending in a device read) of the Inception forward on 5
    and 256 CIFAR-sized images, of the 5-sample eval (tracker built on 5
    reals, FID and IS of 5 fakes) and the 256-image one (IS over 10 splits),
    and of one checkpoint save of the headline MD-GAN state (N=8, full width)."""
    import numpy as np
    import torch

    from mdgan_tpu_torch.core.config import TrainConfig
    from mdgan_tpu_torch.core.registry import get as get_spec
    from mdgan_tpu_torch.engine.mdgan import MDGANEngine
    from mdgan_tpu_torch.metrics import fid as fid_lib
    from mdgan_tpu_torch.metrics import inception
    from mdgan_tpu_torch.utils import checkpoint as ckpt

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    real, fake = (rng.uniform(0, 1, (256, 32, 32, 3)).astype(np.float32) for _ in range(2))
    stats = inception.calibrated_stats(real[:5], dev)

    def best(fn, reps=3):
        fn()  # warm-up
        times = []
        for _ in range(reps):
            t = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t)
        return min(times)

    out = {
        "inception_forward_5_s": best(lambda: inception.inception_features(fake[:5], stats, dev)),
        "inception_forward_256_s": best(lambda: inception.inception_features(fake, stats, dev)),
    }

    def eval_5():
        tracker = fid_lib.FIDTracker(real[:5], device=dev)
        return tracker.score(fake[:5]), tracker.inception_score(fake[:5], splits=1)

    def eval_256():
        tracker = fid_lib.FIDTracker(real, device=dev)
        return tracker.score(fake), tracker.inception_score(fake, splits=10)

    # each reading calibrates afresh, as the standalone run's every eval does
    out["eval_5_s"] = best(lambda: (inception._CALIB_CACHE.clear(), eval_5()))
    out["eval_256_s"] = best(lambda: (inception._CALIB_CACHE.clear(), eval_256()), reps=2)
    fid5, (is5, _) = eval_5()
    require(math.isfinite(fid5) and math.isfinite(is5), f"5-sample eval {fid5} {is5}")

    eng = MDGANEngine(get_spec("CIFAR10"), TrainConfig(compute_dtype="float32"), 8)
    st = eng.init_state(1)
    with tempfile.TemporaryDirectory() as tmp:
        mgr = ckpt.CheckpointManager(tmp)
        t = time.perf_counter()
        snap = ckpt.snapshot_state(st)
        torch.cuda.synchronize()
        snap_s = time.perf_counter() - t
        mgr.save(0, snap)
        mgr.wait_until_finished()
        out["checkpoint_snapshot_s"] = snap_s
        out["checkpoint_save_s"] = time.perf_counter() - t
        out["checkpoint_bytes"] = sum(p.stat().st_size for p in Path(tmp).glob("ckpt_*.pt"))
        t = time.perf_counter()
        mgr.restore(st)
        torch.cuda.synchronize()
        out["checkpoint_restore_s"] = time.perf_counter() - t
        mgr.close()
    return out


def phase_profile(rounds: int = 5):
    """Where a round's time goes (CIFAR10, b=10, full width; MD-GAN with
    N=8 in float32 and bfloat16, and the standalone round in float32): host
    wall per round over 20 warm rounds, then one torch.profiler window of
    ``rounds`` rounds for device time by kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mdgan_tpu_torch.core.config import TrainConfig
    from mdgan_tpu_torch.core.registry import get as get_spec
    from mdgan_tpu_torch.data.partitioner import shard_data
    from mdgan_tpu_torch.data.sampler import ShardSampler
    from mdgan_tpu_torch.engine.mdgan import MDGANEngine
    from mdgan_tpu_torch.engine.standalone import StandaloneEngine

    spec = get_spec("CIFAR10")
    data = spec.load("data")[0]
    shards_np, _ = shard_data(data, 8, iid=True, seed=0)
    out = {}
    for name, dtype in (("float32", "float32"), ("bfloat16", "bfloat16"),
                        ("standalone_float32", "float32")):
        if name.startswith("standalone"):
            eng = StandaloneEngine(spec, TrainConfig(compute_dtype=dtype))
            shards = eng.put_data(data)
            sampler = ShardSampler(1, len(data), 10, seed=0)
        else:
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
        out[name] = {
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

    # deterministic cuBLAS, for the trainer phase's bit-identical resume;
    # set before the first cuBLAS call of the process
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    runs, mdgan_launches = phase_mdgan()
    emit({"phase": "mdgan", "seconds": time.perf_counter() - t,
          "card": smi, "runs": runs})

    t = time.perf_counter()
    rec, standalone_launches = phase_standalone()
    emit({"phase": "standalone", "seconds": time.perf_counter() - t, "card": smi, **rec})

    t = time.perf_counter()
    rec = phase_trainer()
    emit({"phase": "trainer", "seconds": time.perf_counter() - t, "card": smi, **rec})

    t = time.perf_counter()
    rec = phase_profile()
    emit({"phase": "profile", "seconds": time.perf_counter() - t, "card": smi, **rec})

    paths = {"mdgan": mdgan_launches, "standalone": standalone_launches}
    sa_samp = samp_rec["timed"]["standalone_T100"]
    by_path = {
        "adam": {"mdgan": {k: adam_rec[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms")},
                 "standalone": adam_rec["standalone"]},
        "sampling": {"mdgan": {k: samp_rec[k] for k in ("ms", "plain_ms", "bound_ms")},
                     "standalone": {k: sa_samp[k] for k in ("ms", "plain_ms", "bound_ms")}},
    }
    kernels = []
    for name, key, source, replaces, rec in (
            ("adam", "adam", "mdgan_tpu_torch/csrc/adam.cu", "mdgan_tpu/ops/adam.py:43",
             adam_rec),
            ("sample_normalize", "sampling", "mdgan_tpu_torch/csrc/sampling.cu",
             "mdgan_tpu/ops/sampling.py:27", samp_rec)):
        for path_name, counts in paths.items():
            by_path[key][path_name]["launches"] = counts[key]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(counts[key] for counts in paths.values()),
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"], "by_path": by_path[key]})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
