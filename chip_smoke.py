#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``mdgan_tpu_torch``) on one GPU.

    python3 chip_smoke.py

(``chip_smoke.py --rank-program ...`` is one rank of the ``distributed``
phase and ``chip_smoke.py --axes-program ...`` one of the ``axes`` phase,
each started by the script itself.)  Phases, each printing one JSON line
with its seconds:

  env      torch/CUDA versions and ``nvidia-smi`` name and power limit
  build    the one ``nvcc`` build of ``mdgan_tpu_torch/csrc/*.cu``, timed, and
           the ``g++`` build of the host library ``data/native``, timed
  kernels  each CUDA kernel at the main paths' shapes against its plain
           PyTorch version on the card (Adam: the G arena, the 8-D arena of
           the MD-GAN round and the 1-D arena of the standalone round, 3
           steps, rtol 1e-6, for DCGAN-32 and each other family at full
           width; the bfloat16-moment Adam on the same twelve arenas,
           bit-equal, against its 20 B/element bound; sampling: bit-equal on
           the full CIFAR-10 shard
           stack at the MD-GAN chunk T=100 and at T=1, on the standalone
           run's one-shard stack of 50,000 rows at T=100 and T=1, and on
           64x64x3, 128x128x3, 5x5x3, 2x2x3 and 3x3x16 rows, an unaligned
           shard stack and out-of-range indices, which must give NaN rows,
           and at each family's launch: 28x28x1, 64x64x3 and 128x128x3 rows
           at N=8 and N=1),
           with kernel, plain and library device times (CUDA events, the
           host's issue hidden behind a device sleep, see
           ``mdgan_tpu_torch.core.timing.time_ms``; a reading the host's
           issue could reach fails the phase) and the host's issue time per
           call
  upfirdn2d  the FIR resampling kernel (``csrc/upfirdn2d.cu``) at every
           resampling shape of StyleGAN2 config-f at 256x256 (the generator's
           up-modconv FIRs and RGB skips at b=8, the discriminator's two
           blurs a block at b=4), float32 and bfloat16: forward and backward
           against the plain version on the card (float32 TF32 off: rtol
           1e-5 of the largest output; bfloat16: within one rounding of the
           float32 sum), each call's forward and backward device time
           against its byte bound (input read once, output written once) and
           the plan each took, the forward against the plain version's and
           against the one cuDNN call that computes it (a depthwise
           ``conv2d``, or at up=2 a depthwise stride-2
           ``conv_transpose2d``); each site of 8 channels or more again on
           channels_last input (the ``nhwc`` plan, bit-equal to the NCHW
           plans, beside cuDNN's call on the same layout); then two config-f
           MD-GAN rounds (N=8, b=4, bfloat16) through ``run_rounds``, the
           kernel's launches counted from them: 600 a round, all but the
           generator's RGB skips and their gradients (12 a round) by the
           ``nhwc`` plan
  golden   the committed JAX-trained generator through ``from_jax``: a
           train-mode forward on the card equals the CPU's (float32, TF32 off)
  round    two narrow MD-GAN rounds (N=2, width 8) on the card against the
           same rounds on the CPU (plain versions), float32, TF32 off; the
           same for each other family, narrow (MLP at its only width with
           dropout masks injected, DCGAN-64 at width 8, StyleGAN2 at
           max_res 32, 32 base features, 2 mapping layers)
  mdgan    the CLI's ``main`` at the headline config (CIFAR10, N=8, b=10,
           full width), its files in a temporary directory: 20 rounds with
           --swap_interval 10 in float32 with the default --chunk_size, then
           20 in bfloat16 with --chunk_size 4, then 20 in float32 with
           --moment_dtype bfloat16 --straggler_rate 0.3; losses finite,
           FID/IS finite at rounds 0, 10 and 19, launch counters read from
           the run: 2 Adam launches a round (the bf16-moment kernel's in the
           third run) and one sampling launch a chunk; the third run's
           server CSV has ``n_feedbacks`` in [1, 8] on every row
  distributed  ``python -m torch.distributed.run`` of the same CLI on W
           local ranks over NCCL (W the card count, capped at N=8): the
           headline config in float32 for 10 rounds with a swap at round 5;
           at W=1 its checkpoint, exports, CSV losses and printed metrics
           bit-identical to the single-process run under deterministic
           algorithms; every rank's launch counts and its warm-round host
           time against the single-process engine's; prints W
  axes     the replica and tensor axes: the headline config (CIFAR10,
           N=8, b=10, DCGAN-32 at full width, float32, TF32 off,
           deterministic algorithms) under ``torch.distributed.run`` in four
           layouts: (R=2, T=1) on 2 ranks, (R=1, T=2) on 2, (R=2, W=2, T=2)
           on 8, and (R=2, T=1) on 6, JAX's idle fallback (the workers axis
           takes 2 of its 3 slots; ranks 4 and 5 idle, exiting 0).  Ranks
           outnumbering the cards share the one card over gloo (every
           kernel on the card, the collectives through the host); with a
           card a rank they run over NCCL, and the phase prints which ran
           ("not run (1 card)" otherwise).  Each rank runs two engine rounds,
           held to the single-process engine's round by round (the first
           round's metrics at rtol 1e-4, the second's at 2e-3, after Adam
           steps at rounding noise went either way; parameters none beyond
           Adam's largest steps, and after the first round under 0.5% off
           by more than rtol 1e-2), times three warm rounds on the host
           (ranks sharing a card: not a scaling number), then the CLI for 10
           rounds (a swap at 5, checkpoints at 5 and 9): finite metrics,
           2 Adam launches a round and one sampling launch a chunk on every
           rank of the mesh, none on an idle one; the final checkpoint
           resumes in one process for one round.  The kernels phase times
           Adam on the (R=2, W=2, T=2) rank's arenas (its G tensor slice of
           1,727,360 elements and 4 D) and sampling at 5 rows a worker, each
           against its plain version and bound.  Last, in this process, the
           single-process rounds again with the convolutions' sums
           reordered: every convolution on 2 row blocks of its batch (a
           replica split's weight-gradient order), on ATen's own
           convolutions in place of cuDNN's, and repeated unchanged (which
           must be bit-identical); each against the reference round by round
           (``reorder``: measured, not bounded)
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
           from a torch.profiler window; the same for each other model
           family at full width (fewer rounds)
  families the three other model families at full width through the CLI's
           ``main`` (MNIST: MLP-GAN; CelebA: DCGAN-64, ngf=ndf=64; FFHQ128:
           StyleGAN2, 512 base features, 8 mapping layers, 128x128): MD-GAN
           at N=8, b=10, --swap_interval 5, 10 rounds in float32 and in
           bfloat16, and 10 standalone rounds, each on 8,000 examples;
           losses and FID/IS finite, 2 Adam launches a round (a local epoch
           in standalone) and the sampling launches of the chunks, counted
           from the run against a count computed here; then a chunk's
           gather split at the 256 MiB cap held to the plain gather
  tools    (run after trainer) the native host library of
           ``mdgan_tpu_torch/data/native`` loaded (required;
           ``MDGAN_TPU_NO_NATIVE`` must be unset); the full CIFAR-10 train
           split written in its binary layout (5 x 10,000 records of 3,073 B,
           the synthetic stand-in) and MNIST's 60,000-image train split in
           raw idx files, each decoded natively and in numpy (3 runs each,
           alternated), byte-equal to the source, host seconds of each, and
           ``load_mnist`` on the raw files through the native decoder; the
           headline CLI
           (N=8, b=10, full width, float32, 10 rounds) on that ``.bin``
           folder through the native decode and gather; ``--download``
           offline: MNIST idx ``.gz`` files (8,000 train images) and a
           ``cifar-10-python.tar.gz`` fetched from ``file://`` sources with
           their checksums, corrupted copies rejected with nothing left,
           then the CLI with ``--download --dataset MNIST`` for 5 MD-GAN
           rounds (launch counts of both runs from the run); ``shard_data``
           on FFHQ128's 8,000 stand-in examples (393 MB) through the
           threaded gather, then that gather against numpy on the same
           indices (3 runs each, alternated), byte-equal, host seconds of
           each and the CPU count;
           ``cli.generate`` from the trainer phase's checkpoint (64 samples
           on the card, timed), from an export, and a filmstrip, with the
           card's images against the CPU's (same latents, TF32 off, atol
           1e-4); ``cli.convert_weights`` npz -> pt -> npz bit-exact on the
           six (dataset, role) pairs; ``cli.analyze --json`` on the mdgan
           phase's CSVs (20 rounds, a finite rate, the span ops)

  bench    the port's benchmark (``mdgan_tpu_torch/cli/bench.py``): the
           headline config (CIFAR10, N=8, b=10) with chunks cut to 100 rounds
           and 2 timed, in bfloat16 and in float32, and ``bench_sustained``
           for 200 rounds after 20: each JSON line printed, its numbers
           finite, ``flops_per_round`` in [8e9, 9e10], ``mfu`` under 1.05,
           and its Adam and sampling launches counted from the run against
           its rounds and chunks
  parts    ``mdgan_tpu_torch/cli/profile_parts.py`` at the headline config,
           30 calls a part: host microseconds and device busy milliseconds
           of each part, launches counted
  examples ``examples_torch/train_mdgan_minimal.py`` (10 rounds) and
           ``run-standalone-torch.sh`` (``--epochs 10 --log_interval 0``) as
           subprocesses on the card: exit 0, their rounds, swaps, sample grid
           and summary
  record   the recorder's training steps (``cli/record_artifacts.py``) into a
           temporary root, each on one leg cut to 20 rounds with
           ``--log_interval``/``--swap_interval`` 10 and ``--eval_n_samples``
           512: golden, standalone, the convergence step's standalone and
           N=2 legs (then its COMPARISON.json), the scale step's N=20 leg;
           then the prune.  Each leg's summary, span CSV columns (against
           the JAX recording of the same step), a row a round in each worker
           CSV, its grids and its weights left after the prune; 2 Adam
           launches a round in each leg.  The kernels phase times Adam on
           the N=2 and N=4 legs' arenas and sampling at their chunks

Then one JSON line with every kernel's record, the card's name and power
limit, and as the last line ``{"ok": true, "device": {...}}``.  Any failure
exits nonzero before that line.  Imports nothing of JAX or of ``mdgan_tpu``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import io
import itertools
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

from mdgan_tpu_torch.core.timing import card_line
from mdgan_tpu_torch.ops import _build

ADAM_BYTES_PER_ELEM = 28    # read p, g, mu, nu; write p, mu, nu (float32)
ADAM_OPS_PER_ELEM = 13      # see csrc/adam.cu
# the bfloat16-moment kernel: read p, g (4 B each) and mu, nu (2 B each), write
# p, mu, nu: 20 B; its 13 operations plus the bf16 roundings of b1*mu and
# b2*nu and of the two stored moments
ADAM_BF16M_BYTES_PER_ELEM = 20
ADAM_BF16M_OPS_PER_ELEM = 17
L2_BYTES = 50 * 2 ** 20     # H100 SXM L2 cache
# the most float32 bytes one sampling launch of a chunk writes: the engines'
# GATHER_CAP_BYTES, restated here so the expected launch counts do not come
# from the code under test
SAMPLING_CAP_BYTES = 256 * 2 ** 20
# the other model families' datasets and their stored image shapes (H, W, C)
FAMILIES = {"MNIST": (28, 28, 1), "CelebA": (64, 64, 3), "FFHQ128": (128, 128, 3)}
ROOT = Path(__file__).resolve().parent
# the bench phase's cut of the headline config: chunks of BENCH_CHUNK rounds,
# BENCH_TIMED of them timed a dtype; bench_sustained's run of BENCH_SUSTAINED
# rounds after BENCH_WARM
BENCH_CHUNK, BENCH_TIMED, BENCH_SUSTAINED, BENCH_WARM = 50, 1, 100, 20
GOLDEN = ROOT / "artifacts/golden/cifar10_w8_r2000/weights/generator_final.npz"


class SmokeFailure(RuntimeError):
    pass


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def adam_arena(gen, n, rec, name, bf16_moments=False):
    """Adam on an arena of ``n`` elements: 3 steps of the kernel against the
    plain version (rtol 1e-6; the worst errors go into ``rec``), then
    kernel, plain and fused-torch device times, the inputs rotated out of
    the L2.  ``bf16_moments``: the bfloat16-moment kernel, which must be
    bit-equal to its plain version (both round at the same points with
    round-to-nearest-even), and has no library call: fused torch Adam keeps
    its moments in the parameters' dtype."""
    import torch

    from mdgan_tpu_torch.core.timing import bound_ms, time_ms
    from mdgan_tpu_torch.ops import adam

    dev = torch.device("cuda")
    lr, b1, b2, eps = 2e-4, 0.0, 0.999, 1e-8
    plain = adam.adam_plain_bf16m if bf16_moments else adam.adam_plain

    def rand(scale, positive=False):
        t = torch.randn(n, generator=gen, device=dev) * scale
        return t.abs() if positive else t
    start = [rand(0.02), rand(1e-2), rand(1e-3), rand(1e-5, positive=True)]
    if bf16_moments:
        start[2:] = [t.to(torch.bfloat16) for t in start[2:]]
    ker = [t.clone() for t in start]
    ref = [t.clone() for t in start]
    for count in (1, 2, 3):
        lr_c1, inv_c2 = adam.bias_scalars(lr, b1, b2, count)
        adam.adam_update(ker[0], ker[1], ker[2], ker[3], lr_c1, inv_c2, b1, b2, eps)
        plain(ref[0], ref[1], ref[2], ref[3], lr_c1, inv_c2, b1, b2, eps)
    torch.cuda.synchronize()
    for i in (0, 2, 3):  # p, mu, nu
        err = (ker[i].float() - ref[i].float()).abs()
        rel = float((err / (1e-30 + ref[i].float().abs())).max())
        if bf16_moments:
            require(torch.equal(ker[i], ref[i]),
                    f"bf16-moment adam kernel vs plain on {name}: max rel err {rel}")
        else:
            require(bool((err <= 1e-9 + 1e-6 * ref[i].abs()).all()),
                    f"adam kernel vs plain on {name}: max rel err {rel}")
        rec["max_abs_err"] = max(rec["max_abs_err"], float(err.max()))
        rec["max_rel_err"] = max(rec["max_rel_err"], rel)

    lr_c1, inv_c2 = adam.bias_scalars(lr, b1, b2, 4)
    per_elem = ADAM_BF16M_BYTES_PER_ELEM if bf16_moments else ADAM_BYTES_PER_ELEM
    # consecutive timed calls rotate over enough copies of the arenas
    # that each finds its inputs outside the L2, as a launch inside a
    # round does (the 1-D arena alone would stay L2-resident)
    resident = 12 if bf16_moments else 16  # bytes an element holds in p, g, mu, nu
    copies = max(1, math.ceil(2 * L2_BYTES / (resident * n)))
    sets = [ker] + [[t.clone() for t in ker] for _ in range(copies - 1)]
    refs = [ref] + [[t.clone() for t in ref] for _ in range(copies - 1)]
    it = itertools.count()
    k_t = time_ms(lambda: adam.adam_update(*sets[next(it) % copies], lr_c1, inv_c2,
                                           b1, b2, eps), 50)
    p_t = time_ms(lambda: plain(*refs[next(it) % copies], lr_c1, inv_c2, b1, b2, eps), 20)
    library_ms = None
    if not bf16_moments:
        opts = []
        for _ in range(copies):
            param = torch.nn.Parameter(start[0].clone())
            param.grad = start[1].clone()
            opts.append(torch.optim.Adam([param], lr=lr, betas=(b1, b2), eps=eps, fused=True))
        library_ms = time_ms(lambda: opts[next(it) % copies].step(), 50)["ms"]
        del opts
    b_ms, b_by = bound_ms(per_elem * n,
                          (ADAM_BF16M_OPS_PER_ELEM if bf16_moments else ADAM_OPS_PER_ELEM) * n)
    del start, ker, ref, sets, refs
    torch.cuda.empty_cache()
    return {"elements": n, "bytes": per_elem * n, "ms": k_t["ms"],
            "plain_ms": p_t["ms"], "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by,
            "share_of_bound": b_ms / k_t["ms"], "copies": copies,
            "host_us_per_call": k_t["host_us_per_call"]}


def _sum_arenas(*arenas):
    """A path's Adam per round (per local epoch in standalone): one launch on
    each of its arenas."""
    out = {key: sum(a[key] for a in arenas)
           for key in ("ms", "plain_ms", "bound_ms", "bytes")}
    libs = [a["library_ms"] for a in arenas]
    out["library_ms"] = None if None in libs else sum(libs)
    out["share_of_bound"] = out["bound_ms"] / out["ms"]
    return out


def g_shard_numel(size: int = 2) -> int:
    """The headline generator's parameters on one slot of a tensor axis of
    ``size`` (``parallel/tensor.py``): its Adam arena on an axes rank."""
    from mdgan_tpu_torch.core.mesh import Axis
    from mdgan_tpu_torch.core.registry import get as get_spec
    from mdgan_tpu_torch.parallel import tensor as tensor_lib

    g = tensor_lib.shard_module(get_spec("CIFAR10").make_generator(), Axis(size, 0))
    return sum(p.numel() for p in g.parameters())


def phase_kernels():
    """The three kernels at the main path's shapes, and at each other
    family's, against their plain versions: Adam with float32 moments and
    with bfloat16 moments on the same arenas, and sampling."""
    import torch

    from mdgan_tpu_torch.core.registry import get as get_spec

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def sizes(dataset):
        spec = get_spec(dataset)
        return (sum(p.numel() for p in spec.make_generator().parameters()),
                sum(p.numel() for p in spec.make_discriminator().parameters()))

    recs = []
    for bf16 in (False, True):
        rec = {"max_abs_err": 0.0, "max_rel_err": 0.0, "arenas": {}, "families": {}}
        # the MD-GAN round's arenas (G, 8 D) add up to the record's totals;
        # the standalone round's single-D arena is checked and timed beside them
        n_g, n_d1 = sizes("CIFAR10")
        for name, n in (("G", n_g), ("D x8", 8 * n_d1), ("D x1", n_d1)):
            rec["arenas"][name] = adam_arena(gen, n, rec, name, bf16)
        g, d8, d1 = (rec["arenas"][k] for k in ("G", "D x8", "D x1"))
        main = _sum_arenas(g, d8)
        rec.update({k: main[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bytes",
                                         "share_of_bound")}, bound_by=d8["bound_by"])
        rec["standalone"] = _sum_arenas(g, d1)  # one local epoch: one launch on G, one on D
        if not bf16:
            # the axes phase's (R=2, W=2, T=2) rank: its G tensor slice, 4 D
            rec["arenas"]["G T=2 shard"] = adam_arena(gen, g_shard_numel(), rec, "G T=2 shard")
            rec["arenas"]["D x4"] = adam_arena(gen, 4 * n_d1, rec, "D x4")
            rec["axes"] = _sum_arenas(rec["arenas"]["G T=2 shard"], rec["arenas"]["D x4"])
            # the recorded convergence legs at N=2 and N=4: G and the N-D arena
            rec["arenas"]["D x2"] = adam_arena(gen, 2 * n_d1, rec, "D x2")
            rec["mdgan_w2"] = _sum_arenas(g, rec["arenas"]["D x2"])
            rec["mdgan_w4"] = _sum_arenas(g, rec["arenas"]["D x4"])
        for dataset in FAMILIES:
            n_g, n_d1 = sizes(dataset)
            arenas = {name: adam_arena(gen, n, rec, f"{dataset} {name}", bf16)
                      for name, n in (("G", n_g), ("D x8", 8 * n_d1), ("D x1", n_d1))}
            rec["families"][dataset] = {
                "arenas": arenas, "mdgan": _sum_arenas(arenas["G"], arenas["D x8"]),
                "standalone": _sum_arenas(arenas["G"], arenas["D x1"])}
        recs.append(rec)
    recs[1]["library_ms_reason"] = ("no single PyTorch call keeps Adam's moments in "
                                    "bfloat16 beside float32 parameters "
                                    "(torch.optim.Adam(fused=True) keeps them in the "
                                    "parameters' dtype)")
    return recs[0], recs[1], phase_sampling(gen)


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
        # a replica's rows: b/R = 5 a worker (the axes phase's R=2 chunks)
        "axes_T100_b5": check("axes_T100_b5", cifar, indices(100, 8, 5, 6250)),
        # the recorded convergence legs' chunks: the same 50,000 rows as 2 and 4 shards
        "w2_T100": check("w2_T100", cifar.view(2, 25000, 32, 32, 3), indices(100, 2, 10, 25000)),
        "w4_T100": check("w4_T100", cifar.view(4, 12500, 32, 32, 3), indices(100, 4, 10, 12500)),
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
    for name, t, stack, b in (("chunk_T100", 100, cifar, 10), ("round_T1", 1, cifar, 10),
                              ("standalone_T100", 100, whole, 10),
                              ("axes_T100_b5", 100, cifar, 5),
                              ("w2_T100", 100, cifar.view(2, 25000, 32, 32, 3), 10),
                              ("w4_T100", 100, cifar.view(4, 12500, 32, 32, 3), 10),
                              # the bench phase's launches: its timed chunks
                              # and bench_sustained's run
                              *((f"bench_T{t}", t, cifar, 10)
                                for t in sorted({BENCH_CHUNK, BENCH_SUSTAINED}))):
        n, s = stack.shape[:2]
        rows = t * n * b
        # fresh rows each call, more of them than the L2 holds
        k = max(8, math.ceil(2 * L2_BYTES / (rows * 3072)))
        pool = [indices(t, n, b, s) for _ in range(k)]
        it = itertools.count()
        k_t = time_ms(lambda: sampling.sample_normalize(stack, pool[next(it) % k]), 20)
        p_t = time_ms(lambda: sampling.sample_normalize_plain(stack, pool[next(it) % k]), 10)
        nbytes = rows * (4 + 3072 + 4 * 3072)  # read each index and row, write float32 once
        b_ms, b_by = bound_ms(nbytes, 2 * rows * 3072)
        timed[name] = {"rounds_per_launch": t, "rows": rows, "bytes": nbytes,
                       "ms": k_t["ms"], "plain_ms": p_t["ms"], "bound_ms": b_ms,
                       "bound_by": b_by, "share_of_bound": b_ms / k_t["ms"],
                       "host_us_per_call": k_t["host_us_per_call"]}
    del cifar, whole
    torch.cuda.empty_cache()

    # each family's launch: 8,000 stored rows (the families phase's
    # --max_examples) as 8 shards, or as the standalone run's one shard; a
    # launch covers a 100-round chunk unless the cap cuts it shorter
    families = {}
    for dataset, (h, w, c) in FAMILIES.items():
        stack = shards_of(8, 1000, (h, w, c))
        row = h * w * c
        rec = {}
        for path, n, view in (("mdgan", 8, stack), ("standalone", 1, stack.view(1, 8000, h, w, c))):
            t = min(100, SAMPLING_CAP_BYTES // (n * 10 * row * 4))
            s_rows = view.shape[1]
            cases[f"{dataset}_{path}_T{t}"] = check(f"{dataset} {path}", view,
                                                    indices(t, n, 10, s_rows))
            rows = t * n * 10
            k = max(8, math.ceil(2 * L2_BYTES / (rows * row)))
            pool = [indices(t, n, 10, s_rows) for _ in range(k)]
            it = itertools.count()
            k_t = time_ms(lambda: sampling.sample_normalize(view, pool[next(it) % k]), 20)
            p_t = time_ms(lambda: sampling.sample_normalize_plain(view, pool[next(it) % k]), 10)
            nbytes = rows * (4 + row + 4 * row)
            b_ms, b_by = bound_ms(nbytes, 2 * rows * row)
            rec[path] = {"rounds_per_launch": t, "rows": rows, "bytes": nbytes, "ms": k_t["ms"],
                         "plain_ms": p_t["ms"], "bound_ms": b_ms, "bound_by": b_by,
                         "share_of_bound": b_ms / k_t["ms"],
                         "host_us_per_call": k_t["host_us_per_call"]}
        families[dataset] = rec
        del stack
        torch.cuda.empty_cache()
    main = timed["chunk_T100"]
    return {"ms": main["ms"], "plain_ms": main["plain_ms"], "library_ms": None,
            "bytes": main["bytes"], "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "max_abs_err": max(c["max_abs_err"] for c in cases.values()),
            "timed": timed, "families": families, "cases": cases}


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


# narrow family configurations for the card-vs-CPU rounds: dataset, the
# port's width keywords, the image shape the narrow model makes
NARROW_FAMILIES = {
    "MNIST": ({}, (28, 28, 1)),
    "CelebA": ({"ngf": 8, "ndf": 8}, (64, 64, 3)),
    "FFHQ128": ({"max_res": 32, "base_features": 32, "map_layers": 2}, (32, 32, 3)),
}


def _dropout_masks(rng, paths, b):
    """Keep masks for the MLP discriminator's three dropout layers at every
    key path of a round, from a numpy RNG, so the card and the CPU draw the
    same (their torch generators would not)."""
    import torch

    from mdgan_tpu_torch.models import mlp_gan

    return {path: [torch.from_numpy(rng.uniform(size=(b, d)) < mlp_gan.KEEP)
                   for d in mlp_gan.D_DIMS] for path in paths}


def _zero_conv_biases(net):
    """Zero every conv bias that BatchNorm follows (DCGAN-64's blocks 1 and
    2) in an arena-backed discriminator."""
    import torch

    from mdgan_tpu_torch.models.layers import ConvBlock

    with torch.no_grad():
        for module in net.modules:
            for m in module.modules():
                if isinstance(m, ConvBlock) and m.bn is not None and m.conv.bias is not None:
                    m.conv.bias.zero_()


def phase_family_rounds():
    """Each other family, narrow: two MD-GAN rounds (N=2, b=4) and two
    standalone rounds on the card against the same rounds on the CPU,
    float32 with TF32 off; latents, indices and (MLP) dropout masks
    injected.  The losses may part by ~1e-3 relative: a first Adam step
    moves each element by lr*sign(g), and the elements whose gradient sits
    at float noise (DCGAN-64's conv biases before BatchNorm have a zero
    gradient) flip between devices; a later step moves an element by at
    most lr*sqrt(2).  DCGAN-64's biased convs start from zero bias: at
    their init a channel's mean can dwarf its spread, and BatchNorm's
    E[x^2] - E[x]^2 then cancels in float32 differently on each device
    (ROADMAP.md C.3)."""
    import numpy as np
    import torch

    from mdgan_tpu_torch.core.config import TrainConfig
    from mdgan_tpu_torch.core.registry import get as get_spec
    from mdgan_tpu_torch.data.builtin import synthesize
    from mdgan_tpu_torch.data.partitioner import shard_data
    from mdgan_tpu_torch.engine.mdgan import MDGANEngine
    from mdgan_tpu_torch.engine.standalone import StandaloneEngine

    n, b, rounds, lr = 2, 4, 2, 2e-4
    out = {}
    for dataset, (kw, shape) in NARROW_FAMILIES.items():
        spec = get_spec(dataset)
        data = synthesize(shape, 48, seed=7)[0]
        shards_np, _ = shard_data(data, n, iid=True)
        rng = np.random.default_rng(1)
        mdgan_idx = rng.integers(0, shards_np.shape[1], (rounds, n, b)).astype(np.int32)
        sa_idx = rng.integers(0, len(data), (rounds, 1, b)).astype(np.int32)
        z_md = rng.standard_normal((rounds, 2 * b, spec.z_dim)).astype(np.float32)
        z_sa = rng.standard_normal((rounds, b, spec.z_dim)).astype(np.float32)
        use_masks = dataset == "MNIST"
        masks_md = [_dropout_masks(rng, [(0, w, h) for w in range(n) for h in (0, 1)]
                                   + [(1, w) for w in range(n)], b) for _ in range(rounds)]
        masks_sa = [_dropout_masks(rng, [(0, 0, 0), (0, 0, 1), (0, 1)], b)
                    for _ in range(rounds)]
        res = {}
        for dev in ("cpu", "cuda"):
            def on(masks):
                return ({k: [m.to(dev) for m in v] for k, v in masks.items()}
                        if use_masks else None)
            cfg = TrainConfig(batch_size=b, compute_dtype="float32", device=dev)
            eng = MDGANEngine(spec, cfg, n, model_kwargs=kw)
            st = eng.init_state(3)
            _zero_conv_biases(st.d)
            shards = eng.shard_data(shards_np)
            ms = [eng.step(st, shards, eng.put_indices(mdgan_idx[t], shards_np.shape[1]),
                           z=torch.from_numpy(z_md[t]).to(dev), masks=on(masks_md[t]))
                  for t in range(rounds)]
            sa = StandaloneEngine(spec, cfg, model_kwargs=kw)
            sst = sa.init_state(3)
            _zero_conv_biases(sst.d)
            whole = sa.put_data(data)
            sms = [sa.step(sst, whole, sa.put_indices(sa_idx[t], len(data)),
                           z=torch.from_numpy(z_sa[t]).to(dev), masks=on(masks_sa[t]))
                   for t in range(rounds)]
            res[dev] = (
                {**{k: np.stack([m[k].cpu().numpy() for m in ms])
                    for k in ("mean_d_loss", "g_feedback_loss", "feedback_norm")},
                 **{f"standalone {k}": np.array([float(m[k]) for m in sms])
                    for k in ("mean_d_loss", "mean_g_loss")}},
                [t.params.cpu() for t in (st.g, st.d, sst.g, sst.d)])
        worst = max(float(np.max(np.abs(a - res["cuda"][0][k]) / np.abs(a)))
                    for k, a in res["cpu"][0].items())
        require(worst <= 2e-3, f"{dataset} narrow rounds: card vs CPU rel err {worst}")
        dp = max(float((a - c).abs().max()) for a, c in zip(res["cpu"][1], res["cuda"][1]))
        require(dp <= 1.45 * 2 * lr * rounds,
                f"{dataset} narrow rounds: card vs CPU params max |diff| {dp}")
        out[dataset] = {"metric_max_rel_err": worst, "param_max_abs_diff": dp,
                        "width_kwargs": kw}
    return out


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


def upfirdn2d_library(x, k, up: int, pad):
    """The one cuDNN call that computes a config-f resampling site: with
    up=1 and equal pads a depthwise ``conv2d`` with the flipped filter, with
    up=2 and pads (2, 1, 2, 1) a depthwise stride-2 ``conv_transpose2d``
    cropped by 1 (its scatter is the true convolution of the zero-inserted
    plane).  Returns a function of the input."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    c, taps = x.shape[1], np.ascontiguousarray(k[::-1, ::-1] if up == 1 else k)
    w = torch.from_numpy(taps).to(x)[None, None].expand(c, 1, *k.shape).contiguous()
    if up == 1:
        require(len(set(pad)) == 1, f"upfirdn2d library call: unequal pads {pad}")
        return lambda t: F.conv2d(t, w, padding=pad[0], groups=c)
    require(up == 2 and tuple(pad) == (2, 1, 2, 1),
            f"upfirdn2d library call: up {up}, pads {pad}")
    return lambda t: F.conv_transpose2d(t, w, stride=2, padding=1, groups=c)


@no_tf32()
def phase_upfirdn2d():
    """The FIR resampling kernel against its plain version at config-f's
    resampling shapes, forward and backward, in float32 and bfloat16, on
    NCHW input and, at 8 channels or more, channels_last input (the ``nhwc``
    plan, which must give the NCHW plans' bits); each site's forward device
    time against the byte bound, the plain version's and cuDNN's one call
    (``upfirdn2d_library``) on the same layout, and each site's backward
    (the gradient's resampling, called as the backward calls it) against
    its byte bound, with the plan of each; then config-f MD-GAN rounds with
    the kernel's launches counted from them (``upfirdn2d_rounds``)."""
    import numpy as np
    import torch

    from mdgan_tpu_torch.core.timing import bound_ms, time_ms
    from mdgan_tpu_torch.models import stylegan2f
    from mdgan_tpu_torch.ops import upfirdn2d as fir

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def distinct(shape, dtype, layout):  # a per-(n, c) offset: a wrong stride shows
        n, c = shape[:2]
        t = torch.randn(shape, generator=gen, device=dev)
        t = (t + 0.25 * torch.arange(n * c, device=dev).view(n, c, 1, 1)).to(dtype)
        return t.contiguous(memory_format=layout)

    def plan_name(t, out_hw, up, down):
        return fir.plan(math.prod(t.shape[:2]), *out_hw, up, down,
                        t.shape[1] if fir.takes_nhwc(t) else 0, t.element_size()).name

    def site(name, shape, up, pad, k, dtype, layout):
        x = distinct(shape, dtype, layout).requires_grad_(True)
        before = _build.launches["mdgan_upfirdn2d"]
        y = fir.upfirdn2d(x, k, up=up, pad=pad)
        dy = distinct(y.shape, dtype, layout)
        (dx,) = torch.autograd.grad(y, x, dy)
        launched = _build.launches["mdgan_upfirdn2d"] - before
        require(launched == 2,
                f"upfirdn2d {name}: {launched} launches for a forward and its backward, want 2")
        xr = x.detach().float().requires_grad_(True)
        yr = fir.upfirdn2d_plain(xr, k, up=up, pad=pad)
        (dxr,) = torch.autograd.grad(yr, xr, dy.float())
        library = upfirdn2d_library(x.detach(), k, up, pad)
        gpad = fir.grad_pad(shape[2:], y.shape[2:], up, 1, pad)
        k_flip = np.ascontiguousarray(k[::-1, ::-1])
        errs = {}
        for what, got, want in (("forward", y, yr), ("backward", dx, dxr),
                                ("library", library(x.detach()), yr)):
            got, want = got.detach().float(), want.detach().float()
            err = (got - want).abs()
            # float32: the sums' order; bfloat16: the float32 sum rounded
            # once (half a bfloat16 ulp), plus the order where it cancels
            scale = 1e-5 * want.abs().max()
            if dtype == torch.bfloat16:
                scale = scale + 2.0 ** -8 * want.abs()
            require(bool((err <= scale).all()),
                    f"upfirdn2d {name} {dtype} {layout} {what}: max err {float(err.max())}")
            errs[what] = float(err.max())
        if fir.takes_nhwc(x):  # the same float32 sums in the same order as the NCHW plans
            require(torch.equal(y, fir.upfirdn2d(x.detach().contiguous(), k, up=up, pad=pad))
                    and torch.equal(dx, fir.upfirdn2d(dy.contiguous(), k_flip, up=1, down=up,
                                                      pad=gpad)),
                    f"upfirdn2d {name} {dtype}: the nhwc plan's bits differ from the NCHW plans'")
        nbytes = (x.numel() + y.numel()) * x.element_size()
        xs = [distinct(shape, dtype, layout)
              for _ in range(max(1, math.ceil(2 * L2_BYTES / nbytes)))]
        dys = [distinct(y.shape, dtype, layout) for _ in range(len(xs))]
        it = itertools.count()
        t = time_ms(lambda: fir.upfirdn2d(xs[next(it) % len(xs)], k, up=up, pad=pad), 20)
        lib_t = time_ms(lambda: library(xs[next(it) % len(xs)]), 20)
        # the backward's own call: dy (y's shape) back to x's shape
        bwd_t = time_ms(lambda: fir.upfirdn2d(dys[next(it) % len(dys)], k_flip, up=1, down=up,
                                              pad=gpad), 20)
        b_ms, b_by = bound_ms(nbytes, 2 * 16 * y.numel())
        bwd_ms, _ = bound_ms(nbytes, 2 * 16 * x.numel())
        rec = {"ms": t["ms"], "library_ms": lib_t["ms"], "bound_ms": b_ms, "bound_by": b_by,
               "share_of_bound": b_ms / t["ms"], "backward_ms": bwd_t["ms"],
               "backward_bound_ms": bwd_ms, "backward_share_of_bound": bwd_ms / bwd_t["ms"],
               "plans": {"forward": plan_name(x, y.shape[2:], up, 1),
                         "backward": plan_name(dy, shape[2:], 1, up)},
               "max_abs_err": errs}
        if layout == torch.contiguous_format:
            k_dev = torch.from_numpy(k).to(dev)  # the plain version's filter, on the card
            rec["plain_ms"] = time_ms(lambda: fir.upfirdn2d_plain(xs[next(it) % len(xs)], k_dev,
                                                                  up=up, pad=pad), 10)["ms"]
            rec.update(shape=list(shape), up=up, pad=list(pad), bytes=nbytes)
        return rec

    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        recs = {}
        for name, shape, up, pad in stylegan2f.upfirdn2d_sites():
            k = stylegan2f._FIR_UP if name.startswith("g_") else stylegan2f._FIR
            recs[name] = site(name, shape, up, pad, k, dtype, torch.contiguous_format)
            if shape[1] % fir.NHWC_CHANNELS == 0:
                recs[name]["nhwc"] = site(name, shape, up, pad, k, dtype, torch.channels_last)
            torch.cuda.empty_cache()
        sums = {key: sum(r[key] for r in recs.values())
                for key in ("ms", "plain_ms", "library_ms", "bound_ms", "backward_ms",
                            "backward_bound_ms")}
        # as the round runs them: channels_last where a site has 8 channels or more
        main = [r.get("nhwc", r) for r in recs.values()]
        path = {key: sum(r[key] for r in main)
                for key in ("ms", "library_ms", "backward_ms")}
        out[str(dtype).split(".")[-1]] = {
            "calls": recs, "forward_ms": sums["ms"], "plain_ms": sums["plain_ms"],
            "library_ms": sums["library_ms"], "bound_ms": sums["bound_ms"],
            "bound_by": "/".join(sorted({r["bound_by"] for r in recs.values()})),
            "share_of_bound": sums["bound_ms"] / sums["ms"],
            "backward_ms": sums["backward_ms"], "backward_bound_ms": sums["backward_bound_ms"],
            "backward_share_of_bound": sums["backward_bound_ms"] / sums["backward_ms"],
            "main_path": {"forward_ms": path["ms"], "library_ms": path["library_ms"],
                          "share_of_bound": sums["bound_ms"] / path["ms"],
                          "backward_ms": path["backward_ms"],
                          "backward_share_of_bound": sums["backward_bound_ms"]
                          / path["backward_ms"]},
            "max_abs_err": max(e for r in recs.values() for rr in (r, r.get("nhwc", r))
                               for e in rr["max_abs_err"].values())}
    torch.cuda.empty_cache()
    out["mdgan_rounds"] = upfirdn2d_rounds()
    return out


def upfirdn2d_rounds(rounds: int = 2, n: int = 8, b: int = 4, blocks: int = 6):
    """``rounds`` MD-GAN rounds of config-f at full width on the card (N=8,
    b=4, bfloat16, 16 random images a shard) through ``run_rounds``: losses
    finite, and the FIR kernel's launches counted from them.  Each of the
    ``blocks`` (8 to 256 px) has two resampling sites in the generator (the
    up-modconv's FIR, the RGB skip) and two in the discriminator (its
    blurs), each one launch a forward and one a backward: the generator's
    forward and VJP, and each worker's real and fake forwards, their
    backward, and the feedback's forward and backward.  Every one runs the
    ``nhwc`` plan (the networks' activations channels_last) but the RGB
    skips and their gradients, which take 3 channels."""
    import numpy as np
    import torch

    from mdgan_tpu_torch.core.config import TrainConfig
    from mdgan_tpu_torch.core.registry import get as get_spec
    from mdgan_tpu_torch.data.sampler import ShardSampler
    from mdgan_tpu_torch.engine.mdgan import MDGANEngine

    eng = MDGANEngine(get_spec("LSUNChurch256"), TrainConfig(batch_size=b,
                                                             compute_dtype="bfloat16"), n)
    st = eng.init_state(7)
    rng = np.random.default_rng(7)
    data = eng.shard_data(rng.integers(0, 256, (n, 16, 256, 256, 3), dtype=np.uint8))
    _build.launches.clear()
    t = time.perf_counter()
    m = eng.run_rounds(st, data, ShardSampler(n, 16, b, seed=7), rounds)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    launched = _build.launches["mdgan_upfirdn2d"]
    plans = {key.split("/")[1]: count for key, count in _build.launches.items()
             if key.startswith("mdgan_upfirdn2d/")}
    want = rounds * (2 * 2 * blocks + n * 6 * 2 * blocks)
    rgb = rounds * 2 * blocks
    losses = {k: m[k].float().cpu().tolist() for k in ("mean_d_loss", "g_feedback_loss")}
    require(all(math.isfinite(v) for vals in losses.values() for row in vals for v in row),
            f"config-f rounds: losses {losses}")
    require(launched == want, f"config-f rounds: {launched} upfirdn2d launches, want {want}")
    require(sum(plans.values()) == launched and plans.get("nhwc") == want - rgb,
            f"config-f rounds: plans {plans}, want nhwc {want - rgb} and {rgb} others")
    del eng, st, data, m
    torch.cuda.empty_cache()
    return {"rounds": rounds, "num_workers": n, "batch_size": b, "launches": launched,
            "plans": plans, "seconds": seconds, **losses}


def upfirdn2d_entry(rec: dict) -> dict:
    """The FIR kernel's entry of the ``kernels`` line: its launches on the
    main path (``upfirdn2d_rounds``), by plan, and its bfloat16 forward
    times (config-f's compute dtype) summed over the sites of one generator
    forward (8 images) and one discriminator forward (4 images) in the
    layouts the round runs them in, against the plain version's, cuDNN's
    (on the same layouts) and the byte bound.  The JAX package has no such
    kernel: NVlabs' StyleGAN2 ships it as its own CUDA op."""
    bf16, rounds = rec["bfloat16"], rec["mdgan_rounds"]
    times = {"plain_ms": bf16["plain_ms"], "library_ms": bf16["main_path"]["library_ms"],
             "bound_ms": bf16["bound_ms"], "bound_by": bf16["bound_by"]}
    ms = bf16["main_path"]["forward_ms"]
    return {"name": "upfirdn2d", "route": "cuda", "source": "mdgan_tpu_torch/csrc/upfirdn2d.cu",
            "replaces": None, "launches": rounds["launches"],
            "max_abs_err": max(rec[d]["max_abs_err"] for d in ("float32", "bfloat16")),
            "ms": ms, **times,
            "by_path": {"stylegan2f_mdgan_bfloat16": {"launches": rounds["launches"],
                                                      "plans": rounds["plans"], "ms": ms,
                                                      **times}}}


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


def run_main(argv, server_csv=False, keep_logs=None):
    """The CLI's main in-process, writing its files into a temporary
    directory; returns its summary (last stdout line) and log lines, and
    with ``server_csv`` the server CSV's rows.  ``keep_logs``: a directory
    the run's span CSVs are copied to."""
    import csv

    from mdgan_tpu_torch.cli import train

    buf = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(buf):
        rc = train.main(argv + out_dirs(Path(tmp)))
        rows = [list(csv.DictReader(io.StringIO(p.read_text()))) for p in
                (Path(tmp) / "log_dir").glob("*.server.logs.csv")] if server_csv else None
        if keep_logs is not None and rc == 0:
            shutil.copytree(Path(tmp) / "log_dir", keep_logs)
    require(rc == 0, f"train.main returned {rc}")
    lines = buf.getvalue().strip().splitlines()
    out = json.loads(lines[-1]), [json.loads(ln) for ln in lines[:-1]]
    if server_csv:
        require(len(rows) == 1, f"{len(rows)} server CSVs")
        return (*out, rows[0])
    return out


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


def phase_mdgan(keep: Path, rounds: int = 20):
    """The headline config through the CLI, float32 with the default chunk
    size, then bfloat16 with chunks of 4: one sampling launch per chunk; then
    float32 with bfloat16 Adam moments and the straggler policy at rate 0.3:
    every Adam launch the bf16-moment kernel, and the server CSV's
    ``n_feedbacks`` column in [1, 8].  The float32 run's span CSVs are kept
    under ``keep`` for the ``tools`` phase."""

    base = ["--mode", "mdgan", "--dataset", "CIFAR10", "--num_workers", "8",
            "--batch_size", "10", "--epochs", str(rounds), "--swap_interval", "10",
            "--log_interval", "10"]
    _build.launches.clear()
    runs, prev = {}, (0, 0, 0)
    for name, extra, chunk in (
            ("float32", ["--compute_dtype", "float32"], 100),
            ("bfloat16", ["--compute_dtype", "bfloat16"], 4),
            ("bf16_moments_straggler", ["--compute_dtype", "float32", "--moment_dtype",
                                        "bfloat16", "--straggler_rate", "0.3"], 100)):
        summary, logs, rows = run_main(base + extra + ["--chunk_size", str(chunk)],
                                       server_csv=True,
                                       keep_logs=keep if name == "float32" else None)
        now = tuple(_build.reported().values())
        launched = tuple(a - b for a, b in zip(now, prev))
        prev = now
        chunks = cli_chunks(rounds, 10, 10, chunk)
        bf16m = name == "bf16_moments_straggler"
        want = (0, 2 * rounds, len(chunks)) if bf16m else (2 * rounds, 0, len(chunks))
        require(summary["all_finite"], f"{name}: non-finite metrics")
        require(summary["swaps"] == (rounds - 1) // 10,
                f"{name}: {summary['swaps']} swaps, want {(rounds - 1) // 10}")
        require(launched == want,
                f"{name}: launches adam f32/bf16-moment/sampling {launched}, want {want} "
                f"(one sampling launch per chunk {chunks})")
        require([e["epoch"] for e in summary["evals"]] == [0, 10, rounds - 1]
                and all(math.isfinite(e["fid"]) and math.isfinite(e["is"])
                        for e in summary["evals"]), f"{name}: evals {summary['evals']}")
        n_fb = [row.get("n_feedbacks") for row in rows]
        if bf16m:
            require(n_fb and all(v not in (None, "") and 1 <= int(v) <= 8 for v in n_fb),
                    f"{name}: n_feedbacks column {n_fb}")
        else:
            require(all(v is None for v in n_fb), f"{name}: an n_feedbacks column at rate 0")
        r0, r1 = logs[-2], logs[-1]  # rounds 10 and 19: past the warm-up
        summary["steady_rounds_per_s"] = ((r1["round"] - r0["round"])
                                          / (r1["elapsed_s"] - r0["elapsed_s"]))
        runs[name] = {**summary, "chunk_size": chunk, "chunks": chunks,
                      "adam_launches": launched[0], "adam_bf16m_launches": launched[1],
                      "sampling_launches": launched[2], "log": logs,
                      "n_feedbacks": [int(v) for v in n_fb] if bf16m else None}
    counts = {name: {"adam": r["adam_launches"], "adam_bf16m": r["adam_bf16m_launches"],
                     "sampling": r["sampling_launches"]} for name, r in runs.items()}
    return runs, counts


def phase_standalone(rounds: int = 30, local_epochs: int = 1):
    """The CLI in --mode standalone at full width (CIFAR10, b=10, DCGAN-32),
    float32 with the default chunk size: the launch counts computed apart
    from the engine, 2 Adam launches a local epoch and one sampling launch a
    chunk; then a narrow standalone round held to the CPU's."""

    argv = ["--mode", "standalone", "--dataset", "CIFAR10", "--batch_size", "10",
            "--epochs", str(rounds), "--log_interval", "10", "--local_epochs",
            str(local_epochs), "--compute_dtype", "float32"]
    _build.launches.clear()
    summary, logs = run_main(argv)
    launched = _build.reported()
    chunks = cli_chunks(rounds, 0, 10, 100, 3000)
    require(summary["all_finite"], "standalone: non-finite metrics")
    require(launched == {"adam": 2 * local_epochs * rounds, "adam_bf16m": 0,
                         "sampling": len(chunks)},
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


def sampling_launches(chunks, n, shape):
    """Sampling launches of a run's chunks at N=n, b=10: one a chunk, or as
    many as keep each launch's float32 output within SAMPLING_CAP_BYTES."""
    per_round = n * 10 * shape[0] * shape[1] * shape[2] * 4
    span = max(1, SAMPLING_CAP_BYTES // per_round)
    return sum(-(-t // span) for t in chunks)


def phase_families(rounds: int = 10):
    """Each other family at full width through the CLI: MD-GAN (N=8, b=10,
    --swap_interval 5) in float32 and bfloat16 and standalone in float32,
    ``rounds`` rounds on 8,000 examples each, launches counted from the
    run; then the capped gather of a 40-round chunk at 128x128x3."""

    out = {}
    for dataset, shape in FAMILIES.items():
        runs = {}
        for name, mode, dtype in (("mdgan_float32", "mdgan", "float32"),
                                  ("mdgan_bfloat16", "mdgan", "bfloat16"),
                                  ("standalone_float32", "standalone", "float32")):
            argv = ["--mode", mode, "--dataset", dataset, "--num_workers", "8",
                    "--batch_size", "10", "--epochs", str(rounds), "--swap_interval", "5",
                    "--log_interval", "5", "--max_examples", "8000", "--compute_dtype", dtype]
            _build.launches.clear()
            t = time.perf_counter()
            summary, logs = run_main(argv)
            seconds = time.perf_counter() - t
            launched = _build.reported()
            n = 8 if mode == "mdgan" else 1
            chunks = cli_chunks(rounds, 5 if mode == "mdgan" else 0, 5, 100, 3000)
            want = {"adam": 2 * rounds, "adam_bf16m": 0,
                    "sampling": sampling_launches(chunks, n, shape)}
            require(summary["all_finite"], f"{dataset} {name}: non-finite losses")
            require(launched == want, f"{dataset} {name}: launches {launched}, want {want} "
                                      f"(chunks {chunks})")
            want_evals = [0, 5, rounds - 1] if mode == "mdgan" else [0, 5]
            require([e["epoch"] for e in summary["evals"]] == want_evals
                    and all(math.isfinite(e["fid"]) and math.isfinite(e["is"])
                            for e in summary["evals"]),
                    f"{dataset} {name}: evals {summary['evals']}")
            if mode == "mdgan":
                require(summary["swaps"] == (rounds - 1) // 5,
                        f"{dataset} {name}: {summary['swaps']} swaps")
            runs[name] = {**{k: summary[k] for k in ("rounds", "wall_time_s", "steps_per_sec",
                                                     "final_mean_d_loss", "evals")},
                          "seconds": seconds, "chunks": chunks, "launches": launched,
                          "log": logs}
        out[dataset] = runs
    out["capped_gather"] = _capped_gather_check()
    return out


def _capped_gather_check(rounds: int = 40):
    """The MD-GAN engine's gather of a 40-round chunk of 128x128x3 rows
    (N=8, b=10: 629 MB of float32) in launches of at most 256 MiB, against
    the plain gather of the whole chunk, bit for bit."""
    import numpy as np
    import torch

    from mdgan_tpu_torch.core.config import TrainConfig
    from mdgan_tpu_torch.core.registry import get as get_spec
    from mdgan_tpu_torch.engine.mdgan import MDGANEngine
    from mdgan_tpu_torch.ops import sampling

    shape = FAMILIES["FFHQ128"]
    eng = MDGANEngine(get_spec("FFHQ128"), TrainConfig(), 8)
    rng = np.random.default_rng(5)
    shards = eng.shard_data(rng.integers(0, 256, (8, 200, *shape), dtype=np.uint8))
    idx = eng.put_indices(rng.integers(0, 200, (rounds, 8, 10)), 200)
    _build.launches.clear()
    got = torch.stack(list(eng._real_batches(shards, idx)))
    launched = _build.reported()["sampling"]
    want = sampling.sample_normalize_plain(shards, idx)
    require(launched == sampling_launches([rounds], 8, shape),
            f"capped gather: {launched} launches, want {sampling_launches([rounds], 8, shape)}")
    require(torch.equal(got, want), "capped gather differs from the plain gather")
    return {"rounds": rounds, "launches": launched, "bit_equal": True,
            "bytes": got.numel() * 4}


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


def phase_trainer(keep: Path):
    """Both trainers end to end at full width in a temporary directory, with
    cadences of a few rounds: the span CSVs carry the JAX columns, FID/IS are
    finite, and a run of 8 rounds equals 4 rounds plus --resume for 4, bit for
    bit on every arena.  The last needs deterministic kernels on the card
    (cuDNN's and cuBLAS's defaults may use atomics), so this phase runs with
    ``torch.use_deterministic_algorithms(True)``; that each run repeats
    without it is reported, not required.  Also times the Inception forward
    on 5 and 256 images, the 5-sample and 256-image evals, and one
    checkpoint save of the headline MD-GAN state.  The MD-GAN run's
    checkpoints and weight exports are kept under ``keep`` for the ``tools``
    phase."""
    import torch

    from mdgan_tpu_torch.cli import train as cli
    from mdgan_tpu_torch.engine import train_loop

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
            _build.launches.clear()
            torch.use_deterministic_algorithms(True)
            try:
                full, summary = run(root / mode / "full", mode, 8)
                run(root / mode / "split", mode, 4)
                resumed, _ = run(root / mode / "split", mode, 8, "--resume")
            finally:
                torch.use_deterministic_algorithms(False)
            launched = {k: _build.reported()[k] for k in ("adam", "sampling")}
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
            if mode == "mdgan":
                for sub in ("checkpoint_dir", "weights_dir"):
                    shutil.copytree(root / mode / "full" / sub, keep / sub)
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


# --- tools: the native data path, --download, generate, convert_weights, analyze


def _png_size(path: Path):
    """(width, height) from a PNG's IHDR (the card's machine has no PIL)."""
    head = path.read_bytes()[:24]
    require(head[:8] == b"\x89PNG\r\n\x1a\n" and head[12:16] == b"IHDR", f"{path}: not a PNG")
    return int.from_bytes(head[16:20], "big"), int.from_bytes(head[20:24], "big")


def _write_cifar_bin(directory: Path, images, labels, per_file: int = 10000):
    """The CIFAR-10 train split in its binary layout: 5 files of ``per_file``
    records, [label byte][3,072 pixel bytes, CHW]."""
    import numpy as np

    directory.mkdir(parents=True)
    chw = images.transpose(0, 3, 1, 2).reshape(len(images), -1)
    recs = np.concatenate([labels.astype(np.uint8)[:, None], chw], axis=1)
    for i in range(5):
        (directory / f"data_batch_{i + 1}.bin").write_bytes(
            recs[i * per_file:(i + 1) * per_file].tobytes())


def _idx(arr) -> bytes:
    """A uint8 array in MNIST's idx layout."""
    head = (0x0800 | arr.ndim).to_bytes(4, "big") + b"".join(
        d.to_bytes(4, "big") for d in arr.shape)
    return head + arr.astype("uint8").tobytes()


def _idx_gz(arr) -> bytes:
    """An array in MNIST's idx layout, gzipped."""
    import gzip

    return gzip.compress(_idx(arr), compresslevel=1)


def _alternated(reps: int, **fns):
    """Host seconds of each function over ``reps`` rounds, called in turn
    (the first and the second alternate which goes first), and the last
    result of each."""
    seconds = {name: [] for name in fns}
    results = {}
    for rep in range(reps):
        order = list(fns) if rep % 2 == 0 else list(fns)[::-1]
        for name in order:
            t = time.perf_counter()
            results[name] = fns[name]()
            seconds[name].append(time.perf_counter() - t)
    return seconds, results


def _timed_pair(reps: int, what: str, want, native_fn, numpy_fn):
    """``native_fn`` against ``numpy_fn``, alternated: each must return
    ``want`` byte for byte; host seconds of each (every run, and the
    median)."""
    import numpy as np

    seconds, results = _alternated(reps, native=native_fn, numpy=numpy_fn)
    for name, got in results.items():
        require(got is not None and len(got) == len(want)
                and all(np.array_equal(a, b) for a, b in zip(got, want)),
                f"tools: {what} ({name}) differs")
    return {**{f"{k}_s": float(np.median(v)) for k, v in seconds.items()},
            **{f"{k}_runs_s": v for k, v in seconds.items()}}


def _download_sources(src: Path):
    """MNIST's four idx ``.gz`` files (8,000 train and 1,000 test images of
    the synthetic stand-in) and a ``cifar-10-python.tar.gz`` of pickle
    batches (1,000 records each) under ``src``; returns their sha256
    checksums."""
    import hashlib
    import pickle
    import tarfile

    from mdgan_tpu_torch.data import builtin, download

    src.mkdir(parents=True)
    sums = {}
    for stem, n in (("train", 8000), ("t10k", 1000)):
        images, labels = builtin.synthesize((28, 28, 1), n, seed=28 + n)
        for kind, arr in (("images-idx3", images[..., 0]), ("labels-idx1", labels)):
            name = f"{stem}-{kind}-ubyte.gz"
            (src / name).write_bytes(_idx_gz(arr))
    for name, _ in download.MNIST_FILES:
        sums[name] = "sha256:" + hashlib.sha256((src / name).read_bytes()).hexdigest()
    images, labels = builtin.synthesize((32, 32, 3), 6000, seed=7)
    archive = src / download.CIFAR10_ARCHIVE[0]
    with tarfile.open(archive, "w:gz", compresslevel=1) as tf:
        names = [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]
        for i, name in enumerate(names):
            part = slice(i * 1000, (i + 1) * 1000)
            payload = pickle.dumps({b"data": images[part].transpose(0, 3, 1, 2).reshape(1000, -1),
                                    b"labels": [int(v) for v in labels[part]]})
            info = tarfile.TarInfo(f"cifar-10-batches-py/{name}")
            info.size = len(payload)
            tf.addfile(info, io.BytesIO(payload))
    sums["cifar10"] = "sha256:" + hashlib.sha256(archive.read_bytes()).hexdigest()
    return sums


@contextlib.contextmanager
def _file_urls_only():
    """Fetches from anything but a file:// source fail, so no run of this
    phase can reach a network."""
    import urllib.request

    real = urllib.request.urlopen

    def urlopen(url, *a, **k):
        if not str(getattr(url, "full_url", url)).startswith("file://"):
            raise SmokeFailure(f"tools: a fetch of {url} (only file:// sources here)")
        return real(url, *a, **k)

    urllib.request.urlopen = urlopen
    try:
        yield
    finally:
        urllib.request.urlopen = real


def _tools_downloads(root: Path):
    """(d): --download offline, from file:// sources with their checksums;
    corrupted copies rejected with nothing left behind."""
    from mdgan_tpu_torch.data import builtin, download

    src = root / "src"
    sums = _download_sources(src)
    data_dir = root / "data"
    mnist = download.download_mnist(str(data_dir), base_url=src.as_uri(), checksums=sums)
    require(sorted(p.name for p in mnist.iterdir()) == sorted(n for n, _ in download.MNIST_FILES),
            f"download_mnist left {sorted(p.name for p in mnist.iterdir())}")
    cifar = download.download_cifar10(str(data_dir), base_url=src.as_uri(),
                                      checksum=sums["cifar10"])
    loaded = {"mnist": builtin.load_mnist(str(data_dir), fallback="error")[0].shape,
              "cifar10": builtin.load_cifar10(str(data_dir), fallback="error")[0].shape}
    require(loaded == {"mnist": (8000, 28, 28, 1), "cifar10": (5000, 32, 32, 3)},
            f"downloaded data loads as {loaded}")
    require(not list(cifar.parent.glob(".extract.*")) and not list(cifar.parent.glob("*.part*")),
            "download_cifar10 left its staging files")
    bad_src, bad = root / "bad_src", root / "bad"
    shutil.copytree(src, bad_src)
    for name in ("train-images-idx3-ubyte.gz", download.CIFAR10_ARCHIVE[0]):
        raw = bytearray((bad_src / name).read_bytes())
        raw[len(raw) // 2] ^= 0xFF
        (bad_src / name).write_bytes(bytes(raw))
    rejected = []
    for fetch in (lambda: download.download_mnist(str(bad), base_url=bad_src.as_uri(),
                                                  checksums=sums),
                  lambda: download.download_cifar10(str(bad), base_url=bad_src.as_uri(),
                                                    checksum=sums["cifar10"])):
        try:
            fetch()
        except ValueError as err:
            rejected.append("checksum mismatch" in str(err))
    left = sorted(str(p.relative_to(bad)) for p in bad.rglob("*") if p.is_file())
    require(rejected == [True, True] and not left,
            f"corrupted copies: rejected {rejected}, left {left}")
    return data_dir, {"mnist_files": sorted(p.name for p in mnist.iterdir()),
                      "cifar10_batches": sorted(p.name for p in cifar.iterdir()),
                      "loaded_shapes": {k: list(v) for k, v in loaded.items()},
                      "corrupt_rejected": True, "left_after_rejection": left}


def _tools_cli(argv, shape, swap_interval, log_interval, rounds, n=8):
    """The CLI on the card: finite losses, 2 Adam launches a round, the
    sampling launches of its chunks; returns (summary, launches)."""

    _build.launches.clear()
    summary, _ = run_main(argv)
    launched = _build.reported()
    chunks = cli_chunks(rounds, swap_interval, log_interval, 100)
    want = {"adam": 2 * rounds, "adam_bf16m": 0,
            "sampling": sampling_launches(chunks, n, shape)}
    require(summary["all_finite"], f"tools CLI {argv}: non-finite losses")
    require(launched == want, f"tools CLI {argv}: launches {launched}, want {want} "
                              f"(chunks {chunks})")
    return summary, launched


def _tools_generate(keep: Path, out: Path):
    """(f): cli.generate from the trainer phase's checkpoint (64 samples on
    the card) and from a weights export; with the same latents and TF32 off
    the card's images against the CPU's; a filmstrip over the exports."""
    import torch

    from mdgan_tpu_torch.cli import generate
    from mdgan_tpu_torch.core.registry import get as get_spec

    ckpt_dir = keep / "checkpoint_dir" / "mdgan.8.CIFAR10"
    weights = keep / "weights_dir"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        torch.cuda.synchronize()
        t = time.perf_counter()
        rc = generate.main(["--dataset", "CIFAR10", "--checkpoint", str(ckpt_dir), "--num", "64",
                            "--out", str(out / "checkpoint.png")])
        seconds = time.perf_counter() - t
        rc_w = generate.main(["--dataset", "CIFAR10", "--weights",
                              str(weights / "generator_final.npz"), "--num", "64",
                              "--out", str(out / "weights.png")])
        exports = sorted(weights.glob("generator_*.npz"))
        rc_f = generate.main(["--dataset", "CIFAR10", "--weights_glob",
                              str(weights / "generator_*.npz"), "--filmstrip",
                              str(out / "strip.png")])
    require((rc, rc_w, rc_f) == (0, 0, 0), f"generate returned {(rc, rc_w, rc_f)}")
    require(_png_size(out / "checkpoint.png") == _png_size(out / "weights.png") == (320, 224),
            f"generate grids {_png_size(out / 'checkpoint.png')}")
    require(_png_size(out / "strip.png") == (32 * len(exports), 32),
            f"filmstrip {_png_size(out / 'strip.png')} over {len(exports)} exports")
    spec = get_spec("CIFAR10")
    with contextlib.redirect_stdout(io.StringIO()):
        params, stats = generate.load_from_checkpoint(str(ckpt_dir), None)
    z = generate.latents(spec, 64, 0, "cpu")
    with no_tf32():
        card = generate.sample_images(spec, params, stats, 64, 0, "cuda", z=z)
    cpu = generate.sample_images(spec, params, stats, 64, 0, "cpu", z=z)
    err = float(abs(card - cpu).max())
    require(card.shape == (64, 32, 32, 3) and err <= 1e-4,
            f"generate: card vs CPU max abs err {err} (shape {card.shape})")
    return {"seconds_64_samples": seconds, "card_vs_cpu_max_abs_err": err,
            "log": buf.getvalue().strip().splitlines(), "filmstrip_frames": len(exports)}


def _tools_convert(root: Path):
    """(g): cli.convert_weights npz -> pt -> npz on each (dataset, role) pair
    from the port's init exports, bit-exact."""
    import numpy as np

    from mdgan_tpu_torch.cli import convert_weights
    from mdgan_tpu_torch.core import prng
    from mdgan_tpu_torch.core.registry import get as get_spec
    from mdgan_tpu_torch.models import from_jax, layers
    from mdgan_tpu_torch.utils import checkpoint

    out = {}
    for dataset in ("CIFAR10", "CelebA", "MNIST"):
        spec = get_spec(dataset)
        for role in ("generator", "discriminator"):
            module = spec.make_generator() if role == "generator" else spec.make_discriminator()
            (spec.init_weights or layers.dcgan_init_)(module, prng.generator(1, prng.INIT_G))
            stem = root / f"{dataset}_{role}"
            checkpoint.save_weights_only(f"{stem}.npz", *from_jax.export(module))
            base = ["--dataset", dataset, "--role", role]
            with contextlib.redirect_stdout(io.StringIO()):
                rcs = (convert_weights.main(base + ["--input", f"{stem}.npz",
                                                    "--out", f"{stem}.pt"]),
                       convert_weights.main(base + ["--input", f"{stem}.pt",
                                                    "--out", f"{stem}.back.npz"]))
            with np.load(f"{stem}.npz") as a, np.load(f"{stem}.back.npz") as b:
                same = sorted(a.files) == sorted(b.files) and all(
                    a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]) for k in a.files)
                keys = len(a.files)
            require(rcs == (None, None) and same,
                    f"convert_weights {dataset} {role}: round trip not bit-exact (rc {rcs})")
            out[f"{dataset}/{role}"] = keys
    return out


def _tools_analyze(keep_logs: Path, rounds: int):
    """(h): cli.analyze --json on the mdgan phase's server and worker CSVs."""
    from mdgan_tpu_torch.cli import analyze

    csvs = sorted(str(p) for p in keep_logs.glob("*.csv"))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = analyze.main(["--json"] + csvs)
    reports = {Path(r["file"]).name: r for r in json.loads(buf.getvalue())}
    server = [r for n, r in reports.items() if ".server." in n]
    workers = [r for n, r in reports.items() if ".worker." in n]
    require(rc == 0 and len(server) == 1 and len(workers) == 8, f"analyze: {sorted(reports)}")
    s = server[0]
    require(s.get("rounds") == rounds and math.isfinite(s.get("rounds_per_sec", math.nan))
            and {"epoch", "epoch_calculation", "fid"} <= set(s["ops"]),
            f"analyze server report {s}")
    require(all(w["rows"] == rounds and w.get("rounds") == rounds
                and {"epoch", "calc_gradients"} <= set(w["ops"]) for w in workers),
            f"analyze worker reports {[(w['rows'], sorted(w['ops'])) for w in workers]}")
    return {"server": {k: s[k] for k in ("rows", "rounds", "wall_s", "rounds_per_sec")},
            "server_ops": sorted(s["ops"]), "workers": len(workers)}


def phase_tools(keep: Path, rounds: int = 10, mnist_rounds: int = 5):
    """The native host library (required), the CIFAR-10 ``.bin`` decode of
    the full train split against its numpy version, the headline CLI on
    that ``.bin`` folder, ``--download`` offline and an MNIST run after it,
    the threaded shard gather against numpy at FFHQ128's 8,000 stand-in
    examples, ``cli.generate``, ``cli.convert_weights`` on the six (dataset,
    role) pairs and ``cli.analyze`` on the mdgan phase's CSVs."""
    import numpy as np

    from mdgan_tpu_torch.data import builtin, native, partitioner

    out = {"cpu_count": os.cpu_count()}
    # (a) the library (built from the checkout in the build phase, which
    # fails with g++'s output where it does not build) must load
    require(not os.environ.get("MDGAN_TPU_NO_NATIVE"), "tools: MDGAN_TPU_NO_NATIVE is set")
    require(native.available(), "tools: the native library did not load")
    out["library"] = native.library_path().name
    launches = {}
    with tempfile.TemporaryDirectory() as tmp, _file_urls_only():
        root = Path(tmp)
        # (b) the full train split in the binary layout, and MNIST's in raw
        # idx files, each decoded natively and in numpy, alternated
        images, labels = builtin.synthesize((32, 32, 3), 50000, seed=32)
        bin_dir = root / "bin" / "cifar10" / "cifar-10-batches-bin"
        _write_cifar_bin(bin_dir, images, labels)
        out["cifar10_bin_decode"] = {"bytes": 5 * 10000 * 3073, **_timed_pair(
            3, ".bin decode", (images, labels),
            lambda: native.decode_cifar10_bin(bin_dir, 50000),
            lambda: native.decode_cifar10_bin_plain(bin_dir, 50000))}
        mnist, mnist_labels = builtin.synthesize((28, 28, 1), 60000, seed=28)
        raw_dir = root / "raw" / "mnist"
        raw_dir.mkdir(parents=True)
        ipath, lpath = raw_dir / "train-images-idx3-ubyte", raw_dir / "train-labels-idx1-ubyte"
        ipath.write_bytes(_idx(mnist[..., 0]))
        lpath.write_bytes(_idx(mnist_labels))
        out["mnist_idx_decode"] = {"bytes": ipath.stat().st_size + lpath.stat().st_size,
                                   **_timed_pair(
            3, "raw idx decode", (mnist, mnist_labels),
            lambda: native.decode_mnist(ipath, lpath, 60000),
            lambda: native.decode_mnist_plain(ipath, lpath, 60000))}
        calls = native.decode_mnist.native_calls
        loaded = builtin.load_mnist(str(root / "raw"))
        require(native.decode_mnist.native_calls == calls + 1
                and np.array_equal(loaded[0], mnist) and np.array_equal(loaded[1], mnist_labels),
                "tools: load_mnist on raw idx files did not decode through the native library")
        del mnist, mnist_labels, loaded
        # (c) the headline CLI on the .bin folder
        calls = native.decode_cifar10_bin.native_calls, native.gather_rows.native_calls
        summary, launches["mdgan_cifar10_bin"] = _tools_cli(
            ["--mode", "mdgan", "--dataset", "CIFAR10", "--num_workers", "8", "--batch_size",
             "10", "--epochs", str(rounds), "--swap_interval", "5", "--log_interval", "5",
             "--compute_dtype", "float32", "--data_dir", str(root / "bin")],
            (32, 32, 3), 5, 5, rounds)
        require((native.decode_cifar10_bin.native_calls, native.gather_rows.native_calls)
                == (calls[0] + 1, calls[1] + 1),
                "tools: the .bin run did not decode and shard through the native library")
        out["mdgan_cifar10_bin"] = {k: summary[k] for k in (
            "rounds", "wall_time_s", "final_mean_d_loss", "evals")}
        # (d) --download offline, then MNIST after --download
        t = time.perf_counter()
        data_dir, out["download"] = _tools_downloads(root / "dl")
        out["download"]["seconds"] = time.perf_counter() - t
        summary, launches["mnist_download"] = _tools_cli(
            ["--mode", "mdgan", "--dataset", "MNIST", "--num_workers", "8", "--batch_size",
             "10", "--epochs", str(mnist_rounds), "--swap_interval", "5", "--log_interval",
             "5", "--compute_dtype", "float32", "--data_dir", str(data_dir), "--download"],
            (28, 28, 1), 5, 5, mnist_rounds)
        out["mnist_download"] = {k: summary[k] for k in ("rounds", "wall_time_s",
                                                        "final_mean_d_loss")}
        # (e) shard_data through the threaded gather, then the gather against
        # numpy on the same indices, alternated
        data, _ = builtin.load_ffhq128(str(root / "none"), max_examples=8000)
        calls = native.gather_rows.native_calls
        shards, idx = partitioner.shard_data(data, 8, iid=True, seed=0)
        flat = idx.reshape(-1)
        require(data.nbytes >= partitioner.NATIVE_GATHER_BYTES
                and native.gather_rows.native_calls == calls + 1,
                "tools: shard_data did not gather through the native library")
        ref = native.gather_rows_plain(data, flat).reshape(shards.shape)
        require(np.array_equal(shards, ref), "tools: threaded shard gather differs from numpy")
        out["shard_gather"] = {"bytes": int(data.nbytes), **_timed_pair(
            3, "row gather", (ref.reshape(len(flat), *data.shape[1:]),),
            lambda: (native.gather_rows(data, flat),),
            lambda: (native.gather_rows_plain(data, flat),))}
        del data, shards, ref, images, labels
        # (f), (g), (h)
        out["generate"] = _tools_generate(keep, root)
        out["convert_weights"] = _tools_convert(root)
        out["analyze"] = _tools_analyze(keep / "mdgan_logs", 20)
    out["launches"] = launches
    return out, launches


def profile_rounds(eng, shards, sampler, warm: int, timed: int, rounds: int):
    """Host wall per round over ``timed`` rounds after ``warm``, then one
    torch.profiler window of ``rounds`` rounds for device time by kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    st = eng.init_state(1)
    eng.run_rounds(st, shards, sampler, warm)  # warm-up
    torch.cuda.synchronize()
    t = time.perf_counter()
    eng.run_rounds(st, shards, sampler, timed)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t) / timed * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eng.run_rounds(st, shards, sampler, rounds)
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kern) / 1e3 / rounds
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
    return {
        "host_ms_per_round": host_ms, "rounds_per_s": 1e3 / host_ms,
        "device_ms_per_round": dev_ms if kern else None,
        "device_busy_share": dev_ms / host_ms if kern else None,
        "kernels_per_round": sum(e.count for e in kern) / rounds,
        "top": [{"name": e.key[:80], "ms_per_round": e.self_device_time_total / 1e3 / rounds,
                 "per_round": e.count / rounds} for e in top]}


def phase_profile(rounds: int = 3):
    """Where a round's time goes at full width: CIFAR10 (DCGAN-32) MD-GAN
    with N=8 in float32 and bfloat16 and the standalone round in float32
    (20 timed rounds, 3 profiled), then the same three for each other
    family on 8,000 examples (4 timed rounds, 2 profiled).  Adam and
    sampling launches a round are counted in the timed rounds."""
    from mdgan_tpu_torch.core.config import TrainConfig
    from mdgan_tpu_torch.core.registry import get as get_spec
    from mdgan_tpu_torch.data.partitioner import shard_data
    from mdgan_tpu_torch.data.sampler import ShardSampler
    from mdgan_tpu_torch.engine.mdgan import MDGANEngine
    from mdgan_tpu_torch.engine.standalone import StandaloneEngine

    out = {}
    for dataset, max_examples, counts in (("CIFAR10", None, (10, 20, rounds)),
                                          *((d, 8000, (2, 4, 2)) for d in FAMILIES)):
        spec = get_spec(dataset)
        data = spec.load("data", max_examples=max_examples)[0]
        shards_np, _ = shard_data(data, 8, iid=True, seed=0)
        rec = {}
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
            _build.launches.clear()
            rec[name] = profile_rounds(eng, shards, sampler, *counts)
            total, launched = sum(counts), _build.reported()
            rec[name]["adam_launches_per_round"] = launched["adam"] / total
            rec[name]["sampling_launches"] = launched["sampling"]
            del shards
        if dataset == "CIFAR10":
            out.update(rec)
        else:
            out[dataset] = rec
    return out


def rank_program(argv) -> int:
    """One rank of the ``distributed`` phase, started by
    ``torch.distributed.run``: in the process group, the sharded round's
    host time over warm rounds (the ``profile`` phase's measure); then, its
    counters set to 0, the CLI's main under deterministic algorithms (as the
    single-process run it is held to); this rank's launch counts and round
    time go into ``<out>/rank_<rank>.json``."""
    import torch

    from mdgan_tpu_torch.cli import train
    from mdgan_tpu_torch.core import distributed

    out, argv = Path(argv[0]), argv[1:]
    distributed.maybe_initialize()
    host_ms = _round_host_ms()
    _build.launches.clear()
    torch.use_deterministic_algorithms(True)
    rc = train.main(argv)
    out.mkdir(parents=True, exist_ok=True)
    (out / f"rank_{os.environ['RANK']}.json").write_text(json.dumps(
        {"launches": _build.reported(), "host_ms_per_round": host_ms}))
    return rc


def _round_host_ms(warm: int = 5, timed: int = 20) -> float:
    """Host ms a round of the headline MD-GAN round (CIFAR10, N=8, b=10,
    float32) over ``timed`` warm rounds ending in a synchronize, in this
    process's rank layout."""
    import torch

    from mdgan_tpu_torch.core.config import TrainConfig
    from mdgan_tpu_torch.core.registry import get as get_spec
    from mdgan_tpu_torch.data.partitioner import shard_data
    from mdgan_tpu_torch.data.sampler import ShardSampler
    from mdgan_tpu_torch.engine.mdgan import MDGANEngine

    spec = get_spec("CIFAR10")
    shards_np, _ = shard_data(spec.load("data")[0], 8, iid=True, seed=0)
    eng = MDGANEngine(spec, TrainConfig(compute_dtype="float32"), 8)
    shards, st = eng.shard_data(shards_np), eng.init_state(1)
    sampler = ShardSampler(8, shards_np.shape[1], 10, seed=0)
    eng.run_rounds(st, shards, sampler, warm)
    torch.cuda.synchronize()
    t = time.perf_counter()
    eng.run_rounds(st, shards, sampler, timed)
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / timed * 1e3


def _launch_ranks(world: int, argv, timeout: float, program: str = "--rank-program"):
    """``python -m torch.distributed.run`` of this script's rank program
    (``program``) on ``world`` local ranks; every rank is killed if it
    outlives ``timeout``.  Returns (exit code, output)."""
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [str(ROOT), env.get("PYTHONPATH")]))
    env.setdefault("NCCL_SOCKET_IFNAME", "lo")  # one host: the ranks meet on loopback
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           str(world), str(ROOT / "chip_smoke.py"), program, *map(str, argv)]
    proc = subprocess.Popen(cmd, cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, 9)
            proc.communicate()
    return proc.returncode, out


def _json_lines(text: str):
    """The JSON objects among a run's output lines (rank 0's metrics and
    summary), any ``[rankN]:`` prefix dropped."""
    out = []
    for line in text.splitlines():
        line = line.split("]:", 1)[1].strip() if line.startswith("[rank") else line.strip()
        if line.startswith("{"):
            out.append(json.loads(line))
    return out


def _same_tree(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same_tree(a[k], b[k]) for k in a)
    if hasattr(a, "dtype"):
        return a.dtype == b.dtype and a.shape == b.shape and bool((a == b).all())
    return a == b


def phase_distributed(rounds: int = 10, n: int = 8):
    """The headline config (CIFAR10, N=8, b=10, full width, float32) through
    the CLI under ``torch.distributed.run`` on W local ranks over NCCL, W the
    card count capped at the largest divisor of N it reaches: 10 rounds
    with a swap at round 5 and checkpoints at rounds 5 and 9.  At W=1 the
    run's final checkpoint (every arena of G and the 8 D, the Adam moments
    and counts, the sampler), exports, worker CSVs and printed metrics must
    be bit-identical to the single-process run at the same seed, both under
    deterministic algorithms; at W>1 the run must finish with finite
    metrics, and its distance from the single-process run is reported.
    Launch counts are read from every rank.  Each rank also times warm
    rounds of the sharded engine before the CLI run, as this process times
    the single-process engine after it."""
    import numpy as np
    import torch

    from mdgan_tpu_torch.cli import train

    cards = torch.cuda.device_count()
    world = max(d for d in range(1, n + 1) if n % d == 0 and d <= cards)
    argv = ["--mode", "mdgan", "--dataset", "CIFAR10", "--num_workers", str(n),
            "--batch_size", "10", "--epochs", str(rounds), "--swap_interval", "5",
            "--log_interval", "5", "--checkpoint_interval", "5", "--compute_dtype", "float32"]
    name = f"mdgan.{n}.CIFAR10"
    with tempfile.TemporaryDirectory() as tmp:
        ranks_dir, single_dir = Path(tmp) / "ranks", Path(tmp) / "single"
        t = time.perf_counter()
        rc, out = _launch_ranks(world, [ranks_dir, *argv, *out_dirs(ranks_dir)], timeout=600)
        ranks_s = time.perf_counter() - t
        require(rc == 0, f"distributed: {world} ranks exited {rc}:\n{out[-4000:]}")
        lines = _json_lines(out)
        summary, logs = lines[-1], lines[:-1]
        per_rank = [json.loads((ranks_dir / f"rank_{r}.json").read_text())
                    for r in range(world)]
        launches = [r["launches"] for r in per_rank]
        chunks = cli_chunks(rounds, 5, 5, 100, 5)
        for r, counts in enumerate(launches):
            require(counts == {"adam": 2 * rounds, "adam_bf16m": 0, "sampling": len(chunks)},
                    f"distributed rank {r}: launches {counts}, want adam {2 * rounds} and "
                    f"sampling {len(chunks)} (chunks {chunks})")
        require(summary["all_finite"] and summary["swaps"] == 1 and summary["rounds"] == rounds,
                f"distributed: {summary}")

        buf = io.StringIO()
        torch.use_deterministic_algorithms(True)
        try:
            t = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                require(train.main(argv + out_dirs(single_dir)) == 0, "single-process run failed")
            single_s = time.perf_counter() - t
        finally:
            torch.use_deterministic_algorithms(False)
        single = _json_lines(buf.getvalue())
        ckpt = [torch.load(d / "checkpoint_dir" / name / f"ckpt_{rounds - 1}.pt",
                           map_location="cpu", weights_only=True) for d in (ranks_dir, single_dir)]
        exports = sorted(str(p.relative_to(single_dir / "weights_dir"))
                         for p in (single_dir / "weights_dir").rglob("*.npz"))
        csvs = sorted(p.name for p in (single_dir / "log_dir").glob("*.worker.*.csv"))

        def col(path, key):
            import csv

            return [row[key] for row in csv.DictReader(io.StringIO(path.read_text()))]

        same = {
            "checkpoint": _same_tree(ckpt[0], ckpt[1]),
            "exports": all(_same_tree(dict(np.load(ranks_dir / "weights_dir" / e)),
                                      dict(np.load(single_dir / "weights_dir" / e)))
                           for e in exports),
            "worker_csv_losses": all(col(ranks_dir / "log_dir" / c, "mean_d_loss")
                                     == col(single_dir / "log_dir" / c, "mean_d_loss")
                                     for c in csvs),
            "printed_metrics": [{k: v for k, v in ln.items() if k != "elapsed_s"} for ln in logs]
            == [{k: v for k, v in ln.items() if k != "elapsed_s"} for ln in single[:-1]],
        }
        d_params = [torch.cat([t.flatten() for t in c["nets"]["d"]["params"].values()])
                    for c in ckpt]
        max_rel = float(((d_params[0] - d_params[1]).abs()
                         / (1e-12 + d_params[1].abs())).max())
    if world == 1:
        require(all(same.values()), f"distributed W=1 differs from one process: {same}")
    r0, r1 = logs[-2], logs[-1]  # rounds 5 and 9
    s0, s1 = single[-3], single[-2]
    return {"world": world, "world_sizes_run": [world], "cards": cards, "backend": "nccl",
            "host_ms_per_round": [r["host_ms_per_round"] for r in per_rank],
            "single_host_ms_per_round": _round_host_ms(),
            "bit_identical_to_one_process": same, "d_params_max_rel_diff": max_rel,
            "launches_per_rank": launches, "chunks": chunks, "summary": summary,
            "ranks_seconds": ranks_s, "single_seconds": single_s,
            # the CLI runs' rounds 5-9, with an eval on its background thread
            "cli_ms_per_round_rounds_5_9": (r1["elapsed_s"] - r0["elapsed_s"]) / 4 * 1e3,
            "single_cli_ms_per_round_rounds_5_9": (s1["elapsed_s"] - s0["elapsed_s"]) / 4 * 1e3}


# the axes phase's layouts: (name, ranks, R, T).  (R=2, T=1) on 6 ranks is
# JAX's idle fallback: the workers axis takes 2 of its 3 slots (the largest
# divisor of N=8 that fits), so ranks 4 and 5 are idle
AXES_LAYOUTS = (("R2_T1", 2, 2, 1), ("R1_T2", 2, 1, 2), ("R2_W2_T2", 8, 2, 2),
                ("R2_T1_idle", 6, 2, 1))
AXES_ENGINE_ROUNDS, AXES_TIMED_ROUNDS = 2, 3
AXES_METRICS = ("mean_d_loss", "g_feedback_loss", "feedback_norm")


@functools.lru_cache(maxsize=1)
def _headline_shards():
    """CIFAR10's 50,000 examples split over N=8 (loaded once a process)."""
    from mdgan_tpu_torch.core.registry import get as get_spec
    from mdgan_tpu_torch.data.partitioner import shard_data

    return shard_data(get_spec("CIFAR10").load("data")[0], 8, iid=True, seed=0)[0]


def _headline_engine(layout=None):
    """The headline MD-GAN engine (CIFAR10, N=8, b=10, full width, float32)
    in ``layout`` (default: this process's), its state, shards and sampler."""
    from mdgan_tpu_torch.core.config import TrainConfig
    from mdgan_tpu_torch.core.registry import get as get_spec
    from mdgan_tpu_torch.data.sampler import ShardSampler
    from mdgan_tpu_torch.engine.mdgan import MDGANEngine

    spec = get_spec("CIFAR10")
    shards_np = _headline_shards()
    eng = MDGANEngine(spec, TrainConfig(compute_dtype="float32"), 8, layout=layout)
    return eng, eng.init_state(1), eng.shard_data(shards_np), ShardSampler(
        8, shards_np.shape[1], 10, seed=0)


# the engine rounds' metrics against one process, by round: the first
# round's before any Adam step could part them (the D losses) or after one
# step on gradients summed in another order; the second after the first
# round's steps, whose elements at rounding noise went either way, moved the
# weights (measured on this config on an H100: up to 1.8e-5 in round 0 and
# 6.4e-4 in round 1; on the CPU, where every rank's convolutions sum in the
# one process's order, 6.6e-6 in round 1)
AXES_METRIC_RTOL = (1e-4, 2e-3)


def adam_bound(steps: int, lr: float = 2e-4, b2: float = 0.999) -> float:
    """The most two runs' parameters can part after ``steps`` Adam steps
    (beta_1 = 0): step t moves an element by up to lr sqrt((1 - b2^t) /
    (1 - b2)), in either direction where its gradient sits at rounding
    noise (the round phase's sign-flip bound, 2.05 lr a step, for t > 1)."""
    return 2 * lr * sum(math.sqrt((1 - b2 ** t) / (1 - b2)) for t in range(1, steps + 1)) + 1e-6


def engine_rounds():
    """``AXES_ENGINE_ROUNDS`` rounds of the headline engine in this process:
    after each, the generator's and discriminators' parameters and the
    metrics, on the host."""
    import torch

    eng, st, shards, sampler = _headline_engine()
    out = []
    for _ in range(AXES_ENGINE_ROUNDS):
        m = eng.run_rounds(st, shards, sampler, 1)
        out.append({"g": st.g.params.to("cpu", copy=True),
                    "d": st.d.params.to("cpu", copy=True),
                    **{k: m[k].cpu() for k in AXES_METRICS}})
    del eng, st, shards
    torch.cuda.empty_cache()
    return out


def round_diff(got, want) -> dict:
    """One round of ``engine_rounds`` against another: the metrics' largest
    relative error, and per network the largest parameter difference and
    the share of parameters off by more than rtol 1e-2."""
    import torch

    rec = {"metric_rel_err": {k: float(((got[k] - want[k]).abs() / want[k].abs()).max())
                              for k in AXES_METRICS}}
    for net in ("g", "d"):
        rec[f"{net}_max_abs_diff"] = float((got[net] - want[net]).abs().max())
        rec[f"{net}_off_share"] = 1.0 - float(torch.isclose(
            got[net], want[net], rtol=1e-2, atol=1e-6).float().mean())
    return rec


@contextlib.contextmanager
def conv_row_blocks(blocks: int):
    """Every ``Conv2d`` and ``ConvTranspose2d`` forward run on ``blocks``
    row blocks of its batch and concatenated: each image's sums as before,
    each weight gradient summed over the blocks, as a replica split sums it
    over its ranks."""
    import torch
    from torch import nn

    saved = {cls: cls.forward for cls in (nn.Conv2d, nn.ConvTranspose2d)}

    def split(forward):
        def blocked(self, x, *args, **kwargs):
            return torch.cat([forward(self, part, *args, **kwargs) for part in x.chunk(blocks)])
        return blocked

    for cls, forward in saved.items():
        cls.forward = split(forward)
    try:
        yield
    finally:
        for cls, forward in saved.items():
            cls.forward = forward


def reordered_rounds(ref):
    """Whether reordering the convolutions' sums alone, in one process,
    parts the second round as far as the split layouts do: the headline
    engine's rounds (float32, TF32 off) against ``ref`` (the same rounds,
    deterministic) with the convolutions on 2 row blocks (deterministic),
    on ATen's own convolutions in place of cuDNN's, and repeated as they
    were (deterministic: must be bit-identical)."""
    import torch

    variants = {}
    with no_tf32():
        torch.use_deterministic_algorithms(True)
        try:
            variants["repeat"] = engine_rounds()
            with conv_row_blocks(2):
                variants["conv_rows_2"] = engine_rounds()
        finally:
            torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.enabled = False
        try:
            variants["aten_conv"] = engine_rounds()
        finally:
            torch.backends.cudnn.enabled = True
    out = {name: [round_diff(g, w) for g, w in zip(rounds, ref)]
           for name, rounds in variants.items()}
    require(all(torch.equal(g[k], w[k]) for g, w in zip(variants["repeat"], ref) for k in g),
            "reorder: a deterministic repeat of the engine rounds differs")
    require(all(math.isfinite(v) for recs in out.values() for rec in recs
                for v in rec["metric_rel_err"].values()), f"reorder: {out}")
    return out


def axes_program(argv) -> int:
    """One rank of the ``axes`` phase, started by ``torch.distributed.run``:
    ``<out> <R> <T> <CLI argv>``.  In the (R, W, T) mesh of the process
    group, under deterministic algorithms with TF32 off: the headline engine
    for ``AXES_ENGINE_ROUNDS`` rounds (its metrics, its gathered generator
    and its discriminators into ``<out>/engine_<rank>.pt``), then
    ``AXES_TIMED_ROUNDS`` warm rounds timed on the host; then, its counters
    set to 0, the CLI's main with ``--num_replicas R --num_tensor T``.  Its
    launch counts, backend and round time go into ``<out>/rank_<rank>.json``.
    An idle rank skips the engine, and its main returns at once."""
    import torch
    import torch.distributed as dist

    from mdgan_tpu_torch.cli import train
    from mdgan_tpu_torch.core import distributed
    from mdgan_tpu_torch.core.mesh import rank_layout
    from mdgan_tpu_torch.parallel import tensor as tensor_lib

    out, r, t, argv = Path(argv[0]), int(argv[1]), int(argv[2]), argv[3:]
    out.mkdir(parents=True, exist_ok=True)
    distributed.maybe_initialize()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.use_deterministic_algorithms(True)
    rank, lay = dist.get_rank(), rank_layout(8, r, t)
    rec = {"rank": rank, "backend": dist.get_backend(), "coords": list(lay.coords),
           "shape": list(lay.shape), "idle": lay.idle, "host_ms_per_round": None}
    if not lay.idle:
        eng, st, shards, sampler = _headline_engine(lay)
        rounds = []
        for _ in range(AXES_ENGINE_ROUNDS):
            m = eng.run_rounds(st, shards, sampler, 1)
            g = tensor_lib.gather_arenas(st.g, lay.tensor_axis, {"params": st.g.params})
            rounds.append({"g": g["params"].to("cpu", copy=True),
                           "d": st.d.params.to("cpu", copy=True),
                           **{k: m[k].cpu() for k in AXES_METRICS}})
        torch.save({"coords": list(lay.coords), "g_shard_numel": st.g.numel,
                    "rounds": rounds}, out / f"engine_{rank}.pt")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.run_rounds(st, shards, sampler, AXES_TIMED_ROUNDS)
        torch.cuda.synchronize()
        rec["host_ms_per_round"] = (time.perf_counter() - t0) / AXES_TIMED_ROUNDS * 1e3
        del eng, st, shards
        torch.cuda.empty_cache()
    _build.launches.clear()
    rc = train.main(argv + ["--num_replicas", str(r), "--num_tensor", str(t)])
    rec["launches"] = _build.reported()
    (out / f"rank_{rank}.json").write_text(json.dumps(rec))
    return rc


def phase_axes(rounds: int = 10, n: int = 8):
    """The replica and tensor axes (``core/mesh.py``, ``parallel/tensor.py``)
    on the card: each layout of ``AXES_LAYOUTS`` as ranks under
    ``torch.distributed.run`` (over gloo where the ranks outnumber the
    cards, every rank on the one card, the collectives staged through the
    host; over NCCL, one rank a card, where there are enough cards).  Each
    rank's engine rounds are held to the single-process engine's,
    deterministic and TF32 off on both sides, round by round: the metrics
    at ``AXES_METRIC_RTOL``, the parameters sign-flip aware (none further
    than Adam's steps can move them, ``adam_bound``; after the first round
    under 0.5% of them off by more than rtol 1e-2, the round tests' rule).
    A split batch sums gradients in another order, and an Adam step whose
    gradient sits at rounding noise can go either way; the
    CLI's 10 rounds (a swap at 5, checkpoints at 5 and 9) must end with
    finite metrics, 2 Adam launches a round and one sampling launch a chunk
    on every rank of the mesh (none on an idle one), and the final
    checkpoint resumes in one process for one round.  Then the reorder
    check of ``reordered_rounds``."""
    import torch

    cards = torch.cuda.device_count()
    argv = ["--mode", "mdgan", "--dataset", "CIFAR10", "--num_workers", str(n),
            "--batch_size", "10", "--epochs", str(rounds), "--swap_interval", "5",
            "--log_interval", "5", "--checkpoint_interval", "5", "--compute_dtype", "float32"]
    chunks = cli_chunks(rounds, 5, 5, 100, 5)
    with no_tf32():
        torch.use_deterministic_algorithms(True)
        try:
            ref = engine_rounds()
        finally:
            torch.use_deterministic_algorithms(False)
    out = {}
    for name, world, r, t in AXES_LAYOUTS:
        with tempfile.TemporaryDirectory() as tmp:
            root = Path(tmp)
            start = time.perf_counter()
            rc, text = _launch_ranks(world, [root / "ranks", r, t, *argv, *out_dirs(root)],
                                     timeout=420, program="--axes-program")
            seconds = time.perf_counter() - start
            require(rc == 0, f"axes {name}: {world} ranks exited {rc}:\n{text[-4000:]}")
            ranks = [json.loads((root / "ranks" / f"rank_{i}.json").read_text())
                     for i in range(world)]
            used = [rk for rk in ranks if not rk["idle"]]
            shape = used[0]["shape"]
            require(len(used) == shape[0] * shape[1] * shape[2] and all(
                rk["rank"] >= len(used) for rk in ranks if rk["idle"]),
                f"axes {name}: idle ranks {[rk['rank'] for rk in ranks if rk['idle']]}")
            for rk in ranks:
                want = ({"adam": 0, "adam_bf16m": 0, "sampling": 0} if rk["idle"] else
                        {"adam": 2 * rounds, "adam_bf16m": 0, "sampling": len(chunks)})
                require(rk["launches"] == want, f"axes {name} rank {rk['rank']}: launches "
                        f"{rk['launches']}, want {want} (chunks {chunks})")
            summary = _json_lines(text)[-1]
            require(summary["all_finite"] and summary["swaps"] == 1
                    and summary["rounds"] == rounds, f"axes {name}: {summary}")

            # the engine rounds against the single-process engine's
            eng_recs = {rk["rank"]: torch.load(root / "ranks" / f"engine_{rk['rank']}.pt",
                                               weights_only=True) for rk in used}
            first = eng_recs[0]
            engine = []
            for i, want in enumerate(ref):
                got = dict(first["rounds"][i])
                for j, e in eng_recs.items():
                    require(torch.equal(e["rounds"][i]["g"], got["g"]),
                            f"axes {name}: rank {j}'s generator differs from rank 0's")
                got["d"] = torch.cat([next(e["rounds"][i]["d"] for e in eng_recs.values()
                                           if tuple(e["coords"]) == (0, w, 0))
                                      for w in range(shape[1])])
                rec = round_diff(got, want)
                worst = max(rec["metric_rel_err"].values())
                require(worst <= AXES_METRIC_RTOL[i], f"axes {name}: round {i} metrics rel "
                        f"err {worst} > {AXES_METRIC_RTOL[i]} ({rec})")
                dp = max(rec["g_max_abs_diff"], rec["d_max_abs_diff"])
                require(dp <= adam_bound(i + 1), f"axes {name}: round {i} params max |diff| "
                        f"{dp} > {adam_bound(i + 1)}")
                if i == 0:
                    off = max(rec["g_off_share"], rec["d_off_share"])
                    require(off < 0.005, f"axes {name}: {off:.2%} of the parameters off the "
                            "one-process run's by more than rtol 1e-2 after round 0")
                engine.append(rec)

            # the final checkpoint resumed in one process for one round
            from mdgan_tpu_torch.cli import train

            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = train.main(argv + ["--epochs", str(rounds + 1), "--resume"]
                                + out_dirs(root / "resumed")
                                + ["--checkpoint_dir", str(root / "checkpoint_dir")])
            resumed = json.loads(buf.getvalue().strip().splitlines()[-1])
            require(rc == 0 and resumed["rounds"] == 1 and resumed["all_finite"],
                    f"axes {name}: resume {resumed}")
        out[name] = {
            "ranks": world, "shape_RWT": shape, "backend": sorted({rk["backend"] for rk in ranks}),
            "idle_ranks": [rk["rank"] for rk in ranks if rk["idle"]],
            "g_shard_elements": first["g_shard_numel"],
            "engine_rounds": engine,
            "launches_per_rank": [rk["launches"] for rk in ranks],
            "host_ms_per_round": [rk["host_ms_per_round"] for rk in used],
            "host_ms_note": ("ranks sharing one card over gloo: not a scaling number"
                             if cards < world else "one rank a card"),
            "summary": {k: summary[k] for k in ("rounds", "swaps", "all_finite",
                                                "final_mean_d_loss", "steps_per_sec")},
            "seconds": seconds}
    nccl = [name for name, rec in out.items() if rec["backend"] == ["nccl"]]
    return {"cards": cards, "layouts": out, "chunks": chunks,
            "nccl_layouts": nccl or f"not run ({cards} card{'s' if cards != 1 else ''})",
            "reorder": reordered_rounds(ref)}


HEADLINE_SHAPE = (32, 32, 3)


def check_bench_line(row: dict, what: str) -> None:
    """A line of the port's bench: finite numbers, the FLOPs of a headline
    round in ``tests/test_bench_artifacts.py``'s band, ``mfu`` under 1.05."""
    require(all(math.isfinite(v) for v in row.values() if isinstance(v, float)),
            f"{what}: a non-finite number in {row}")
    require(8e9 < row["flops_per_round"] < 9e10, f"{what}: flops_per_round "
            f"{row['flops_per_round']} outside [8e9, 9e10]")
    require(row["value"] > 0 and 0 < row["mfu"] < 1.05, f"{what}: value {row['value']}, "
            f"mfu {row['mfu']}")


def phase_bench(chunk: int = BENCH_CHUNK, timed: int = BENCH_TIMED,
                sustained: int = BENCH_SUSTAINED, warm: int = BENCH_WARM):
    """The port's benchmark (``mdgan_tpu_torch/cli/bench.py``): the headline
    config with its chunks cut to ``chunk`` rounds and ``timed`` timed
    chunks (a temporary ``CONFIGS`` entry, as ``bench_scaling`` makes one),
    in bfloat16 and in float32, then ``bench_sustained`` for ``sustained``
    rounds after ``warm``.  Each line printed, checked (``check_bench_line``)
    and its kernel launches counted from its run against the count of its
    rounds and chunks."""
    from mdgan_tpu_torch.cli import bench

    dataset, n, b, _, _, max_ex = bench.CONFIGS["headline"]
    lines, launches = {}, {}
    bench.CONFIGS["_smoke"] = (dataset, n, b, chunk, timed, max_ex)
    try:
        for dtype in ("bfloat16", "float32"):
            _build.launches.clear()
            row = bench.bench_mdgan("_smoke", compute_dtype=dtype)
            launches[f"bench_{dtype}"] = _build.reported()
            print(json.dumps(row), flush=True)
            check_bench_line(row, f"bench {dtype}")
            # a warm chunk, the timed chunks, the round FlopCounterMode counts
            chunks = [chunk] * (1 + timed) + [1]
            want = {"adam": 2 * sum(chunks), "adam_bf16m": 0,
                    "sampling": sampling_launches(chunks, n, HEADLINE_SHAPE)}
            require(launches[f"bench_{dtype}"] == want, f"bench {dtype}: launches "
                    f"{launches[f'bench_{dtype}']}, want {want}")
            require(row["compute_dtype"] == dtype and row["steps_timed"] == chunk * timed,
                    f"bench {dtype}: {row}")
            lines[dtype] = row
    finally:
        bench.CONFIGS.pop("_smoke", None)
    _build.launches.clear()
    row = bench.bench_sustained(rounds=sustained, warm_rounds=warm)
    launches["bench_sustained"] = _build.reported()
    print(json.dumps(row), flush=True)
    check_bench_line(row, "bench sustained")
    # each run one chunk (no log, swap or checkpoint event before its last
    # round), then the counted round
    require(max(warm, sustained) <= bench.CONFIGS["headline"][3] and sustained < 5000,
            "bench sustained: a run of more than one chunk")
    want = {"adam": 2 * (warm + sustained + 1), "adam_bf16m": 0,
            "sampling": sampling_launches([warm, sustained, 1], n, HEADLINE_SHAPE)}
    require(launches["bench_sustained"] == want,
            f"bench sustained: launches {launches['bench_sustained']}, want {want}")
    lines["sustained"] = row
    return lines, launches


def phase_parts(iters: int = 10, profiled: int = 3):
    """``mdgan_tpu_torch/cli/profile_parts.py`` at the headline config: every
    part's host microseconds and device busy milliseconds a call finite,
    each launch counted (3 warm-up calls, ``iters`` host-timed and
    ``profiled`` profiled a part: the profiler's window is the phase's main
    cost)."""
    from mdgan_tpu_torch.cli import profile_parts

    _build.launches.clear()
    rec = profile_parts.profile(8, 10, iters, profiled=profiled)
    rec["profiled_calls"] = profiled
    launched = _build.reported()
    calls = 3 + iters + profiled
    # G fwd+VJP+Adam and the D region one Adam launch a call, the round two;
    # the D region and the round one sampling launch a call
    want = {"adam": 4 * calls, "adam_bf16m": 0, "sampling": 2 * calls}
    require(launched == want, f"parts: launches {launched}, want {want}")
    for name in rec["components_us"]:
        host, dev = rec["components_us"][name], rec["components_device_ms"][name]
        # a profiler window misses a few dozen kernels: maybe all the noop's
        require(math.isfinite(host) and dev is not None
                and (dev > 0 or name == profile_parts.NOOP),
                f"parts: {name} host {host} us, device {dev} ms")
    return rec, launched


def phase_examples(rounds: int = 10):
    """``examples_torch/train_mdgan_minimal.py`` (the headline config, chunks
    of 5, a swap every 5 rounds) and ``run-standalone-torch.sh`` (its
    shared-args.sh flags, ``--epochs`` cut) as subprocesses on the card, side
    by side: exit 0, their printed rounds and swaps, the sample grid, the
    summary."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    env = dict(os.environ, PYTHONPATH=str(ROOT), PYTHON=sys.executable)

    def run(what, argv, cwd):
        t = time.perf_counter()
        proc = subprocess.run(argv, cwd=cwd, env=env, capture_output=True, text=True,
                              timeout=600)
        require(proc.returncode == 0, f"{what} exited {proc.returncode}:\n"
                f"{proc.stderr[-3000:]}")
        return proc.stdout, time.perf_counter() - t

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        minimal, script = Path(tmp) / "minimal", Path(tmp) / "standalone"
        minimal.mkdir()
        script.mkdir()
        with ThreadPoolExecutor(2) as pool:
            first = pool.submit(run, "train_mdgan_minimal.py", [
                sys.executable, str(ROOT / "examples_torch" / "train_mdgan_minimal.py"),
                "--rounds", str(rounds), "--chunk_size", "5", "--swap_interval", "5"], minimal)
            second = pool.submit(run, "run-standalone-torch.sh", [
                "bash", str(ROOT / "run-standalone-torch.sh"), "--epochs", str(rounds),
                "--log_interval", "0", *out_dirs(script)], script)
            (stdout, seconds), (script_out, script_s) = first.result(), second.result()

        printed = [ln for ln in stdout.splitlines() if ln.startswith("round")]
        png = minimal / "mdgan_samples.png"
        require([int(ln.split()[1]) for ln in printed] == list(range(5, rounds + 1, 5))
                and all("d_loss=" in ln and "g_feedback_loss=" in ln for ln in printed)
                and stdout.count("swapped discriminator pairs") == rounds // 5,
                f"train_mdgan_minimal.py printed:\n{stdout}")
        # 64 samples, 8 a row
        require(_png_size(png) == (8 * 32, 8 * 32), f"{png}: {_png_size(png)}")
        out["train_mdgan_minimal"] = {"seconds": seconds, "rounds": printed}

        summary = json.loads(script_out.strip().splitlines()[-1])
        require(summary["rounds"] == rounds and summary["all_finite"]
                and summary["compute_dtype"] == "bfloat16"
                and summary["device"] == torch.cuda.get_device_name(0),
                f"run-standalone-torch.sh: {summary}")
        out["run_standalone_torch"] = {"seconds": script_s, "summary": summary}
    return out


# the record phase's cut of each recorder step: one leg of at most 20 rounds
RECORD_CUT = {"--epochs": "20", "--log_interval": "10", "--swap_interval": "10",
              "--eval_n_samples": "512"}
JAX_ARTIFACTS = ROOT / "artifacts"


def _csv_header(path: Path) -> list:
    from mdgan_tpu_torch.obs.spans import open_maybe_gz

    with open_maybe_gz(path) as f:
        return f.readline().strip().split(",")


def _record_leg(out: Path, rounds: int, server: str, jax_run: str, workers=(), gz=(),
                weights=frozenset()):
    """One recorded leg's layout: the summary's rounds, its span CSVs' columns
    against the JAX recording of the same step, a row a round in each worker
    CSV, three grids, and the weight exports left after pruning."""
    summary = json.loads((out / "summary.json").read_text())
    require(summary["rounds"] == rounds and summary["all_finite"],
            f"record {out.name}: summary {summary}")
    require((out / "MANIFEST.md").is_file(), f"record {out.name}: no MANIFEST.md")
    logs, jax_logs = out / "logs", JAX_ARTIFACTS / jax_run / "logs"
    require(_csv_header(logs / server) == _csv_header(jax_logs / server),
            f"record {out.name}: {server} columns differ from the JAX recording's")
    for w in workers:
        name = f"{server.split('.server')[0]}.worker.{w}.logs.csv" + (".gz" if w in gz else "")
        jax_name = next(iter(sorted(jax_logs.glob(f"*.worker.{w}.logs.csv*"))), None)
        require(jax_name is not None and _csv_header(logs / name) == _csv_header(jax_name),
                f"record {out.name}: {name} columns differ from the JAX recording's")
        from mdgan_tpu_torch.obs.spans import read_spans

        rows = read_spans(logs / name)
        require([int(r["epoch"]) for r in rows] == list(range(rounds)),
                f"record {out.name}: {name} is not a row a round")
    # the first, middle and last grid (the standalone run's 20 rounds make 2)
    grids = sorted((p.name for p in (out / "images").glob("*_[0-9]*.png")),
                   key=lambda n: int(n[:-4].rsplit("_", 1)[1]))
    require(2 <= len(grids) <= 3 and grids[0].endswith("_0.png"),
            f"record {out.name}: grids {grids}")
    kept = {p.relative_to(out / "weights").as_posix()
            for p in (out / "weights").rglob("*.npz")} if (out / "weights").is_dir() else set()
    require(kept == set(weights), f"record {out.name}: weights left {sorted(kept)}")
    return {"rounds": summary["rounds"], "steps_per_sec": summary["steps_per_sec"],
            "grids": grids, "weights": sorted(kept)}


def phase_record():
    """The recorder's training steps (``cli/record_artifacts.py``) on the card,
    each on one leg cut to ``RECORD_CUT``, into a temporary root: golden,
    standalone, the convergence step's standalone and w2 legs (then its
    COMPARISON.json), the scale step's w20 leg; then the prune.  Each leg's
    layout is checked, and the Adam and sampling launches counted."""
    from mdgan_tpu_torch.cli import record_artifacts as recorder

    steps = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_record_") as tmp:
        root = Path(tmp)
        saved_tmp, tempfile.tempdir = tempfile.tempdir, str(root)  # the runs' checkpoints
        try:
            _build.launches.clear()
            for name, step in (
                    ("golden", lambda: recorder.record_golden_mdgan(root, RECORD_CUT)),
                    ("standalone", lambda: recorder.record_golden_standalone(root, RECORD_CUT)),
                    ("convergence_standalone", lambda: recorder.record_convergence(
                        root, "cifar10_standalone_r30000", RECORD_CUT)),
                    ("convergence_w2", lambda: recorder.record_convergence(
                        root, "cifar10_w2_r30000", RECORD_CUT)),
                    ("scale_w20", lambda: recorder.record_scale_runs(root, RECORD_CUT, only=20))):
                t = time.perf_counter()
                with contextlib.redirect_stdout(io.StringIO()):
                    step()
                steps[name] = time.perf_counter() - t
            launches = _build.reported()
            with contextlib.redirect_stdout(io.StringIO()):
                recorder.prune_weights(root)
                recorder.trim_inventory(root)
        finally:
            tempfile.tempdir = saved_tmp
        art = root / recorder.ARTIFACTS
        rounds = int(RECORD_CUT["--epochs"])
        legs = {
            "golden": _record_leg(
                art / "golden/cifar10_w8_r2000", rounds, "mdgan.8.CIFAR10.server.logs.csv",
                "golden/cifar10_w8_r2000", workers=range(1, 9),
                weights={"generator_final.npz", "worker_1/discriminator.npz"}),
            "standalone": _record_leg(
                art / "golden/cifar10_standalone_r2000", rounds, "CIFAR10.standalone.logs.csv",
                "golden/cifar10_standalone_r2000"),
            "convergence_standalone": _record_leg(
                art / "convergence/cifar10_standalone_r30000", rounds,
                "CIFAR10.standalone.logs.csv", "convergence/cifar10_standalone_r30000"),
            "convergence_w2": _record_leg(
                art / "convergence/cifar10_w2_r30000", rounds, "mdgan.2.CIFAR10.server.logs.csv",
                "convergence/cifar10_w2_r30000", workers=(1, 2), gz=(2,)),
            "scale_w20": _record_leg(
                art / "scale/cifar10_w20_r10000", rounds, "mdgan.20.CIFAR10.server.logs.csv",
                "scale/cifar10_w20_r10000", workers=range(1, 21), gz=range(2, 21)),
        }
        require((art / "golden/cifar10_w8_r2000/logs/host.csv").is_file(),
                "record golden: no host metrics CSV")
        comp = json.loads((art / "convergence/COMPARISON.json").read_text())
        require(set(comp) == {"standalone", "mdgan_w2"}, f"record COMPARISON keys {sorted(comp)}")
        for label, c in comp.items():
            vals = [v for _, v in c["fid_standard"]]
            require([e for e, _ in c["fid_standard"]] == [0, rounds - 1]
                    and all(math.isfinite(v) for v in vals)
                    and c["best_fid_standard"] == min(vals) and c["final_fid_standard"] == vals[-1],
                    f"record COMPARISON {label}: {c}")
    # 2 Adam launches a round (a local epoch in standalone) in each of the 5
    # legs, and at least one sampling launch a leg
    require(launches["adam"] == 2 * rounds * len(steps) and launches["sampling"] >= len(steps),
            f"record: launches {launches}")
    return {"steps_s": steps, "legs": legs, "launches": launches,
            "comparison_best_fid_standard": {k: c["best_fid_standard"] for k, c in comp.items()}}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke test "
              "needs one CUDA GPU", file=sys.stderr)
        return 2

    if sys.argv[1:2] == ["--rank-program"]:  # a rank of the distributed phase
        return rank_program(sys.argv[2:])
    if sys.argv[1:2] == ["--axes-program"]:  # a rank of the axes phase
        return axes_program(sys.argv[2:])

    # deterministic cuBLAS, for the trainer phase's bit-identical resume;
    # set before the first cuBLAS call of the process
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    t = time.perf_counter()
    smi = card_line()
    require(smi is not None, "nvidia-smi failed")
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
    kernels_s = time.perf_counter() - t
    # the host library of data/native, built here before any phase loads data
    from mdgan_tpu_torch.data import native

    t = time.perf_counter()
    host_built = not native.library_path().is_file()
    host_path = native.build()
    host_library = {"library": host_path.name, "built": host_built,
                    "seconds": time.perf_counter() - t}
    emit({"phase": "build", "seconds": kernels_s, "built": built,
          "library": path.name, "ptxas": ptxas, "host_library": host_library})

    t = time.perf_counter()
    fir_rec = phase_upfirdn2d()
    emit({"phase": "upfirdn2d", "seconds": time.perf_counter() - t, "card": smi, **fir_rec})

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t = time.perf_counter()
    adam_rec, bf16m_rec, samp_rec = phase_kernels()
    emit({"phase": "kernels", "seconds": time.perf_counter() - t,
          "adam": adam_rec, "adam_bf16m": bf16m_rec, "sampling": samp_rec})

    t = time.perf_counter()
    rec = phase_golden()
    emit({"phase": "golden", "seconds": time.perf_counter() - t, **rec})

    t = time.perf_counter()
    rec = phase_round()
    rec["families"] = phase_family_rounds()
    emit({"phase": "round", "seconds": time.perf_counter() - t, **rec})

    torch.backends.cudnn.allow_tf32 = True  # the library default, as a user runs
    # what the tools phase reads of earlier phases: the mdgan phase's span
    # CSVs, the trainer phase's checkpoints and exports
    keep_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    keep = Path(keep_dir.name)
    t = time.perf_counter()
    runs, mdgan_launches = phase_mdgan(keep / "mdgan_logs")
    emit({"phase": "mdgan", "seconds": time.perf_counter() - t,
          "card": smi, "runs": runs})

    t = time.perf_counter()
    dist_rec = phase_distributed()
    emit({"phase": "distributed", "seconds": time.perf_counter() - t, "card": smi,
          **dist_rec})
    print(f"distributed: W={dist_rec['world']} (world sizes run: "
          f"{dist_rec['world_sizes_run']}, {dist_rec['cards']} card(s))", flush=True)

    t = time.perf_counter()
    axes_rec = phase_axes()
    emit({"phase": "axes", "seconds": time.perf_counter() - t, "card": smi, **axes_rec})
    for name, rec in axes_rec["layouts"].items():
        print(f"axes {name}: {rec['ranks']} ranks, (R, W, T) = {tuple(rec['shape_RWT'])}, "
              f"idle {rec['idle_ranks']}, over {'/'.join(rec['backend'])}", flush=True)
    print(f"axes over NCCL, one rank a card: {axes_rec['nccl_layouts']}", flush=True)
    for name, recs in axes_rec["reorder"].items():
        print(f"reorder {name}: metrics rel err by round "
              f"{[max(r['metric_rel_err'].values()) for r in recs]}, G off share "
              f"{[r['g_off_share'] for r in recs]}", flush=True)

    t = time.perf_counter()
    rec, standalone_launches = phase_standalone()
    emit({"phase": "standalone", "seconds": time.perf_counter() - t, "card": smi, **rec})

    t = time.perf_counter()
    rec = phase_trainer(keep)
    emit({"phase": "trainer", "seconds": time.perf_counter() - t, "card": smi, **rec})

    t = time.perf_counter()
    rec, tools_launches = phase_tools(keep)
    keep_dir.cleanup()
    emit({"phase": "tools", "seconds": time.perf_counter() - t, "card": smi, **rec})

    t = time.perf_counter()
    fam_runs = phase_families()
    emit({"phase": "families", "seconds": time.perf_counter() - t, "card": smi, **fam_runs})

    t = time.perf_counter()
    rec = phase_profile()
    emit({"phase": "profile", "seconds": time.perf_counter() - t, "card": smi, **rec})

    t = time.perf_counter()
    bench_lines, bench_launches = phase_bench()
    emit({"phase": "bench", "seconds": time.perf_counter() - t, "card": smi,
          "lines": bench_lines, "launches": bench_launches})

    t = time.perf_counter()
    parts_rec, parts_launches = phase_parts()
    emit({"phase": "parts", "seconds": time.perf_counter() - t, "card": smi,
          "launches": parts_launches, **parts_rec})

    t = time.perf_counter()
    rec = phase_examples()
    emit({"phase": "examples", "seconds": time.perf_counter() - t, "card": smi, **rec})

    t = time.perf_counter()
    record_rec = phase_record()
    emit({"phase": "record", "seconds": time.perf_counter() - t, "card": smi, **record_rec})

    # each path's launches, counted in its run
    paths = {"mdgan": {k: mdgan_launches["float32"][k] + mdgan_launches["bfloat16"][k]
                       for k in ("adam", "adam_bf16m", "sampling")},
             "mdgan_bf16_moments": mdgan_launches["bf16_moments_straggler"],
             "standalone": standalone_launches,
             "distributed": {k: sum(c[k] for c in dist_rec["launches_per_rank"])
                             for k in ("adam", "adam_bf16m", "sampling")},
             "axes": {k: sum(c[k] for rec in axes_rec["layouts"].values()
                             for c in rec["launches_per_rank"])
                      for k in ("adam", "adam_bf16m", "sampling")},
             **tools_launches, **bench_launches, "parts": parts_launches,
             "record": record_rec["launches"]}
    sa_samp = samp_rec["timed"]["standalone_T100"]
    main_adam = {k: adam_rec[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    main_samp = {k: samp_rec[k] for k in ("ms", "plain_ms", "bound_ms")}
    mnist_samp = samp_rec["families"]["MNIST"]["mdgan"]
    by_path = {
        # the axes path at its (R=2, W=2, T=2) rank's arenas: a G tensor slice and 4 D
        "adam": {"mdgan": dict(main_adam), "standalone": adam_rec["standalone"],
                 "distributed": dict(main_adam), "mdgan_cifar10_bin": dict(main_adam),
                 "axes": {k: adam_rec["axes"][k] for k in (
                     "ms", "plain_ms", "library_ms", "bound_ms")},
                 "mnist_download": dict(adam_rec["families"]["MNIST"]["mdgan"])},
        "adam_bf16m": {"mdgan_bf16_moments": {k: bf16m_rec[k] for k in (
            "ms", "plain_ms", "library_ms", "bound_ms")}},
        "sampling": {"mdgan": dict(main_samp), "mdgan_bf16_moments": dict(main_samp),
                     "distributed": dict(main_samp), "mdgan_cifar10_bin": dict(main_samp),
                     # a replica's launch: b/R = 5 rows a worker
                     "axes": {k: samp_rec["timed"]["axes_T100_b5"][k] for k in (
                         "ms", "plain_ms", "bound_ms")},
                     "standalone": {k: sa_samp[k] for k in ("ms", "plain_ms", "bound_ms")},
                     "mnist_download": {k: mnist_samp[k] for k in (
                         "ms", "plain_ms", "bound_ms", "rounds_per_launch")}},
    }
    # the record phase's new shapes: the convergence step's N=2 leg (its N=8,
    # N=1 and N=20 legs are the mdgan, standalone and scale shapes)
    by_path["adam"]["record"] = {k: adam_rec["mdgan_w2"][k] for k in (
        "ms", "plain_ms", "library_ms", "bound_ms")}
    by_path["sampling"]["record"] = {k: samp_rec["timed"]["w2_T100"][k] for k in (
        "ms", "plain_ms", "bound_ms", "rounds_per_launch")}
    # the bench's lines and the parts run the headline round: its arenas, and
    # the gather at each path's main launch (the bench's timed chunks,
    # bench_sustained's run, a round a launch in the parts)
    for path, samp in (("bench_bfloat16", f"bench_T{BENCH_CHUNK}"),
                       ("bench_float32", f"bench_T{BENCH_CHUNK}"),
                       ("bench_sustained", f"bench_T{BENCH_SUSTAINED}"), ("parts", "round_T1")):
        by_path["adam"][path] = dict(main_adam)
        by_path["sampling"][path] = {k: samp_rec["timed"][samp][k] for k in (
            "ms", "plain_ms", "bound_ms", "rounds_per_launch")}
    # each family's paths: the kernels' times at that path's shapes (Adam a
    # round or a local epoch, sampling a launch), launches from its CLI runs
    for dataset in FAMILIES:
        for run, mode in (("mdgan_float32", "mdgan"), ("mdgan_bfloat16", "mdgan"),
                          ("standalone_float32", "standalone")):
            path = f"{dataset}_{run}"
            paths[path] = fam_runs[dataset][run]["launches"]
            by_path["adam"][path] = dict(adam_rec["families"][dataset][mode])
            by_path["sampling"][path] = {k: samp_rec["families"][dataset][mode][k] for k in (
                "ms", "plain_ms", "bound_ms", "rounds_per_launch")}
    kernels = []
    for name, key, source, replaces, rec in (
            ("adam", "adam", "mdgan_tpu_torch/csrc/adam.cu", "mdgan_tpu/ops/adam.py:43",
             adam_rec),
            # a variant of the Adam kernel: JAX runs bf16 moments through
            # optax (mdgan_tpu/engine/state.py:216-251), never through Pallas
            ("adam_bf16m", "adam_bf16m", "mdgan_tpu_torch/csrc/adam.cu",
             "mdgan_tpu/ops/adam.py:43", bf16m_rec),
            ("sample_normalize", "sampling", "mdgan_tpu_torch/csrc/sampling.cu",
             "mdgan_tpu/ops/sampling.py:27", samp_rec)):
        launched = 0
        for path_name, counts in paths.items():
            if path_name in by_path[key]:
                by_path[key][path_name]["launches"] = counts.get(key, 0)
            launched += counts.get(key, 0)
        require(launched > 0, f"{name}: no launch on the main paths")
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launched,
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"], "by_path": by_path[key]})
    kernels.append(upfirdn2d_entry(fir_rec))
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
