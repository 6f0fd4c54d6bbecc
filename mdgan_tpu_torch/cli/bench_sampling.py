"""Device time of the sampling kernel against its baselines, on one GPU.

    python -m mdgan_tpu_torch.cli.bench_sampling [--seed 0] [--reps 2]

Times, with the host's issue hidden (``core.timing.time_ms``), three kernels
that compute the same (T, N, b) gather + normalize + NCHW on a full CIFAR-10
shard stack (N=8 x 6,250 rows of 32x32x3 uint8, b=10, random from ``--seed``):

  sampling   ``csrc/sampling.cu`` through ``ops.sampling.sample_normalize``,
             the kernel the training path launches
  scalar     the port's first sampling kernel, with the round axis folded
             into its grid (``csrc/baselines/sampling_baselines.cu``)
  ring       a persistent grid feeding a shared-memory ring of rows by TMA
             bulk copies, with the same float4 stores (same file)

each at T = 1, 10, 100 (the main path's chunk) and 1,000 rounds per launch,
and ``sampling`` and ``scalar`` also as 100 launches of one round each (a
chunk gathered round by round, as the port first did).  Every kernel is held
bit-equal to ``sample_normalize_plain`` at T=100 and T=1 first, with one
out-of-range index that must give a NaN row.  The kernels are timed in turns
(``--reps`` passes, the order reversed on every other pass).  Prints one JSON
line per reading, then a summary line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys

N, B, S, ROW = 8, 10, 6250, (32, 32, 3)
ROW_BYTES = ROW[0] * ROW[1] * ROW[2]
BASELINES = ("baselines/sampling_baselines.cu",)


def card() -> str:
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60)
    return proc.stdout.strip().splitlines()[0] if proc.returncode == 0 else "not read"


def kernels():
    """name -> fn(shards, idx) for each kernel under test."""
    import torch

    from mdgan_tpu_torch.ops import _build, sampling

    lib = ctypes.CDLL(str(_build.build("mdgan_baselines", BASELINES)))

    def via(name):
        fn = getattr(lib, name)
        fn.argtypes = _build.SIGNATURES["mdgan_sample_normalize_u8"]
        fn.restype = ctypes.c_int

        def run(shards, idx):
            n, s, h, w, c = shards.shape
            out = torch.empty((*idx.shape, c, h, w), dtype=torch.float32, device=shards.device)
            err = fn(shards.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.numel(), n,
                     idx.shape[-1], s, h * w, c, torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"{name}: CUDA error {err} at launch")
            return out
        return run

    return {"sampling": sampling.sample_normalize, "scalar": via("mdgan_sample_scalar_u8"),
            "ring": via("mdgan_sample_ring_u8")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("bench_sampling: needs a CUDA GPU", file=sys.stderr)
        return 2
    from mdgan_tpu_torch.core.timing import bound_ms, time_ms
    from mdgan_tpu_torch.ops.sampling import sample_normalize_plain

    smi = card()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    shards = torch.randint(0, 256, (N, S, *ROW), dtype=torch.uint8, generator=gen, device=dev)

    def indices(t):
        return torch.randint(0, S, (t, N, B), dtype=torch.int32, generator=gen, device=dev)

    fns = kernels()
    for name, fn in fns.items():
        for t in (100, 1):
            idx = indices(t)
            idx[0, 0, 0] = -1
            out = fn(shards, idx)
            ref = sample_normalize_plain(shards, torch.where(idx < 0, 0, idx))
            bad = (idx < 0)
            if not (bool(torch.isnan(out[bad]).all()) and torch.equal(out[~bad], ref[~bad])):
                raise RuntimeError(f"{name} at T={t}: differs from sample_normalize_plain")

    cases = [(name, t, 1) for name in fns for t in (1, 10, 100, 1000)]
    cases += [(name, 1, 100) for name in ("sampling", "scalar")]
    readings = {}
    for rep in range(args.reps):
        for name, t, launches in (cases if rep % 2 == 0 else cases[::-1]):
            pool = [indices(t) for _ in range(launches * 4)]  # fresh rows each call
            fn, it = fns[name], iter(range(10 ** 9))

            def call():
                for _ in range(launches):
                    fn(shards, pool[next(it) % len(pool)])

            rec = time_ms(call, max(2, 200 // launches))
            rows = t * launches * N * B
            nbytes = rows * (4 + ROW_BYTES + 4 * ROW_BYTES)  # index, row, float32 row
            b_ms, b_by = bound_ms(nbytes, 2 * rows * ROW_BYTES)
            key = f"{name} T={t} x{launches}"
            line = {"kernel": name, "T": t, "launches": launches, "rows": rows, "bytes": nbytes,
                    "ms": rec["ms"], "host_us_per_call": rec["host_us_per_call"] / launches,
                    "bound_ms": b_ms, "bound_by": b_by, "share_of_bound": b_ms / rec["ms"],
                    "rep": rep, "card": smi}
            readings.setdefault(key, []).append(rec["ms"])
            print(json.dumps(line), flush=True)
            del pool
    print(json.dumps({"card": smi, "ms": readings}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
