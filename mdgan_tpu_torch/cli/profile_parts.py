"""Per-part breakdown of the MD-GAN round on the card (port of
``scripts/profile_parts.py``).

    python -m mdgan_tpu_torch.cli.profile_parts [--workers 8] [--batch 10] [--iters 300]
        [--json parts.json] [--device cpu]

Times each part of one round of the headline config (CIFAR-10, DCGAN-32,
bfloat16) in isolation, through the engine's own functions
(``engine/mdgan.py``):

  dispatch baseline (noop)   one small elementwise kernel, the cost of a launch
  G forward (k*b imgs)       ``generate``
  G fwd+VJP+Adam             G's forward, then ``_g_update`` on N random
                             feedbacks: scatter-add, G backward, G Adam
  D region                   the real batch's gather (``sample_normalize``)
                             and ``_d_region``: the N local D steps and the
                             feedbacks
  feedback-only pass         ``_feedback``
  FULL round (chunk_fn(1))   ``step``: one round on device indices

Every part's inputs rotate over 8 sets from one seed a call, as JAX's do.
For each part it reports the host's microseconds a call (the mean over
``--iters`` calls up to a synchronize, the noop's subtracted, as the JAX
script subtracts its dispatch) and, on the card, the device's busy
milliseconds a call and its kernels a call: the durations of the kernels
that ``PROFILED_CALLS`` calls (``profile``'s ``profiled``) launched in a
``torch.profiler`` window, summed.
(``core.timing.time_ms`` hides the host's issue by queueing every timed
call behind one device sleep; a round's thousands of launches do not fit in
the card's launch queue behind it.)  On the CPU the device fields are null:
not measured.  The parts run on the engine's state, so the D and G Adam
steps move it as rounds would.  Derived: ``g_vjp_adam`` (G fwd+VJP+Adam less the
G forward) and ``d_local_train`` (the D region less the feedback pass).
``--json`` writes the record as a file too.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

NOOP = "dispatch baseline (noop)"
G_FWD = "G forward (k*b imgs)"
G_VJP_ADAM = "G fwd+VJP+Adam"
FEEDBACK = "feedback-only pass"
FULL = "FULL round (chunk_fn(1))"
ROTATE = 8  # input sets a part cycles through
# calls a part in the profiler's window: its cost grows with the events it
# records (a round's 4,000 launches), and every call of a part does the same work
PROFILED_CALLS = 10


def d_region_name(n: int) -> str:
    return f"D region (train+feedback, {n} workers)"


def host_seconds(fn, iters: int) -> float:
    """Mean host seconds a call of ``fn(i)`` over ``iters`` calls, up to a
    synchronize (``scripts/profile_parts.py:timed``)."""
    import time

    import torch

    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
    sync()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(i)
    sync()
    return (time.perf_counter() - t0) / iters


def device_busy(fn, iters: int):
    """(device ms, kernels) a call of ``fn(i)``: the durations of the
    kernels its ``iters`` calls launched in a ``torch.profiler`` window,
    summed, and their count, each over ``iters``.  A window misses a few
    dozen of its kernels (on an H100, 24 of 30 rounds' 121,776), so the
    noop's reading is a floor and may be 0; a scheduled warm-up step
    before the window read kernel durations ~10x too long there."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(i)
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return (sum(e.self_device_time_total for e in kern) / 1e3 / iters,
            sum(e.count for e in kern) / iters)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--batch", type=int, default=10)
    p.add_argument("--iters", type=int, default=300)
    p.add_argument("--json", dest="json_out", default=None,
                   help="also write the breakdown to this file")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' runs the kernels' plain "
                        "PyTorch versions and measures no device time)")
    args = p.parse_args(argv)
    record = profile(args.workers, args.batch, args.iters, args.device, args.json_out)
    print(json.dumps(record), flush=True)
    return 0


def profile(n: int, b: int, iters: int, device=None, out=None,
            profiled: int = PROFILED_CALLS) -> dict:
    """The breakdown as a dict (and, given ``out``, as a JSON file), the
    device fields over ``profiled`` calls a part."""
    import torch

    from mdgan_tpu_torch.cli.bench import card
    from mdgan_tpu_torch.core.config import TrainConfig
    from mdgan_tpu_torch.core.registry import get as get_spec
    from mdgan_tpu_torch.data.partitioner import shard_data
    from mdgan_tpu_torch.data.sampler import ShardSampler
    from mdgan_tpu_torch.engine.mdgan import MDGANEngine
    from mdgan_tpu_torch.ops.sampling import sample_normalize

    spec = get_spec("CIFAR10")
    cfg = TrainConfig(batch_size=b, chunk_size=1, compute_dtype="bfloat16", device=device)
    eng = MDGANEngine(spec, cfg, num_workers=n)
    st = eng.init_state(seed=1)
    data, _ = spec.load("data", max_examples=50000)
    shards_np, _ = shard_data(data, n, iid=True, seed=0)
    shards = eng.shard_data(shards_np)
    sampler = ShardSampler(n, shards_np.shape[1], b, seed=0)
    k, (h, w, c), dev = eng.k, spec.shape, eng.device

    gen = torch.Generator(device=dev)
    gen.manual_seed(1000)
    fake = eng.generate(st.g, torch.zeros(1, spec.z_dim, device=dev)).dtype
    zs = [torch.randn(k * b, spec.z_dim, generator=gen, device=dev) for _ in range(ROTATE)]
    fbs = [(torch.randn(n, b, c, h, w, generator=gen, device=dev) / (b * n)).to(fake)
           for _ in range(ROTATE)]
    xks = [torch.randn(k, b, c, h, w, generator=gen, device=dev).to(fake)
           for _ in range(ROTATE)]
    idxs = [eng.put_indices(sampler.next_chunk(1)[0], shards.shape[1]) for _ in range(ROTATE)]

    def g_fwd_vjp_adam(i):
        with eng._autocast():
            x = st.g.modules[0](zs[i])
        eng._g_update(st, x, fbs[i])

    parts = {
        NOOP: lambda i: torch.neg(zs[i]),
        G_FWD: lambda i: eng.generate(st.g, zs[i]),
        G_VJP_ADAM: g_fwd_vjp_adam,
        d_region_name(n): lambda i: eng._d_region(st, sample_normalize(shards, idxs[i]),
                                                  xks[i]),
        FEEDBACK: lambda i: eng._feedback(st, xks[i][eng._g_assign]),
        FULL: lambda i: eng.step(st, shards, idxs[i]),
    }
    host, dev_ms, kernels = {}, {}, {}
    for name, fn in parts.items():
        def call(i, fn=fn):
            return fn(i % ROTATE)
        for i in range(3):  # warm-up
            call(i)
        host[name] = host_seconds(call, iters)
        dev_ms[name], kernels[name] = (device_busy(call, profiled)
                                       if dev.type == "cuda" else (None, None))

    base = host[NOOP]
    by = {name: (sec - base) * 1e6 for name, sec in host.items()}

    def less(a, b, table):
        return None if table[a] is None or table[b] is None else table[a] - table[b]

    where = card(dev)
    record = {
        "config": {"workers": n, "batch": b, "iters": iters,
                   "compute_dtype": cfg.compute_dtype},
        "device": where["device"],
        "power_limit_w": where["power_limit_w"],
        "dispatch_baseline_us": base * 1e6,
        # host microseconds a call, the noop's subtracted
        "components_us": by,
        "derived_us": {"g_vjp_adam": less(G_VJP_ADAM, G_FWD, by),
                       "d_local_train": less(d_region_name(n), FEEDBACK, by)},
        # the card's busy milliseconds a call, and its kernels a call
        "components_device_ms": dev_ms,
        "components_kernels": kernels,
        "derived_device_ms": {"g_vjp_adam": less(G_VJP_ADAM, G_FWD, dev_ms),
                              "d_local_train": less(d_region_name(n), FEEDBACK, dev_ms)},
    }
    if out is not None:
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        Path(out).write_text(json.dumps(record, indent=1) + "\n")
    return record


if __name__ == "__main__":
    raise SystemExit(main())
