"""One run of one cell: set-up, the measured window, the traced slice, the
check against the reference, and the result line.

Set-up (``setup_s`` runs from process start to the window's start): the
program's engine, the inputs made from the seed (weights, pixels, indices,
latents, and the generator's noise where the family declares any), a fresh
state holding the weights, then the check's three
rounds through the window's own call (``run_rounds`` on the window's feed,
in the chunks of ``check.CHECK_CHUNKS``: one round, then a chunk of the
rest), whose losses, first gradients (the Adam state after one step) and
parameter changes are kept, then a warm chunk of ``WARM_ROUNDS`` rounds.  The same state goes on into the window.

The window runs whole chunks of the cell's ``chunk`` rounds until
``--seconds`` have passed, and ends at a host read of every chunk's losses;
``wall_rounds_per_s`` is its rounds over its wall time.  With ``--trace 1``
the window is followed by ``traced_chunks`` chunks under ``torch.profiler``
(CPU and CUDA activities, no schedule), which the other per-layer metrics
read.  With ``--trace 0``, a cell that reports ``device_ms_per_round`` runs
one chunk of the traffic's ``device_rounds`` rounds under the profiler
after the window, and that metric is the slice's device-busy time over its
rounds.

After the window, the peak memory is read, the program's state freed, and
the reference runs the same first rounds from the same inputs, made again
from the seed, in float32 with TF32 off (``check.py``).

A cell on R ranks runs R processes, one card each: this one (rank 0, which
prints) and R-1 started by it (``perfbench/rank.py``), joined over
``tcp://localhost:<free port>``: NCCL for the program, gloo for the
harness's own messages (when to end the window, the gathered readings).
"""

from __future__ import annotations

import gc
import importlib
import json
import os
import socket
import subprocess
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from perfbench import check, inputs, spec, trace
from perfbench.reference.ops import Ops, float32_exact

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "mdgan_tpu")
CHILD_TIMEOUT_S = 330
JOIN_TIMEOUT_S = 120     # the ranks' joins and collectives give up after this
# rounds of the warm chunk: every kernel of a round, and the chunk's
# multi-round path, have run in the check rounds already
WARM_ROUNDS = 2


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted(n for n in list(sys.modules) if n.split(".")[0] in FORBIDDEN)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def host_clocks() -> Dict[str, float]:
    """This process's CPU seconds (every thread), and where Linux gives them
    the machine's stolen seconds: a window whose CPU time tracks its wall
    time, with nothing stolen, ran on a host whose cores were slow."""
    out = {"cpu_s": time.process_time()}
    try:
        with open("/proc/stat") as f:
            out["steal_s"] = int(f.readline().split()[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        pass
    return out


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class Rank:
    """This process's share of a cell: the program on its card, its inputs,
    and the control messages between ranks."""

    def __init__(self, cell: spec.Cell, device: str, rank: int = 0, world: int = 1,
                 port: Optional[int] = None):
        self.cell, self.rank, self.world = cell, rank, world
        self.dev = torch.device("cuda", rank) if device == "cuda" else torch.device(device)
        if self.dev.type == "cuda":
            if rank >= torch.cuda.device_count():
                raise RuntimeError(f"{cell.name} needs {world} cards, "
                                   f"{torch.cuda.device_count()} present")
            torch.cuda.set_device(self.dev)
        self.ctl = None
        if world > 1:
            import datetime

            import torch.distributed as dist

            dist.init_process_group("nccl" if self.dev.type == "cuda" else "gloo",
                                    init_method=f"tcp://localhost:{port}",
                                    world_size=world, rank=rank,
                                    timeout=datetime.timedelta(seconds=JOIN_TIMEOUT_S))
            self.ctl = dist.new_group(backend="gloo")
        self.fam, self.mode = cell.family, cell.mode
        self.cfg, self.traffic = cell.config, cell.traffic
        self.program = self.mode.Program(self.fam, self.cfg, self.traffic, self.dev)
        self.noise_shapes = spec.noise_shapes(self.fam, self.cfg)
        self.chunk_i = 0

    # --- messages between ranks (gloo, host only) ---
    def agree(self, go: bool) -> bool:
        """Rank 0's ``go``, on every rank."""
        if self.ctl is None:
            return go
        import torch.distributed as dist

        flag = torch.tensor([int(go)])
        dist.broadcast(flag, 0, group=self.ctl)
        return bool(flag.item())

    def gather(self, obj) -> Optional[list]:
        """Every rank's ``obj`` on rank 0 (in rank order); None elsewhere."""
        if self.ctl is None:
            return [obj]
        import torch.distributed as dist

        out = [None] * self.world if self.rank == 0 else None
        dist.gather_object(obj, out, dst=0, group=self.ctl)
        return out

    def barrier(self) -> None:
        if self.ctl is not None:
            import torch.distributed as dist

            dist.barrier(group=self.ctl)

    def close(self) -> None:
        if self.ctl is not None:
            import torch.distributed as dist

            dist.barrier(group=self.ctl)
            dist.destroy_process_group()
            self.ctl = None

    # --- the program ---
    def draws(self, rounds: int):
        """The next chunk's latents, and its noise where the family declares
        any (else None)."""
        i, self.chunk_i = self.chunk_i, self.chunk_i + 1
        per_round = self.mode.latents_per_round(self.traffic)
        z = inputs.latents(self.dev, self.seed, i, rounds, per_round, self.cfg["z_dim"])
        if self.noise_shapes is None:
            return z, None
        return z, inputs.noise(self.dev, self.seed, i, rounds, per_round, self.noise_shapes)

    def chunk(self, rounds: int) -> Dict[str, torch.Tensor]:
        z, noise = self.draws(rounds)
        return self.program.chunk(self.st, self.data, self.sampler, rounds, z, noise)

    def prepare(self, seed: int) -> dict:
        """A fresh state from the seed's weights, driven through the check
        rounds; returns the program's readings of them (this rank's
        leaves)."""
        cfg, p = self.cfg, self.program
        self.seed, self.chunk_i = seed, 0
        self.data = p.data(seed)
        self.sampler = inputs.Sampler(seed, self.traffic["num_workers"], p.shard_size,
                                      self.traffic["batch_size"])
        g, ds = weights(self.fam, cfg, self.dev, seed, p.workers)
        self.st = p.state(seed, g, ds)
        init = leaf_dict(g, ds)
        losses = []
        for i, rounds in enumerate(check.CHECK_CHUNKS):
            m = self.chunk(rounds)
            losses += [{k: v[t].reshape(-1).cpu().tolist() for k, v in m.items()}
                       for t in range(rounds)]
            if i == 0:
                first = check.host_copy(p.leaves(self.st, "mu"), 1.0 / (1.0 - cfg["beta_1"]))
        change = check.norms({k: v - init[k] for k, v in p.leaves(self.st, "params").items()})
        return {"losses": losses, "grads": check.norms(first), "grad_tensors": first,
                "change": change}

    def window(self, seconds: float):
        """Whole chunks until ``seconds`` have passed (rank 0's clock), up
        to a host read of every chunk's losses: (rounds, wall s, failed)."""
        clocks0 = host_clocks()
        outs, t0 = [], time.perf_counter()
        issued = [t0]
        while True:
            outs.append(self.chunk(self.traffic["chunk"]))
            issued.append(time.perf_counter())
            if not self.agree(issued[-1] - t0 < seconds):
                break
        failed = count_failed(outs)
        wall = time.perf_counter() - t0
        clocks = host_clocks()
        self.host = {k: v - clocks0[k] for k, v in clocks.items() if k in clocks0}
        self.issue_s = [b - a for a, b in zip(issued, issued[1:])]
        return len(outs) * self.traffic["chunk"], wall, failed

    def traced(self, chunks: int, rounds: int):
        """``chunks`` chunks of ``rounds`` rounds under the profiler:
        (summary, rounds, failed)."""
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.dev.type == "cuda" else [])
        outs = []
        with profile(activities=acts) as prof:
            with record_function(trace.SPAN):
                for _ in range(chunks):
                    outs.append(self.chunk(rounds))
                _sync(self.dev)
        summary = trace.summarize(trace.events(prof))
        return summary, chunks * rounds, count_failed(outs)

    def peak_bytes(self) -> int:
        return torch.cuda.max_memory_allocated(self.dev) if self.dev.type == "cuda" else 0

    def free(self) -> None:
        self.st = self.data = self.sampler = None
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()


def weights(fam, cfg: dict, dev, seed: int, workers):
    """The generator's and the given workers' discriminators' weights."""
    g = inputs.weights(fam.leaves(cfg, "g"), dev, seed, inputs.WEIGHTS_G)
    d_leaves = fam.leaves(cfg, "d")
    return g, {w: inputs.weights(d_leaves, dev, seed, inputs.WEIGHTS_D, w) for w in workers}


def leaf_dict(g: dict, ds: dict) -> Dict[str, torch.Tensor]:
    out = {f"g/{k}": v for k, v in g.items()}
    for w, d in ds.items():
        out.update({f"d{w}/{k}": v for k, v in d.items()})
    return out


def count_failed(outs: List[Dict[str, torch.Tensor]]) -> int:
    """Rounds with a non-finite loss (each chunk's losses read to the host)."""
    failed = 0
    for m in outs:
        finite = torch.stack([v.reshape(v.shape[0], -1).isfinite().all(1)
                              for v in m.values()]).all(0)
        failed += int((~finite.cpu()).sum())
    return failed


def merge(readings: List[dict]) -> dict:
    """The ranks' readings as one program's: losses and the generator's
    leaves from rank 0, each rank's own discriminators."""
    out = {"losses": readings[0]["losses"], "grads": {}, "grad_tensors": {}, "change": {}}
    for i, r in enumerate(readings):
        for key in ("grads", "grad_tensors", "change"):
            out[key].update({k: v for k, v in r[key].items() if i == 0 or not k.startswith("g/")})
    return out


def reference(cell: spec.Cell, seed: int, dev, precision: str = "float32", fault=None) -> dict:
    """The reference's readings of the check rounds: the same inputs, made
    again from the seed, for all N workers, and where the family declares
    noise the mode's reference gets ``noise``: each input's (rounds, k*b,
    *shape) over the check chunks.  ``fault`` "gather" feeds every round of
    a check chunk its first round's rows (a gather that reads the wrong
    round); the others are the reference's own (``reference.rounds``)."""
    fam, mode, cfg, traffic = cell.family, cell.mode, cell.config, cell.traffic
    n, size = traffic["num_workers"], mode.shard_size(cfg, traffic)
    workers = list(range(n))
    g, ds = weights(fam, cfg, dev, seed, workers)
    sampler = inputs.Sampler(seed, n, size, traffic["batch_size"])
    blocks = [sampler.next_chunk(rounds) for rounds in check.CHECK_CHUNKS]
    if fault == "gather":
        blocks, fault = [np.broadcast_to(b[:1], b.shape) for b in blocks], None
    reals = inputs.real_batches(dev, seed, workers, size, cfg["image_shape"],
                                np.concatenate(blocks))
    per_round = mode.latents_per_round(traffic)
    zs = torch.cat([inputs.latents(dev, seed, i, rounds, per_round, cfg["z_dim"])
                    for i, rounds in enumerate(check.CHECK_CHUNKS)])
    extra = {}
    shapes = spec.noise_shapes(fam, cfg)
    if shapes is not None:
        chunks = [inputs.noise(dev, seed, i, rounds, per_round, shapes)
                  for i, rounds in enumerate(check.CHECK_CHUNKS)]
        extra["noise"] = [torch.cat(parts) for parts in zip(*chunks)]
    ops = Ops(precision)
    with float32_exact(), ops.context(torch.device(dev)):
        out = mode.reference(fam, cfg, traffic, g, [ds[w] for w in workers], reals,
                             list(zs.unbind(0)), ops, fault, **extra)
    return check.reduce_reference(out, leaf_dict(g, ds))


# --- the run -----------------------------------------------------------------

def drive(rk: Rank, job: dict, t_start: float) -> Optional[dict]:
    """What every rank does; rank 0 gets the gathered readings back.

    ``job["kind"]`` is "run" (set-up, window, traced slice) or "readings"
    (set-up and check rounds for each of ``job["seeds"]``).  A test may
    name a ``job["hook"]``, "module:function", that every rank calls first
    (the fault tests break the program there)."""
    if job.get("hook"):
        module, _, fn = job["hook"].partition(":")
        getattr(importlib.import_module(module), fn)()
    if job["kind"] == "readings":
        out = []
        for seed in job["seeds"]:
            got = rk.gather(rk.prepare(seed))
            rk.free()
            if got is not None:
                out.append(merge(got))
        return {"readings": out}
    steps = {"process start to engine": time.perf_counter() - t_start}
    prog = rk.prepare(job["seed"])
    steps["inputs, state and check rounds"] = time.perf_counter() - t_start - sum(steps.values())
    rk.chunk(WARM_ROUNDS)
    _sync(rk.dev)
    rk.barrier()                         # every rank set up
    setup_s = time.perf_counter() - t_start
    steps["warm chunk and the ranks' barrier"] = setup_s - sum(steps.values())
    rounds, secs, failed = rk.window(job["seconds"])
    steps["window, host issue of each chunk"] = rk.issue_s
    steps.update({f"window, host {k}": v for k, v in rk.host.items()})
    mine = {"prog": prog, "failed": failed, "rounds": rounds}
    traffic, t = rk.traffic, time.perf_counter()
    if job["trace"]:
        summary, t_rounds, t_failed = rk.traced(traffic["traced_chunks"], traffic["chunk"])
        steps["traced slice and its reading"] = time.perf_counter() - t
        mine.update(summary=summary, traced_rounds=t_rounds, failed=failed + t_failed)
    elif job.get("device_slice"):
        summary, t_rounds, t_failed = rk.traced(1, traffic["device_rounds"])
        steps["device slice and its reading"] = time.perf_counter() - t
        mine.update(device_busy_ns=summary["busy_ns"], traced_rounds=t_rounds,
                    failed=failed + t_failed)
    mine["peak"] = rk.peak_bytes()
    got = rk.gather(mine)
    rk.free()
    if got is None:
        return None
    return {"setup_s": setup_s, "window_s": secs, "rounds": rounds, "ranks": got,
            "prog": merge([g["prog"] for g in got]), "steps": steps}


def _spawn(job: dict, cell: str, overrides, device: str, world: int, port: int):
    """Ranks 1..world-1, each a ``perfbench/rank.py`` process."""
    return [subprocess.Popen([sys.executable, str(spec.HERE / "rank.py"), json.dumps(
        {"job": job, "cell": cell, "overrides": overrides, "device": device, "rank": r,
         "world": world, "port": port})]) for r in range(1, world)]


def ranked(cell_name: str, job: dict, device: str, t_start: float, overrides=None):
    """Run ``job`` on the cell's ranks (this process is rank 0): the
    gathered result, the cell and rank 0's ``Rank`` (closed)."""
    cell = spec.cell(cell_name, overrides)
    world = cell.traffic.get("ranks", 1)
    port = free_port() if world > 1 else None
    if world > 1:              # the ranks talk over the loopback interface
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    children = _spawn(job, cell_name, overrides, device, world, port) if world > 1 else []
    try:
        rk = Rank(cell, device, 0, world, port)
        out = drive(rk, job, t_start)
        rk.close()
        for c in children:
            if c.wait(timeout=CHILD_TIMEOUT_S) != 0:
                raise RuntimeError(f"a rank exited with {c.returncode}")
    finally:
        for c in children:
            if c.poll() is None:
                c.kill()
                c.wait()
    return out, cell, rk


def e2e_value(name: str, got: dict) -> float:
    if name == "setup_s":
        return got["setup_s"]
    if name == "device_ms_per_round":     # rank 0's card; none where no device ran
        r0 = got["ranks"][0]
        return r0["device_busy_ns"] / 1e6 / r0["traced_rounds"] if r0["device_busy_ns"] else None
    raise KeyError(f"no end-to-end metric {name!r} in the harness")


class Reading:
    """What a per-layer metric's reader sees: the cell, the untraced window's
    rate, and rank 0's trace summary of the traced slice."""

    def __init__(self, cell: spec.Cell, got: dict):
        self.cell, self.cfg, self.traffic, self.mode = cell, cell.config, cell.traffic, cell.mode
        self.world = len(got["ranks"])
        self.rate = got["rounds"] / got["window_s"]
        self.summary = got["ranks"][0]["summary"]
        self.rounds = got["ranks"][0]["traced_rounds"]

    def device_ns(self, match) -> float:
        """Device ns of the slice's events whose name ``match`` accepts."""
        return sum(ns for name, (_, ns) in self.summary["by_name"].items() if match(name))


def run(cell_name: str, seed: int, seconds: float, trace_on: bool, device: str,
        t_start: float, overrides=None, hook: str = ""):
    """(result line as a dict, lines for standard error)."""
    device_slice = any(m["source"] == "device_trace" for m in spec.cell(cell_name).end_to_end)
    job = {"kind": "run", "seed": seed, "seconds": seconds, "trace": bool(trace_on), "hook": hook,
           "device_slice": device_slice}
    got, cell, rk = ranked(cell_name, job, device, t_start, overrides)
    t = time.perf_counter()
    ref = reference(cell, seed, rk.dev)
    got["steps"]["reference"] = time.perf_counter() - t
    values = check.numbers(got["prog"], ref)
    failed = got["ranks"][0]["failed"]       # the losses are whole on every rank
    attempted = got["rounds"] + got["ranks"][0].get("traced_rounds", 0)
    correct = check.verdict(values, cell.limits) and failed == 0
    metrics = {}
    if not trace_on:
        for m in cell.end_to_end:
            value = e2e_value(m["name"], got)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        reading = Reading(cell, got)
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"]).read(reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = rk.dev
    result = {"correct": bool(correct), "attempted": attempted, "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                         "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                         "count": len(got["ranks"]),
                         "memory_peak_bytes": max(r["peak"] for r in got["ranks"])}}
    if trace_on:
        sums = [r["summary"] for r in got["ranks"]]
        result["device"]["busy_s"] = sum(s["busy_ns"] for s in sums) / len(sums) / 1e9
        result["device"]["window_s"] = sum(s["window_ns"] for s in sums) / len(sums) / 1e9
        s0 = sums[0]
        result["breakdown"] = {
            "device_ops": trace.top({k: ns for k, (_, ns) in s0["by_name"].items()}),
            "idle_gaps": trace.top(s0["gaps"])}
    result["checks"] = {k: {"value": values[k][0], "limit": lim} for k, lim in cell.limits.items()}
    lines = [f"time {k}: {v!r} s" for k, v in got["steps"].items()]
    lines += [f"check {k} {v!r} limit {cell.limits.get(k)!r} (worst: {where})"
              for k, (v, where) in values.items() if k not in cell.limits]
    lines += [f"check {k} {values[k][0]!r} limit {lim!r} (worst: {values[k][1]})"
              for k, lim in cell.limits.items()]
    return result, lines


def main(argv: List[str], t_start: float) -> int:
    import argparse

    p = argparse.ArgumentParser(description="One run of one benchmark cell (perfbench/README.md).")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = spec.cell(args.workload)
    if not torch.cuda.is_available():
        print("perfbench: no CUDA device; the benchmark runs only on the card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    result, lines = run(args.workload, args.seed, args.seconds, args.trace, "cuda", t_start)
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
