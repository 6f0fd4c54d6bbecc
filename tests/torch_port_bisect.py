"""Where the port's MD-GAN rounds part from JAX's, at full width on the CPU.

    python tests/torch_port_bisect.py [--rounds 40] [--dtypes float32,bfloat16]
        [--workers 8] [--batch 10] [--json out.json]

Not a test: a measurement, run as a script (it imports both packages, as the
port's tests do).  The headline round (DCGAN-32 at ngf = ndf = 64, N
discriminators, b images each) runs on JAX's ``MDGANEngine.chunk_fn(1)``
along its own trajectory from ``init_state(seed=42)``, and beside it two
copies of the port's engine, given JAX's latents and sampler indices:

- ``forced`` starts every round from JAX's state of that round (parameters,
  BatchNorm statistics, Adam moments and count): its differences are one
  round's, and stay at rounding noise unless the round's semantics differ;
- ``free`` starts from JAX's initial state only and runs on its own: its
  differences are those rounding noise grows into.

Each round prints one JSON line: the largest relative difference of the
round's metrics (``mean_d_loss`` of each worker, ``g_feedback_loss``,
``feedback_norm``) for both copies, and the relative L2 distance of the
generator's and the discriminators' parameters after the round, over the
round's own update (``|port - jax| / |jax_after - jax_before|``).  The last
line summarizes: per dtype, the first round whose forced difference passes
``--noise`` (default 1e-3), and the free copy's differences at rounds 1, 10
and the last.
"""

from __future__ import annotations

import argparse
import json
import tempfile

import numpy as np

import jax
import jax.numpy as jnp
import torch

from mdgan_tpu.core import prng as jprng
from mdgan_tpu.core import registry as jregistry
from mdgan_tpu.core.config import TrainConfig as JaxTrainConfig
from mdgan_tpu.engine.mdgan import MDGANEngine as JaxEngine
from mdgan_tpu.models import dcgan32 as jdcgan32
from mdgan_tpu_torch.core.config import TrainConfig
from mdgan_tpu_torch.core.registry import get as get_spec
from mdgan_tpu_torch.data import partitioner, sampler
from mdgan_tpu_torch.engine.mdgan import MDGANEngine
from mdgan_tpu_torch.models import from_jax


def _flat(tree) -> np.ndarray:
    return np.concatenate([np.ravel(np.asarray(a, np.float64)) for a in jax.tree.leaves(tree)])


def _carry(pst, jst) -> None:
    """JAX's state (params, BN statistics, Adam moments and count) into the port's."""
    for net, jnet in ((pst.g, jst.g), (pst.d, jst.d)):
        adam = jnet.opt[0]
        from_jax.load_net(net, jax.device_get(jnet.params), jax.device_get(jnet.stats),
                          jax.device_get(adam.mu), jax.device_get(adam.nu), int(adam.count))
    pst.step = int(jst.step)


def _metric_err(jm, pm) -> float:
    worst = 0.0
    for key in ("mean_d_loss", "g_feedback_loss", "feedback_norm"):
        a = np.asarray(pm[key].detach().numpy() if torch.is_tensor(pm[key]) else pm[key],
                       np.float64).ravel()
        b = np.asarray(jm[key], np.float64).ravel()
        worst = max(worst, float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-12))))
    return worst


def _param_err(pst, jst_after, jst_before) -> dict:
    out = {}
    for role in ("g", "d"):
        port = _flat(from_jax.export_net(getattr(pst, role))[0])
        after = _flat(jax.device_get(getattr(jst_after, role).params))
        before = _flat(jax.device_get(getattr(jst_before, role).params))
        out[role] = float(np.linalg.norm(port - after)
                          / max(np.linalg.norm(after - before), 1e-30))
    return out


def bisect(dtype: str, rounds: int, n: int, b: int, noise: float) -> dict:
    jspec = jregistry.get("CIFAR10")
    spec = get_spec("CIFAR10")
    jeng = JaxEngine(jspec, JaxTrainConfig(batch_size=b, chunk_size=1, compute_dtype=dtype,
                                           donate=False), n)
    peng = MDGANEngine(spec, TrainConfig(batch_size=b, compute_dtype=dtype, device="cpu"), n)
    with tempfile.TemporaryDirectory() as tmp:
        data, _ = spec.load(tmp, max_examples=1000 * n)
    shards, _ = partitioner.shard_data(data, n, iid=True, seed=0)
    jdata, pdata = jeng.shard_data(shards), peng.shard_data(shards)
    samp = sampler.ShardSampler(n, shards.shape[1], b, seed=0)
    jst = jeng.init_state(seed=42)
    forced, free = peng.init_state(seed=42), peng.init_state(seed=42)
    _carry(free, jst)
    step = jeng.chunk_fn(1)
    rows = []
    for r in range(rounds):
        idx = samp.next_chunk(1)
        kz = jprng.for_step(jst.key, jprng.LATENT, jst.step)
        z = torch.from_numpy(np.array(jax.random.normal(
            kz, (jeng.k * b, jdcgan32.Z_DIM), jnp.float32)))
        before = jst
        jst, jm = step(jst, jdata, jnp.asarray(idx))
        jm = {k: np.asarray(v)[0] for k, v in jm.items() if k != "x_eval"}
        _carry(forced, before)
        ind = peng.put_indices(idx[0], shards.shape[1])
        pm_forced = peng.step(forced, pdata, ind, z=z)
        pm_free = peng.step(free, pdata, ind, z=z)
        row = {"dtype": dtype, "round": r,
               "forced_metric_rel": _metric_err(jm, pm_forced),
               "free_metric_rel": _metric_err(jm, pm_free),
               "forced_param_rel": _param_err(forced, jst, before),
               "free_param_rel": _param_err(free, jst, before),
               "jax_mean_d_loss": float(np.mean(jm["mean_d_loss"])),
               "port_free_mean_d_loss": float(pm_free["mean_d_loss"].mean())}
        print(json.dumps(row), flush=True)
        rows.append(row)
    parted = [row["round"] for row in rows if row["forced_metric_rel"] > noise]
    return {"dtype": dtype, "rounds": rounds, "noise": noise,
            "first_forced_round_past_noise": parted[0] if parted else None,
            "forced_metric_rel_max": max(row["forced_metric_rel"] for row in rows),
            "forced_metric_rel_median": float(np.median([row["forced_metric_rel"]
                                                         for row in rows])),
            "free_metric_rel_at": {str(i): rows[i]["free_metric_rel"]
                                   for i in sorted({1, min(10, rounds - 1), rounds - 1})},
            "jax_mean_d_loss_mean": float(np.mean([row["jax_mean_d_loss"] for row in rows])),
            "port_free_mean_d_loss_mean": float(np.mean([row["port_free_mean_d_loss"]
                                                         for row in rows]))}


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--rounds", type=int, default=40)
    p.add_argument("--dtypes", default="float32,bfloat16")
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--batch", type=int, default=10)
    p.add_argument("--noise", type=float, default=1e-3)
    p.add_argument("--json", default=None, help="also write the summary here")
    args = p.parse_args()
    summary = [bisect(d, args.rounds, args.workers, args.batch, args.noise)
               for d in args.dtypes.split(",")]
    print(json.dumps({"summary": summary}), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(summary, f, indent=1)


if __name__ == "__main__":
    main()
