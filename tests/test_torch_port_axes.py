"""The mesh's replica and tensor axes (``mdgan_tpu_torch/core/mesh.py``,
``parallel/tensor.py``, the cross-replica BatchNorm of ``models/layers.py``)
on the CPU with gloo, against ``mdgan_tpu.core.mesh``, the single-process
port and JAX's engines.

The rank programs are this file run as a script under
``python -m torch.distributed.run`` (:func:`_rank_main`), as
``tests/test_torch_port_distributed.py`` starts its ranks: one timeout a
launch that kills every rank, one intra-op thread a rank.  Held here:

  * the rank layout against ``make_mesh`` on the 8 forced CPU devices for
    every (world <= 8, N, R, T): the axis sizes, JAX's device-grid order,
    the idle fallback and the ``ValueError``;
  * the sharded leaves and their dims for all four families' generators at
    T=2 and 4 against ``generator_sharding`` on JAX's own leaves, and each
    rank's slices equal to JAX's leaves split along their trailing dim;
  * one 4-rank launch: the cross-replica BatchNorm forward, backward and
    running statistics (b=4 and b=3 over R=2) and StyleGAN2's minibatch
    statistic against one process; (R=2, W=2) DCGAN-32 against the
    single-process port (rtol 1e-5, atol 1e-6) and JAX's engine on a
    (replica 2, workers 2) mesh, JAX's weights and latents injected, at the
    free-running bounds of ``tests/test_torch_port_round.py``; and a narrow
    StyleGAN2 on (W=2, T=2) against the single-process port and JAX's
    single-device engine (``tests/test_parallel.py:189-240`` holds JAX's
    mesh to it).  Replicas' discriminators are bit-equal, and the gathered
    generator is bit-equal on every rank.

``tests/test_torch_port_axes_tp.py`` holds the 8-rank (R=2, W=2, T=2) runs,
``tests/test_torch_port_axes_cli.py`` the trainer through the CLI.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_port_distributed import launch

ROOT = Path(__file__).resolve().parents[1]
N, B, WIDTH, SEED = 4, 4, 8, 3
SG2 = {"max_res": 32, "base_features": 32, "map_layers": 2}
# family -> (port dataset, width keywords, stored image shape)
FAMILY = {
    "dcgan32": ("Synthetic32", {"ngf": WIDTH, "ndf": WIDTH}, (32, 32, 3)),
    "mlp": ("SyntheticMNIST", {}, (28, 28, 1)),
    "stylegan2": ("FFHQ128", SG2, (32, 32, 3)),
}
CHUNKS = (1, 1)  # a chunk, a swap, a chunk
ARENAS = ("params", "stats", "mu", "nu")
LR = 2e-4


# --- what the ranks and the single-process references both run --------------

def units(replica) -> dict:
    """The cross-replica BatchNorm (b=4 and b=3) and StyleGAN2's minibatch
    statistic (b=8) on this replica's rows of fixed batches: outputs, input
    and parameter gradients (the latter summed over the replicas) and
    running statistics.  ``replica``: the mesh's replica axis (an inactive
    one: the whole batch in one process)."""
    from mdgan_tpu_torch.core import distributed
    from mdgan_tpu_torch.models.layers import BatchNorm2d
    from mdgan_tpu_torch.models.stylegan2 import minibatch_stddev

    out = {}
    for b in (4, 3, 8):
        rng = np.random.default_rng(b)
        x = rng.standard_normal((b, 6, 5, 5)).astype(np.float32) * 2 + 0.5
        sizes = [len(a) for a in np.array_split(np.arange(b), replica.size)]
        lo = sum(sizes[:replica.index])
        rows = slice(lo, lo + sizes[replica.index])
        xr = torch.from_numpy(x[rows]).requires_grad_(True)
        if b == 8:
            y = minibatch_stddev(xr, replica=replica)
            params = []
        else:
            bn = BatchNorm2d(6)
            with torch.no_grad():
                bn.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, 6).astype(np.float32)))
                bn.bias.copy_(torch.from_numpy(rng.standard_normal(6).astype(np.float32)))
            bn.replica = replica
            y = bn(xr)
            params = [bn.weight, bn.bias]
            out[f"b{b}/running"] = torch.cat([bn.running_mean, bn.running_var]).numpy()
        cot = rng.standard_normal((b, *y.shape[1:])).astype(np.float32)[rows]
        (y * torch.from_numpy(cot)).sum().backward()
        out[f"b{b}/y"] = y.detach().numpy()
        out[f"b{b}/x_grad"] = xr.grad.numpy()
        if params:
            grads = torch.cat([p.grad for p in params])
            out[f"b{b}/param_grad"] = distributed.all_reduce_(grads, replica).numpy()
    return out


def _masks_from(init: dict):
    """Injected dropout masks, ``masks/<round>/<key path>/<layer>`` -> a
    list by round of {key path: masks}."""
    rounds: dict = {}
    for key in [k for k in init if k.startswith("masks/")]:
        _, t, path, i = key.split("/")
        rounds.setdefault(int(t), {}).setdefault(tuple(map(int, path.split("-"))), {})[
            int(i)] = torch.from_numpy(init.pop(key))
    return [{p: [m[i] for i in sorted(m)] for p, m in rounds[t].items()}
            for t in sorted(rounds)] or None


def run_engine(spec: dict) -> dict:
    """Two rounds around a swap (chunks ``CHUNKS``) of ``spec["family"]`` at
    N=4, b=4 on the (``replicas``, workers, ``tensor``) mesh of this
    process's group (one process: the single-process run), optionally from
    ``init``, an npz of JAX's weights, latents and dropout masks: this rank's
    discriminator arenas, the generator's gathered whole, and the metrics."""
    from mdgan_tpu_torch.core.config import TrainConfig
    from mdgan_tpu_torch.core.mesh import rank_layout
    from mdgan_tpu_torch.core.registry import get as get_spec
    from mdgan_tpu_torch.data import builtin, partitioner, sampler
    from mdgan_tpu_torch.engine.mdgan import MDGANEngine
    from mdgan_tpu_torch.models import from_jax
    from mdgan_tpu_torch.parallel import tensor as tensor_lib
    from mdgan_tpu_torch.utils.checkpoint import unflatten

    if spec["family"] == "units":
        lay = rank_layout(N, spec["replicas"], 1)
        return {**units(lay.replica_axis), "coords": np.array(lay.coords)}
    dataset, kw, shape = FAMILY[spec["family"]]
    lay = rank_layout(N, spec.get("replicas", 1), spec.get("tensor", 1))
    eng = MDGANEngine(get_spec(dataset), TrainConfig(
        batch_size=B, compute_dtype="float32", device="cpu", swap_opt_state=True), N,
        model_kwargs=kw, layout=lay)
    data, _ = builtin.synthesize(shape, 40 * N, seed=32)
    shards, _ = partitioner.shard_data(data, N, iid=True, seed=0)
    pdata = eng.shard_data(shards)
    smp = sampler.ShardSampler(N, shards.shape[1], B, seed=0)
    st = eng.init_state(SEED)
    z = masks = None
    if spec.get("init"):
        init = dict(np.load(spec["init"]))
        z = torch.from_numpy(init.pop("z"))
        masks = _masks_from(init)
        trees = unflatten(init)
        from_jax.load_net(st.g, trees["g"]["params"], trees["g"].get("stats", {}))
        from_jax.load_net(st.d, trees["d"]["params"], trees["d"].get("stats", {}),
                          rows=lay.workers)
    out, t0 = {}, 0
    for c, rounds in enumerate(CHUNKS):
        if masks is None:
            m = eng.run_rounds(st, pdata, smp, rounds,
                               z=None if z is None else z[t0:t0 + rounds])
        else:  # one round a step, with its injected masks
            ms = [eng.step(st, pdata, eng.put_indices(smp.next_chunk(1)[0], shards.shape[1]),
                           z=z[t], masks=masks[t]) for t in range(t0, t0 + rounds)]
            m = {k: torch.stack([x[k] for x in ms]) for k in ms[0] if k != "x_eval"}
            m["x_eval"] = ms[-1]["x_eval"]
        t0 += rounds
        for key, value in m.items():
            out[f"chunk{c}/{key}"] = value.numpy()
        if c == 0:
            eng.swap(st, eng.sample_swap_perm(np.random.default_rng(5)))
    whole = tensor_lib.gather_arenas(st.g, lay.tensor_axis,
                                     {a: getattr(st.g, a) for a in ARENAS})
    for a in ARENAS:
        out[f"g/{a}"] = whole[a].float().numpy()
        out[f"d/{a}"] = getattr(st.d, a).float().numpy()
    out["g_local/params"] = st.g.params.numpy()
    out["coords"] = np.array(lay.coords)
    return out


def _rank_main(argv) -> int:
    """One rank: ``engine <json list of specs> <out prefix>`` (each spec's
    results in ``<prefix><i>_<rank>.npz``) or ``cli <argv...>``."""
    from mdgan_tpu_torch.core import distributed

    torch.set_num_threads(1)
    mode, rest = argv[0], argv[1:]
    if mode == "cli":
        from test_torch_port_distributed import _stub_inception

        _stub_inception()
        from mdgan_tpu_torch.cli import train

        return train.main(rest)
    distributed.maybe_initialize("cpu")
    try:
        import torch.distributed as dist

        for i, spec in enumerate(json.loads(rest[0])):
            np.savez(f"{rest[1]}{i}_{dist.get_rank()}.npz", **run_engine(spec))
    finally:
        distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    sys.exit(_rank_main(sys.argv[1:]))


# --- launching the ranks -------------------------------------------------------

def launch_engine(tmp_path, world: int, specs, timeout: float = 240):
    """The specs on ``world`` ranks; returns each spec's per-rank results."""
    prefix = tmp_path / "rank"
    launch(Path(__file__).resolve(), world, ["engine", json.dumps(specs), prefix], timeout)
    return [[dict(np.load(f"{prefix}{i}_{r}.npz")) for r in range(world)]
            for i in range(len(specs))]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# Against one process, a replica or tensor axis sums gradients in another
# order.  An Adam step whose gradient sits at rounding noise can go either
# way, and the next round's images, gradients and moments follow the few
# parameters it moved.  So the losses and the feedback norm are held at rtol
# 1e-5, atol 1e-6 throughout; the arenas and x_eval at that bound for all but
# OFF_SHARE of their elements, and every element within adam_bound
# (parameters) or 1e-3 of the array's largest magnitude (the rest).
# Measured on these runs: at most 2.2e-5 of an arena's elements off, by at
# most 2.5e-6.
OFF_SHARE = 1e-3


def adam_bound(rounds: int, b2: float = 0.999) -> float:
    """The most two runs' parameters can part after ``rounds`` Adam steps
    (beta_1 = 0): step t moves an element by up to lr sqrt((1 - b2^t) /
    (1 - b2)), in either direction."""
    return 2 * LR * sum(((1 - b2 ** t) / (1 - b2)) ** 0.5 for t in range(1, rounds + 1))


def check_close(got, want, key, rounds=sum(CHUNKS), params=None):
    """``got`` against the single-process ``want`` by the rule above
    (``params``: whether they are parameters; default: by the key)."""
    if key.split("/")[-1] in ("mean_d_loss", "g_feedback_loss", "feedback_norm"):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=key)
        return
    assert got.shape == want.shape, key
    if not want.size:
        return
    off = 1.0 - np.isclose(got, want, rtol=1e-5, atol=1e-6).mean()
    if params is None:
        params = key.endswith("params")
    bound = adam_bound(rounds) if params else 1e-3 * np.abs(want).max()
    assert off < OFF_SHARE, (key, off)
    assert np.abs(got - want).max() <= bound, (key, np.abs(got - want).max())


def check_against_one_process(ranks, ref):
    """Rank runs against one process: the gathered generator and the
    metrics bit-equal on every rank, each worker slot's discriminators
    bit-equal over its replicas and tensor slots; the generator, the
    discriminators (in worker-slot order) and the metrics against one
    process by :func:`check_close`."""
    coords = [tuple(r["coords"]) for r in ranks]
    for key in ref:
        if key.startswith(("coords", "g_local/")):
            continue
        if key.startswith("d/"):
            for r, (_, w, _) in zip(ranks, coords):
                first = ranks[coords.index((0, w, 0))]
                assert np.array_equal(r[key], first[key]), (key, coords)
            slots = sorted({w for _, w, _ in coords})
            got = np.concatenate([ranks[coords.index((0, w, 0))][key] for w in slots])
        else:
            got = ranks[0][key]
            for r in ranks[1:]:
                assert np.array_equal(r[key], got), key
        check_close(got, ref[key], key)


def port_trees(family: str, g_params: np.ndarray, d_params: np.ndarray) -> dict:
    """Whole generator and N-stacked discriminator param arenas -> flax
    trees (through a single-process engine's layout)."""
    from mdgan_tpu_torch.core.config import TrainConfig
    from mdgan_tpu_torch.core.registry import get as get_spec
    from mdgan_tpu_torch.engine.mdgan import MDGANEngine
    from mdgan_tpu_torch.models import from_jax

    dataset, kw, _ = FAMILY[family]
    lay = MDGANEngine(get_spec(dataset), TrainConfig(device="cpu"), N,
                      model_kwargs=kw).init_state(SEED)
    return {name: from_jax.export_arenas(getattr(lay, name),
                                         {"params": torch.from_numpy(a)})["params"]
            for name, a in (("g", g_params), ("d", d_params))}


def jax_run(family: str, tmp_path, replicas: int = 1):
    """JAX's engine on ``family`` (single device, or a (replica, workers)
    mesh of 2*``replicas`` devices) over ``CHUNKS`` with the swap: its
    initial weights, latents and (MLP) dropout masks written as an npz for
    the port, its per-round metrics and its final state."""
    import jax
    import jax.numpy as jnp

    import test_torch_port_families as fam
    import test_torch_port_round as rnd
    from mdgan_tpu.core import mesh as jmesh
    from mdgan_tpu.core import prng as jprng
    from mdgan_tpu.core.config import MeshConfig, TrainConfig as JaxTrainConfig
    from mdgan_tpu.data import builtin as jbuiltin
    from mdgan_tpu.data import partitioner as jpartitioner
    from mdgan_tpu.data.sampler import ShardSampler
    from mdgan_tpu.engine.mdgan import MDGANEngine as JaxEngine
    from mdgan_tpu_torch.utils.checkpoint import flatten

    mesh = mcfg = None
    if replicas > 1:
        mcfg = MeshConfig(num_workers=N, num_devices=2 * replicas, num_replicas=replicas)
        mesh = jmesh.make_mesh(mcfg)
        assert dict(mesh.shape) == {"replica": replicas, "workers": 2}
    jspec = rnd._narrow_jax_spec() if family == "dcgan32" else fam._jax_spec(family)
    jeng = JaxEngine(jspec, JaxTrainConfig(batch_size=B, compute_dtype="float32", donate=False,
                                           swap_opt_state=True), N, mesh=mesh, mesh_cfg=mcfg)
    jst = jeng.init_state(SEED) if mesh is not None else fam._jit_init(jeng, SEED)
    total = sum(CHUNKS)
    z = np.stack([np.array(jax.random.normal(jprng.for_step(jst.key, jprng.LATENT, t),
                                             (jeng.k * B, jeng.spec.z_dim), jnp.float32))
                  for t in range(total)])
    init = {"z": z, **flatten({name: {"params": jax.device_get(getattr(jst, name).params),
                                      "stats": jax.device_get(getattr(jst, name).stats)}
                               for name in ("g", "d")})}
    data, _ = jbuiltin.synthesize(FAMILY[family][2], 40 * N, seed=32)
    shards, _ = jpartitioner.shard_data(data, N, iid=True, seed=0)
    jdata = jeng.shard_data(shards)
    smp = ShardSampler(N, shards.shape[1], B, seed=0)
    metrics, t = [], 0
    for c, rounds in enumerate(CHUNKS):
        for _ in range(rounds):
            if family == "mlp":
                for path, ms in fam.mdgan_masks(jeng, jst, B).items():
                    for i, m in enumerate(ms):
                        init[f"masks/{t}/{'-'.join(map(str, path))}/{i}"] = m.numpy()
            jst, m = jeng.chunk_fn(1)(jst, jdata, jnp.asarray(smp.next_chunk(1)))
            metrics.append({k: np.asarray(v)[0] for k, v in m.items() if k != "x_eval"})
            t += 1
        if c == 0:
            jst = jeng.swap(jst, jeng.sample_swap_perm(np.random.default_rng(5)))
    path = tmp_path / f"init_{family}.npz"
    np.savez(path, **init)
    return str(path), metrics, jst


# Per family against JAX over the two free-running rounds: the loss and
# feedback-norm rtols, the largest share of parameters off by more than rtol
# 1e-2 plus the delta atol, and the delta atol (tests/test_torch_port_round.py's
# free-running bounds for DCGAN-32; tests/test_torch_port_families.py's
# ROUND_TOL for the others, whose StyleGAN2 mapping-net steps sit near Adam's
# eps: free-running, its second round's feedback norm was 2.3e-3 off JAX's
# here, against 1.3e-5 teacher-forced, so its bound is 5e-3).
JAX_TOL = {"dcgan32": (1e-3, 2e-3, 0.005, 1e-6), "mlp": (2e-4, 2e-3, 0.005, 1e-6),
           "stylegan2": (2e-4, 5e-3, 0.005, 0.1 * LR)}


def check_against_jax(family, ranks, jax_metrics, jst):
    import jax

    import test_torch_port_round as rnd

    rtol_loss, rtol_fb, share, atol = JAX_TOL[family]
    t = 0
    for c, rounds in enumerate(CHUNKS):
        for i in range(rounds):
            rnd.check_metrics(jax_metrics[t], {k: ranks[0][f"chunk{c}/{k}"][i] for k in
                                               ("mean_d_loss", "g_feedback_loss",
                                                "feedback_norm")},
                              rtol_loss=rtol_loss, rtol_fb=rtol_fb)
            t += 1
    coords = [tuple(r["coords"]) for r in ranks]
    slots = sorted({w for _, w, _ in coords})
    d = np.concatenate([ranks[coords.index((0, w, 0))]["d/params"] for w in slots])
    trees = port_trees(family, ranks[0]["g/params"], d)
    for name in ("g", "d"):
        got = rnd._flat(trees[name])
        want = rnd._flat(jax.device_get(getattr(jst, name).params))
        close = np.isclose(got, want, rtol=1e-2, atol=atol)
        assert 1.0 - close.mean() < share, (family, name, 1.0 - close.mean())
        assert np.abs(got - want).max() <= 2.05 * LR * t + atol, (family, name)


# --- the layout against make_mesh ---------------------------------------------

def test_layout_matches_make_mesh(eight_devices):
    """Every (world <= 8, N, R, T): the axis sizes ``make_mesh`` gives, JAX's
    device-grid order (rank (r*W + w)*T + t holds device (r, w, t)), the
    idle ranks past the mesh, each slot's workers, and JAX's ValueError."""
    import re

    from mdgan_tpu.core import mesh as jmesh
    from mdgan_tpu.core.config import MeshConfig
    from mdgan_tpu_torch.core.mesh import RankLayout, mesh_shape

    idle_seen = raised = 0
    for world in range(1, 9):
        for n in (1, 2, 3, 4, 6, 8):
            for r in (1, 2, 4):
                for t in (1, 2, 4):
                    cfg = MeshConfig(num_workers=n, num_devices=world, num_replicas=r,
                                     num_tensor=t)
                    try:
                        mesh = jmesh.make_mesh(cfg)
                    except ValueError as e:
                        with pytest.raises(ValueError, match=re.escape(str(e))):
                            mesh_shape(world, n, r, t)
                        raised += 1
                        continue
                    shape = mesh_shape(world, n, r, t)
                    assert shape == (mesh.shape["replica"], mesh.shape["workers"],
                                     mesh.shape.get("tensor", 1)), (world, n, r, t)
                    grid = mesh.devices.reshape(shape)
                    for rank in range(world):
                        lay = RankLayout(n, world, rank, world > 1, r, t)
                        if rank >= grid.size:
                            assert lay.idle
                            idle_seen += 1
                            continue
                        rr, w, tt = lay.coords
                        assert grid[rr, w, tt].id == rank and not lay.idle
                        assert list(lay.workers) == list(range(w * n // shape[1],
                                                               (w + 1) * n // shape[1]))
    assert idle_seen and raised


# --- the sharded leaves against generator_sharding ------------------------------

def _generators(family):
    """(flax generator, the port's, the port's full-width one) of a family."""
    import test_torch_port_families as fam
    from mdgan_tpu.models import dcgan32 as jdcgan32
    from mdgan_tpu_torch.core.registry import get as get_spec

    if family == "dcgan32":
        spec = get_spec("Synthetic32")
        return (jdcgan32.DCGANGenerator32(ngf=WIDTH), spec.make_generator(ngf=WIDTH),
                spec.make_generator())
    return fam.FAMILIES[family][2](), fam._port_model(family, "generator"), None


@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("family", ["dcgan32", "dcgan64", "mlp", "stylegan2"])
def test_sharded_leaves_match_generator_sharding(family, size, eight_devices):
    """The leaves ``parallel/tensor.py`` splits are those JAX's
    ``generator_sharding`` splits over a tensor axis of ``size`` (params
    and BatchNorm statistics), and tensor slot t's slices, loaded from
    JAX's whole leaves, are JAX's leaves split along their trailing dim."""
    import functools

    import jax
    import jax.numpy as jnp

    from mdgan_tpu.core import mesh as jmesh
    from mdgan_tpu.core.config import MeshConfig
    from mdgan_tpu_torch.core.mesh import Axis
    from mdgan_tpu_torch.engine.state import NetState
    from mdgan_tpu_torch.models import from_jax
    from mdgan_tpu_torch.parallel import tensor as tensor_lib

    jm, port, full = _generators(family)
    z = jnp.zeros((2, 512 if family == "stylegan2" else 100))
    v = jax.jit(functools.partial(jm.init, train=True))({"params": jax.random.key(1)}, z)
    leaves = {"params": v["params"], "stats": v.get("batch_stats", {})}
    mcfg = MeshConfig(num_workers=8, num_tensor=size)
    mesh = jmesh.make_mesh(mcfg)
    dims = tensor_lib.sharded_dims(port, size)
    role = from_jax.role_of(port)
    n_sharded = 0
    for t in range(size):
        sharded = from_jax.load_into(
            tensor_lib.shard_module(_generators(family)[1], Axis(size, t)),
            leaves["params"], leaves["stats"])
        assert sharded.tensor_shards == dims
        sd = sharded.state_dict()
        for name, path, kind in from_jax.entries(role):
            node = leaves["stats" if kind == "stat" else "params"]
            for p in path:
                node = node[p]
            leaf = np.asarray(node)
            spec = jmesh.generator_sharding(mesh, mcfg, leaf).spec
            jax_split = len(spec) > 0 and spec[-1] == "tensor"
            assert (name in dims) == jax_split, (name, spec)
            want = np.split(leaf, size, axis=-1)[t] if jax_split else leaf
            np.testing.assert_array_equal(sd[name].numpy(), from_jax.to_port(want, kind),
                                          err_msg=name)
            n_sharded += jax_split
    assert n_sharded
    if full is not None and size == 2:
        # full width: the G arena of tensor slot 0 at T=2
        g = NetState([tensor_lib.shard_module(full, Axis(2, 0))], "cpu")
        assert (g.numel, tensor_lib.full_layout(g).numel) == (1_727_360, 3_448_576)


# --- one 4-rank launch: BatchNorm, the replica mesh, StyleGAN2's tensor axis ------

def test_four_ranks_replica_and_tensor_axes(tmp_path, eight_devices):
    """On 4 ranks: the cross-replica units against one process; (R=2, W=2)
    DCGAN-32 against one process and JAX's (replica 2, workers 2) mesh;
    StyleGAN2 on (W=2, T=2) against one process and JAX's single device."""
    init_dc, jm_dc, jst_dc = jax_run("dcgan32", tmp_path, replicas=2)
    init_sg, jm_sg, jst_sg = jax_run("stylegan2", tmp_path)
    specs = [{"family": "units", "replicas": 2},
             {"family": "dcgan32", "replicas": 2, "init": init_dc},
             {"family": "stylegan2", "tensor": 2, "init": init_sg}]
    units_ranks, dc_ranks, sg_ranks = launch_engine(tmp_path, 4, specs)

    # the units: each replica's rows and the summed gradients against one process
    from mdgan_tpu_torch.core.mesh import Axis

    ref = units(Axis())
    by_replica = {}
    for r in units_ranks:
        by_replica.setdefault(int(r["coords"][0]), r)
    for key, want in ref.items():
        if key.endswith(("/y", "/x_grad")):
            got = np.concatenate([by_replica[i][key] for i in sorted(by_replica)])
        else:
            got = by_replica[0][key]
            assert all(np.array_equal(r[key], got) for r in units_ranks), key
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=key)

    for family, ranks, init, jm, jst in (("dcgan32", dc_ranks, init_dc, jm_dc, jst_dc),
                                         ("stylegan2", sg_ranks, init_sg, jm_sg, jst_sg)):
        check_against_one_process(ranks, run_engine({"family": family, "init": init}))
        check_against_jax(family, ranks, jm, jst)
    # the tensor slots hold different slices of one generator
    assert not np.array_equal(sg_ranks[0]["g_local/params"], sg_ranks[1]["g_local/params"])
    assert sg_ranks[0]["g_local/params"].size < sg_ranks[0]["g/params"].size
