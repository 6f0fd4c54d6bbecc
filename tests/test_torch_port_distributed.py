"""The port's discriminators sharded over ``torch.distributed`` ranks, on the
CPU with gloo, against the single-process port and the JAX package.

The rank programs are this file run as a script under
``python -m torch.distributed.run`` (the ``engine`` and ``cli`` modes of
:func:`_rank_main`): each rank holds N/W discriminators, and one
``all_reduce`` of the feedback cotangents a round joins them
(``mdgan_tpu_torch/engine/mdgan.py``).  Held here:

  * 2 and 4 ranks (N=4) over two chunks and a swap against one process, at
    rtol 1e-5, atol 1e-6 (the order of the cross-rank sum may differ), with
    the generator bit-equal on every rank; the 4-rank run under the
    straggler policy with the pair swap, and the pair swap bit-equal to the
    gather swap;
  * the 2-rank run against JAX's ``MDGANEngine`` on a 2-device workers mesh
    (its ``shard_map`` region), JAX's weights and latents injected, at the
    free-running bounds of ``tests/test_torch_port_round.py``;
  * a 2-rank trainer through the CLI against the single-process trainer:
    CSV rows and exports at rtol 1e-5, its checkpoint resumed in one
    process and a single-process checkpoint resumed on 2 ranks;
  * the pair swap's rejections (``tests/test_parallel.py:55-77``) and the
    rank layout's.

Every launch has its own timeout and kills every rank when it expires (as
``tests/test_multihost.py:_communicate_all`` does), and holds a file lock,
one launch of the port's tests at a time (:func:`run_ranks`); the ranks run
with one intra-op thread each.
"""

import json
import os
import signal
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from mdgan_tpu_torch.utils.build import BUILD_DIR, file_lock

ROOT = Path(__file__).resolve().parents[1]
N, B, WIDTH, SEED = 4, 4, 8, 3
ENGINE_ROUNDS = (2, 1)  # a chunk, a swap, a chunk
ARENAS = ("params", "stats", "mu", "nu")


# --- what the ranks and the single-process references both run --------------

def run_engine(spec: dict) -> dict:
    """Two chunks around a swap on the narrow DCGAN-32 engine (N=4, b=4),
    in this process's layout: the rank's arenas and the gathered metrics.
    ``spec``: ``straggler_rate``, ``swap_impl``, and optionally ``init``, an
    npz of JAX's initial weights and latents."""
    from mdgan_tpu_torch.core.config import TrainConfig
    from mdgan_tpu_torch.core.registry import get as get_spec
    from mdgan_tpu_torch.data import builtin, partitioner, sampler
    from mdgan_tpu_torch.engine.mdgan import MDGANEngine
    from mdgan_tpu_torch.models import from_jax
    from mdgan_tpu_torch.parallel import swap as swap_lib
    from mdgan_tpu_torch.utils.checkpoint import unflatten

    eng = MDGANEngine(get_spec("Synthetic32"), TrainConfig(
        batch_size=B, compute_dtype="float32", device="cpu",
        straggler_rate=spec["straggler_rate"], swap_impl=spec["swap_impl"],
        swap_opt_state=True), N, model_kwargs={"ngf": WIDTH, "ndf": WIDTH})
    lay = eng.layout
    data, _ = builtin.synthesize((32, 32, 3), 40 * N, seed=32)
    shards, _ = partitioner.shard_data(data, N, iid=True, seed=0)
    pdata = eng.shard_data(shards)
    smp = sampler.ShardSampler(N, shards.shape[1], B, seed=0)
    st = eng.init_state(SEED)
    z = None
    if spec.get("init"):
        init = dict(np.load(spec["init"]))
        z = torch.from_numpy(init.pop("z"))
        trees = unflatten(init)
        from_jax.load_net(st.g, trees["g"]["params"], trees["g"]["stats"])
        from_jax.load_net(st.d, trees["d"]["params"], trees["d"]["stats"], rows=lay.workers)
    out, t0 = {}, 0
    for c, rounds in enumerate(ENGINE_ROUNDS):
        m = eng.run_rounds(st, pdata, smp, rounds,
                           z=None if z is None else z[t0:t0 + rounds])
        t0 += rounds
        for key, value in m.items():
            out[f"chunk{c}/{key}"] = value.numpy()
        if c == 0:
            eng.swap(st, eng.sample_swap_perm(np.random.default_rng(5)))
    for name in ("g", "d"):
        for arena in ARENAS:
            out[f"{name}/{arena}"] = getattr(getattr(st, name), arena).float().numpy()
    if lay.distributed and lay.world == N:
        # the pair swap and the gather swap of the same permutation, on copies
        perm = eng.sample_swap_perm(np.random.default_rng(6))
        copies = []
        for swap in (swap_lib.swap_pairs, swap_lib.swap_gather):
            net = types.SimpleNamespace(numel=st.d.numel, stat_numel=st.d.stat_numel,
                                        **{a: getattr(st.d, a).clone() for a in ARENAS})
            swap(net, perm, lay, True)
            copies.append(net)
        out["pair_equals_gather"] = np.array(all(
            torch.equal(getattr(copies[0], a), getattr(copies[1], a)) for a in ARENAS))
        out["pair_moved"] = np.array(not torch.equal(copies[0].params, st.d.params))
    return out


def _stub_inception():
    """FID/IS stubbed in this process, as ``tests/test_torch_port_round.py``
    stubs them: the trainers' tests do not score."""
    from mdgan_tpu_torch.metrics import fid as fid_mod

    class FakeTracker:
        def __init__(self, real, device=None):
            pass

        def score(self, fakes):
            return 123.0

        def inception_score(self, fakes, splits=1):
            return (2.0, 0.0)

    fid_mod.FIDTracker = FakeTracker


def _rank_main(argv) -> int:
    """One rank: ``engine <spec json> <out prefix>`` or ``cli <argv...>``."""
    from mdgan_tpu_torch.core import distributed

    torch.set_num_threads(1)
    mode, rest = argv[0], argv[1:]
    if mode == "cli":
        _stub_inception()
        from mdgan_tpu_torch.cli import train

        return train.main(rest)
    distributed.maybe_initialize("cpu")
    try:
        out = run_engine(json.loads(rest[0]))
        import torch.distributed as dist

        np.savez(f"{rest[1]}{dist.get_rank()}.npz", **out)
    finally:
        distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(_rank_main(sys.argv[1:]))


# --- launching the ranks -------------------------------------------------------

# Every launch of ranks in the port's tests holds this lock, so the suite's
# workers start one launch at a time: unlocked, the 2-, 4- and 8-rank launches
# of this file and the axes files could run together, up to 20 rank
# processes beside the suite's own workers on the machine's cores.
RANKS_LOCK = BUILD_DIR / "test_ranks.lock"


def rank_env() -> dict:
    """The environment of a launch: the repository importable, one intra-op
    thread a process."""
    return {"PATH": os.environ.get("PATH", ""), "HOME": os.environ.get("HOME", str(ROOT)),
            "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1",
            "TMPDIR": os.environ.get("TMPDIR", "/tmp")}


def run_ranks(cmd, timeout: float, cwd: Path = ROOT, env=None):
    """Run ``cmd``, a launch of ranks, under ``RANKS_LOCK`` in a session of
    its own; every process of it is killed if it outlives ``timeout``.
    Returns (return code, stdout and stderr)."""
    with file_lock(RANKS_LOCK):
        proc = subprocess.Popen(cmd, cwd=str(cwd), env=env or rank_env(),
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                                start_new_session=True)
        try:
            out, _ = proc.communicate(timeout=timeout)
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.communicate()
    return proc.returncode, out


def launch(script: Path, world: int, args, timeout: float) -> str:
    """``python -m torch.distributed.run`` of ``script`` on ``world`` ranks
    (:func:`run_ranks`); its output."""
    rc, out = run_ranks([sys.executable, "-m", "torch.distributed.run", "--standalone",
                         "--nproc_per_node", str(world), str(script), *map(str, args)],
                        timeout)
    assert rc == 0, out[-6000:]
    return out


def _launch(world: int, args, timeout: float) -> str:
    """:func:`launch` of this file."""
    return launch(Path(__file__).resolve(), world, args, timeout)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ranks(prefix, world):
    return [dict(np.load(f"{prefix}{r}.npz")) for r in range(world)]


def _check_against_one_process(ranks, ref):
    """Rank runs (their arenas concatenated in rank order) against one
    process: G bit-equal on every rank, everything else at rtol 1e-5."""
    world = len(ranks)
    for arena in ARENAS:
        for r in range(1, world):
            assert np.array_equal(ranks[r][f"g/{arena}"], ranks[0][f"g/{arena}"]), arena
    for key, want in ref.items():
        if key.startswith("d/"):
            got = np.concatenate([r[key] for r in ranks])
        else:
            got = ranks[0][key]
            for r in ranks[1:]:  # every rank holds the gathered metrics
                assert np.array_equal(r[key], got), key
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=key)


@pytest.mark.parametrize("world,straggler_rate,swap_impl", [
    (2, 0.0, "auto"), (4, 0.5, "ppermute")])
def test_ranks_match_one_process(tmp_path, world, straggler_rate, swap_impl):
    """2 ranks (gather swap) and 4 ranks (one worker a rank: the straggler
    policy and the pair swap) against the single-process engine."""
    spec = {"straggler_rate": straggler_rate, "swap_impl": swap_impl}
    _launch(world, ["engine", json.dumps(spec), tmp_path / "rank"], timeout=150)
    ranks = _ranks(tmp_path / "rank", world)
    ref = run_engine({**spec, "swap_impl": "gather"})
    _check_against_one_process(ranks, ref)
    if world == N:
        assert all(bool(r["pair_equals_gather"]) for r in ranks)
        assert any(bool(r["pair_moved"]) for r in ranks)
        assert int(ranks[0]["chunk0/n_feedbacks"].min()) < N  # a feedback was dropped


def test_two_ranks_match_jax_workers_mesh(tmp_path, eight_devices):
    """2 ranks from JAX's weights and latents against JAX's engine on a
    2-device workers mesh (2 discriminators a device), over the same
    chunk, swap, chunk."""
    import jax
    import jax.numpy as jnp

    import test_torch_port_round as rnd
    from mdgan_tpu.core import mesh as jmesh
    from mdgan_tpu.core import prng as jprng
    from mdgan_tpu.core.config import MeshConfig, TrainConfig as JaxTrainConfig
    from mdgan_tpu.data import builtin as jbuiltin
    from mdgan_tpu.data import partitioner as jpartitioner
    from mdgan_tpu.data.sampler import ShardSampler
    from mdgan_tpu.engine.mdgan import MDGANEngine as JaxEngine
    from mdgan_tpu_torch.models import from_jax
    from mdgan_tpu_torch.utils.checkpoint import flatten

    mcfg = MeshConfig(num_workers=N, num_devices=2)
    mesh = jmesh.make_mesh(mcfg)
    assert dict(mesh.shape) == {"replica": 1, "workers": 2}
    jeng = JaxEngine(rnd._narrow_jax_spec(), JaxTrainConfig(
        batch_size=B, compute_dtype="float32", donate=False, swap_opt_state=True),
        N, mesh=mesh, mesh_cfg=mcfg)
    jst = jeng.init_state(SEED)
    total = sum(ENGINE_ROUNDS)
    z = np.stack([np.array(jax.random.normal(jprng.for_step(jst.key, jprng.LATENT, t),
                                             (jeng.k * B, 100), jnp.float32))
                  for t in range(total)])
    init = {"z": z, **flatten({name: {"params": jax.device_get(getattr(jst, name).params),
                                      "stats": jax.device_get(getattr(jst, name).stats)}
                               for name in ("g", "d")})}
    np.savez(tmp_path / "init.npz", **init)
    spec = {"straggler_rate": 0.0, "swap_impl": "auto", "init": str(tmp_path / "init.npz")}
    _launch(2, ["engine", json.dumps(spec), tmp_path / "rank"], timeout=150)
    ranks = _ranks(tmp_path / "rank", 2)
    # the single-process port from the same weights and latents
    _check_against_one_process(ranks, run_engine(spec))

    data, _ = jbuiltin.synthesize((32, 32, 3), 40 * N, seed=32)
    shards, _ = jpartitioner.shard_data(data, N, iid=True, seed=0)
    jdata = jeng.shard_data(shards)
    smp = ShardSampler(N, shards.shape[1], B, seed=0)
    jm = []
    for c, rounds in enumerate(ENGINE_ROUNDS):
        jst, m = jeng.chunk_fn(rounds)(jst, jdata, jnp.asarray(smp.next_chunk(rounds)))
        jm.append(m)
        if c == 0:
            jst = jeng.swap(jst, jeng.sample_swap_perm(np.random.default_rng(5)))
    for c, m in enumerate(jm):
        for t in range(ENGINE_ROUNDS[c]):
            rnd.check_metrics({k: np.asarray(v)[t] for k, v in m.items() if k != "x_eval"},
                              {k: ranks[0][f"chunk{c}/{k}"][t] for k in
                               ("mean_d_loss", "g_feedback_loss", "feedback_norm")},
                              rtol_loss=rnd.FREE_RUNNING_RTOL[1])
    # parameters after three free-running rounds, sign-flip aware as the
    # round tests hold them (an Adam step moves an element by about lr)
    from mdgan_tpu_torch.core.config import TrainConfig
    from mdgan_tpu_torch.core.registry import get as get_spec
    from mdgan_tpu_torch.engine.mdgan import MDGANEngine

    layout = MDGANEngine(get_spec("Synthetic32"), TrainConfig(device="cpu"), N,
                         model_kwargs={"ngf": WIDTH, "ndf": WIDTH}).init_state(SEED)
    port = {"g": ranks[0]["g/params"], "d": np.concatenate([r["d/params"] for r in ranks])}
    for name in ("g", "d"):
        tree = from_jax.export_arenas(getattr(layout, name),
                                      {"params": torch.from_numpy(port[name])})["params"]
        got, want = rnd._flat(tree), rnd._flat(jax.device_get(getattr(jst, name).params))
        close = np.isclose(got, want, rtol=1e-2, atol=1e-6)
        assert 1.0 - close.mean() < 0.005, (name, 1.0 - close.mean())
        assert np.abs(got - want).max() <= 2.05 * rnd.LR * total + 1e-6, name


# --- the trainer through the CLI ------------------------------------------------

def _cli_argv(root, epochs, *extra):
    return ["--mode", "mdgan", "--dataset", "SyntheticMNIST", "--num_workers", str(N),
            "--batch_size", str(B), "--epochs", str(epochs), "--swap_interval", "2",
            "--log_interval", "2", "--checkpoint_interval", "2", "--chunk_size", "3",
            "--max_examples", "200", "--compute_dtype", "float32", "--device", "cpu",
            "--straggler_rate", "0.5", "--moment_dtype", "bfloat16",
            *[a for flag in ("log_dir", "image_dir", "weights_dir", "checkpoint_dir")
              for a in (f"--{flag}", str(root / flag))], *extra]


def _csv_rows(root):
    """Every CSV's rows without their clock readings."""
    from mdgan_tpu_torch.obs import spans

    out = {}
    for path in sorted((root / "log_dir").glob("*.csv")):
        out[path.name] = [{k: v for k, v in row.items() if not k.startswith(("start.", "end."))}
                          for row in spans.read_spans(path)]
    return out


def _check_runs_agree(got_root, want_root):
    got, want = _csv_rows(got_root), _csv_rows(want_root)
    assert sorted(got) == sorted(want) and len(got) == 1 + N
    for name, rows in want.items():
        assert len(got[name]) == len(rows), name
        for a, b in zip(got[name], rows):
            assert a.keys() == b.keys(), name
            for key, value in b.items():
                if isinstance(value, float):
                    np.testing.assert_allclose(a[key], value, rtol=1e-5, err_msg=f"{name} {key}")
                else:
                    assert a[key] == value, (name, key)
    exports = sorted(p.relative_to(want_root) for p in (want_root / "weights_dir").rglob("*.npz"))
    assert exports == sorted(p.relative_to(got_root)
                             for p in (got_root / "weights_dir").rglob("*.npz"))
    for rel in exports:
        a, b = np.load(got_root / rel), np.load(want_root / rel)
        assert sorted(a.files) == sorted(b.files), rel
        for key in b.files:
            np.testing.assert_allclose(a[key], b[key], rtol=1e-5, atol=1e-6, err_msg=f"{rel} {key}")


def _one_process(argv):
    from mdgan_tpu_torch.cli import train

    _stub_inception()
    assert train.main(argv) == 0


def test_two_rank_trainer_matches_one_process_and_checkpoints_cross(tmp_path, monkeypatch,
                                                                    capsys):
    """4 rounds on 2 ranks (a swap, checkpoints at rounds 2 and 3) equal
    one process; the 2-rank checkpoint resumes in one process, and a
    single-process checkpoint resumes on 2 ranks, each to round 6."""
    from mdgan_tpu_torch.metrics import fid as fid_mod
    import shutil

    monkeypatch.setattr(fid_mod, "FIDTracker", fid_mod.FIDTracker)  # restored afterwards
    ranks, single = tmp_path / "ranks", tmp_path / "single"
    _launch(2, ["cli", *_cli_argv(ranks, 4)], timeout=180)
    _one_process(_cli_argv(single, 4))
    _check_runs_agree(ranks, single)
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1])["swaps"] == 1

    # cross the checkpoints: one process resumes the ranks' run, 2 ranks
    # resume a copy of the single-process run, and one process the original
    crossed = tmp_path / "crossed"
    shutil.copytree(single, crossed)
    _one_process(_cli_argv(ranks, 6, "--resume"))
    _launch(2, ["cli", *_cli_argv(crossed, 6, "--resume")], timeout=180)
    _one_process(_cli_argv(single, 6, "--resume"))
    _check_runs_agree(ranks, single)
    _check_runs_agree(crossed, single)


# --- rejections ----------------------------------------------------------------

def test_pair_swap_rejections():
    from mdgan_tpu_torch.core.mesh import RankLayout
    from mdgan_tpu_torch.parallel import swap as swap_lib

    net = types.SimpleNamespace(params=torch.zeros(8), stats=torch.zeros(0), numel=2,
                                stat_numel=0, mu=torch.zeros(8), nu=torch.zeros(8))
    four = RankLayout(4, world=4, rank=0, distributed=True)
    with pytest.raises(ValueError, match="involution"):
        swap_lib.swap_pairs(net, np.roll(np.arange(4), 1), four)  # a rotation, not a pairing
    with pytest.raises(ValueError, match="one worker per rank"):
        swap_lib.swap_pairs(net, np.array([1, 0, 3, 2]), RankLayout(4, world=2, rank=0,
                                                                    distributed=True))
    with pytest.raises(ValueError, match="one worker per rank"):
        swap_lib.swap_pairs(net, np.array([1, 0, 3, 2]), RankLayout(4))


def test_engine_swap_dispatch_in_one_process():
    """One process: ``auto`` and ``gather`` take the gather swap, and
    ``ppermute`` raises JAX's error, as ``MDGANEngine.swap`` does without a
    workers mesh."""
    from mdgan_tpu_torch.core.config import TrainConfig
    from mdgan_tpu_torch.core.registry import get as get_spec
    from mdgan_tpu_torch.engine.mdgan import MDGANEngine

    perm = np.array([1, 0, 3, 2])
    states = {}
    for impl in ("auto", "gather", "ppermute"):
        eng = MDGANEngine(get_spec("Synthetic32"), TrainConfig(
            batch_size=B, device="cpu", swap_impl=impl), N, model_kwargs={"ndf": WIDTH})
        st = eng.init_state(SEED)
        if impl == "ppermute":
            with pytest.raises(ValueError, match="one worker per rank"):
                eng.swap(st, perm)
        else:
            before = st.d.params.view(N, -1).clone()
            eng.swap(st, perm)
            assert torch.equal(st.d.params.view(N, -1), before[perm])
            states[impl] = st.d.params
    assert torch.equal(states["auto"], states["gather"])


def test_rank_layout():
    from mdgan_tpu_torch.core import mesh

    lay = mesh.rank_layout(8)
    assert (lay.world, lay.rank, list(lay.workers), lay.distributed) == (1, 0, list(range(8)),
                                                                          False)
    two = mesh.RankLayout(8, world=2, rank=1, distributed=True)
    assert (two.per_rank, list(two.workers), two.is_main) == (4, [4, 5, 6, 7], False)
    for kw in ({"num_replicas": 2}, {"num_tensor": 2}):
        # one process holds the whole run, as JAX ignores the axes on one device
        one = mesh.rank_layout(8, **kw)
        assert (one.world, one.shape, list(one.workers), one.idle) == (
            1, (1, 1, 1), list(range(8)), False)
    # rank 5 of a (replica 2, workers 2, tensor 2) mesh: tensor innermost
    eight = mesh.RankLayout(8, world=8, rank=5, distributed=True, num_replicas=2, num_tensor=2)
    assert (eight.shape, eight.coords, list(eight.workers), eight.rank_of(1, 0, 1)) == (
        (2, 2, 2), (1, 0, 1), [0, 1, 2, 3], 5)
