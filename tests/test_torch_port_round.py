"""The port's MD-GAN round against ``MDGANEngine.chunk_fn(1)``, on the CPU.

Narrow DCGAN-32 (ngf=ndf=8) in float32.  Both sides start from the JAX
engine's weights (carried over by ``models/from_jax.py``) and get the same
latents z (drawn from ``prng.for_step(key, LATENT, step)``) and the same
sampler indices.  Bounds are those of ``tests/test_torch_parity.py:356-369``:
losses within rtol 2e-4, feedback norm within rtol 2e-3, and parameter
deltas sign-flip aware (one Adam step moves a weight by about lr*sign(grad),
so elements whose gradient sits at float noise may flip: under 0.5% of
elements, and never by more than 2.05*lr).
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from mdgan_tpu.core import prng as jprng
from mdgan_tpu.core import registry as jregistry
from mdgan_tpu.core.config import TrainConfig as JaxTrainConfig
from mdgan_tpu.data import builtin as jbuiltin
from mdgan_tpu.data import partitioner as jpartitioner
from mdgan_tpu.data import sampler as jsampler
from mdgan_tpu.engine.mdgan import MDGANEngine as JaxEngine
from mdgan_tpu.models import dcgan32 as jdcgan32
from mdgan_tpu_torch.cli import train as cli
from mdgan_tpu_torch.core.config import TrainConfig
from mdgan_tpu_torch.core.registry import get as get_spec
from mdgan_tpu_torch.data import builtin, partitioner, sampler
from mdgan_tpu_torch.engine.mdgan import MDGANEngine
from mdgan_tpu_torch.models import from_jax

LR, B, WIDTH = 2e-4, 4, 8
NARROW = "TorchPortNarrow32"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small tensors: extra threads
    buy nothing at these sizes and spin against the other test processes
    the suite runs beside this one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)



def _narrow_jax_spec(width=WIDTH):
    name = NARROW if width == WIDTH else f"{NARROW}w{width}"
    try:
        return jregistry.get(name)
    except KeyError:
        return jregistry.register(jregistry.DatasetSpec(
            name=name, shape=jdcgan32.SHAPE, z_dim=jdcgan32.Z_DIM,
            make_generator=functools.partial(jdcgan32.DCGANGenerator32, ngf=width),
            make_discriminator=functools.partial(jdcgan32.DCGANDiscriminator32, ndf=width),
            load=lambda *a, **k: jbuiltin.synthesize((32, 32, 3), 400, seed=32),
        ))


class Pair:
    """A JAX engine and the port's, on the same data and indices."""

    def __init__(self, n, local_epochs=1, swap_opt_state=False, dtype="float32", seed=3,
                 width=WIDTH):
        self.n = n
        self.local_epochs = local_epochs
        self.jeng = JaxEngine(_narrow_jax_spec(width), JaxTrainConfig(
            batch_size=B, chunk_size=1, compute_dtype=dtype, donate=False,
            local_epochs=local_epochs, swap_opt_state=swap_opt_state), n)
        self.peng = MDGANEngine(get_spec("Synthetic32"), TrainConfig(
            batch_size=B, compute_dtype=dtype, device="cpu", local_epochs=local_epochs,
            swap_opt_state=swap_opt_state), n,
            model_kwargs={"ngf": width, "ndf": width})
        data, _ = builtin.synthesize((32, 32, 3), 40 * n, seed=32)
        shards, _ = partitioner.shard_data(data, n, iid=True, seed=0)
        self.shard_size = shards.shape[1]
        self.jdata = self.jeng.shard_data(shards)
        self.pdata = self.peng.shard_data(shards)
        self.sampler = sampler.ShardSampler(n, shards.shape[1], B, seed=0)
        self.jst = self.jeng.init_state(seed=seed)
        self.pst = self.peng.init_state(seed=seed)
        self.carry_jax_state()

    def carry_jax_state(self):
        """Copy the JAX state (params, BN stats, Adam moments and count)
        into the port's."""
        for net, jnet in ((self.pst.g, self.jst.g), (self.pst.d, self.jst.d)):
            adam = jnet.opt[0]
            from_jax.load_net(net, jax.device_get(jnet.params), jax.device_get(jnet.stats),
                              jax.device_get(adam.mu), jax.device_get(adam.nu),
                              int(adam.count))
        self.pst.step = int(self.jst.step)

    def round(self):
        """One round on both sides; returns (jax metrics, port metrics) and
        the states before the round."""
        idx = self.sampler.next_chunk(1)
        kz = jprng.for_step(self.jst.key, jprng.LATENT, self.jst.step)
        z = np.array(jax.random.normal(kz, (self.jeng.k * B, jdcgan32.Z_DIM), jnp.float32))
        before = (self.jst, self.port_trees())
        self.jst, jm = self.jeng.chunk_fn(1)(self.jst, self.jdata, jnp.asarray(idx))
        pm = self.peng.step(self.pst, self.pdata, self.peng.put_indices(idx[0], self.shard_size),
                            z=torch.from_numpy(z))
        jm = {k: np.asarray(v)[0] for k, v in jm.items() if k != "x_eval"}
        pm = {k: v.detach().numpy() for k, v in pm.items() if k != "x_eval"}
        return jm, pm, before

    def port_trees(self):
        return {"g": from_jax.export_net(self.pst.g), "d": from_jax.export_net(self.pst.d)}


def _flat(tree):
    return np.concatenate([np.ravel(a) for a in jax.tree.leaves(tree)])


def check_metrics(jm, pm, rtol_loss=2e-4, rtol_fb=2e-3):
    for k in ("mean_d_loss", "g_feedback_loss"):
        np.testing.assert_allclose(pm[k], jm[k], rtol=rtol_loss, err_msg=k)
    np.testing.assert_allclose(pm["feedback_norm"], jm["feedback_norm"], rtol=rtol_fb)


def check_deltas(pair, before):
    """Per network: the port's parameter update against JAX's, sign-flip aware;
    the first Adam moment (the gradient itself, since beta_1 = 0) and the BN
    running statistics within float32 noise."""
    jold, pold = before
    pnew = pair.port_trees()
    for name in ("g", "d"):
        jnet_old, jnet_new = getattr(jold, name), getattr(pair.jst, name)
        d_jax = _flat(jax.device_get(jnet_new.params)) - _flat(jax.device_get(jnet_old.params))
        d_port = _flat(pnew[name][0]) - _flat(pold[name][0])
        close = np.isclose(d_port, d_jax, rtol=1e-2, atol=1e-6)
        assert 1.0 - close.mean() < 0.005, (name, 1.0 - close.mean())
        steps = pair.local_epochs if name == "d" else 1
        assert np.abs(d_port - d_jax).max() <= 2.05 * LR * steps + 1e-6, name
        net = getattr(pair.pst, name)
        mu_port = np.concatenate([_flat(from_jax.params_to_jax(
            net.views(net.mu, w), from_jax.role_of(net.modules[0]))) for w in range(net.n)])
        mu_jax = jax.device_get(jnet_new.opt[0].mu)
        mu_jax = np.concatenate([_flat(from_jax.index_tree(mu_jax, w)) if net.n > 1
                                 else _flat(mu_jax) for w in range(net.n)])
        np.testing.assert_allclose(mu_port, mu_jax, rtol=1e-3, atol=1e-3 * np.abs(mu_jax).max(),
                                   err_msg=f"{name} gradient")
        np.testing.assert_allclose(_flat(pnew[name][1]), _flat(jax.device_get(jnet_new.stats)),
                                   rtol=2e-5, atol=1e-6, err_msg=f"{name} BN stats")


# (N, local_epochs, swap_opt_state) per case; local_epochs changes the round,
# swap_opt_state only the swap, so each test takes the cases that reach it
PAIRS = {"N2": (2, 1, False), "N8": (8, 1, False), "N2-local_epochs2": (2, 2, False),
         "N8-swap_opt_state": (8, 1, True)}
ROUND_CASES = ["N2", "N8", "N2-local_epochs2"]
SWAP_CASES = ["N2", "N8", "N8-swap_opt_state"]


@pytest.fixture(scope="module")
def pairs():
    """The module's Pairs, each built on first use."""
    return {}


@pytest.fixture
def pair(request, pairs):
    if request.param not in pairs:
        pairs[request.param] = Pair(*PAIRS[request.param])
    return pairs[request.param]


@pytest.mark.parametrize("pair", ROUND_CASES, indirect=True)
def test_one_round_matches_chunk_fn(pair):
    pair.carry_jax_state()
    jm, pm, before = pair.round()
    check_metrics(jm, pm)
    check_deltas(pair, before)


@pytest.mark.parametrize("pair", ROUND_CASES, indirect=True)
def test_three_rounds_teacher_forced(pair):
    for _ in range(3):
        pair.carry_jax_state()
        jm, pm, before = pair.round()
        check_metrics(jm, pm)
        check_deltas(pair, before)


# Free-running rounds amplify float noise.  With local_epochs=1 the port
# stays within 2e-6 of JAX over 3 rounds; with two D steps a round, an Adam
# step whose gradient sits at float noise can flip, and the losses then
# drift by up to 2.1e-3 over 3 rounds (N=2 and N=8, from a fresh state and
# after 4 rounds; tests/test_torch_port_spread.py) while every teacher-forced
# round still agrees to 1e-6.
FREE_RUNNING_RTOL = {1: 1e-3, 2: 5e-3}


@pytest.mark.parametrize("pair", ROUND_CASES, indirect=True)
def test_three_rounds_free_running(pair):
    pair.carry_jax_state()
    for _ in range(3):
        jm, pm, _ = pair.round()
        check_metrics(jm, pm, rtol_loss=FREE_RUNNING_RTOL[pair.local_epochs])


# bfloat16: the port autocasts and normalizes BN in float32, flax casts per
# layer and normalizes in bfloat16 (ROADMAP.md C).  Measured spread, one
# teacher-forced round, N in {2, 8}, widths 8 and 16, seeds 1-4 (CPU,
# tests/test_torch_port_spread.py): losses up to 4.6e-3 relative, feedback norm
# up to 7.8e-3 (the CPU's bfloat16 convolutions move a little between
# runs).  The bounds are 2.5-3x that.
def test_one_round_bfloat16_teacher_forced():
    pair = Pair(2, dtype="bfloat16", seed=1)
    jm, pm, _ = pair.round()
    check_metrics(jm, pm, rtol_loss=1.5e-2, rtol_fb=2e-2)


class _Fixed:
    """A sampler that hands out given (T, N, b) indices."""

    def __init__(self, idx):
        self.idx = idx

    def next_chunk(self, num_steps):
        assert num_steps == len(self.idx)
        return self.idx


@pytest.mark.parametrize("pair", ROUND_CASES, indirect=True)
def test_run_rounds_matches_chunk_fn(pair):
    """One port chunk of 3 rounds (one gather) against JAX's fused
    ``chunk_fn(3)``, with JAX's latents injected."""
    t = 3
    pair.carry_jax_state()
    idx = pair.sampler.next_chunk(t)
    step0 = int(pair.jst.step)
    z = np.stack([np.array(jax.random.normal(jprng.for_step(pair.jst.key, jprng.LATENT, step0 + r),
                                             (pair.jeng.k * B, jdcgan32.Z_DIM), jnp.float32))
                  for r in range(t)])
    pair.jst, jm = pair.jeng.chunk_fn(t)(pair.jst, pair.jdata, jnp.asarray(idx))
    pm = pair.peng.run_rounds(pair.pst, pair.pdata, _Fixed(idx), t, z=torch.from_numpy(z))
    assert pair.pst.step == int(pair.jst.step) == step0 + t
    for r in range(t):
        check_metrics({k: np.asarray(v)[r] for k, v in jm.items() if k != "x_eval"},
                      {k: v[r].detach().numpy() for k, v in pm.items() if k != "x_eval"},
                      rtol_loss=1e-3)
    np.testing.assert_allclose(pm["x_eval"].numpy(),
                               np.asarray(jm["x_eval"]).transpose(0, 3, 1, 2),
                               rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("latents", ["lanes", "injected"])
@pytest.mark.parametrize("n", [2, 8])
def test_run_rounds_equals_step_calls_bit_equal(n, latents):
    """A chunk gathered once equals the same rounds gathered one by one."""
    t = 3
    eng = MDGANEngine(get_spec("Synthetic32"), TrainConfig(
        batch_size=B, compute_dtype="float32", device="cpu"), n,
        model_kwargs={"ngf": WIDTH, "ndf": WIDTH})
    shards, _ = partitioner.shard_data(builtin.synthesize((32, 32, 3), 40 * n, seed=32)[0], n,
                                       iid=True, seed=0)
    data = eng.shard_data(shards)
    idx = sampler.ShardSampler(n, shards.shape[1], B, seed=0).next_chunk(t)
    z = None
    if latents == "injected":
        z = torch.from_numpy(np.random.default_rng(7).standard_normal(
            (t, eng.k * B, 100), np.float32))
    st_chunk, st_steps = eng.init_state(3), eng.init_state(3)
    chunk = eng.run_rounds(st_chunk, data, _Fixed(idx), t, z=z)
    steps = [eng.step(st_steps, data, eng.put_indices(idx[r], shards.shape[1]),
                      z=None if z is None else z[r]) for r in range(t)]
    for key in ("mean_d_loss", "g_feedback_loss", "feedback_norm"):
        assert torch.equal(chunk[key], torch.stack([m[key] for m in steps])), key
    assert torch.equal(chunk["x_eval"], steps[-1]["x_eval"])
    assert st_chunk.step == st_steps.step == t
    for name in ("g", "d"):
        a, b = getattr(st_chunk, name), getattr(st_steps, name)
        for arena in ("params", "stats", "mu", "nu"):
            assert torch.equal(getattr(a, arena), getattr(b, arena)), (name, arena)
    with pytest.raises(ValueError, match="rounds of latents"):
        eng.run_rounds(st_chunk, data, _Fixed(idx), t, z=torch.zeros(t - 1, eng.k * B, 100))


@pytest.mark.parametrize("pair", SWAP_CASES, indirect=True)
def test_swap_matches_swap_fn(pair):
    if pair.n % 2:
        pytest.skip("swaps need an even worker count")
    # Adam moments that differ between workers, so a swap of them shows
    rng = np.random.default_rng(4)
    adam = pair.jst.d.opt[0]
    noisy = adam._replace(**{k: jax.tree.map(
        lambda a: jnp.asarray(np.abs(rng.normal(size=a.shape)), a.dtype), getattr(adam, k))
        for k in ("mu", "nu")})
    pair.jst = pair.jst.replace(d=pair.jst.d.replace(opt=(noisy,) + tuple(pair.jst.d.opt[1:])))
    pair.carry_jax_state()
    perm = pair.jeng.sample_swap_perm(np.random.default_rng(5))
    np.testing.assert_array_equal(pair.peng.sample_swap_perm(np.random.default_rng(5)), perm)
    jst = pair.jeng.swap_fn()(pair.jst, jnp.asarray(perm))
    pair.peng.swap(pair.pst, perm)
    params, stats = from_jax.export_net(pair.pst.d)
    for got, want in ((params, jst.d.params), (stats, jst.d.stats)):
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jax.device_get(want))):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="permutation"):
        pair.peng.swap(pair.pst, np.zeros(pair.n, np.int32))
    # Adam moments move with their discriminator only under swap_opt_state
    for w in range(pair.n):
        for arena, moment in (("mu", jst.d.opt[0].mu), ("nu", jst.d.opt[0].nu)):
            got = from_jax.params_to_jax(pair.pst.d.views(getattr(pair.pst.d, arena), w),
                                         "discriminator")
            want = from_jax.index_tree(jax.device_get(moment), w)
            for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
                np.testing.assert_array_equal(a, b)
    moved = not np.array_equal(perm, np.arange(pair.n))
    stayed = all(np.array_equal(a, b) for a, b in zip(
        jax.tree.leaves(jax.device_get(jst.d.opt[0].mu)),
        jax.tree.leaves(jax.device_get(pair.jst.d.opt[0].mu))))
    assert stayed == (not (pair.peng.cfg.swap_opt_state and moved))


@pytest.mark.parametrize("pair", ["N2", "N8"], indirect=True)
def test_sample_matches_flax_and_keeps_stats(pair):
    from mdgan_tpu.engine import state as jstate
    from mdgan_tpu_torch.core import prng

    pair.carry_jax_state()
    g = pair.pst.g
    before = g.stats.clone()
    got = pair.peng.sample(g, 6, seed=9)
    assert torch.equal(g.stats, before)
    gen = prng.generator(9, prng.EVAL, 0)
    z = torch.randn(6, 100, generator=gen).numpy()
    want, _ = jstate.apply_train(pair.jeng.g_model, pair.jst.g.params, pair.jst.g.stats,
                                 jnp.asarray(z))
    np.testing.assert_allclose(got.numpy(), np.asarray(want).transpose(0, 3, 1, 2),
                               rtol=1e-4, atol=1e-5)


# --- the data pipeline, byte for byte --------------------------------------

def test_synthesize_and_cifar_fallback_identical(tmp_path):
    for shape, n, seed in (((32, 32, 3), 300, 32), ((28, 28, 1), 50, 28)):
        a, la = builtin.synthesize(shape, n, seed=seed)
        b, lb = jbuiltin.synthesize(shape, n, seed=seed)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(la, lb)
    a, _ = builtin.load_cifar10(str(tmp_path), max_examples=200)
    b, _ = jbuiltin.load_cifar10(str(tmp_path), max_examples=200)
    np.testing.assert_array_equal(a, b)


def test_cifar_pickle_batches_identical(tmp_path):
    import pickle

    base = tmp_path / "cifar-10-batches-py"
    base.mkdir()
    rng = np.random.default_rng(0)
    for i in range(1, 6):
        with open(base / f"data_batch_{i}", "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (4, 3072), dtype=np.uint8),
                         b"labels": list(range(4))}, f)
    a, la = builtin.load_cifar10(str(tmp_path))
    b, lb = jbuiltin.load_cifar10(str(tmp_path))
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(la, lb)


@pytest.mark.parametrize("iid", [True, False])
def test_shard_data_and_sampler_identical(iid):
    data, _ = builtin.synthesize((32, 32, 3), 203, seed=32)
    a, ia = partitioner.shard_data(data, 4, iid=iid, seed=0)
    b, ib = jpartitioner.shard_data(data, 4, iid=iid, seed=0)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ia, ib)
    # shard of 50 with b=7 reshuffles every 7 batches: cross several epochs
    ps, js = sampler.ShardSampler(4, 50, 7, seed=0), jsampler.ShardSampler(4, 50, 7, seed=0)
    for t in (3, 11, 1):
        np.testing.assert_array_equal(ps.next_chunk(t), js.next_chunk(t))


def test_swap_perm_identical():
    peng = MDGANEngine(get_spec("Synthetic32"), TrainConfig(batch_size=B, device="cpu"), 8,
                       model_kwargs={"ngf": WIDTH, "ndf": WIDTH})
    rp, rj = np.random.default_rng(11), np.random.default_rng(11)
    for _ in range(4):
        np.testing.assert_array_equal(peng.sample_swap_perm(rp),
                                      JaxEngine.sample_swap_perm(peng, rj))


@pytest.fixture()
def stub_inception(monkeypatch):
    """FID/IS stubbed, as ``tests/test_train_loop.py`` stubs them: the
    metrics have their own tests (``tests/test_torch_port_metrics.py``)."""
    from mdgan_tpu_torch.metrics import fid as fid_mod

    class FakeTracker:
        def __init__(self, real, device=None):
            pass

        def score(self, fakes):
            return 123.0

        def inception_score(self, fakes, splits=1):
            return (2.0, 0.0)

    monkeypatch.setattr(fid_mod, "FIDTracker", FakeTracker)


def _dirs(root):
    """The CLI's output directories, under ``root``."""
    return [arg for flag in ("log_dir", "image_dir", "weights_dir", "checkpoint_dir")
            for arg in (f"--{flag}", str(root / flag))]


def test_cli_two_rounds_full_width_on_cpu(capsys, tmp_path, stub_inception):
    rc = cli.main(["--mode", "mdgan", "--dataset", "CIFAR10", "--num_workers", "8",
                   "--batch_size", "10", "--epochs", "2", "--swap_interval", "1",
                   "--log_interval", "1", "--max_examples", "800", "--device", "cpu"]
                  + _dirs(tmp_path))
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    summary = __import__("json").loads(lines[-1])
    assert summary["rounds"] == 2 and summary["all_finite"] and summary["swaps"] == 1
    assert summary["device"] == "cpu" and len(lines) == 3


def _cli_lines(capsys, chunk_size, root):
    """The CLI's printed lines without their clock readings."""
    rc = cli.main(["--mode", "mdgan", "--dataset", "CIFAR10", "--num_workers", "2",
                   "--batch_size", "4", "--epochs", "5", "--swap_interval", "3",
                   "--log_interval", "4", "--max_examples", "200", "--device", "cpu",
                   "--compute_dtype", "float32", "--chunk_size", str(chunk_size)]
                  + _dirs(root / str(chunk_size)))
    assert rc == 0
    lines = [__import__("json").loads(ln) for ln in capsys.readouterr().out.strip().splitlines()]
    for line in lines:
        for key in ("elapsed_s", "wall_time_s", "steps_per_sec"):
            line.pop(key, None)
    return lines


def test_cli_chunk_size_changes_no_metric(capsys, monkeypatch, tmp_path, stub_inception):
    """Chunks of 2 rounds ([0], [1, 2], [3], [4]: clipped at the log event
    of round 0, the swap after round 3 and the last round) print what one
    chunk per event run ([0], [1, 2, 3], [4]) prints."""
    chunks = []
    run_rounds = MDGANEngine.run_rounds

    def recording(self, st, data, sampler_, num_rounds, z=None):
        chunks.append(num_rounds)
        return run_rounds(self, st, data, sampler_, num_rounds, z)

    monkeypatch.setattr(MDGANEngine, "run_rounds", recording)
    small = _cli_lines(capsys, 2, tmp_path)
    assert chunks == [1, 2, 1, 1]
    chunks.clear()
    large = _cli_lines(capsys, 100, tmp_path)
    assert chunks == [1, 3, 1]
    assert [ln.get("round") for ln in small[:-1]] == [0, 4]
    assert small[-1]["swaps"] == 1 and small[-1]["all_finite"]
    assert small == large
    with pytest.raises(ValueError, match="chunk_size"):
        _cli_lines(capsys, 0, tmp_path)


@pytest.mark.parametrize("flag", [["--swap_impl", "ppermute"], ["--straggler_rate", "0.1"],
                                  ["--moment_dtype", "bfloat16"], ["--num_replicas", "2"],
                                  ["--num_tensor", "2"], ["--download"]])
def test_cli_waiting_features_raise(flag, tmp_path, stub_inception, monkeypatch, caplog):
    """Every flag that once waited for a slice runs now: bfloat16 moments
    and stragglers (ROADMAP A.6) through a round; ``--num_replicas`` and
    ``--num_tensor`` (A.8b) in one process, which ignores them with a log
    line as JAX ignores them on one device (their ranks are
    ``tests/test_torch_port_axes.py``'s); ``--download`` (A.9) after
    fetching the dataset into ``--data_dir`` (the fetch is recorded here;
    the offline fetches are ``tests/test_torch_port_tools.py``'s); and the
    pair swap (A.8's workers axis), which needs one worker a rank, raises
    JAX's ValueError at its first swap in one process."""
    argv = ["--epochs", "1", "--device", "cpu", "--num_workers", "2",
            "--max_examples", "40"] + flag + _dirs(tmp_path)
    if flag[0] in ("--num_replicas", "--num_tensor"):
        with caplog.at_level("INFO", logger="mdgan_tpu_torch"):
            assert cli.main(argv) == 0
        assert "ignored" in caplog.text
    elif flag[0] == "--download":
        from mdgan_tpu_torch.data import download

        fetched = []
        monkeypatch.setattr(download, "ensure_dataset", lambda *a: fetched.append(a))
        assert cli.main(argv + ["--data_dir", str(tmp_path / "data")]) == 0
        assert fetched == [("CIFAR10", str(tmp_path / "data"))]
    elif flag[0] == "--swap_impl":
        with pytest.raises(ValueError, match="one worker per rank"):
            cli.main(argv + ["--epochs", "2", "--swap_interval", "1"])
    else:
        assert cli.main(argv) == 0
