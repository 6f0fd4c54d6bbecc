"""bfloat16 Adam moments and the straggler policy in the port, against the
JAX package, on the CPU.

``--moment_dtype bfloat16``: the JAX package runs bf16 moments through optax
(``mdgan_tpu/engine/state.py:216-251``), so the port's plain bf16-moment Adam
(the CUDA kernel's reference, ``ops/adam.py:adam_plain_bf16m``) is held to
``make_optimizer`` with both moments in bfloat16.  The stored moments were
measured bit-equal to optax's over 5 steps at b1 0.0 and 0.5 (100,000
elements, gradients spread over six decades), and the test holds them so;
the parameters differ only by the order of the f32 bias correction
(torch-semantics ``lr/(1-b1^t)`` against optax's ``mu/(1-b1^t)``, then
``-lr``): rtol 1e-6, atol 1e-9.

``--straggler_rate``: JAX's threefry draws cannot be made in torch, so the
rounds against JAX take JAX's accept mask, derived as the engine derives it
(``mdgan.py:404-414``), as they take its latents and dropout masks.  The
properties of ``tests/test_straggler.py`` are held on the port's own draws.

Rounds are teacher-forced at ``tests/test_torch_port_round.py``'s bounds:
losses rtol 2e-4, feedback norm 2e-3, parameter updates sign-flip aware.
The moments, one bfloat16 rounding of a gradient that agrees to float32
noise, within one bf16 ulp (rtol 2^-7), with the absolute floor of the
round tests (1e-3 of the largest) for the noise-level gradients.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

import test_torch_port_families as fam
import test_torch_port_round as rnd
import test_torch_port_standalone as sa
from mdgan_tpu.core import prng as jprng
from mdgan_tpu.core.config import OptimizerConfig as JaxOptimizerConfig
from mdgan_tpu.core.config import TrainConfig as JaxTrainConfig
from mdgan_tpu.engine.mdgan import MDGANEngine as JaxEngine
from mdgan_tpu.engine.standalone import StandaloneEngine as JaxStandalone
from mdgan_tpu.engine.state import make_optimizer
from mdgan_tpu_torch.cli import train as cli
from mdgan_tpu_torch.core import prng
from mdgan_tpu_torch.core.config import OptimizerConfig, TrainConfig
from mdgan_tpu_torch.core.registry import get as get_spec
from mdgan_tpu_torch.data import builtin, partitioner, sampler
from mdgan_tpu_torch.engine import state as state_lib
from mdgan_tpu_torch.engine.mdgan import MDGANEngine
from mdgan_tpu_torch.engine.standalone import StandaloneEngine
from mdgan_tpu_torch.models import from_jax
from mdgan_tpu_torch.obs import spans
from mdgan_tpu_torch.ops import _build, adam
from mdgan_tpu_torch.utils import checkpoint as ckpt

LR, B = 2e-4, 4
BF16 = {"mu_dtype": "bfloat16", "nu_dtype": "bfloat16"}
BF16_RTOL = 2.0 ** -7  # one bfloat16 ulp, relative


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small tensors, as the other
    port test modules pin it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --- the plain bf16-moment Adam against optax ---------------------------------

@pytest.mark.parametrize("b1", [0.0, 0.5])
def test_bf16_moment_adam_matches_optax(b1):
    lr, b2, eps, n = 2e-4, 0.999, 1e-8, 4099  # odd: the kernel's scalar tail
    rng = np.random.default_rng(0)
    tx = make_optimizer(JaxOptimizerConfig(lr=lr, beta_1=b1, beta_2=b2, eps=eps, **BF16))
    update = jax.jit(tx.update)
    p0 = (rng.standard_normal(n) * 0.1).astype(np.float32)
    jp = jnp.asarray(p0)
    jopt = tx.init(jp)
    p = torch.from_numpy(p0.copy())
    mu, nu = torch.zeros(n, dtype=torch.bfloat16), torch.zeros(n, dtype=torch.bfloat16)
    for t in range(1, 6):
        g = (rng.standard_normal(n) * 10.0 ** rng.uniform(-6, 0, n)).astype(np.float32)
        upd, jopt = update(jnp.asarray(g), jopt, jp)
        jp = optax.apply_updates(jp, upd)
        adam.adam_update(p, torch.from_numpy(g), mu, nu, *adam.bias_scalars(lr, b1, b2, t),
                         b1, b2, eps)
        assert mu.dtype == nu.dtype == torch.bfloat16
        assert jopt[0].mu.dtype == jopt[0].nu.dtype == jnp.bfloat16
        np.testing.assert_array_equal(mu.float().numpy(), np.asarray(jopt[0].mu, np.float32))
        np.testing.assert_array_equal(nu.float().numpy(), np.asarray(jopt[0].nu, np.float32))
        np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=1e-6, atol=1e-9,
                                   err_msg=f"step {t}")


def test_adam_update_dispatches_on_the_moments_dtype():
    rng = np.random.default_rng(1)
    p, g = (torch.from_numpy(rng.standard_normal(37).astype(np.float32)) for _ in range(2))
    args = (*adam.bias_scalars(LR, 0.5, 0.999, 2), 0.5, 0.999, 1e-8)
    moments = torch.from_numpy(np.abs(rng.standard_normal(37)).astype(np.float32))
    for dtype, plain in ((torch.float32, adam.adam_plain),
                         (torch.bfloat16, adam.adam_plain_bf16m)):
        got = [p.clone(), g, moments.to(dtype, copy=True), moments.to(dtype, copy=True)]
        want = [t.clone() for t in got]
        adam.adam_update(*got, *args)
        plain(*want, *args)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b)
    with pytest.raises(TypeError, match="nu must be torch.bfloat16"):
        adam.adam_update(p.clone(), g, moments.to(torch.bfloat16), moments.clone(), *args)
    with pytest.raises(TypeError, match="mu must be"):
        adam.adam_update(p.clone(), g, moments.half(), moments.half(), *args)
    assert _build.launches["mdgan_adam_f32"] == _build.launches["mdgan_adam_f32_bf16m"] == 0


def test_net_state_holds_bf16_moments_and_rejects_mixed():
    eng = MDGANEngine(get_spec("Synthetic32"), TrainConfig(
        batch_size=B, device="cpu", generator_opt=OptimizerConfig(**BF16)), 2,
        model_kwargs={"ngf": 8, "ndf": 8})
    st = eng.init_state(1)
    assert st.g.mu.dtype == st.g.nu.dtype == torch.bfloat16
    assert st.d.mu.dtype == torch.float32 and st.g.params.dtype == torch.float32
    snap = st.g.snapshot()
    assert snap["mu"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="both float32 or both bfloat16"):
        state_lib.moment_dtype(OptimizerConfig(mu_dtype="bfloat16"))


# --- rounds against the JAX engines ------------------------------------------

def _jax_mask(jst, n, rate):
    """JAX's accept mask for the round at ``jst.step`` (``mdgan.py:404-414``)."""
    u = jax.random.uniform(jprng.for_step(jst.key, jprng.STRAGGLER, jst.step), (n,))
    return np.array((u <= 1.0 - rate) | (u == jnp.min(u)))


class MDGANPair(fam._Pair):
    """JAX's and the port's MD-GAN engines on one family, the same data,
    optimizer dtypes and straggler rate."""

    def __init__(self, family, n=2, seed=3, moments="bfloat16", rate=0.0):
        self.family, self.n, self.rate = family, n, rate
        if family == "dcgan32":
            jspec, pspec, kw, shape = (rnd._narrow_jax_spec(), get_spec("Synthetic32"),
                                       {"ngf": rnd.WIDTH, "ndf": rnd.WIDTH}, (32, 32, 3))
        else:
            jspec, pspec, kw, shape = (fam._jax_spec("mlp"), get_spec("SyntheticMNIST"), {},
                                       (28, 28, 1))
        opt = {"mu_dtype": moments, "nu_dtype": moments}
        self.jeng = JaxEngine(jspec, JaxTrainConfig(
            batch_size=B, chunk_size=1, compute_dtype="float32", donate=False,
            straggler_rate=rate, generator_opt=JaxOptimizerConfig(**opt),
            discriminator_opt=JaxOptimizerConfig(**opt)), n)
        self.peng = MDGANEngine(pspec, TrainConfig(
            batch_size=B, compute_dtype="float32", device="cpu", straggler_rate=rate,
            generator_opt=OptimizerConfig(**opt), discriminator_opt=OptimizerConfig(**opt)),
            n, model_kwargs=kw)
        data, _ = builtin.synthesize(shape, 12 * n, seed=7)
        shards, _ = partitioner.shard_data(data, n, iid=True, seed=0)
        self.shard_size = shards.shape[1]
        self.jdata, self.pdata = self.jeng.shard_data(shards), self.peng.shard_data(shards)
        self.sampler = sampler.ShardSampler(n, shards.shape[1], B, seed=0)
        self.jst = fam._jit_init(self.jeng, seed)
        self.pst = self.peng.init_state(seed=seed)

    def round(self):
        """One teacher-forced round; returns (JAX metrics, port metrics,
        (JAX state, port trees) before it)."""
        fam._carry(self.pst, self.jst)
        idx = self.sampler.next_chunk(1)
        z = self._latents(self.jeng.k * B)
        masks = fam.mdgan_masks(self.jeng, self.jst, B) if self.family == "mlp" else None
        fb_mask = (torch.from_numpy(_jax_mask(self.jst, self.n, self.rate))
                   if self.rate > 0 else None)
        before = (self.jst, self.port_trees())
        self.jst, jm = self.jeng.chunk_fn(1)(self.jst, self.jdata, jnp.asarray(idx))
        pm = self.peng.step(self.pst, self.pdata, self.peng.put_indices(idx[0], self.shard_size),
                            z=torch.from_numpy(z), masks=masks, fb_mask=fb_mask)
        jm = {k: np.asarray(v)[0] for k, v in jm.items() if k != "x_eval"}
        pm = {k: v.detach().numpy() for k, v in pm.items() if k != "x_eval"}
        return jm, pm, before


def check_moments(pst, jst):
    """The port's stored Adam moments (their dtype, and values within one
    bf16 ulp) against optax's."""
    for name in ("g", "d"):
        net, opt = getattr(pst, name), getattr(jst, name).opt[0]
        for arena, jtree in (("mu", opt.mu), ("nu", opt.nu)):
            jtree = jax.device_get(jtree)
            assert getattr(net, arena).dtype == torch.bfloat16
            assert all(a.dtype == jnp.bfloat16 for a in jax.tree.leaves(jtree))
            got = fam._flat(from_jax.export_arenas(net, {arena: getattr(net, arena)})[arena])
            want = fam._flat(jtree).astype(np.float32)
            np.testing.assert_allclose(got, want, rtol=BF16_RTOL,
                                       atol=1e-3 * np.abs(want).max(), err_msg=f"{name} {arena}")


@pytest.mark.parametrize("family", ["dcgan32", "mlp"])
def test_mdgan_rounds_with_bf16_moments_match_jax(family):
    """Two teacher-forced MD-GAN rounds at N=2 with bfloat16 moments."""
    pair = MDGANPair(family)
    for _ in range(2):
        jm, pm, (jold, pold) = pair.round()
        fam.check_metrics(jm, pm, 2e-4)
        fam.check_deltas(jold, pair.jst, pold, pair.port_trees(), 0.005, 1e-6)
        check_moments(pair.pst, pair.jst)


def test_standalone_rounds_with_bf16_moments_match_jax():
    """Two teacher-forced standalone rounds (DCGAN-32, width 8) with
    bfloat16 moments."""
    opt = JaxOptimizerConfig(**BF16)
    jeng = JaxStandalone(sa._jax_spec(sa.WIDTH), JaxTrainConfig(
        batch_size=B, compute_dtype="float32", donate=False, generator_opt=opt,
        discriminator_opt=opt))
    peng = StandaloneEngine(get_spec("Synthetic32"), TrainConfig(
        batch_size=B, compute_dtype="float32", device="cpu",
        generator_opt=OptimizerConfig(**BF16), discriminator_opt=OptimizerConfig(**BF16)),
        model_kwargs={"ngf": sa.WIDTH, "ndf": sa.WIDTH})
    data, _ = builtin.synthesize((32, 32, 3), 40, seed=32)
    pdata = peng.put_data(data)
    smp = sampler.ShardSampler(1, len(data), B, seed=0)
    jst, pst = fam._jit_init(jeng, 3), peng.init_state(3)
    for _ in range(2):
        fam._carry(pst, jst)
        idx = smp.next_chunk(1)
        z = np.array(jax.random.normal(jprng.for_step(jst.key, jprng.LATENT, jst.step),
                                       (B, 100), jnp.float32))
        jold, pold = jst, {"g": from_jax.export_net(pst.g), "d": from_jax.export_net(pst.d)}
        jst, jm = jeng.chunk_fn(1)(jst, jnp.asarray(data), jnp.asarray(idx[:, 0, :]))
        pm = peng.step(pst, pdata, peng.put_indices(idx[0], len(data)), z=torch.from_numpy(z))
        fam.check_metrics({k: np.asarray(v)[0] for k, v in jm.items()},
                          {k: v.detach().numpy() for k, v in pm.items()}, 2e-4,
                          keys=("mean_d_loss", "mean_g_loss"))
        fam.check_deltas(jold, jst, pold, {"g": from_jax.export_net(pst.g),
                                           "d": from_jax.export_net(pst.d)}, 0.005, 1e-6)
        check_moments(pst, jst)


def test_straggler_rounds_match_jax():
    """N=4 at rate 0.5 (DCGAN-32, width 8), JAX's mask injected: two
    teacher-forced rounds, at least one of them with a feedback dropped."""
    pair = MDGANPair("dcgan32", n=4, seed=2, moments="float32", rate=0.5)
    accepted = []
    for _ in range(2):
        jm, pm, (jold, pold) = pair.round()
        assert int(pm["n_feedbacks"]) == int(jm["n_feedbacks"])
        accepted.append(int(jm["n_feedbacks"]))
        rnd.check_metrics(jm, pm)
        fam.check_deltas(jold, pair.jst, pold, pair.port_trees(), 0.005, 1e-6)
    assert min(accepted) < 4, accepted


# --- the straggler policy's properties (tests/test_straggler.py) ---------------

def _mnist_engine(n, rate, **kw):
    return MDGANEngine(get_spec("SyntheticMNIST"), TrainConfig(
        batch_size=B, compute_dtype="float32", device="cpu", straggler_rate=rate, **kw), n)


def _run_chunks(n, rate, chunks, seed=3):
    eng = _mnist_engine(n, rate)
    data, _ = builtin.synthesize((28, 28, 1), 16 * n, seed=28)
    shards, _ = partitioner.shard_data(data, n, iid=True, seed=0)
    pdata = eng.shard_data(shards)
    smp = sampler.ShardSampler(n, shards.shape[1], B, seed=0)
    st = eng.init_state(seed)
    ms = [eng.run_rounds(st, pdata, smp, t) for t in chunks]
    return eng, st, {k: torch.cat([m[k] for m in ms]) for k in ms[0] if k != "x_eval"}


def test_straggler_rate_validation():
    for rate in (1.0, -0.1):
        with pytest.raises(ValueError, match="straggler_rate"):
            _mnist_engine(2, rate)


def test_straggler_drop_is_server_side_only():
    """Dropping feedbacks leaves every worker-side quantity bit-identical
    and changes only the generator's step."""
    _, st0, m0 = _run_chunks(4, 0.0, [1])
    _, st1, m1 = _run_chunks(4, 0.7, [1])
    assert torch.equal(st0.d.params, st1.d.params) and torch.equal(st0.d.stats, st1.d.stats)
    for key in ("mean_d_loss", "g_feedback_loss", "feedback_norm"):
        assert torch.equal(m0[key], m1[key]), key  # the norm is taken before the drop
    nf = m1["n_feedbacks"]
    assert nf.shape == (1,) and nf.dtype == torch.int32 and 1 <= int(nf[0]) < 4
    assert not torch.equal(st0.g.params, st1.g.params)


def test_straggler_survivor_guarantee_and_determinism():
    eng, st_a, m_a = _run_chunks(8, 0.9, [16])
    _, st_b, m_b = _run_chunks(8, 0.9, [16])
    nf = m_a["n_feedbacks"]
    assert nf.shape == (16,) and int(nf.min()) == 1 and int(nf.max()) <= 8
    assert torch.equal(nf, m_b["n_feedbacks"]) and torch.equal(st_a.g.params, st_b.g.params)
    # the mask is the documented derivation from lane (STRAGGLER, step)
    for step in (0, 5):
        u = torch.rand(8, generator=prng.generator(3, prng.STRAGGLER, step))
        want = (u <= 1.0 - 0.9) | (u == u.min())
        st_a.step = step
        assert torch.equal(eng.straggler_mask(st_a), want)


def test_straggler_chunking_invariance_and_single_worker():
    """4 rounds as one chunk equal 2+2 (the mask folds the global step);
    with one worker the lone feedback always survives and the run equals
    the rate-0 run."""
    _, st_a, m_a = _run_chunks(2, 0.5, [4])
    _, st_b, m_b = _run_chunks(2, 0.5, [2, 2])
    assert torch.equal(m_a["n_feedbacks"], m_b["n_feedbacks"])
    assert torch.equal(st_a.g.params, st_b.g.params)
    _, st0, m0 = _run_chunks(1, 0.0, [3])
    _, st1, m1 = _run_chunks(1, 0.9, [3])
    assert "n_feedbacks" not in m0
    assert torch.equal(m1["n_feedbacks"], torch.ones(3, dtype=torch.int32))
    torch.testing.assert_close(st1.g.params, st0.g.params, rtol=1e-6, atol=1e-7)


def _cli(root, epochs, *extra):
    return cli.main(["--mode", "mdgan", "--dataset", "SyntheticMNIST", "--num_workers", "4",
                     "--batch_size", "4", "--epochs", str(epochs), "--swap_interval", "2",
                     "--log_interval", "2", "--checkpoint_interval", "2", "--chunk_size", "3",
                     "--max_examples", "200", "--compute_dtype", "float32", "--device", "cpu",
                     *rnd._dirs(root), *extra])


def test_trainer_csv_has_n_feedbacks_column(tmp_path, capsys, stub_inception):
    csv = "log_dir/mdgan.4.SyntheticMNIST.server.logs.csv"
    assert _cli(tmp_path / "straggle", 6, "--straggler_rate", "0.5") == 0
    rows = spans.read_spans(tmp_path / "straggle" / csv)
    assert [r["epoch"] for r in rows] == [0, 2, 4, 5]
    assert all(r["n_feedbacks"] is not None and 1 <= r["n_feedbacks"] <= 4 for r in rows)
    assert _cli(tmp_path / "parity", 3) == 0
    rows = spans.read_spans(tmp_path / "parity" / csv)
    assert rows and all("n_feedbacks" not in r for r in rows)


def test_bf16_moment_checkpoints_resume_bit_identically(tmp_path, capsys, stub_inception):
    """8 rounds equal 4 plus --resume for 4, with bfloat16 moments stored as
    bfloat16 leaves."""
    from mdgan_tpu_torch.engine import train_loop

    def run(root, epochs, *extra):
        cfg = cli.config_from_args(cli.build_parser().parse_args([
            "--mode", "mdgan", "--dataset", "SyntheticMNIST", "--num_workers", "2",
            "--batch_size", "4", "--epochs", str(epochs), "--swap_interval", "3",
            "--log_interval", "2", "--checkpoint_interval", "2", "--chunk_size", "2",
            "--max_examples", "100", "--compute_dtype", "float32", "--device", "cpu",
            "--moment_dtype", "bfloat16", "--straggler_rate", "0.3",
            *rnd._dirs(root), *extra]))
        trainer = train_loop.MDGANTrainer(cfg)
        try:
            trainer.train()
        finally:
            trainer.close()
        return trainer.state

    full = run(tmp_path / "full", 8)
    run(tmp_path / "split", 4)
    resumed = run(tmp_path / "split", 8, "--resume")
    for name in ("g", "d"):
        for arena in ("params", "stats", "mu", "nu"):
            a, b = getattr(getattr(full, name), arena), getattr(getattr(resumed, name), arena)
            assert a.dtype == b.dtype and torch.equal(a, b), (name, arena)
    assert full.d.mu.dtype == torch.bfloat16 and resumed.step == full.step == 8
    payload = torch.load(tmp_path / "split" / "checkpoint_dir" / "mdgan.2.SyntheticMNIST"
                         / "ckpt_7.pt", weights_only=True)
    for name in ("g", "d"):
        for moment in ("mu", "nu"):
            assert all(t.dtype == torch.bfloat16 for t in payload["nets"][name][moment].values())
        assert all(t.dtype == torch.float32 for t in payload["nets"][name]["params"].values())


@pytest.fixture()
def stub_inception(monkeypatch):
    """FID/IS stubbed, as ``tests/test_torch_port_round.py`` stubs them."""
    from mdgan_tpu_torch.metrics import fid as fid_mod

    class FakeTracker:
        def __init__(self, real, device=None):
            pass

        def score(self, fakes):
            return 123.0

        def inception_score(self, fakes, splits=1):
            return (2.0, 0.0)

    monkeypatch.setattr(fid_mod, "FIDTracker", FakeTracker)


def test_ckpt_round_trip_keeps_bf16_moments(tmp_path):
    """A bf16-moment state saved and restored into a fresh one, bit for bit."""
    eng = _mnist_engine(2, 0.0, generator_opt=OptimizerConfig(**BF16),
                        discriminator_opt=OptimizerConfig(**BF16))
    st = eng.init_state(5)
    rng = np.random.default_rng(0)
    for net in (st.g, st.d):
        for arena in (net.mu, net.nu):
            arena.copy_(torch.from_numpy(rng.standard_normal(arena.numel()).astype(np.float32)))
    mgr = ckpt.CheckpointManager(tmp_path)
    mgr.save(0, ckpt.snapshot_state(st))
    back = eng.init_state(6)
    mgr.restore(back)
    mgr.close()
    for name in ("g", "d"):
        for arena in ("params", "stats", "mu", "nu"):
            assert torch.equal(getattr(getattr(st, name), arena),
                               getattr(getattr(back, name), arena)), (name, arena)
