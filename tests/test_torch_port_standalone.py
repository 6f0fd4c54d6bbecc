"""The port's standalone round against ``StandaloneEngine.chunk_fn``, on the CPU.

Narrow DCGAN-32 (ngf=ndf=8) in float32.  Both sides start from the JAX
engine's state (params, BN statistics, Adam moments and count, carried over
by ``models/from_jax.py``) and get the same latents z (drawn from
``prng.for_step(key, LATENT, step)``) and the same sampler indices.  Bounds:
losses within rtol 1e-3 and ``x_eval`` within rtol 1e-3 / atol 1e-4 (as the
MD-GAN chunk test); parameter deltas sign-flip aware (each Adam step moves a
weight by about lr*sign(grad), so an element whose gradient sits at float
noise may flip: under 0.5% of elements, never by more than 2.05*lr a step);
BN statistics within float32 noise; the real batches bit-equal.
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
from mdgan_tpu.engine.standalone import StandaloneEngine as JaxStandalone
from mdgan_tpu.models import dcgan32 as jdcgan32
from mdgan_tpu.ops import losses as jlosses
from mdgan_tpu_torch.core.config import TrainConfig
from mdgan_tpu_torch.core.registry import get as get_spec
from mdgan_tpu_torch.data import builtin, sampler
from mdgan_tpu_torch.engine.standalone import StandaloneEngine
from mdgan_tpu_torch.models import from_jax
from mdgan_tpu_torch.ops.sampling import sample_normalize

LR, B, WIDTH, T = 2e-4, 4, 8, 3
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



def _flat(tree):
    return np.concatenate([np.ravel(a) for a in jax.tree.leaves(tree)])


class Fixed:
    """A sampler that hands out given (T, 1, b) indices."""

    def __init__(self, idx):
        self.idx = idx

    def next_chunk(self, num_steps):
        assert num_steps == len(self.idx)
        return self.idx


class StandalonePair:
    """The JAX standalone engine and the port's, on the same data."""

    def __init__(self, local_epochs, dtype="float32", width=WIDTH, seed=3):
        self.jeng = JaxStandalone(_jax_spec(width), JaxTrainConfig(
            batch_size=B, local_epochs=local_epochs, compute_dtype=dtype, donate=False))
        self.peng = StandaloneEngine(get_spec("Synthetic32"), TrainConfig(
            batch_size=B, local_epochs=local_epochs, compute_dtype=dtype, device="cpu"),
            model_kwargs={"ngf": width, "ndf": width})
        self.data, _ = builtin.synthesize((32, 32, 3), 120, seed=32)
        self.jdata = jnp.asarray(self.data)
        self.pdata = self.peng.put_data(self.data)
        self.sampler = sampler.ShardSampler(1, len(self.data), B, seed=0)
        self.jst = self.jeng.init_state(seed=seed)
        self.pst = self.peng.init_state(seed=seed)
        self.carry_jax_state()

    def carry_jax_state(self):
        for net, jnet in ((self.pst.g, self.jst.g), (self.pst.d, self.jst.d)):
            adam = jnet.opt[0]
            from_jax.load_net(net, jax.device_get(jnet.params), jax.device_get(jnet.stats),
                              jax.device_get(adam.mu), jax.device_get(adam.nu), int(adam.count))
        self.pst.step = int(self.jst.step)

    def latents(self, t):
        step0 = int(self.jst.step)
        return np.stack([np.array(jax.random.normal(
            jprng.for_step(self.jst.key, jprng.LATENT, step0 + r),
            (B, jdcgan32.Z_DIM), jnp.float32)) for r in range(t)])

    def chunk(self, t):
        """``t`` rounds on both sides from the same state; returns (jax
        metrics, port metrics, the states before)."""
        idx = self.sampler.next_chunk(t)
        z = self.latents(t)
        before = (self.jst, self.port_trees())
        self.jst, jm = self.jeng.chunk_fn(t)(self.jst, self.jdata, jnp.asarray(idx[:, 0, :]))
        pm = self.peng.run_rounds(self.pst, self.pdata, Fixed(idx), t, z=torch.from_numpy(z))
        return jm, pm, before, idx

    def port_trees(self):
        return {"g": from_jax.export_net(self.pst.g), "d": from_jax.export_net(self.pst.d)}


def _jax_spec(width):
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


@pytest.mark.parametrize("local_epochs", [1, 2])
def test_run_rounds_matches_chunk_fn(local_epochs):
    pair = StandalonePair(local_epochs)
    jm, pm, (jold, pold), _ = pair.chunk(T)
    assert pair.pst.step == int(pair.jst.step) == T
    for key in ("mean_d_loss", "mean_g_loss"):
        np.testing.assert_allclose(pm[key].numpy(), np.asarray(jm[key]), rtol=1e-3, err_msg=key)
    np.testing.assert_allclose(pm["x_eval"].numpy(),
                               np.asarray(jm["x_eval"]).transpose(0, 3, 1, 2),
                               rtol=1e-3, atol=1e-4)
    steps = T * local_epochs
    pnew = pair.port_trees()
    for name in ("g", "d"):
        jnet_old, jnet_new = getattr(jold, name), getattr(pair.jst, name)
        d_jax = _flat(jax.device_get(jnet_new.params)) - _flat(jax.device_get(jnet_old.params))
        d_port = _flat(pnew[name][0]) - _flat(pold[name][0])
        close = np.isclose(d_port, d_jax, rtol=1e-2, atol=1e-6)
        assert 1.0 - close.mean() < 0.005, (name, 1.0 - close.mean())
        assert np.abs(d_port - d_jax).max() <= 2.05 * LR * steps + 1e-6, name
        np.testing.assert_allclose(_flat(pnew[name][1]), _flat(jax.device_get(jnet_new.stats)),
                                   rtol=1e-4, atol=1e-5, err_msg=f"{name} BN stats")
    assert pair.pst.g.count == pair.pst.d.count == int(pair.jst.g.opt[0].count) == steps


@pytest.mark.parametrize("local_epochs", [1, 2])
def test_one_round_teacher_forced_state(local_epochs):
    """One round from an identical state: the new BN statistics of both
    nets (G's from the G step's forward, not from fake0's; D's from its
    step and from the G step's D(fake)) and the Adam moments agree."""
    pair = StandalonePair(local_epochs)
    pair.chunk(1)
    for name in ("g", "d"):
        net, jnet = getattr(pair.pst, name), getattr(pair.jst, name)
        got = from_jax.export_net(net)[1]
        np.testing.assert_allclose(_flat(got), _flat(jax.device_get(jnet.stats)),
                                   rtol=2e-5, atol=1e-6, err_msg=f"{name} BN stats")
        mu = from_jax.params_to_jax(net.views(net.mu, 0), from_jax.role_of(net.modules[0]))
        want = jax.device_get(jnet.opt[0].mu)
        np.testing.assert_allclose(_flat(mu), _flat(want), rtol=1e-3,
                                   atol=1e-3 * np.abs(_flat(want)).max(), err_msg=name)


# bfloat16 (see tests/test_torch_port_round.py): measured spread, one
# teacher-forced round, widths 8 and 16, seeds 1-4 (CPU,
# tests/test_torch_port_spread.py): losses up to 2.6e-3 relative, x_eval up to
# 4.1e-3 absolute (one bfloat16 step near 1).  The bounds are 3x that.
def test_one_round_bfloat16_teacher_forced():
    pair = StandalonePair(1, dtype="bfloat16", seed=1)
    jm, pm, _, _ = pair.chunk(1)
    for key in ("mean_d_loss", "mean_g_loss"):
        np.testing.assert_allclose(pm[key].numpy(), np.asarray(jm[key]), rtol=8e-3, err_msg=key)
    np.testing.assert_allclose(pm["x_eval"].numpy(),
                               np.asarray(jm["x_eval"]).transpose(0, 3, 1, 2), rtol=0,
                               atol=1.2e-2)


def test_real_batches_bit_equal():
    """The port's sampling (N=1) against the JAX standalone round's plain
    ``normalize_uint8(data[idx])`` under ``jit`` (``standalone.py:71``)."""
    data, _ = builtin.synthesize((32, 32, 3), 120, seed=32)
    idx = sampler.ShardSampler(1, len(data), B, seed=0).next_chunk(5)
    want = jax.jit(lambda d, i: jlosses.normalize_uint8(d[i]))(jnp.asarray(data),
                                                               jnp.asarray(idx[:, 0, :]))
    got = sample_normalize(torch.from_numpy(data[None]), torch.from_numpy(idx))
    np.testing.assert_array_equal(got[:, 0].numpy(), np.asarray(want).transpose(0, 1, 4, 2, 3))


def test_generator_statistics_move_once_a_round():
    """fake0's forward leaves G's running statistics alone: after a round
    they equal one momentum update from the G step's forward."""
    eng = StandaloneEngine(get_spec("Synthetic32"), TrainConfig(
        batch_size=B, compute_dtype="float32", device="cpu"),
        model_kwargs={"ngf": WIDTH, "ndf": WIDTH})
    st = eng.init_state(1)
    before = st.g.stats.clone()
    z = eng.latents(st)
    data = eng.put_data(builtin.synthesize((32, 32, 3), 40, seed=32)[0])
    expected = eng.init_state(1)
    with torch.no_grad():
        expected.g.modules[0](z)  # one forward at the round-start params
    eng.step(st, data, torch.zeros(1, B, dtype=torch.int32), z=z)
    assert not torch.equal(st.g.stats, before)
    torch.testing.assert_close(st.g.stats, expected.g.stats, rtol=0, atol=0)


def test_chunk_equals_step_calls_bit_equal():
    eng = StandaloneEngine(get_spec("Synthetic32"), TrainConfig(
        batch_size=B, local_epochs=2, compute_dtype="float32", device="cpu"),
        model_kwargs={"ngf": WIDTH, "ndf": WIDTH})
    data_np = builtin.synthesize((32, 32, 3), 40, seed=32)[0]
    data = eng.put_data(data_np)
    idx = sampler.ShardSampler(1, len(data_np), B, seed=0).next_chunk(T)
    a, b = eng.init_state(5), eng.init_state(5)
    chunk = eng.run_rounds(a, data, Fixed(idx), T)
    steps = [eng.step(b, data, eng.put_indices(idx[t], len(data_np))) for t in range(T)]
    for key in ("mean_d_loss", "mean_g_loss"):
        assert torch.equal(chunk[key], torch.stack([m[key] for m in steps])), key
    assert torch.equal(chunk["x_eval"], steps[-1]["x_eval"])
    np.testing.assert_array_equal(chunk["idx"], idx)
    for name in ("g", "d"):
        for arena in ("params", "stats", "mu", "nu"):
            assert torch.equal(getattr(getattr(a, name), arena),
                               getattr(getattr(b, name), arena)), (name, arena)
