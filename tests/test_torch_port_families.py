"""The port's other model families against the JAX package, on the CPU, f32.

MLP-GAN (MNIST), DCGAN-64 (CelebA, width 8) and a tiny StyleGAN2 (``max_res``
32, ``base_features`` 32, ``map_layers`` 2, as ``tests/test_models.py``
runs it).  The JAX side's weights cross over through ``models/from_jax.py``;
its latents z, sampler indices and dropout keep masks are injected.  A mask
is recorded outside ``jit``: the D's key is derived as ``_d_region`` (or the
standalone ``_step``) derives it, and the flax ``MLPDiscriminator`` is applied
eagerly under ``flax.linen.intercept_methods``, which draws each
``Dropout``'s mask from the key that layer would use
(:func:`record_masks`).  ``test_vmapped_dropout_draws_the_recorded_bits``
shows that the engine's vmapped apply draws the same bits.

Bounds are those of ``tests/test_torch_port_round.py``: losses rtol 2e-4,
feedback norm 2e-3, parameter deltas sign-flip aware.  Forwards and
gradients are held at rtol 1e-4 with an absolute floor of 1e-5 of the
largest magnitude (float32 sums in different orders).
"""

import functools
import json

import numpy as np
import pytest

import flax.linen as fnn
import jax
import jax.numpy as jnp
import torch

import test_golden
from mdgan_tpu.core import prng as jprng
from mdgan_tpu.core import registry as jregistry
from mdgan_tpu.core.config import TrainConfig as JaxTrainConfig
from mdgan_tpu.data import builtin as jbuiltin
from mdgan_tpu.engine.mdgan import MDGANEngine as JaxEngine
from mdgan_tpu.engine.standalone import StandaloneEngine as JaxStandalone
from mdgan_tpu.models import dcgan64 as jdcgan64
from mdgan_tpu.models import mlp_gan as jmlp
from mdgan_tpu.models import stylegan2 as jsg2
from mdgan_tpu.utils import checkpoint as jckpt
from mdgan_tpu_torch.cli import train as cli
from mdgan_tpu_torch.core import registry
from mdgan_tpu_torch.core.config import TrainConfig
from mdgan_tpu_torch.data import builtin, partitioner, sampler
from mdgan_tpu_torch.engine import mdgan as mdgan_engine
from mdgan_tpu_torch.engine.mdgan import MDGANEngine
from mdgan_tpu_torch.engine.standalone import StandaloneEngine
from mdgan_tpu_torch.models import from_jax, mlp_gan
from mdgan_tpu_torch.ops import sampling
from mdgan_tpu_torch.utils import checkpoint as ckpt

LR, B = 2e-4, 4
SG2 = {"max_res": 32, "base_features": 32, "map_layers": 2}

# family -> (port dataset, port width keywords, JAX G, JAX D, image shape, z_dim)
FAMILIES = {
    "mlp": ("SyntheticMNIST", {}, jmlp.MLPGenerator, jmlp.MLPDiscriminator,
            jmlp.SHAPE, jmlp.Z_DIM),
    "dcgan64": ("CelebA", {"ngf": 8, "ndf": 8},
                functools.partial(jdcgan64.DCGANGenerator64, ngf=8),
                functools.partial(jdcgan64.DCGANDiscriminator64, ndf=8),
                jdcgan64.SHAPE, jdcgan64.Z_DIM),
    "stylegan2": ("FFHQ128", SG2, functools.partial(jsg2.StyleGAN2Generator, **SG2),
                  functools.partial(jsg2.StyleGAN2Discriminator, max_res=32,
                                    base_features=32),
                  (32, 32, 3), jsg2.Z_DIM),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small tensors: extra threads
    buy nothing at these sizes and spin against the other test processes
    the suite runs beside this one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_spec(family):
    name = f"TorchPortFamily_{family}"
    _, _, g, d, shape, z_dim = FAMILIES[family]
    try:
        return jregistry.get(name)
    except KeyError:
        return jregistry.register(jregistry.DatasetSpec(
            name=name, shape=shape, z_dim=z_dim, make_generator=g, make_discriminator=d,
            load=lambda *a, **k: jbuiltin.synthesize(shape, 64, seed=1)))


def _close(got, want, rtol=1e-4, floor=1e-5, what=""):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=floor * np.abs(want).max(),
                               err_msg=what)


def _flat(tree):
    return np.concatenate([np.ravel(a) for a in jax.tree.leaves(tree)])


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


# --- dropout masks -----------------------------------------------------------

def record_masks(model, params, key, batch):
    """The keep masks ``model`` draws from dropout key ``key`` at batch
    ``batch``: an apply with each ``Dropout`` intercepted to draw its mask
    from the key it would use itself and to run with that key (compiled
    once per model and batch)."""
    return [torch.from_numpy(np.array(m)) for m in _mask_fn(model, batch)(params, key)]


@functools.lru_cache(maxsize=None)
def _mask_fn(model, batch):
    def masks_of(params, key):
        masks = []

        def interceptor(next_fun, args, kwargs, context):
            mod = context.module
            if isinstance(mod, fnn.Dropout) and context.method_name == "__call__":
                rng = mod.make_rng(mod.rng_collection)
                masks.append(jax.random.bernoulli(rng, 1.0 - mod.rate, args[0].shape))
                return next_fun(*args, **kwargs, rng=rng)
            return next_fun(*args, **kwargs)

        with fnn.intercept_methods(interceptor):
            model.apply({"params": params}, jnp.zeros((batch, *jmlp.SHAPE)), train=True,
                        rngs={"dropout": key})
        return masks

    return jax.jit(masks_of)


def mdgan_masks(jeng, jst, b):
    """Every D forward's masks of the JAX MD-GAN round at ``jst.step``, by
    the port's key paths: (l, w, half) for the D step (``_d_region``:
    ``fold_in(kdrop, l)``, ``fold_in(., w)``, ``split``), (L, w) for the
    feedback (``fold_in(kdrop, L)``, ``fold_in(., w)``)."""
    params = jax.tree.map(lambda a: a[0], jst.d.params)
    kdrop = jprng.for_step(jst.key, jprng.DROPOUT, jst.step)
    out = {}
    L = jeng.cfg.local_epochs
    for w in range(jeng.n):
        for l in range(L):
            halves = jax.random.split(jax.random.fold_in(jax.random.fold_in(kdrop, l), w))
            for half in (0, 1):
                out[(l, w, half)] = record_masks(jeng.d_model, params, halves[half], b)
        out[(L, w)] = record_masks(jeng.d_model, params,
                                   jax.random.fold_in(jax.random.fold_in(kdrop, L), w), b)
    return out


def standalone_masks(jeng, jst, b):
    """The JAX standalone round's masks by the port's key paths: (i, 0, half)
    for local epoch i's D step, (i, 1) for its G step (``rd, rg =
    split(fold_in(kdrop, i))``, ``r1, r2 = split(rd)``)."""
    kdrop = jprng.for_step(jst.key, jprng.DROPOUT, jst.step)
    out = {}
    for i in range(jeng.cfg.local_epochs):
        rd, rg = jax.random.split(jax.random.fold_in(kdrop, i))
        for half, key in enumerate(jax.random.split(rd)):
            out[(i, 0, half)] = record_masks(jeng.d_model, jst.d.params, key, b)
        out[(i, 1)] = record_masks(jeng.d_model, jst.d.params, rg, b)
    return out


def test_vmapped_dropout_draws_the_recorded_bits():
    """The engine's apply (``apply_train_pair``, vmapped over workers and
    over the real/fake halves, under ``jit``) draws the masks that the eager
    per-key apply records: the port with those masks gives its logits."""
    from mdgan_tpu.engine import state as jstate

    model = jmlp.MLPDiscriminator()
    x = np.random.default_rng(0).uniform(-1, 1, (2, 2, B, 28, 28, 1)).astype(np.float32)
    keys = jax.random.split(jax.random.key(5), 2)
    params = jax.vmap(lambda k: model.init({"params": k}, jnp.asarray(x[0, 0]),
                                           train=False)["params"])(keys)

    def pair(p, xw, k):
        return jstate.apply_train_pair(model, p, {}, xw, jax.random.split(k))[0]

    want = np.asarray(jax.jit(jax.vmap(pair))(params, jnp.asarray(x), keys))
    for w in range(2):
        pw = jax.tree.map(lambda a: a[w], params)
        port = from_jax.load_into(mlp_gan.MLPDiscriminator(), pw, {})
        for half, key in enumerate(jax.random.split(keys[w])):
            masks = record_masks(model, pw, key, B)
            with torch.no_grad():
                got = port(_nchw(x[w, half]), masks).numpy()
            _close(got, want[w, half], what=f"worker {w} half {half}")


def test_dropout_scale_is_jits_rounding():
    """flax's ``where(mask, x / 0.7, 0)`` under ``jit`` is a multiply by the
    float32 reciprocal, bit for bit the port's; eager JAX would divide."""
    x = np.random.default_rng(1).standard_normal((64, 1024)).astype(np.float32)
    mask = np.random.default_rng(2).uniform(size=x.shape) < 0.7
    layer = fnn.Dropout(0.3)
    want = jax.jit(lambda v, m: jnp.where(m, layer.apply({}, v, deterministic=True) / 0.7,
                                          0.0))(x, mask)
    got = torch.where(torch.from_numpy(mask), torch.from_numpy(x) * mlp_gan._KEEP_SCALE, 0.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_port_draws_its_own_masks_by_key():
    """Without injected masks the port's D draws from the DROPOUT lane: the
    same key path gives the same masks, another path other masks, and the
    keep rate is 0.7."""
    from mdgan_tpu_torch.core import prng

    def draw(*path):
        return mlp_gan.keep_masks(prng.reseed(torch.Generator(), 1, prng.DROPOUT, 3, *path),
                                  64, "cpu")

    a, b, c = draw(0, 1, 0), draw(0, 1, 0), draw(0, 1, 1)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    assert abs(float(torch.cat([m.flatten() for m in a]).float().mean()) - 0.7) < 0.01


# --- forwards and gradients ---------------------------------------------------

def _inputs(family, role, batch, seed=0):
    _, _, _, _, shape, z_dim = FAMILIES[family]
    rng = np.random.default_rng(seed)
    if role == "generator":
        return rng.standard_normal((batch, z_dim)).astype(np.float32)
    return rng.uniform(-1, 1, (batch, *shape)).astype(np.float32)


def _port_model(family, role):
    spec = registry.get(FAMILIES[family][0])
    kw = FAMILIES[family][1]
    widths = spec.g_widths if role == "generator" else spec.d_widths
    make = spec.make_generator if role == "generator" else spec.make_discriminator
    return make(**{k: kw[k] for k in widths if k in kw})


def _perturbed(tree, seed):
    """Params off their init (zero biases and gains made nonzero), so every
    leaf reaches the output and its gradient."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape)
                        .astype(np.float32), tree)


@pytest.mark.parametrize("role", ["generator", "discriminator"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_train_forward_and_gradients_match_jax(family, role):
    _, _, jg, jd, _, _ = FAMILIES[family]
    jm = (jg if role == "generator" else jd)()
    batch = 6 if family == "stylegan2" and role == "discriminator" else B
    x = _inputs(family, role, batch)
    v = jax.jit(functools.partial(jm.init, train=True))(
        {"params": jax.random.key(3), "dropout": jax.random.key(4)}, jnp.asarray(x))
    params, stats = _perturbed(v["params"], 5), v.get("batch_stats", {})
    key = jax.random.key(6)
    uses_dropout = family == "mlp" and role == "discriminator"
    rngs = {"dropout": key} if uses_dropout else None
    variables = {"params": params, **({"batch_stats": stats} if stats else {})}
    jout = jax.eval_shape(lambda xx: jm.apply(variables, xx, train=True, mutable=["batch_stats"],
                                              rngs=rngs)[0], jnp.asarray(x))
    cot = np.random.default_rng(7).standard_normal(jout.shape).astype(np.float32)

    @jax.jit
    def jgrads(p, xx):
        def jloss(p, xx):
            out, mutated = jm.apply({**variables, "params": p}, xx, train=True,
                                    mutable=["batch_stats"], rngs=rngs)
            return jnp.sum(out * cot), (out, mutated.get("batch_stats", {}))
        return jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(p, xx)

    (_, (jout, jstats)), (jgp, jgx) = jgrads(params, jnp.asarray(x))

    port = from_jax.load_into(_port_model(family, role), params, stats).train()
    xt = torch.from_numpy(x) if role == "generator" else _nchw(x)
    xt.requires_grad_(True)
    args = (record_masks(jm, params, key, batch),) if uses_dropout else ()
    out = port(xt, *args)
    to_nchw = (lambda a: np.asarray(a).transpose(0, 3, 1, 2)) if role == "generator" \
        else np.asarray
    cot_t = torch.from_numpy(np.ascontiguousarray(to_nchw(cot)))
    (out * cot_t).sum().backward()
    _close(out.detach().numpy(), to_nchw(jout), what="output")
    gx = xt.grad.numpy() if role == "generator" else xt.grad.numpy().transpose(0, 2, 3, 1)
    _close(gx, jgx, rtol=2e-4, what="input gradient")
    role_key = from_jax.role_of(port)
    # parameters off the path (StyleGAN2's noise gains) have no gradient: 0
    got = from_jax.params_to_jax({k: (torch.zeros_like(p) if p.grad is None else p.grad).numpy()
                                  for k, p in port.named_parameters()}, role_key)
    assert jax.tree.structure(got) == jax.tree.structure(jax.device_get(jgp))
    # the floor is of the network's largest gradient: a conv bias before
    # BatchNorm has a gradient of exactly 0, which both sides meet as noise
    scale = max(float(np.abs(np.asarray(b)).max()) for b in jax.tree.leaves(jgp))
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                            jax.tree.leaves(jgp)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=2e-4, atol=2e-5 * scale,
                                   err_msg=f"grad {jax.tree_util.keystr(path)}")
    _, got_stats = from_jax.export(port)
    assert jax.tree.structure(got_stats) == jax.tree.structure(jstats)
    for a, b in zip(jax.tree.leaves(got_stats), jax.tree.leaves(jstats)):
        _close(a, b, what="BN stats")


@pytest.mark.parametrize("family", list(FAMILIES))
def test_weight_maps_cover_every_jax_leaf(family):
    """Each family's map names every leaf of the JAX init, no more, with
    the shapes the port's modules have (0-d noise gains included)."""
    _, _, jg, jd, _, _ = FAMILIES[family]
    for role, jm in (("generator", jg()), ("discriminator", jd())):
        x = _inputs(family, role, B)
        v = jax.jit(functools.partial(jm.init, train=True))(
            {"params": jax.random.key(0), "dropout": jax.random.key(1)}, jnp.asarray(x))
        port = _port_model(family, role)
        entries = from_jax.entries(from_jax.role_of(port))
        want = {"/".join(p.key for p in path) for path, _ in
                jax.tree_util.tree_flatten_with_path(v["params"])[0]}
        assert {"/".join(e[1]) for e in entries if e[2] != "stat"} == want, (family, role)
        from_jax.load_into(port, v["params"], v.get("batch_stats", {}))
        params, stats = from_jax.export(port)
        for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(v["params"])):
            np.testing.assert_array_equal(a, np.asarray(b))
        assert bool(stats) == bool(v.get("batch_stats"))


# --- rounds ---------------------------------------------------------------------

def _conditioned(family, jst):
    """DCGAN-64's D with the biases of its biased convs (blocks 1 and 2) at
    zero.  At their init, U(+-1/sqrt(fan_in)), a channel's mean can dwarf its
    spread, and flax's fast variance E[x^2] - E[x]^2 then cancels in float32:
    the JAX feedback drifts from float64 by percents where the port's stays
    near it (``test_dcgan64_feedback_closer_to_float64_than_jax``).  A bias
    before BatchNorm has a zero gradient, so from zero it stays within a few
    Adam steps of zero, and the rounds stay well-conditioned."""
    if family != "dcgan64":
        return jst
    params = jax.device_get(jst.d.params)
    for blk in ("ConvBlock_1", "ConvBlock_2"):
        conv = params[blk]["Conv_0"]
        params[blk] = {**params[blk], "Conv_0": {**conv, "bias": np.zeros_like(conv["bias"])}}
    return jst.replace(d=jst.d.replace(params=params))


def _jit_init(jeng, seed):
    """``jeng.init_state(seed)`` as one compiled program: an eager init
    compiles every primitive of the vmapped flax init on its own, ~3x
    slower at these sizes.  The weights differ from the eager init's, and
    both sides start from them."""
    return jax.jit(jeng.init_state)(jnp.uint32(seed))


def _carry(pst, jst):
    """The JAX state (params, BN stats, Adam moments and count, step) into
    the port's."""
    for net, jnet in ((pst.g, jst.g), (pst.d, jst.d)):
        adam = jnet.opt[0]
        from_jax.load_net(net, jax.device_get(jnet.params), jax.device_get(jnet.stats),
                          jax.device_get(adam.mu), jax.device_get(adam.nu), int(adam.count))
    pst.step = int(jst.step)


class _Pair:
    """A JAX engine and the port's on one family and the same data."""

    def port_trees(self):
        return {"g": from_jax.export_net(self.pst.g), "d": from_jax.export_net(self.pst.d)}

    def _latents(self, num):
        kz = jprng.for_step(self.jst.key, jprng.LATENT, self.jst.step)
        return np.array(jax.random.normal(kz, (num, self.jeng.spec.z_dim)))


class MDGANPair(_Pair):
    def __init__(self, family, n=2, seed=3, batch=B):
        self.family, self.n, self.b = family, n, batch
        spec, kw = registry.get(FAMILIES[family][0]), FAMILIES[family][1]
        self.jeng = JaxEngine(_jax_spec(family), JaxTrainConfig(
            batch_size=batch, chunk_size=1, compute_dtype="float32", donate=False), n)
        self.peng = MDGANEngine(spec, TrainConfig(batch_size=batch, compute_dtype="float32",
                                                  device="cpu"), n, model_kwargs=kw)
        data, _ = builtin.synthesize(FAMILIES[family][4], 12 * n, seed=7)
        shards, _ = partitioner.shard_data(data, n, iid=True, seed=0)
        self.shard_size = shards.shape[1]
        self.jdata, self.pdata = self.jeng.shard_data(shards), self.peng.shard_data(shards)
        self.sampler = sampler.ShardSampler(n, shards.shape[1], batch, seed=0)
        self.jst = _conditioned(family, _jit_init(self.jeng, seed))
        self.pst = self.peng.init_state(seed=seed)

    def carry_jax_state(self):
        _carry(self.pst, self.jst)

    def round(self):
        """One round on both sides; returns (JAX metrics, port metrics,
        (JAX state, port trees) before it)."""
        idx = self.sampler.next_chunk(1)
        z = self._latents(self.jeng.k * self.b)
        masks = mdgan_masks(self.jeng, self.jst, self.b) if self.family == "mlp" else None
        before = (self.jst, self.port_trees())
        self.jst, jm = self.jeng.chunk_fn(1)(self.jst, self.jdata, jnp.asarray(idx))
        pm = self.peng.step(self.pst, self.pdata, self.peng.put_indices(idx[0], self.shard_size),
                            z=torch.from_numpy(z), masks=masks)
        jm = {k: np.asarray(v)[0] for k, v in jm.items() if k != "x_eval"}
        pm = {k: v.detach().numpy() for k, v in pm.items() if k != "x_eval"}
        return jm, pm, before


class StandalonePair(_Pair):
    def __init__(self, family, seed=3, batch=B):
        self.family, self.b = family, batch
        spec, kw = registry.get(FAMILIES[family][0]), FAMILIES[family][1]
        self.jeng = JaxStandalone(_jax_spec(family), JaxTrainConfig(
            batch_size=batch, compute_dtype="float32", donate=False))
        self.peng = StandaloneEngine(spec, TrainConfig(
            batch_size=batch, compute_dtype="float32", device="cpu"), model_kwargs=kw)
        self.data, _ = builtin.synthesize(FAMILIES[family][4], 24, seed=7)
        self.pdata = self.peng.put_data(self.data)
        self.sampler = sampler.ShardSampler(1, len(self.data), batch, seed=0)
        self.jst = _conditioned(family, _jit_init(self.jeng, seed))
        self.pst = self.peng.init_state(seed=seed)

    def round(self):
        """One teacher-forced round: the JAX state carried over first."""
        _carry(self.pst, self.jst)
        idx = self.sampler.next_chunk(1)
        z = self._latents(self.b)
        masks = standalone_masks(self.jeng, self.jst, self.b) if self.family == "mlp" else None
        before = (self.jst, self.port_trees())
        self.jst, jm = self.jeng.chunk_fn(1)(self.jst, jnp.asarray(self.data),
                                             jnp.asarray(idx[:, 0, :]))
        pm = self.peng.step(self.pst, self.pdata, self.peng.put_indices(idx[0], len(self.data)),
                            z=torch.from_numpy(z), masks=masks)
        return jm, pm, before


# Per family: the teacher-forced rounds checked, the loss rtol (feedback
# norm 2e-3 throughout), the largest share of parameter updates off by more
# than rtol 1e-2 plus the delta atol, the BN statistics' atol, and the delta
# atol.  The spread measured over seeds 1-6, rounds 0 and 1, with these
# pairs' compiled init (tests/test_torch_port_spread.py, family_rounds):
#   MLP: losses within 1.8e-7, under 0.001% of updates off.
#   StyleGAN2: losses within 2.1e-6, feedback norm 1.3e-5.  Much of its
#     mapping net's gradient (scaled by lr_mul 0.01) sits near Adam's eps
#     (1e-8), where a step is g/(|g|+eps) of lr and moves with the
#     gradient's last digits: up to 10.9% of G updates differ by more than
#     1e-6, 0.15% by more than 0.1*lr.  Its delta atol is 0.1*lr.
#   DCGAN-64, round 0: g_feedback_loss within 2.4e-4, feedback norm 1.0e-3,
#     0.88% of G updates off (by 2*lr: sign flips).  With four conv layers
#     in its D, the first Adam step's sign flips of noise-level D gradients
#     move the feedback by ~1e-3 and flip the sign-like G steps of the
#     elements whose gradient is that small.  The second round compounds
#     them by an amount that depends on the weights (0.38% of G updates
#     off here, 8% with the eager init's weights of the same seeds), so
#     DCGAN-64 is held on its first round.  Its conv biases before
#     BatchNorm have a zero gradient, so each Adam step moves them by lr
#     with the sign of float noise, and a running mean follows its bias at
#     momentum 0.1: the statistics' atol adds 0.1 * 2 * lr.
ROUND_TOL = {"mlp": (2, 2e-4, 0.005, 1e-6, 1e-6),
             "stylegan2": (2, 2e-4, 0.005, 1e-6, 0.1 * LR),
             "dcgan64": (1, 6e-4, 0.02, 1e-6 + 0.1 * 2.05 * LR, 1e-6)}


def check_metrics(jm, pm, rtol_loss, keys=("mean_d_loss", "g_feedback_loss")):
    for k in keys:
        np.testing.assert_allclose(pm[k], jm[k], rtol=rtol_loss, err_msg=k)
    if "feedback_norm" in jm:
        np.testing.assert_allclose(pm["feedback_norm"], jm["feedback_norm"], rtol=2e-3)


def check_deltas(jst_old, jst_new, pold, pnew, off_share, stats_atol, atol=1e-6):
    """Parameter updates sign-flip aware (``tests/test_torch_port_round.py``),
    BN statistics within float32 noise, no statistics where JAX has none."""
    for name in ("g", "d"):
        d_jax = (_flat(jax.device_get(getattr(jst_new, name).params))
                 - _flat(jax.device_get(getattr(jst_old, name).params)))
        d_port = _flat(pnew[name][0]) - _flat(pold[name][0])
        close = np.isclose(d_port, d_jax, rtol=1e-2, atol=atol)
        assert 1.0 - close.mean() < off_share, (name, 1.0 - close.mean())
        # a first Adam step moves an element by lr*sign(g); a later one by
        # at most lr*sqrt(2) (beta_1 = 0, beta_2 = 0.999)
        assert np.abs(d_port - d_jax).max() <= 2.9 * LR, name
        jstats = jax.device_get(getattr(jst_new, name).stats)
        if jax.tree.leaves(jstats):
            np.testing.assert_allclose(_flat(pnew[name][1]), _flat(jstats), rtol=2e-5,
                                       atol=stats_atol, err_msg=f"{name} BN stats")
        else:
            assert not jax.tree.leaves(pnew[name][1])


@pytest.mark.parametrize("family", list(FAMILIES))
def test_mdgan_round_matches_chunk_fn(family):
    """MD-GAN rounds at N=2, each from JAX's state (teacher-forced)."""
    rounds, rtol, off, stats_atol, atol = ROUND_TOL[family]
    pair = MDGANPair(family)
    for _ in range(rounds):
        pair.carry_jax_state()
        jm, pm, (jold, pold) = pair.round()
        check_metrics(jm, pm, rtol)
        check_deltas(jold, pair.jst, pold, pair.port_trees(), off, stats_atol, atol)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_standalone_round_matches_chunk_fn(family):
    rounds, rtol, off, stats_atol, atol = ROUND_TOL[family]
    pair = StandalonePair(family)
    for _ in range(rounds):
        jm, pm, (jold, pold) = pair.round()
        check_metrics({k: np.asarray(v)[0] for k, v in jm.items()},
                      {k: v.detach().numpy() for k, v in pm.items()}, rtol,
                      keys=("mean_d_loss", "mean_g_loss"))
        _close(pm["x_eval"].numpy(), np.asarray(jm["x_eval"]).transpose(0, 3, 1, 2),
               what="x_eval")
        check_deltas(jold, pair.jst, pold, pair.port_trees(), off, stats_atol, atol)


def test_dcgan64_feedback_closer_to_float64_than_jax():
    """Where the port and JAX part on DCGAN-64's feedback (its D at init,
    biased convs before BatchNorm), the port is the one near float64: flax's
    fast variance cancels in float32 when a channel's mean dwarfs its
    spread.  Same D weights, same images."""
    from mdgan_tpu.engine import state as jstate
    from mdgan_tpu.ops import losses as jlosses
    from mdgan_tpu_torch.ops import losses

    jm = FAMILIES["dcgan64"][3]()
    x = np.tanh(np.random.default_rng(3).standard_normal((B, 64, 64, 3))).astype(np.float32)
    init = jax.jit(functools.partial(jm.init, train=True))
    feedback = jax.jit(jax.grad(
        lambda xx, p, st: jlosses.g_loss(jstate.apply_train(jm, p, st, xx)[0])))
    worst = {"jax": 0.0, "port": 0.0}
    for seed in (4, 5):
        v = init(jax.random.key(seed), jnp.asarray(x))
        params, stats = jax.device_get(v["params"]), jax.device_get(v["batch_stats"])
        want = np.asarray(feedback(jnp.asarray(x), params, stats)).transpose(0, 3, 1, 2)
        port = from_jax.load_into(_port_model("dcgan64", "discriminator"), params, stats)
        grads = {}
        for dtype in (torch.float32, torch.float64):
            xt = _nchw(x).to(dtype).requires_grad_(True)
            (grads[dtype],) = torch.autograd.grad(losses.g_loss(port.to(dtype)(xt)), xt)
        truth = grads[torch.float64].numpy()
        scale = np.abs(truth).max()
        worst["jax"] = max(worst["jax"], np.abs(want - truth).max() / scale)
        worst["port"] = max(worst["port"], np.abs(grads[torch.float32].numpy() - truth).max()
                            / scale)
    assert worst["port"] < 1e-4, worst
    assert worst["jax"] >= worst["port"], worst


def golden_trajectories():
    """The SyntheticMNIST goldens of ``tests/test_golden.py`` (seed 42, N=2,
    b=4, 5 rounds, float32) run by the port with JAX's init weights, z,
    indices and dropout masks injected, free-running: {name: (port, golden)}."""
    jspec = jregistry.get("SyntheticMNIST")
    data, _ = jspec.load("data", max_examples=64)
    jcfg = JaxTrainConfig(batch_size=4, compute_dtype="float32", donate=False)
    out = {}
    for mode in ("mdgan", "standalone"):
        if mode == "mdgan":
            jeng = JaxEngine(jspec, jcfg, num_workers=2)
            peng = MDGANEngine(registry.get("SyntheticMNIST"), TrainConfig(
                batch_size=4, compute_dtype="float32", device="cpu"), 2)
            shards, _ = partitioner.shard_data(data, 2, iid=True, seed=0)
            pdata = peng.shard_data(shards)
            keys, masks_of, num_z = ("mean_d_loss", "g_feedback_loss"), mdgan_masks, jeng.k * 4
        else:
            jeng = JaxStandalone(jspec, jcfg)
            peng = StandaloneEngine(registry.get("SyntheticMNIST"), TrainConfig(
                batch_size=4, compute_dtype="float32", device="cpu"))
            shards = data[None]
            pdata = peng.put_data(data)
            keys, masks_of, num_z = ("mean_d_loss", "mean_g_loss"), standalone_masks, 4
        jst = jeng.init_state(seed=42)
        pst = peng.init_state(42)
        for net, jnet in ((pst.g, jst.g), (pst.d, jst.d)):
            from_jax.load_net(net, jax.device_get(jnet.params), jax.device_get(jnet.stats))
        idx = sampler.ShardSampler(shards.shape[0], shards.shape[1], 4, seed=0).next_chunk(5)
        got = {k: [] for k in keys}
        for t in range(5):
            at_t = jst.replace(step=jnp.int32(t))  # round t's keys; masks read shapes only
            z = np.array(jax.random.normal(jprng.for_step(jst.key, jprng.LATENT, t),
                                           (num_z, jmlp.Z_DIM)))
            m = peng.step(pst, pdata, peng.put_indices(idx[t], shards.shape[1]),
                          z=torch.from_numpy(z), masks=masks_of(jeng, at_t, 4))
            for k in keys:
                got[k].append(m[k].numpy())
        golden = {"mdgan mean_d_loss": test_golden.GOLDEN_MDGAN_D,
                  "mdgan g_feedback_loss": test_golden.GOLDEN_MDGAN_GFB,
                  "standalone mean_d_loss": test_golden.GOLDEN_STANDALONE_D,
                  "standalone mean_g_loss": test_golden.GOLDEN_STANDALONE_G}
        out.update({f"{mode} {k}": (np.stack(v), golden[f"{mode} {k}"]) for k, v in got.items()})
    return out


# The goldens pin JAX at rtol 2e-5 / atol 2e-6 (tests/test_golden.py); the
# port, free-running over the 5 rounds with JAX's draws injected, is within
# 1.1e-7 relative of them (tests/test_torch_port_spread.py, goldens), so
# it is held to the same bound.
GOLDEN_RTOL, GOLDEN_ATOL = 2e-5, 2e-6


def test_synthetic_mnist_goldens_reproduced():
    for key, (got, want) in golden_trajectories().items():
        np.testing.assert_allclose(got, want, rtol=GOLDEN_RTOL, atol=GOLDEN_ATOL, err_msg=key)


# --- the capped gather ----------------------------------------------------------

def test_split_chunk_equals_unsplit(monkeypatch):
    """A chunk whose gather is split by ``GATHER_CAP_BYTES`` runs the rounds
    the one-launch chunk runs, bit for bit, in ceil(T / rounds-per-launch)
    gathers."""
    t, n = 5, 2
    spec, kw = registry.get("CelebA"), FAMILIES["dcgan64"][1]
    eng = MDGANEngine(spec, TrainConfig(batch_size=B, compute_dtype="float32", device="cpu"),
                      n, model_kwargs=kw)
    shards, _ = partitioner.shard_data(builtin.synthesize((64, 64, 3), 40, seed=7)[0], n,
                                       iid=True, seed=0)
    data = eng.shard_data(shards)
    idx = sampler.ShardSampler(n, shards.shape[1], B, seed=0).next_chunk(t)

    class Fixed:
        def next_chunk(self, num):
            return idx

    calls = []
    plain = sampling.sample_normalize

    def counting(d, i):
        calls.append(i.shape[0])
        return plain(d, i)

    monkeypatch.setattr(mdgan_engine, "sample_normalize", counting)
    per_round = n * B * 64 * 64 * 3 * 4
    results = {}
    for cap, want in ((t * per_round, [5]), (2 * per_round + 1, [2, 2, 1]),
                      (per_round - 1, [1] * 5)):
        monkeypatch.setattr(mdgan_engine, "GATHER_CAP_BYTES", cap)
        calls.clear()
        st = eng.init_state(3)
        m = eng.run_rounds(st, data, Fixed(), t)
        assert calls == want, (cap, calls)
        results[cap] = (m, st)
    (m0, st0), *rest = results.values()
    for m, st in rest:
        for key in ("mean_d_loss", "g_feedback_loss", "feedback_norm", "x_eval"):
            assert torch.equal(m[key], m0[key]), key
        assert torch.equal(st.d.params, st0.d.params) and torch.equal(st.g.params, st0.g.params)


# --- data -----------------------------------------------------------------------

JAX_DATASETS = ("MNIST", "CIFAR10", "CelebA", "Synthetic32", "SyntheticMNIST", "FFHQ128")


def test_registry_has_every_jax_dataset():
    assert set(JAX_DATASETS) <= set(jregistry.available())
    for name in JAX_DATASETS:
        assert registry.get(name).shape == jregistry.get(name).shape
        assert registry.get(name).z_dim == jregistry.get(name).z_dim


@pytest.mark.parametrize("name,max_examples", [("SyntheticMNIST", 50), ("MNIST", 40),
                                               ("CelebA", 30), ("FFHQ128", 6),
                                               ("CIFAR10", 50000)])
def test_fallback_loaders_identical(tmp_path, name, max_examples):
    a, la = registry.get(name).load(str(tmp_path), max_examples=max_examples)
    b, lb = jregistry.get(name).load(str(tmp_path), max_examples=max_examples)
    assert a.dtype == np.uint8 and a.shape == b.shape
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(la, lb)


def _write_idx(path, array, gz):
    import gzip
    import struct

    header = struct.pack(">I", 0x0800 | array.ndim) + struct.pack(">" + "I" * array.ndim,
                                                                 *array.shape)
    opener = gzip.open if gz else open
    with opener(str(path) + (".gz" if gz else ""), "wb") as f:
        f.write(header + array.astype(np.uint8).tobytes())


@pytest.mark.parametrize("gz", [False, True])
def test_mnist_idx_identical(tmp_path, gz):
    rng = np.random.default_rng(0)
    (tmp_path / "mnist").mkdir()
    _write_idx(tmp_path / "mnist" / "train-images-idx3-ubyte",
               rng.integers(0, 256, (12, 28, 28)), gz)
    _write_idx(tmp_path / "mnist" / "train-labels-idx1-ubyte", rng.integers(0, 10, 12), gz)
    for cap in (None, 7):
        a, la = builtin.load_mnist(str(tmp_path), max_examples=cap)
        b, lb = jbuiltin.load_mnist(str(tmp_path), max_examples=cap)
        assert a.shape == (cap or 12, 28, 28, 1)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(la, lb)


def test_packed_npz_loaders_identical(tmp_path):
    rng = np.random.default_rng(1)
    (tmp_path / "celeba").mkdir()
    (tmp_path / "ffhq").mkdir()
    np.savez(tmp_path / "celeba" / "celeba64.npz",
             images=rng.integers(0, 256, (5, 64, 64, 3), dtype=np.uint8))
    np.savez(tmp_path / "ffhq" / "ffhq128.npz",
             images=rng.integers(0, 256, (4, 128, 128, 3), dtype=np.uint8),
             labels=np.arange(4))
    for name in ("CelebA", "FFHQ128"):
        a, la = registry.get(name).load(str(tmp_path), max_examples=3)
        b, lb = jregistry.get(name).load(str(tmp_path), max_examples=3)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(la, lb)


def test_celeba_jpg_folder_identical(tmp_path):
    Image = pytest.importorskip("PIL.Image")
    folder = tmp_path / "img_align_celeba"
    folder.mkdir()
    rng = np.random.default_rng(2)
    for i, (h, w) in enumerate(((90, 70), (70, 90), (64, 64))):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
            folder / f"{i:06d}.jpg")
    a, _ = builtin.load_celeba(str(tmp_path))
    b, _ = jbuiltin.load_celeba(str(tmp_path))
    assert a.shape == (3, 64, 64, 3)
    np.testing.assert_array_equal(a, b)


# --- exports, resume and the CLI -----------------------------------------------

@pytest.mark.parametrize("family", list(FAMILIES))
def test_exports_read_by_jax_and_equal_its_apply(tmp_path, family):
    spec, kw = registry.get(FAMILIES[family][0]), FAMILIES[family][1]
    eng = MDGANEngine(spec, TrainConfig(batch_size=B, compute_dtype="float32", device="cpu"),
                      2, model_kwargs=kw)
    st = eng.init_state(9)
    _, _, jg, jd, _, _ = FAMILIES[family]
    ckpt.save_net_weights(tmp_path / "g.npz", st.g)
    d_trees = from_jax.export_net(st.d)
    ckpt.save_weights_only(tmp_path / "d.npz", *(from_jax.index_tree(t, 1) for t in d_trees))
    for role, path, jm, module in (("generator", "g.npz", jg(), st.g.modules[0]),
                                   ("discriminator", "d.npz", jd(), st.d.modules[1])):
        params, stats = jckpt.load_weights_only(tmp_path / path)
        x = _inputs(family, role, B, seed=4)
        variables = {"params": params, **({"batch_stats": stats} if stats else {})}
        # train mode without dropout: the MLP's D in eval mode on both sides
        train = not (family == "mlp" and role == "discriminator")
        want = np.asarray(jm.apply(variables, jnp.asarray(x), train=train,
                                   mutable=["batch_stats"])[0])
        saved = {k: v.clone() for k, v in module.state_dict().items()}
        with torch.no_grad():
            got = module(torch.from_numpy(x) if role == "generator" else _nchw(x)).numpy()
        module.load_state_dict(saved)
        if role == "generator":
            want = want.transpose(0, 3, 1, 2)
        _close(got, want, what=f"{family} {role}")


@pytest.fixture()
def stub_inception(monkeypatch):
    """FID/IS stubbed, as ``tests/test_torch_port_round.py`` stubs them."""
    from mdgan_tpu_torch.metrics import fid as fid_mod

    class FakeTracker:
        def __init__(self, real, device=None):
            assert real.shape[1:] == (28, 28, 1)

        def score(self, fakes):
            assert fakes.shape[1:] == (28, 28, 1)
            return 100.0

        def inception_score(self, fakes, splits=1):
            return (1.5, 0.0)

    monkeypatch.setattr(fid_mod, "FIDTracker", FakeTracker)


def _argv(root, mode, epochs, *extra):
    argv = ["--mode", mode, "--dataset", "SyntheticMNIST", "--num_workers", "2",
            "--batch_size", "4", "--epochs", str(epochs), "--swap_interval", "3",
            "--log_interval", "2", "--checkpoint_interval", "2", "--chunk_size", "2",
            "--compute_dtype", "float32", "--device", "cpu", "--max_examples", "64"]
    for flag in ("log_dir", "image_dir", "weights_dir", "checkpoint_dir"):
        argv += [f"--{flag}", str(root / flag)]
    return argv + list(extra)


@pytest.mark.parametrize("mode", ["mdgan", "standalone"])
def test_mlp_resume_is_bit_identical(tmp_path, stub_inception, mode):
    """8 rounds equal 4 plus ``--resume`` for 4, bit for bit, with an empty
    stats arena on both nets."""
    from mdgan_tpu_torch.engine import train_loop

    def run(root, epochs, *extra):
        cfg = cli.config_from_args(cli.build_parser().parse_args(
            _argv(root, mode, epochs, *extra)))
        trainer = (train_loop.MDGANTrainer if mode == "mdgan"
                   else train_loop.StandaloneTrainer)(cfg)
        try:
            trainer.train()
        finally:
            trainer.close()
        return trainer.state

    full = run(tmp_path / "full", 8)
    run(tmp_path / "split", 4)
    resumed = run(tmp_path / "split", 8, "--resume")
    assert resumed.step == full.step == 8
    for name in ("g", "d"):
        a, b = getattr(full, name), getattr(resumed, name)
        assert a.stats.numel() == 0
        for arena in ("params", "mu", "nu"):
            assert torch.equal(getattr(a, arena), getattr(b, arena)), (name, arena)


@pytest.mark.parametrize("mode", ["mdgan", "standalone"])
def test_cli_synthetic_mnist_on_cpu(capsys, tmp_path, stub_inception, mode):
    rc = cli.main(_argv(tmp_path, mode, 5))
    assert rc == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["rounds"] == 5 and summary["all_finite"] and summary["device"] == "cpu"
    assert summary["evals"] and all(e["fid"] == 100.0 for e in summary["evals"])
    grids = sorted((tmp_path / "image_dir").glob("*.png"))
    assert grids
    from mdgan_tpu_torch.obs.images import load_png

    assert load_png(grids[0]).ndim == 2  # one channel: a grayscale PNG
    exports = sorted((tmp_path / "weights_dir").rglob("*.npz"))
    assert exports
    params, stats = jckpt.load_weights_only(exports[-1])
    assert params and not stats
