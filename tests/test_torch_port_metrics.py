"""The port's InceptionV3, FID and IS against ``mdgan_tpu/metrics``, on the CPU.

Each Inception block is built on both sides at a small spatial size; the
JAX block's random-init variables (with random frozen statistics) cross
through ``from_jax.inception_to_port`` into the port's ``load_state_dict``.
Both graph variants are checked.  Measured spread of the block outputs
(float32, CPU, both variants, seeds 0 and 5; ``tests/test_torch_port_spread.py``):
at most 9.1e-7 of the output's
largest magnitude, so the bound is rtol 1e-4 with an absolute floor of 1e-4
times that magnitude.  The calibration pass
(momentum 0) must write the statistics flax's train-mode BatchNorm writes.
FID/IS math is compared on identical features (rtol 1e-6).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import mdgan_tpu.metrics.fid as jfid
from mdgan_tpu.metrics import inception as jinception
from mdgan_tpu_torch.metrics import fid as pfid
from mdgan_tpu_torch.metrics import inception as pinception
from mdgan_tpu_torch.models import from_jax

RTOL = 1e-4

# (name, JAX module, port module, input channels, spatial size)
BLOCKS = [
    ("BasicConv", lambda fid: jinception.BasicConv(16, (3, 3), padding=((1, 1), (1, 1))),
     lambda fid: pinception.BasicConv(8, 16, 3, padding=1), 8, 7),
    ("BasicConv_s2", lambda fid: jinception.BasicConv(16, (3, 3), strides=(2, 2)),
     lambda fid: pinception.BasicConv(8, 16, 3, stride=2), 8, 9),
    ("InceptionA", lambda fid: jinception.InceptionA(8, fid),
     lambda fid: pinception.InceptionA(16, 8, fid), 16, 7),
    ("InceptionB", lambda fid: jinception.InceptionB(),
     lambda fid: pinception.InceptionB(16), 16, 9),
    ("InceptionC", lambda fid: jinception.InceptionC(8, fid),
     lambda fid: pinception.InceptionC(16, 8, fid), 16, 7),
    ("InceptionD", lambda fid: jinception.InceptionD(),
     lambda fid: pinception.InceptionD(16), 16, 9),
    ("InceptionE", lambda fid: jinception.InceptionE(fid),
     lambda fid: pinception.InceptionE(16, fid), 16, 5),
    ("InceptionE_maxpool", lambda fid: jinception.InceptionE(fid, max_branch_pool=fid),
     lambda fid: pinception.InceptionE(16, fid, max_branch_pool=fid), 16, 5),
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small tensors: extra threads
    buy nothing at these sizes and spin against the other test processes
    the suite runs beside this one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)



def _randomize_stats(variables, rng):
    """Frozen statistics away from 0/1, so the inference path is exercised."""
    stats = jax.tree.map(lambda a: np.asarray(a), variables["batch_stats"])

    def fill(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                fill(v)
            elif k == "mean":
                tree[k] = rng.normal(0, 0.5, v.shape).astype(np.float32)
            else:
                tree[k] = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)

    fill(stats)
    return {"params": jax.tree.map(np.asarray, variables["params"]), "batch_stats": stats}


def _pair(make_jax, make_port, cin, size, fid, seed=0):
    jmod = make_jax(fid)
    x = np.random.default_rng(seed).normal(0, 1, (2, size, size, cin)).astype(np.float32)
    variables = jmod.init(jax.random.key(seed), jnp.asarray(x))
    variables = _randomize_stats(variables, np.random.default_rng(seed + 1))
    port = make_port(fid)
    port.load_state_dict({k: torch.from_numpy(v)
                          for k, v in from_jax.inception_to_port(variables).items()})
    return jmod, variables, port, x


def _close(got, want):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale)


@pytest.mark.parametrize("fid", [False, True], ids=["torchvision", "fid_compat"])
@pytest.mark.parametrize("block", BLOCKS, ids=[b[0] for b in BLOCKS])
def test_block_inference_matches_flax(block, fid):
    _, make_jax, make_port, cin, size = block
    jmod, variables, port, x = _pair(make_jax, make_port, cin, size, fid)
    want = np.asarray(jmod.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    _close(got, want)


@pytest.mark.parametrize("block", BLOCKS[:3] + BLOCKS[-1:], ids=lambda b: b[0])
def test_block_calibration_matches_flax_train_mode(block):
    """One momentum-0 train-mode pass: the output and every written
    statistic equal flax's ``apply(..., True, mutable=["batch_stats"])``."""
    _, make_jax, make_port, cin, size = block
    fid = True
    jmod, variables, port, x = _pair(make_jax, make_port, cin, size, fid, seed=3)
    want, mutated = jmod.apply(variables, jnp.asarray(x), True, mutable=["batch_stats"])
    bns = [m for m in port.modules() if isinstance(m, pinception.FrozenBN)]
    for m in bns:
        m.calibrating = True
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    _close(got, np.asarray(want))
    want_stats = from_jax.inception_to_port({"params": {}, "batch_stats": jax.tree.map(
        np.asarray, mutated["batch_stats"])})
    state = port.state_dict()
    assert set(want_stats) <= set(state)
    for k, v in want_stats.items():
        np.testing.assert_allclose(state[k].numpy(), v, rtol=RTOL,
                                   atol=RTOL * float(np.abs(v).max()), err_msg=k)


def test_whole_network_names_and_shapes_match_flax():
    """Every leaf of the JAX InceptionV3 maps onto a port tensor of the same
    size, both variants (1000 and 1008 classes), and nothing is left over."""
    for fid, classes in ((False, 1000), (True, 1008)):
        shapes = jax.eval_shape(
            lambda: jinception.InceptionV3(num_classes=classes, fid_variant=fid).init(
                jax.random.key(0), jnp.zeros((1, 299, 299, 3))))
        fake = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
        mapped = from_jax.inception_to_port(fake)
        port = pinception.InceptionV3(num_classes=classes, fid_variant=fid).state_dict()
        assert set(mapped) == set(port)
        for k, v in mapped.items():
            assert v.shape == tuple(port[k].shape), k


@pytest.mark.parametrize("channels", [1, 3])
def test_preprocessing_matches_jax(channels):
    """Channel repeat, bilinear resize to 299 (align_corners=False) and
    x*2-1, as the JAX extractor's ``jax.image.resize``."""
    x = np.random.default_rng(0).uniform(0, 1, (2, 32, 32, channels)).astype(np.float32)
    xj = np.repeat(x, 3, axis=-1) if channels == 1 else x
    want = np.asarray(jax.image.resize(jnp.asarray(xj), (2, 299, 299, 3), "bilinear")) * 2 - 1
    got = pinception._to_input(x, "cpu").permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


def _features(images):
    """A fixed function of the images standing in for the network: 16-d
    features and 10-way probabilities."""
    flat = np.asarray(images, np.float64).reshape(len(images), -1)
    proj = np.random.default_rng(7).normal(0, 1, (flat.shape[1], 26))
    z = flat @ proj / np.sqrt(flat.shape[1])
    logits = z[:, 16:]
    probs = np.exp(logits - logits.max(1, keepdims=True))
    return z[:, :16], probs / probs.sum(1, keepdims=True)


@pytest.fixture()
def same_features(monkeypatch):
    monkeypatch.setattr(jfid, "inception_features", lambda x, **kw: _features(x))
    monkeypatch.setattr(jinception, "calibrated_variables", lambda x: None)
    monkeypatch.setattr(pfid, "inception_features", lambda x, *a, **kw: _features(x))
    monkeypatch.setattr(pfid, "calibrated_stats", lambda x, *a, **kw: None)


@pytest.mark.parametrize("n_real,n_fake", [(5, 5), (40, 30), (40, 5)],
                         ids=["low_rank", "dense", "mixed"])
def test_fid_and_is_math_equal_jax(same_features, n_real, n_fake):
    rng = np.random.default_rng(n_real + n_fake)
    real = rng.uniform(0, 1, (n_real, 4, 4, 3)).astype(np.float32)
    fake = rng.uniform(0, 1, (n_fake, 4, 4, 3)).astype(np.float32) ** 2
    jt, pt = jfid.FIDTracker(real), pfid.FIDTracker(real, device="cpu")
    np.testing.assert_allclose(pt.score(fake), jt.score(fake), rtol=1e-6)
    for splits in (1, 5):
        np.testing.assert_allclose(pt.inception_score(fake, splits),
                                   jt.inception_score(fake, splits), rtol=1e-6)
    np.testing.assert_allclose(pfid.frechet_from_features(*map(lambda a: _features(a)[0],
                                                               (real, fake))),
                               jfid.frechet_from_features(*map(lambda a: _features(a)[0],
                                                               (real, fake))), rtol=1e-6)


class _SmallInception(torch.nn.Module):
    """The ``InceptionV3`` interface on one strided ``BasicConv``: (pool
    features, logits) from (b, 3, 299, 299)."""

    def __init__(self):
        super().__init__()
        self.stem = pinception.BasicConv(3, 8, 3, stride=8)
        self.fc = torch.nn.Linear(8, 10)

    def forward(self, x):
        feats = self.stem(x).mean(dim=(2, 3))
        return feats, self.fc(feats)


def test_tracker_is_deterministic_and_calibration_pure(monkeypatch):
    """Through the port's calibration, cache and feature path (on a small
    network, so the 299x299 forwards stay cheap): finite scores, the same
    for two trackers on the same reals whatever was calibrated between,
    and calibration leaves the base statistics alone."""
    model = pinception.random_init_(_SmallInception()).eval().requires_grad_(False)
    base = {k: v.clone() for k, v in model.named_buffers()}
    monkeypatch.setattr(pinception, "_CACHED", {"cpu": (model, "random-init",
                                                        {k: v.clone() for k, v in base.items()})})
    monkeypatch.setattr(pinception, "_CALIB_CACHE", {})
    rng = np.random.default_rng(0)
    real = rng.uniform(0, 1, (4, 16, 16, 3)).astype(np.float32)
    fake = rng.uniform(0, 1, (3, 16, 16, 3)).astype(np.float32)
    a = pfid.FIDTracker(real, device="cpu")
    pfid.FIDTracker(fake, device="cpu")  # another calibration in between
    pinception._CALIB_CACHE.clear()
    b = pfid.FIDTracker(real, device="cpu")
    assert not torch.equal(a.stats["stem.bn.running_var"], base["stem.bn.running_var"])
    for k, v in pinception._CACHED["cpu"][2].items():  # the base statistics
        assert torch.equal(v, base[k]), k
    assert np.isfinite(a.score(fake)) and a.score(fake) == b.score(fake)
    assert a.inception_score(fake) == b.inception_score(fake)
    assert pinception.feature_source("cpu") == "random-init"


@pytest.mark.slow
def test_whole_network_matches_flax_at_299():
    """JAX's random-init InceptionV3 carried across whole: calibrated
    statistics equal ``calibrated_variables``, and features and probabilities
    equal ``inception_features`` under them."""
    rng = np.random.default_rng(1)
    imgs = rng.uniform(0, 1, (4, 32, 32, 3)).astype(np.float32)
    _, variables, _ = jinception.get_inception()
    port = pinception.InceptionV3()
    port.load_state_dict({k: torch.from_numpy(v) for k, v in from_jax.inception_to_port(
        jax.tree.map(np.asarray, dict(variables))).items()})
    port.eval()
    jvars = jinception.calibrated_variables(imgs)
    bns = [m for m in port.modules() if isinstance(m, pinception.FrozenBN)]
    for m in bns:
        m.calibrating = True
    with torch.no_grad():
        port(pinception._to_input(imgs, "cpu"))
    for m in bns:
        m.calibrating = False
    want = from_jax.inception_to_port({"params": {}, "batch_stats": jax.tree.map(
        np.asarray, jvars["batch_stats"])})
    state = port.state_dict()
    for k, v in want.items():
        np.testing.assert_allclose(state[k].numpy(), v, rtol=1e-3,
                                   atol=1e-3 * float(np.abs(v).max()), err_msg=k)
    jf, jp = jinception.inception_features(imgs, variables=jvars)
    with torch.no_grad():
        feats, logits = port(pinception._to_input(imgs, "cpu"))
    np.testing.assert_allclose(feats.numpy(), jf, rtol=1e-3, atol=1e-3 * np.abs(jf).max())
    np.testing.assert_allclose(torch.softmax(logits, -1).numpy(), jp, rtol=1e-3, atol=1e-6)
