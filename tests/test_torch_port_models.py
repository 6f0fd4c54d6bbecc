"""mdgan_tpu_torch DCGAN-32 against the flax models, on the CPU.

The same weights (flax's init, carried over by ``models/from_jax.py``) and the
same inputs go through both; train-mode outputs and the updated BatchNorm
running statistics must agree (rtol 1e-4, atol 1e-5: float32 convolutions
summed in different orders).
"""

from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from mdgan_tpu.models.dcgan32 import DCGANDiscriminator32 as JaxD
from mdgan_tpu.models.dcgan32 import DCGANGenerator32 as JaxG
from mdgan_tpu_torch.models import from_jax
from mdgan_tpu_torch.models.dcgan32 import DCGANDiscriminator32, DCGANGenerator32

GOLDEN = Path(__file__).resolve().parents[1] / "artifacts/golden/cifar10_w8_r2000/weights"
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small tensors: extra threads
    buy nothing at these sizes and spin against the other test processes
    the suite runs beside this one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)



def _flax_train(model, params, stats, x):
    out, mutated = model.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                               train=True, mutable=["batch_stats"])
    return np.asarray(out), jax.tree.map(np.asarray, mutated["batch_stats"])


def _torch_input(role, x):
    return torch.from_numpy(x if role == "generator" else x.transpose(0, 3, 1, 2).copy())


def _compare(role, jax_model, port, params, stats, x):
    want, want_stats = _flax_train(jax_model, params, stats, x)
    from_jax.load_into(port, params, stats)
    with torch.no_grad():
        got = port.train()(_torch_input(role, x)).numpy()
    if role == "generator":
        want = want.transpose(0, 3, 1, 2)  # NHWC -> NCHW
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    _, got_stats = from_jax.export(port)
    for a, b in zip(jax.tree.leaves(got_stats), jax.tree.leaves(want_stats)):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("width", [8, 64])
@pytest.mark.parametrize("role", ["generator", "discriminator"])
def test_train_forward_and_bn_stats_match_flax(role, width):
    rng = np.random.default_rng(width)
    if role == "generator":
        jm, port = JaxG(ngf=width), DCGANGenerator32(ngf=width)
        x = rng.standard_normal((6, 100)).astype(np.float32)
    else:
        jm, port = JaxD(ndf=width), DCGANDiscriminator32(ndf=width)
        x = rng.uniform(-1, 1, (6, 32, 32, 3)).astype(np.float32)
    v = jm.init({"params": jax.random.key(width)}, jnp.asarray(x), train=True)
    # non-trivial running stats, so the momentum update is visible
    stats = jax.tree.map(lambda a: np.asarray(a) + 0.5, v["batch_stats"])
    _compare(role, jm, port, v["params"], stats, x)


@pytest.mark.parametrize("role", ["generator", "discriminator"])
def test_export_round_trips(role):
    port = DCGANGenerator32(ngf=8) if role == "generator" else DCGANDiscriminator32(ndf=8)
    torch.manual_seed(0)
    for p in port.parameters():
        torch.nn.init.normal_(p)
    params, stats = from_jax.export(port)
    other = DCGANGenerator32(ngf=8) if role == "generator" else DCGANDiscriminator32(ndf=8)
    from_jax.load_into(other, params, stats)
    for a, b in zip(port.state_dict().values(), other.state_dict().values()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("role,path", [
    ("generator", GOLDEN / "generator_final.npz"),
    ("discriminator", GOLDEN / "worker_1" / "discriminator.npz"),
])
def test_golden_weights_forward_matches_flax(role, path):
    params, stats = from_jax.load_npz(path)
    rng = np.random.default_rng(7)
    if role == "generator":
        jm, port = JaxG(), DCGANGenerator32()
        x = rng.standard_normal((8, 100)).astype(np.float32)
    else:
        jm, port = JaxD(), DCGANDiscriminator32()
        x = rng.uniform(-1, 1, (8, 32, 32, 3)).astype(np.float32)
    _compare(role, jm, port, params, stats, x)


def test_load_into_rejects_wrong_width():
    params, stats = from_jax.load_npz(GOLDEN / "generator_final.npz")
    with pytest.raises(ValueError, match="shape"):
        from_jax.load_into(DCGANGenerator32(ngf=8), params, stats)
