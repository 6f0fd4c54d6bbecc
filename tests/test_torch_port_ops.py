"""mdgan_tpu_torch ops against the JAX package's, on the CPU.

Inputs come from ``np.random.default_rng``; the JAX side runs its Pallas
kernels in interpret mode (as ``tests/test_ops.py`` does) and the port side
its wrappers on CPU tensors, which run the kernels' plain versions.
"""

import collections
import ctypes
import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from mdgan_tpu.ops import losses as jlosses
from mdgan_tpu.ops.adam import FusedAdam
from mdgan_tpu.ops.sampling import sample_normalize as jax_sample_normalize
from mdgan_tpu_torch.ops import _build, adam, losses, sampling


@pytest.mark.parametrize("name", ["bce_real", "bce_fake", "g_loss", "denormalize_to_unit"])
def test_unary_losses_match_jax(name):
    x = np.random.default_rng(0).normal(0, 4, (64,)).astype(np.float32)
    x[:4] = [30.0, -30.0, 0.0, 1e-3]  # saturated and tiny logits
    want = np.asarray(getattr(jlosses, name)(jnp.asarray(x)))
    got = getattr(losses, name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_d_loss_matches_jax():
    rng = np.random.default_rng(1)
    r, f = (rng.normal(0, 3, (10,)).astype(np.float32) for _ in range(2))
    want = float(jlosses.d_loss(jnp.asarray(r), jnp.asarray(f)))
    got = float(losses.d_loss(torch.from_numpy(r), torch.from_numpy(f)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_normalize_uint8_matches_jitted_jax_bit_equal():
    """Under jit (the JAX engine's path) XLA rounds x * (2/255) - 1 once."""
    x = np.arange(256, dtype=np.uint8)
    want = np.asarray(jax.jit(jlosses.normalize_uint8)(jnp.asarray(x)))
    got = losses.normalize_uint8(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


# lane-aligned leaves with >= 8 rows take FusedAdam's Pallas path
_SPECS = [("conv", (4, 4, 8, 128)), ("stacked", (2, 4, 4, 128)), ("vec", (16, 128))]


@pytest.mark.parametrize("b1,b2", [(0.0, 0.999), (0.5, 0.999)])
def test_adam_plain_matches_fused_adam_and_optax(b1, b2):
    lr, eps = 2e-4, 1e-8
    rng = np.random.default_rng(2)
    params = {k: rng.normal(0, 0.02, s).astype(np.float32) for k, s in _SPECS}
    grads = [{k: rng.normal(0, 1e-2, s).astype(np.float32) for k, s in _SPECS}
             for _ in range(3)]

    tx = optax.adam(lr, b1=b1, b2=b2, eps=eps)
    fused = FusedAdam(lr=lr, b1=b1, b2=b2, eps=eps)
    p_ref = {k: jnp.asarray(v) for k, v in params.items()}
    o_ref = tx.init(p_ref)
    p_fus, o_fus = dict(p_ref), o_ref

    flat = lambda tree: torch.from_numpy(  # noqa: E731
        np.concatenate([np.asarray(tree[k]).ravel() for k, _ in _SPECS]))
    p, mu, nu = flat(params), torch.zeros(flat(params).numel()), torch.zeros(flat(params).numel())
    for t, g in enumerate(grads, start=1):
        jg = {k: jnp.asarray(v) for k, v in g.items()}
        upd, o_ref = tx.update(jg, o_ref, p_ref)
        p_ref = optax.apply_updates(p_ref, upd)
        p_fus, o_fus = fused.update_in_place(jg, o_fus, p_fus)
        lr_c1, inv_c2 = adam.bias_scalars(lr, b1, b2, t)
        adam.adam_update(p, flat(g), mu, nu, lr_c1, inv_c2, b1, b2, eps)
        for want in (p_ref, p_fus):
            np.testing.assert_allclose(p.numpy(), flat(want).numpy(), rtol=1e-6, atol=1e-9,
                                       err_msg=f"step {t}")
        np.testing.assert_allclose(mu.numpy(), flat(o_ref[0].mu).numpy(), rtol=1e-6, atol=1e-12)
        np.testing.assert_allclose(nu.numpy(), flat(o_ref[0].nu).numpy(), rtol=1e-6, atol=1e-14)
    assert _build.launches["mdgan_adam_f32"] == 0  # the CPU path launches no kernel


def test_sampling_plain_matches_pallas_bit_equal():
    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, (3, 40, 32, 32, 3), dtype=np.uint8)
    idx = rng.integers(0, 40, (3, 5)).astype(np.int32)
    want = np.asarray(jax_sample_normalize(jnp.asarray(data), jnp.asarray(idx)))
    want = want.reshape(3, 5, 32, 32, 3).transpose(0, 1, 4, 2, 3)
    got = sampling.sample_normalize(torch.from_numpy(data), torch.from_numpy(idx))
    assert got.shape == (3, 5, 3, 32, 32) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert _build.launches["mdgan_sample_normalize_u8"] == 0


@pytest.mark.parametrize("t,shape", [(4, (32, 32, 3)), (3, (8, 8, 2))], ids=["cifar", "row128"])
def test_sampling_chunk_plain_matches_stacked_pallas_bit_equal(t, shape):
    """(T, N, b) indices: one plain gather equals T stacked Pallas calls."""
    rng = np.random.default_rng(4)
    data = rng.integers(0, 256, (3, 40, *shape), dtype=np.uint8)
    idx = rng.integers(0, 40, (t, 3, 5)).astype(np.int32)
    want = np.stack([np.asarray(jax_sample_normalize(jnp.asarray(data), jnp.asarray(idx[r])))
                     for r in range(t)])
    h, w, c = shape
    want = want.reshape(t, 3, 5, h, w, c).transpose(0, 1, 2, 5, 3, 4)
    shards, tidx = torch.from_numpy(data), torch.from_numpy(idx)
    plain = sampling.sample_normalize_plain(shards, tidx)
    got = sampling.sample_normalize(shards, tidx)
    assert got.shape == (t, 3, 5, c, h, w) and got.dtype == torch.float32
    np.testing.assert_array_equal(plain.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), want)
    assert _build.launches["mdgan_sample_normalize_u8"] == 0


def _arena(n=64):
    return [torch.zeros(n) for _ in range(4)]


@pytest.mark.parametrize("bad", ["dtype", "shape", "noncontiguous", "meta"])
def test_adam_wrapper_rejects(bad):
    p, g, mu, nu = _arena()
    if bad == "dtype":
        g = g.double()
    elif bad == "shape":
        g = torch.zeros(8, 8)
    elif bad == "noncontiguous":
        g = torch.zeros(128)[::2]
    else:
        p, g, mu, nu = (t.to("meta") for t in (p, g, mu, nu))
    with pytest.raises((TypeError, ValueError)):
        adam.adam_update(p, g, mu, nu, 1e-4, 1.0, 0.0, 0.999, 1e-8)


@pytest.mark.parametrize("bad", ["idx_dtype", "shards_dtype", "workers", "meta"])
def test_sampling_wrapper_rejects(bad):
    shards = torch.zeros(2, 4, 2, 2, 3, dtype=torch.uint8)
    idx = torch.zeros(2, 3, dtype=torch.int32)
    if bad == "idx_dtype":
        idx = idx.long()
    elif bad == "shards_dtype":
        shards = shards.float()
    elif bad == "workers":
        idx = torch.zeros(3, 3, dtype=torch.int32)
    else:
        shards, idx = shards.to("meta"), idx.to("meta")
    with pytest.raises(ValueError):
        sampling.sample_normalize(shards, idx)


@pytest.mark.parametrize("bad", ["workers", "dtype", "noncontiguous", "ndim"])
def test_sampling_wrapper_rejects_chunk_idx(bad):
    shards = torch.zeros(2, 4, 2, 2, 3, dtype=torch.uint8)
    idx = {"workers": torch.zeros(5, 3, 3, dtype=torch.int32),
           "dtype": torch.zeros(5, 2, 3, dtype=torch.int64),
           "noncontiguous": torch.zeros(5, 2, 6, dtype=torch.int32)[..., ::2],
           "ndim": torch.zeros(1, 5, 2, 3, dtype=torch.int32)}[bad]
    with pytest.raises(ValueError):
        sampling.sample_normalize(shards, idx)


def test_build_command_and_missing_nvcc(monkeypatch, tmp_path):
    cmd = _build.command(tmp_path / "nvcc", tmp_path / "lib.so")
    for flag in ("arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared", "-fPIC"):
        assert flag in cmd
    assert "--use_fast_math" not in cmd
    assert [c for c in cmd if c.endswith(".cu")] == [str(_build.CSRC / s) for s in _build.SOURCES]
    monkeypatch.setattr(_build, "nvcc_candidates", lambda: [tmp_path / "none" / "nvcc"])
    with pytest.raises(RuntimeError, match="arch=compute_90a"):
        _build.find_nvcc()


def test_library_name_tracks_sources(monkeypatch, tmp_path):
    for name in _build.SOURCES:
        (tmp_path / name).write_bytes((_build.CSRC / name).read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build.library_path()
    assert before.parent == _build.BUILD_DIR and _build.source_hash() in before.name
    (tmp_path / _build.SOURCES[0]).write_bytes(b"// changed\n")
    assert _build.library_path() != before


def test_launch_refuses_a_count_off_the_signature(monkeypatch):
    """``_build.launch`` holds every call to its entry's ``SIGNATURES`` row
    before it reaches the library (a stub here: no card runs), and counts
    only the launches that ran, by entry point and plan."""
    calls = []

    class Lib:
        def mdgan_sample_normalize_u8(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(_build, "lib", lambda: Lib())
    monkeypatch.setattr(_build, "launches", collections.Counter())
    want = len(_build.SIGNATURES["mdgan_sample_normalize_u8"])
    for n in (want - 1, want + 1):
        with pytest.raises(TypeError, match=f"takes {want} arguments, got {n}"):
            _build.launch("mdgan_sample_normalize_u8", *range(n))
    assert calls == [] and not _build.launches
    _build.launch("mdgan_sample_normalize_u8", *range(want), plan="rows")
    assert calls == [tuple(range(want))]
    assert _build.launches == {"mdgan_sample_normalize_u8": 1,
                               "mdgan_sample_normalize_u8/rows": 1}
    assert _build.reported() == {"adam": 0, "adam_bf16m": 0, "sampling": 1}


def _c_params(name):
    """The parameter types of csrc's ``extern "C"`` function ``name``."""
    for src in sorted(_build.CSRC.glob("*.cu")):
        m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", src.read_text())
        if m:
            return [" ".join(p.split()[:-1]) for p in m.group(1).split(",")]
    raise AssertionError(f"no extern C function {name}")


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_ctypes_signature_matches_the_c_entry_point(name):
    """Each ctypes signature declares the C function's parameters one for
    one: a missing or extra one passes garbage in the last ones (the stream),
    which no CPU run executes."""
    ctype = {"int": ctypes.c_int, "int64_t": ctypes.c_int64, "float": ctypes.c_float,
             "cudaStream_t": ctypes.c_void_p}
    want = [ctypes.c_void_p if t.endswith("*") else ctype[t.replace("const ", "")]
            for t in _c_params(name)]
    assert _build.SIGNATURES[name] == want
