"""The generator's noise as an input stream: ``inputs.noise`` keyed by (seed,
chunk, input), the same noise handed to the program and to the reference,
and every other stream's values unchanged by a family that declares noise;
and the CPU sizes read per configuration."""

import types

import pytest
import torch

from perfbench import harness, inputs, spec
from perfbench.configs import dcgan32
from perfbench.tests import tiny

SEED = 2 ** 31 + 1234
SHAPES = [(1, 4, 4), (2, 3)]
CPU = torch.device("cpu")


def test_stream_tags_keep_their_numbers():
    """NOISE is appended: the streams drawn before it keep their keys."""
    assert (inputs.WEIGHTS_G, inputs.WEIGHTS_D, inputs.IMAGES, inputs.INDICES, inputs.LATENTS,
            inputs.NOISE) == (0, 1, 2, 3, 4, 5)


def test_noise_is_keyed_by_seed_chunk_and_input():
    a = inputs.noise(CPU, SEED, 3, 2, 5, SHAPES)
    assert [tuple(t.shape) for t in a] == [(2, 5, 1, 4, 4), (2, 5, 2, 3)]
    assert all(torch.equal(x, y) for x, y in zip(a, inputs.noise(CPU, SEED, 3, 2, 5, SHAPES)))
    # input i is the generator of (seed, NOISE, chunk, i), whatever the others are
    assert torch.equal(inputs.noise(CPU, SEED, 3, 2, 5, SHAPES[:1])[0], a[0])
    g = inputs.generator(CPU, SEED, inputs.NOISE, 3, 1)
    assert torch.equal(torch.randn(2, 5, 2, 3, generator=g), a[1])
    # another seed, chunk or input draws other values
    assert not torch.equal(inputs.noise(CPU, SEED + 1, 3, 2, 5, SHAPES)[0], a[0])
    assert not torch.equal(inputs.noise(CPU, SEED, 4, 2, 5, SHAPES)[0], a[0])
    same = inputs.noise(CPU, SEED, 3, 2, 5, [SHAPES[1], SHAPES[1]])
    assert not torch.equal(same[0], same[1])


def _noisy_family():
    """DCGAN-32's reference with two declared noise inputs."""
    fam = types.ModuleType("noisy_dcgan32")
    for name in ("WIDTHS", "leaves", "generator", "discriminator"):
        setattr(fam, name, getattr(dcgan32, name))
    fam.noise_shapes = lambda cfg: [(1, 4, 4), (1, 8, 8)]
    return fam


class _Handed(Exception):
    """What the mode's reference was handed (its call stops there)."""


def _reference_inputs(cell) -> dict:
    def handed(fam, cfg, traffic, g, ds, reals, zs, ops, fault=None, **extra):
        raise _Handed({"g": g, "ds": ds, "reals": reals, "zs": zs, **extra})

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cell.mode, "reference", handed)
        with pytest.raises(_Handed) as got:
            harness.reference(cell, SEED, CPU)
    return got.value.args[0]


def _same(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and torch.equal(a, b)
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))


def _program_draws(cell):
    """The program side's check chunks' (latents, noise), and its shards."""
    rk = harness.Rank(cell, "cpu")
    rk.seed, rk.chunk_i = SEED, 0
    return [rk.draws(rounds) for rounds in (1, 2)], rk.program.data(SEED)


def test_streams_unchanged_by_a_noise_family(monkeypatch):
    """The same cell with its family declaring noise: the weights, real
    batches (images at the sampler's indices) and latents the reference
    gets, and the program's latents and shards, bit-identical; the noise
    only where it is declared, and the program's check chunks given the
    noise the reference gets for those rounds."""
    name = "dcgan32_mdgan_n8"
    cell = spec.cell(name, tiny.overrides(name))
    ref_plain, prog_plain = _reference_inputs(cell), _program_draws(cell)
    noisy = _noisy_family()
    monkeypatch.setattr(spec, "family", lambda family: noisy)
    ref_noisy, prog_noisy = _reference_inputs(cell), _program_draws(cell)

    assert "noise" not in ref_plain and all(noise is None for _, noise in prog_plain[0])
    assert _same({k: v for k, v in ref_noisy.items() if k != "noise"}, ref_plain)
    assert _same([z for z, _ in prog_noisy[0]], [z for z, _ in prog_plain[0]])
    assert torch.equal(prog_noisy[1], prog_plain[1])
    # the check's three rounds: chunk 0 holds round 1, chunk 1 rounds 2-3
    k_b = cell.mode.latents_per_round(cell.traffic)
    assert [tuple(x.shape) for x in ref_noisy["noise"]] == [(3, k_b, 1, 4, 4), (3, k_b, 1, 8, 8)]
    program = [torch.cat(parts) for parts in zip(*[noise for _, noise in prog_noisy[0]])]
    assert _same(ref_noisy["noise"], program)


def test_configuration_without_cpu_sizes_names_the_file(tmp_path, monkeypatch):
    monkeypatch.setattr(spec, "HERE", tmp_path / "perfbench")
    with pytest.raises(FileNotFoundError, match="dcgan32_cifar10.json"):
        tiny.overrides("dcgan32_mdgan_n8")
