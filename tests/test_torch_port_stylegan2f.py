"""StyleGAN2 config-f (``models/stylegan2f.py``, dataset ``LSUNChurch256``)
against the benchmark's plain float32 reference
(``perfbench/configs/stylegan2f.py``, which imports nothing of the port), on
the CPU at a small config-f shape (fmap_base 512, fmap_max 64, 32 px, 2
mapping layers), with seeded random weights; and the FIR resampling op
(``ops/upfirdn2d.py``) on the CPU against its definition.

Held here:

  * ``upfirdn2d``'s CPU path against a direct float64 evaluation of its
    definition (zeros inserted, padded, a true convolution, every down-th
    output) for up=2 and down=2 at every pad the model uses, with an
    asymmetric filter (so a flip shows), and ``gradcheck`` of its backward
    (the same operation, filter flipped, up and down swapped);
  * the CUDA kernel's plan (``upfirdn2d.plan``) at every config-f
    resampling of ``chip_smoke.upfirdn2d_sites`` and its gradient's call,
    and at odd sizes and cropping pads, by a model of the kernel's blocks
    and patches: every output computed once, every input row and column
    the taps reach staged, shared memory within the plan's limit, whole
    planes packed where outputs are 32 wide or less;
  * the generator's forward with given noise, the discriminator's forward,
    and their parameter and input gradients, against the reference;
  * one MD-GAN round at N=2 with given latents and noise, and one standalone
    round, through ``run_rounds``: losses, the feedbacks' norm, the first
    gradients (Adam's ``mu`` after one step at beta_1 = 0) and the parameter
    deltas;
  * the noise lane: the same noise gives the same round; ``noise=None``
    draws from lane (NOISE, step, input), reproducibly; a family without
    noise refuses it;
  * the parameter counts at config-f widths against the benchmark
    configuration's ``g_params``/``d_params``; the CLI in both modes; the
    weight map's round trip; the tensor-parallel refusal; the dataset.

Tolerances: the model and the reference compute the same float32
operations, but convolutions fuse their bias or not and sums run in other
orders, so forwards and gradients are held at rtol 1e-5 with an atol of
1e-6 of the largest magnitude (measured ~4e-7 relative).  The round runs
Adam at lr 2e-5 and eps 1e-3, where a step is continuous in the gradient
(at the default eps a step is about lr * sign(grad), and an element whose
gradient sits at rounding noise may step either way), and holds its
numbers at rtol 1e-4 with an atol of 1e-5 of the largest magnitude: the
feedback passes through the discriminators after their Adam step, which
carries the first gradients' rounding into it.  A step is held as the
parameters after it, so two float32 ulps of each parameter come on top.
"""

import dataclasses
import functools
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from mdgan_tpu_torch.core import prng, registry
from mdgan_tpu_torch.core.config import OptimizerConfig, TrainConfig
from mdgan_tpu_torch.core.mesh import Axis
from mdgan_tpu_torch.data import builtin
from mdgan_tpu_torch.data.sampler import ShardSampler
from mdgan_tpu_torch.engine.mdgan import MDGANEngine
from mdgan_tpu_torch.engine.standalone import StandaloneEngine
from mdgan_tpu_torch.engine.state import NetState
from mdgan_tpu_torch.models import from_jax
from mdgan_tpu_torch.ops.losses import normalize_uint8
from mdgan_tpu_torch.ops import upfirdn2d as upfirdn2d_ops
from mdgan_tpu_torch.ops.upfirdn2d import setup_kernel, upfirdn2d, upfirdn2d_plain
from mdgan_tpu_torch.parallel import tensor as tensor_lib
from chip_smoke import upfirdn2d_sites
from perfbench import inputs
from perfbench.configs import stylegan2f as ref
from perfbench.reference import rounds
from perfbench.reference.ops import Ops

ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "perfbench/configs/stylegan2f_church256.json").read_text())
WIDTHS = {"fmap_base": 512, "fmap_max": 64, "max_res": 32, "map_layers": 2}
CFG = {**CONFIG, **WIDTHS, "image_shape": [32, 32, 3]}
SPEC = registry.get("LSUNChurch256")
ATOL, RTOL = 1e-6, 1e-5          # of the largest magnitude; relative (module docstring)
ROUND_ATOL, ROUND_RTOL = 1e-5, 1e-4
# (up, down, pad): the model's resamplings, their gradients, and crossings
SITES = [(1, 1, (1, 1, 1, 1)), (2, 1, (2, 1, 2, 1)), (1, 1, (2, 2, 2, 2)),
         (1, 2, (1, 1, 1, 1)), (1, 2, (2, 2, 2, 2)), (1, 2, (2, 1, 2, 1)),
         (2, 1, (1, 1, 1, 1)), (2, 1, (2, 2, 2, 2)), (2, 2, (0, 3, 1, 2))]
ASYM = np.array([[1.0, 2.0, 0.5, -1.0], [0.0, 3.0, 1.0, 2.0],
                 [-2.0, 1.0, 4.0, 0.5], [1.5, -0.5, 2.0, 1.0]], np.float32)


def _close(got, want, atol=ATOL, rtol=RTOL):
    got, want = got.detach().double(), want.detach().double()
    scale = want.abs().max().clamp(min=1e-30)
    assert torch.allclose(got, want, rtol=rtol, atol=atol * float(scale)), \
        float((got - want).abs().max() / scale)


def _close_step(got, want, init):
    """Parameters after a step, held by their step from ``init``: each side
    rounds p + step to float32 once, so two ulps of p come on top of the
    step's own tolerance."""
    got, want, init = got.double(), want.double(), init.double()
    step = want - init
    bound = (ROUND_RTOL * step.abs() + ROUND_ATOL * step.abs().max()
             + 2.0 ** -22 * init.abs())
    assert bool(((got - want).abs() <= bound).all()), \
        float(((got - want).abs() / step.abs().max().clamp(min=1e-30)).max())


def _definition(x: np.ndarray, k: np.ndarray, up: int, down: int, pad) -> np.ndarray:
    """upfirdn2d in float64, element by element."""
    n, c, h, w = x.shape
    x0, x1, y0, y1 = pad
    kh, kw = k.shape
    u = np.zeros((n, c, h * up, w * up))
    u[:, :, ::up, ::up] = x
    p = np.zeros((n, c, h * up + y0 + y1, w * up + x0 + x1))
    p[:, :, y0:y0 + h * up, x0:x0 + w * up] = u
    oh, ow = (p.shape[2] - kh) // down + 1, (p.shape[3] - kw) // down + 1
    out = np.zeros((n, c, oh, ow))
    for oy in range(oh):
        for ox in range(ow):
            win = p[:, :, oy * down:oy * down + kh, ox * down:ox * down + kw]
            out[:, :, oy, ox] = (win * k[::-1, ::-1]).sum(axis=(2, 3))
    return out


@pytest.mark.parametrize("up,down,pad", SITES)
@pytest.mark.parametrize("fir", ["asymmetric", "stylegan2"])
def test_upfirdn2d_matches_its_definition(up, down, pad, fir):
    k = ASYM if fir == "asymmetric" else setup_kernel((1, 3, 3, 1), gain=up * up)
    x = torch.randn(2, 3, 7, 6, generator=torch.Generator().manual_seed(1), dtype=torch.float64)
    got = upfirdn2d(x, k, up=up, down=down, pad=pad)
    want = _definition(x.numpy(), k.astype(np.float64), up, down, pad)
    assert got.shape == want.shape and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("up,down,pad", SITES)
def test_upfirdn2d_gradient(up, down, pad):
    """The backward is the op with the filter flipped and up/down swapped:
    held to finite differences in float64 (and, upsampling, its own
    gradient too)."""
    x = torch.randn(1, 1, 5, 4, generator=torch.Generator().manual_seed(2),
                    dtype=torch.float64, requires_grad=True)
    fn = functools.partial(upfirdn2d, k=ASYM, up=up, down=down, pad=pad)
    assert torch.autograd.gradcheck(fn, (x,))
    if (up, down) == (2, 1):
        assert torch.autograd.gradgradcheck(fn, (x,))


def test_upfirdn2d_crops_negative_pads_and_keeps_dtype():
    x = torch.randn(1, 1, 8, 8, generator=torch.Generator().manual_seed(3))
    got = upfirdn2d(x, ASYM, pad=(-1, 0, 0, -2))
    want = _definition(x.double().numpy()[:, :, :-2, 1:], ASYM.astype(np.float64), 1, 1,
                       (0, 0, 0, 0))
    np.testing.assert_allclose(got.double().numpy(), want, rtol=1e-6, atol=1e-6)
    half = upfirdn2d(x.bfloat16(), ASYM, pad=(1, 1, 1, 1))
    assert half.dtype == torch.bfloat16
    # the float32 sum rounded once
    assert torch.equal(half, upfirdn2d_plain(x.bfloat16(), ASYM, pad=(1, 1, 1, 1)))
    with pytest.raises(ValueError, match="N, C, H, W"):
        upfirdn2d(x[0], ASYM)


@pytest.mark.parametrize("taps,up,down", [((3, 3), 1, 1), ((4, 4), 2, 2), ((4, 4), 4, 1)])
def test_upfirdn2d_kernel_refuses_other_resamplings(taps, up, down):
    """The CUDA kernel is compiled for the models' resamplings only (a 4x4
    filter, (up, down) of (1, 1), (2, 1) or (1, 2)); any other is refused
    before a launch, where the plain version would have run."""
    x = torch.zeros(1, 1, 8, 8)
    with pytest.raises(ValueError, match="CUDA kernel"):
        upfirdn2d_ops._launch(x, np.ones(taps, np.float32), up, down, (0, 0, 0, 0))
    assert upfirdn2d(x, np.ones(taps, np.float32), up=up, down=down).shape[0] == 1


def test_upfirdn2d_wrapper_passes_the_plan(monkeypatch):
    """``_launch`` hands the C entry point exactly the arguments its ctypes
    signature declares, the call's plan among them, and counts the launch
    under the plan's name (the library and the CUDA calls stubbed: no card
    runs here)."""
    calls = []

    class Lib:
        def mdgan_upfirdn2d(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(upfirdn2d_ops._build, "lib", lambda: Lib())
    monkeypatch.setattr(torch.cuda, "current_device", lambda: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("Stream", (), {"cuda_stream": 7})())
    monkeypatch.setattr(upfirdn2d_ops.upfirdn2d, "plans", {})
    monkeypatch.setattr(upfirdn2d_ops.upfirdn2d, "launches", 0)
    x = torch.zeros(2, 3, 9, 9)
    y = upfirdn2d_ops._launch(x, setup_kernel((1, 3, 3, 1)), 1, 1, (1, 1, 1, 1))
    (args,) = calls
    assert y.shape == (2, 3, 8, 8)
    assert len(args) == len(upfirdn2d_ops._build.SIGNATURES["mdgan_upfirdn2d"])
    pl = upfirdn2d_ops.plan(6, 8, 8, 1, 1)
    assert args[15:21] == (1, pl.tile_h, pl.planes_per_block, pl.threads, pl.pitch,
                           pl.stage_rows)
    assert args[-1] == 7 and upfirdn2d_ops.upfirdn2d.plans == {"planes": 1}
    assert upfirdn2d_ops.upfirdn2d.launches == 1


def _fir_calls():
    """(id, planes, (in_h, in_w), up, down, pad) of every config-f resampling
    and its gradient's call, then odd sizes and cropping pads."""
    calls = []
    for name, (n, c, h, w), up, pad in upfirdn2d_sites():
        out = (upfirdn2d_ops.out_size(h, up, 1, pad[2], pad[3], 4),
               upfirdn2d_ops.out_size(w, up, 1, pad[0], pad[1], 4))
        calls.append((name, n * c, (h, w), up, 1, pad))
        calls.append((name + "_grad", n * c, out, 1, up,
                      upfirdn2d_ops.grad_pad((h, w), out, up, 1, pad)))
    for planes, hw, up, down, pad in [
            (145, (8, 8), 1, 1, (1, 1, 1, 1)), (7, (5, 7), 1, 1, (-1, 2, 1, -1)),
            (6, (13, 40), 2, 1, (3, -1, -2, 3)), (6, (13, 40), 1, 2, (0, 3, 1, 2)),
            (3, (1, 1), 1, 1, (2, 1, 2, 1)), (2, (3, 33), 2, 1, (-1, 2, 0, -2)),
            (5, (70, 9), 1, 2, (2, 2, 2, 2)), (1, (31, 300), 1, 1, (1, 1, -1, 2))]:
        calls.append((f"odd{planes}x{hw[0]}x{hw[1]}_{up}{down}", planes, hw, up, down, pad))
    return calls


FIR_CALLS = _fir_calls()


def _fir_plan(planes, hw, up, down, pad):
    out = (upfirdn2d_ops.out_size(hw[0], up, down, pad[2], pad[3], 4),
           upfirdn2d_ops.out_size(hw[1], up, down, pad[0], pad[1], 4))
    return upfirdn2d_ops.plan(planes, *out, up, down), out


def _fir_blocks(pl, planes, out_h):
    """(first plane, planes, first output row) of each block, as the kernel
    takes them from blockIdx; for the rows plan the first two planes'."""
    if pl.name == "planes":
        assert pl.grid == -(-planes // pl.planes_per_block)
        pb = pl.planes_per_block
        return [(b * pb, min(pb, planes - b * pb), 0) for b in range(pl.grid)]
    tiles = -(-out_h // pl.tile_h)
    assert pl.grid == planes * tiles and pl.planes_per_block == 1
    return [(b // tiles, 1, (b % tiles) * pl.tile_h) for b in range(min(pl.grid, 2 * tiles))]


@pytest.mark.parametrize("call", FIR_CALLS, ids=[c[0] for c in FIR_CALLS])
def test_upfirdn2d_plan_covers_each_output_once(call):
    """Each block's threads walk its patches (plane, row group, column
    group) of RY x XB outputs; over the blocks each output is written once."""
    _, planes, hw, up, down, pad = call
    pl, (oh, ow) = _fir_plan(planes, hw, up, down, pad)
    xb, ry = upfirdn2d_ops.XB, upfirdn2d_ops.RY
    col_groups, row_groups = -(-ow // xb), pl.tile_h // ry
    assert pl.tile_h % ry == 0 and 32 <= pl.threads <= upfirdn2d_ops.THREADS
    assert pl.threads % 32 == 0
    blocks = _fir_blocks(pl, planes, oh)
    seen = min(planes, blocks[-1][0] + blocks[-1][1])
    count = np.zeros((seen, oh, ow), np.int32)
    patch_y, patch_x = np.meshgrid(np.arange(ry), np.arange(xb), indexing="ij")
    for plane0, nplanes, ty0 in blocks:
        i = np.arange(nplanes * row_groups * col_groups)
        p, rg, cg = i // (row_groups * col_groups), i // col_groups % row_groups, i % col_groups
        oy = ty0 + rg[:, None, None] * ry + patch_y
        ox = cg[:, None, None] * xb + patch_x
        p = np.broadcast_to(plane0 + p[:, None, None], oy.shape)
        keep = (oy < oh) & (ox < ow)
        np.add.at(count, (p[keep], oy[keep], ox[keep]), 1)
    assert count.min() == 1 and count.max() == 1


@pytest.mark.parametrize("call", FIR_CALLS, ids=[c[0] for c in FIR_CALLS])
def test_upfirdn2d_plan_stages_every_row_the_taps_reach(call):
    """A block stages rows [ty0 * down, ty0 * down + stage_rows) and columns
    [0, pitch) of the upsampled, padded plane: every input pixel a tap of
    its outputs reaches lies there, and so does every staged float4 its
    patches read."""
    _, planes, (h, w), up, down, pad = call
    pl, (oh, ow) = _fir_plan(planes, (h, w), up, down, pad)
    xb, ry = upfirdn2d_ops.XB, upfirdn2d_ops.RY
    col_groups = -(-ow // xb)
    taps = np.arange(4)
    for _, _, ty0 in _fir_blocks(pl, planes, oh):
        oy = np.arange(ty0, min(ty0 + pl.tile_h, oh))
        uy = (oy[:, None] * down + taps).ravel()
        iy = uy - pad[2]
        reached = uy[(iy >= 0) & (iy % up == 0) & (iy // up < h)] - ty0 * down
        assert reached.min() >= 0 and reached.max() < pl.stage_rows
    ux = (np.arange(ow)[:, None] * down + taps).ravel()
    ix = ux - pad[0]
    assert ux[(ix >= 0) & (ix % up == 0) & (ix // up < w)].max() < pl.pitch
    # the last row group and column group read inside the staged tile
    assert (pl.tile_h - 1) * down + 4 <= pl.stage_rows
    assert (col_groups - 1) * xb * down + -(-((xb - 1) * down + 4) // 4) * 4 <= pl.pitch
    assert pl.pitch % 4 == 0


@pytest.mark.parametrize("call", FIR_CALLS, ids=[c[0] for c in FIR_CALLS])
def test_upfirdn2d_plan_fits_its_shared_memory(call):
    _, planes, hw, up, down, pad = call
    pl, _ = _fir_plan(planes, hw, up, down, pad)
    assert pl.smem == 4 * pl.planes_per_block * pl.stage_rows * pl.pitch
    assert pl.smem <= pl.smem_limit <= upfirdn2d_ops.ROWS_SMEM


@pytest.mark.parametrize("call", FIR_CALLS, ids=[c[0] for c in FIR_CALLS])
def test_upfirdn2d_plan_packs_small_planes(call):
    """Outputs 32 wide or less take the packed plan, wider ones full rows.
    A packed block takes as many planes as fit: one more would pass
    ``THREADS`` patches or the memory limit, or leave the call under
    ``MIN_BLOCKS`` blocks.  A rows block takes the tallest tile that fits
    the same way, then evens the tiles of a plane: one tile fewer a plane
    would not fit, and no tile is a row group or more taller than the rows
    its plane has left for it.  Threads cover the patches, and the staged
    rows in one batch where ``THREADS`` allow."""
    _, planes, hw, up, down, pad = call
    pl, (oh, ow) = _fir_plan(planes, hw, up, down, pad)
    ops = upfirdn2d_ops
    assert pl.name == ("planes" if ow <= ops.SMALL_W else "rows")
    col_groups, row_groups = -(-ow // ops.XB), pl.tile_h // ops.RY
    staged = pl.planes_per_block * pl.stage_rows * pl.pitch // up
    assert pl.threads >= min(ops.THREADS, pl.planes_per_block * col_groups * row_groups)
    assert pl.threads >= min(ops.THREADS, -(-staged // ops.STAGE_FLOATS))

    def fits(pb, rg):
        rows = (rg * ops.RY - 1) * down + 4
        blocks = -(-planes // pb) if pl.name == "planes" else planes * -(-oh // (rg * ops.RY))
        return (pb * col_groups * rg <= ops.THREADS
                and 4 * pb * rows * pl.pitch <= ops.BLOCK_SMEM and blocks >= ops.MIN_BLOCKS)

    if pl.name == "planes":
        assert pl.tile_h >= oh and pl.planes_per_block <= planes
        assert not fits(pl.planes_per_block + 1, row_groups)
    else:
        plane_groups = -(-oh // ops.RY)
        tiles = -(-plane_groups // row_groups)
        assert tiles * row_groups - plane_groups < tiles
        if tiles > 1:
            assert not fits(1, -(-plane_groups // (tiles - 1)))


def _weights(net: str, seed: int):
    """The reference's init, then every noise strength and bias drawn too,
    so that each leaf moves the output."""
    w = inputs.weights(ref.leaves(CFG, net), "cpu", seed, inputs.WEIGHTS_G)
    gen = torch.Generator().manual_seed(seed)
    for name, t in w.items():
        if name.endswith("noise_strength") or (name.endswith("bias") and ".mod." not in name):
            t.copy_(torch.randn(t.shape, generator=gen) * 0.3)
    return w


def _load(module, weights):
    with torch.no_grad():
        for name, p in module.named_parameters():
            p.copy_(weights[name])
    return module


def _noise(num, seed):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(num, *s, generator=gen) for s in ref.noise_shapes(CFG)]


def _generator():
    return _load(SPEC.make_generator(**WIDTHS), _weights("g", 5))


def _discriminator():
    return _load(SPEC.make_discriminator(**{k: WIDTHS[k] for k in SPEC.d_widths}),
                 _weights("d", 6))


def test_leaves_and_counts_match_the_reference():
    g, d = _generator(), _discriminator()
    for module, net in ((g, "g"), (d, "d")):
        assert {n: tuple(p.shape) for n, p in module.named_parameters()} == \
            {n: tuple(s) for n, s, _ in ref.leaves(CFG, net)}
    full_g, full_d = SPEC.make_generator(), SPEC.make_discriminator()
    assert sum(p.numel() for p in full_g.parameters()) == CONFIG["g_params"] == 30_034_338
    assert sum(p.numel() for p in full_d.parameters()) == CONFIG["d_params"] == 28_864_129
    assert len(full_g.noise_shapes()) == 13 and full_g.noise_shapes() == ref.noise_shapes(CONFIG)


def test_frozen_resampling_bytes_match_the_reference():
    """The configuration's ``upfirdn2d_bytes_per_sample`` (read by the
    benchmark's FIR roofline) is the reference's own count at config-f,
    and the count scales with the compute dtype's width."""
    assert ref.upfirdn2d_bytes(CONFIG) == CONFIG["upfirdn2d_bytes_per_sample"]
    wide = ref.upfirdn2d_bytes({**CONFIG, "compute_dtype": "float32"})
    assert wide == {k: 2 * v for k, v in CONFIG["upfirdn2d_bytes_per_sample"].items()}


def test_generator_forward_with_given_noise():
    g = _generator()
    z = torch.randn(4, 512, generator=torch.Generator().manual_seed(7))
    noise = _noise(4, 8)
    got = g(z, noise)
    _close(got, ref.generator(CFG, _weights("g", 5), z, Ops(), noise))
    # the noise reaches the image
    assert not torch.allclose(got, g(z, _noise(4, 9)))


def test_discriminator_forward():
    x = torch.randn(4, 3, 32, 32, generator=torch.Generator().manual_seed(10))
    _close(_discriminator()(x), ref.discriminator(CFG, _weights("d", 6), x, Ops()))


@pytest.mark.parametrize("net", ["g", "d"])
def test_parameter_and_input_gradients(net):
    gen = torch.Generator().manual_seed(11)
    p = {k: v.clone().requires_grad_(True) for k, v in _weights(net, 5 if net == "g" else 6).items()}
    if net == "g":
        module, noise = _generator(), _noise(4, 12)
        z = torch.randn(4, 512, generator=gen, requires_grad=True)
        got, want = module(z, noise), ref.generator(CFG, p, z, Ops(), noise)
        arg = z
    else:
        module = _discriminator()
        arg = torch.randn(4, 3, 32, 32, generator=gen, requires_grad=True)
        got, want = module(arg), ref.discriminator(CFG, p, arg, Ops())
    cot = torch.randn(got.shape, generator=gen)
    g_got = torch.autograd.grad(got, [arg, *module.parameters()], cot)
    g_want = dict(zip(["input", *p], torch.autograd.grad(want, [arg, *p.values()], cot)))
    for (name, _), grad in zip([("input", None), *module.named_parameters()], g_got):
        _close(grad, g_want[name])


def _train_cfg():
    opt = OptimizerConfig(lr=2e-5, beta_1=0.0, beta_2=0.99, eps=1e-3)
    return TrainConfig(batch_size=2, compute_dtype="float32", device="cpu",
                       generator_opt=opt, discriminator_opt=opt)


def _shards(n, size=6):
    return np.random.default_rng(13).integers(0, 256, (n, size, 32, 32, 3), dtype=np.uint8)


def _program_state(eng, n):
    st = eng.init_state(3)
    _load(st.g.modules[0], _weights("g", 5))
    for i in range(n):
        _load(st.d.modules[i], _weights("d", 20 + i))
    return st


def _leaves(net: NetState, arena, prefix, w=0):
    return {f"{prefix}/{k}": v for k, v in net.views(arena, w).items()}


def test_mdgan_round_against_the_reference():
    n, b, k = 2, 2, 2
    eng = MDGANEngine(SPEC, _train_cfg(), n, model_kwargs=WIDTHS)
    st = _program_state(eng, n)
    init = {**_leaves(st.g, st.g.params.clone(), "g"),
            **{k_: v for i in range(n) for k_, v in _leaves(st.d, st.d.params.clone(), f"d{i}",
                                                            i).items()}}
    shards = _shards(n)
    sampler = ShardSampler(n, shards.shape[1], b, seed=4)
    idx = ShardSampler(n, shards.shape[1], b, seed=4).next_chunk(1)[0]
    z = torch.randn(1, k * b, 512, generator=torch.Generator().manual_seed(14))
    noise = [x[None] for x in _noise(k * b, 15)]
    m = eng.run_rounds(st, eng.shard_data(shards), sampler, 1, z=z, noise=noise)

    reals = normalize_uint8(torch.from_numpy(shards[np.arange(n)[:, None], idx])).permute(
        0, 1, 4, 2, 3)
    cfg = {**CFG, "lr": 2e-5, "beta_1": 0.0, "beta_2": 0.99, "eps": 1e-3}
    out = rounds.mdgan_rounds(ref, cfg, n, _weights("g", 5), [_weights("d", 20 + i)
                                                            for i in range(n)],
                              [reals], [z[0]], Ops(), noise=noise)
    want = out["losses"][0]
    for key in ("mean_d_loss", "g_feedback_loss"):
        _close(m[key][0], want[key], ROUND_ATOL, ROUND_RTOL)
    _close(m["feedback_norm"][0], want["feedback_norm"], ROUND_ATOL, ROUND_RTOL)
    # mu after one step at beta_1 = 0 is the first gradient
    mu = {**_leaves(st.g, st.g.mu, "g"),
          **{k_: v for i in range(n) for k_, v in _leaves(st.d, st.d.mu, f"d{i}", i).items()}}
    params = {**_leaves(st.g, st.g.params, "g"),
              **{k_: v for i in range(n) for k_, v in _leaves(st.d, st.d.params, f"d{i}",
                                                            i).items()}}
    assert set(mu) == set(out["grads"]) == set(out["params"])
    for name in out["grads"]:
        _close(mu[name], out["grads"][name], ROUND_ATOL, ROUND_RTOL)
        _close_step(params[name], out["params"][name], init[name])


def test_standalone_round_against_the_reference():
    b = 2
    eng = StandaloneEngine(SPEC, _train_cfg(), model_kwargs=WIDTHS)
    st = _program_state(eng, 1)
    shards = _shards(1)
    sampler = ShardSampler(1, shards.shape[1], b, seed=4)
    idx = ShardSampler(1, shards.shape[1], b, seed=4).next_chunk(1)[0, 0]
    z = torch.randn(1, b, 512, generator=torch.Generator().manual_seed(16))
    noise = [x[None] for x in _noise(b, 17)]
    m = eng.run_rounds(st, eng.put_data(shards[0]), sampler, 1, z=z, noise=noise)
    real = normalize_uint8(torch.from_numpy(shards[0, idx])).permute(0, 3, 1, 2)
    cfg = {**CFG, "lr": 2e-5, "beta_1": 0.0, "beta_2": 0.99, "eps": 1e-3}
    out = rounds.standalone_rounds(ref, cfg, _weights("g", 5), _weights("d", 20), [real],
                                   [z[0]], Ops(), noise=noise)
    for key in ("mean_d_loss", "mean_g_loss"):
        _close(m[key][0], out["losses"][0][key], ROUND_ATOL, ROUND_RTOL)
    init = _weights("g", 5)
    for name, p in _leaves(st.g, st.g.params, "g").items():
        _close_step(p, out["params"][name], init[name[2:]])


def _round(eng, seed, noise=None):
    st = eng.init_state(seed)
    shards = _shards(2)
    m = eng.run_rounds(st, eng.shard_data(shards), ShardSampler(2, 6, 2, seed=1), 2,
                       noise=noise)
    return m, st


def test_noise_lane():
    eng = MDGANEngine(SPEC, _train_cfg(), 2, model_kwargs=WIDTHS)
    st = eng.init_state(1)
    with torch.no_grad():  # noise that matters
        for name, p in st.g.modules[0].named_parameters():
            if name.endswith("noise_strength"):
                p.fill_(0.5)
    x0 = eng.generate(st.g, torch.zeros(4, 512), _noise(4, 1))
    assert torch.equal(x0, eng.generate(st.g, torch.zeros(4, 512), _noise(4, 1)))
    assert not torch.equal(x0, eng.generate(st.g, torch.zeros(4, 512), _noise(4, 2)))
    # given noise: the same noise gives the same rounds
    given = [torch.randn(2, 4, *s) for s in ref.noise_shapes(CFG)]
    a, _ = _round(eng, 1, given)
    b, _ = _round(eng, 1, given)
    assert all(torch.equal(a[k], b[k]) for k in ("mean_d_loss", "g_feedback_loss"))
    # drawn: lane (NOISE, step, input), the same for the same seed
    drawn, _ = _round(eng, 1)
    again, _ = _round(eng, 1)
    other, _ = _round(eng, 2)
    assert torch.equal(drawn["x_eval"], again["x_eval"])
    assert not torch.equal(drawn["x_eval"], other["x_eval"])
    lane = [torch.stack([torch.randn(4, *s, generator=prng.reseed(torch.Generator(), 1,
                                                                   prng.NOISE, t, i))
                         for t in range(2)]) for i, s in enumerate(ref.noise_shapes(CFG))]
    explicit, _ = _round(eng, 1, lane)
    assert torch.equal(drawn["x_eval"], explicit["x_eval"])


def test_noise_refused_where_not_taken():
    eng = MDGANEngine(registry.get("Synthetic32"), _train_cfg(), 2,
                      model_kwargs={"ngf": 8, "ndf": 8})
    st = eng.init_state(1)
    data = eng.shard_data(_shards(2))
    with pytest.raises(ValueError, match="takes no noise"):
        eng.run_rounds(st, data, ShardSampler(2, 6, 2), 1, noise=[torch.zeros(1, 4, 1, 4, 4)])
    cf = MDGANEngine(SPEC, _train_cfg(), 2, model_kwargs=WIDTHS)
    st = cf.init_state(1)
    with pytest.raises(ValueError, match="noise must be"):
        cf.run_rounds(st, cf.shard_data(_shards(2)), ShardSampler(2, 6, 2), 1,
                      noise=[torch.zeros(1, 4, 1, 4, 4)])


def test_weight_map_round_trip():
    d_widths = {k: WIDTHS[k] for k in SPEC.d_widths}
    for module, make in ((_generator(), lambda: SPEC.make_generator(**WIDTHS)),
                         (_discriminator(), lambda: SPEC.make_discriminator(**d_widths))):
        net = NetState([module], "cpu")
        params, stats = from_jax.export_net(net)
        assert stats == {}
        twin = NetState([make()], "cpu")
        from_jax.load_net(twin, params, stats)
        assert torch.equal(twin.params, net.params)


def test_no_tensor_parallel_form():
    with pytest.raises(NotImplementedError, match="config-f"):
        tensor_lib.shard_module(SPEC.make_generator(**WIDTHS), Axis(2, 0))
    # one slot: nothing to split
    assert tensor_lib.shard_module(SPEC.make_generator(**WIDTHS), Axis(1, 0)).tensor_shards == {}


def test_dataset_synthetic_fallback(tmp_path):
    data, labels = SPEC.load(str(tmp_path), max_examples=3)
    assert data.shape == (3, 256, 256, 3) and data.dtype == np.uint8 and len(labels) == 3
    assert SPEC.shape == (256, 256, 3) and SPEC.z_dim == 512
    np.savez(tmp_path / "church256.npz", images=data[:2])
    assert SPEC.load(str(tmp_path))[0].shape == (2, 256, 256, 3)
    with pytest.raises(FileNotFoundError):
        builtin.load_lsun_church256(str(tmp_path / "none"), fallback="none")


@pytest.mark.parametrize("mode", ["mdgan", "standalone"])
def test_cli_trains_lsun_church(mode, tmp_path, monkeypatch):
    """``cli.train --dataset LSUNChurch256`` on synthetic pixels, the
    networks narrowed (the registry's factories wrapped): finite losses,
    the final checkpoint and weight exports written through the map."""
    from mdgan_tpu_torch.cli import train

    narrow = {"fmap_base": 256, "fmap_max": 16, "map_layers": 1}
    monkeypatch.setitem(registry._REGISTRY, "LSUNChurch256", dataclasses.replace(
        SPEC, make_generator=functools.partial(SPEC.make_generator, **narrow),
        make_discriminator=functools.partial(SPEC.make_discriminator, fmap_base=256,
                                             fmap_max=16)))
    dirs = {k: str(tmp_path / k) for k in ("log_dir", "image_dir", "weights_dir",
                                           "checkpoint_dir")}
    argv = ["--mode", mode, "--dataset", "LSUNChurch256", "--num_workers", "2",
            "--batch_size", "2", "--epochs", "2", "--max_examples", "8", "--log_interval", "0",
            "--device", "cpu", "--data_dir", str(tmp_path / "data")]
    argv += [x for k, v in dirs.items() for x in (f"--{k}", v)]
    assert train.main(argv) == 0
    assert list((tmp_path / "weights_dir").rglob("*.npz"))
