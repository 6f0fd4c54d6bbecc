"""The FIR resampling kernel (``csrc/upfirdn2d.cu``) on a CUDA card against
its plain version (``upfirdn2d_plain``), at every resampling of StyleGAN2
config-f (``stylegan2f.upfirdn2d_sites``), forward and backward, in float32
(within 1e-5 of the largest output, TF32 off) and bfloat16 (within one
rounding of the float32 sum), NCHW and channels_last; and at cases the sites
do not reach: a plane count that is not a multiple of the packed plan's
planes a block, an input that starts mid-pair, odd sizes with cropping pads,
channels that are not a multiple of 8 (channels_last input then takes the
NCHW plans).  Every sample and channel holds distinct content (a per-(n, c)
offset), so a wrong batch or channel stride shows.  Each call is one launch,
counted in ``_build.launches`` under the plan ``upfirdn2d.plan`` names; the
``nhwc`` plan gives the NCHW plans' bits (the same float32 sum in the same
order) and a channels_last output.  Config-f's generator forward and VJP and
its discriminator's forward and backward, at full width in bfloat16, launch
none of cuDNN's NCHW/NHWC transposes but at the 3-channel image's
convolutions.

Without a card every test skips.  This file imports no JAX, so on the card
it runs without the repository's ``conftest.py`` (which does):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_upfirdn2d_cuda.py
"""

import collections

import numpy as np
import pytest
import torch

from mdgan_tpu_torch.models import stylegan2f
from mdgan_tpu_torch.ops import _build
from mdgan_tpu_torch.ops import upfirdn2d as fir

pytestmark = pytest.mark.card

ASYM = np.array([[1.0, 2.0, 0.5, -1.0], [0.0, 3.0, 1.0, 2.0],
                 [-2.0, 1.0, 4.0, 0.5], [1.5, -0.5, 2.0, 1.0]], np.float32)
SITES = [(name, shape, up, pad) for name, shape, up, pad in stylegan2f.upfirdn2d_sites()]
# (id, shape, up, down, pad): the packed plan's last job part full (679
# planes of 7x7 outputs, 3 a job), rows of odd width, cropping pads
EXTRA = [("packed_remainder", (7, 97, 8, 8), 1, 1, (1, 1, 1, 1)),
         ("odd_crop_down", (2, 3, 13, 40), 1, 2, (0, 3, 1, 2)),
         ("odd_crop_up", (2, 3, 13, 40), 2, 1, (3, -1, -2, 3)),
         ("odd_rows", (1, 2, 31, 301), 1, 1, (1, 1, -1, 2))]
# channels_last cases: every factor and odd sizes with cropping pads at
# channels a multiple of 8 (the nhwc plan; 24: 3 vectors of bfloat16 a
# block, 40 float32: 5), and channels that are not (the NCHW plans)
EXTRA_NHWC = [("nhwc_odd_crop_down", (2, 24, 13, 40), 1, 2, (0, 3, 1, 2)),
              ("nhwc_odd_crop_up", (2, 16, 13, 40), 2, 1, (3, -1, -2, 3)),
              ("nhwc_odd_rows", (3, 40, 31, 45), 1, 1, (1, 1, -1, 2)),
              ("nhwc_many_chunks", (2, 320, 19, 23), 1, 1, (2, 2, 2, 2)),
              ("nhwc_c12", (2, 12, 17, 17), 1, 1, (1, 1, 1, 1)),
              ("nhwc_c3_up", (4, 3, 16, 16), 2, 1, (2, 1, 2, 1))]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run this file on the card, module docstring)")
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = saved


def _close(got, want, dtype):
    got, want = got.detach().float(), want.detach().float()
    bound = 1e-5 * want.abs().max()
    if dtype == torch.bfloat16:
        bound = bound + 2.0 ** -8 * want.abs()
    err = (got - want).abs()
    assert bool((err <= bound).all()), float(err.max())


def _distinct(gen, shape, dtype, dev, offset=0, channels_last=False):
    """N(0, 1) plus a per-(n, c) offset, ``offset`` elements into its buffer
    (offset 1: NCHW rows start mid-pair)."""
    n, c = shape[:2]
    flat = torch.randn(offset + int(np.prod(shape)), generator=gen, device=dev)
    flat[offset:].view(shape).add_(0.25 * torch.arange(n * c, device=dev).view(n, c, 1, 1))
    x = flat.to(dtype)[offset:].view(shape)
    return x.contiguous(memory_format=torch.channels_last) if channels_last else x


def _plan_name(t, out_hw, up, down):
    nhwc = fir.takes_nhwc(t)
    return fir.plan(t.shape[0] * t.shape[1], *out_hw, up, down, t.shape[1] if nhwc else 0,
                    t.element_size()).name


def _check(dev, shape, k, up, down, pad, dtype, offset=0, channels_last=False):
    gen = torch.Generator(device=dev).manual_seed(sum(shape) + up + 7 * down)
    x = _distinct(gen, shape, dtype, dev, offset, channels_last).requires_grad_(True)
    before = _build.launches.copy()
    y = fir.upfirdn2d(x, k, up=up, down=down, pad=pad)
    dy = _distinct(gen, tuple(y.shape), dtype, dev, channels_last=channels_last)
    (dx,) = torch.autograd.grad(y, x, dy)
    torch.cuda.synchronize()
    launched = _build.launches - before
    want_plans = [_plan_name(x, y.shape[2:], up, down), _plan_name(dy, shape[2:], down, up)]
    assert launched == collections.Counter(
        ["mdgan_upfirdn2d"] * 2 + [f"mdgan_upfirdn2d/{name}" for name in want_plans])
    nhwc = fir.takes_nhwc(x)
    assert nhwc == (channels_last and shape[1] % 8 == 0)
    for t in (y, dx):
        assert t.is_contiguous(memory_format=torch.channels_last if nhwc else
                               torch.contiguous_format)
    xr = x.detach().float().requires_grad_(True)
    yr = fir.upfirdn2d_plain(xr, k, up=up, down=down, pad=pad)
    (dxr,) = torch.autograd.grad(yr, xr, dy.float())
    assert y.dtype == dx.dtype == dtype and y.shape == yr.shape
    _close(y, yr, dtype)
    _close(dx, dxr, dtype)
    if nhwc:  # the same sums in the same order as the NCHW plans
        assert torch.equal(y, fir.upfirdn2d(x.detach().contiguous(), k, up=up, down=down,
                                            pad=pad))
        assert torch.equal(dx, fir.upfirdn2d(dy.contiguous(), k[::-1, ::-1], up=down, down=up,
                                             pad=fir.grad_pad(shape[2:], y.shape[2:], up,
                                                              down, pad)))


@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("name,shape,up,pad", SITES, ids=[s[0] for s in SITES])
def test_config_f_sites_match_the_plain_version(card, name, shape, up, pad, dtype, layout):
    k = stylegan2f._FIR_UP if name.startswith("g_") else stylegan2f._FIR
    _check(card, shape, k, up, 1, pad, dtype, channels_last=layout == "channels_last")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("name,shape,up,down,pad", EXTRA, ids=[e[0] for e in EXTRA])
def test_other_shapes_match_the_plain_version(card, name, shape, up, down, pad, offset, dtype):
    if name == "packed_remainder":
        p = fir.plan(shape[0] * shape[1], 7, 7, up, down)  # 8x8 at pads of 1: 7x7
        assert p.name == "planes" and p.planes_per_block > 1
        assert shape[0] * shape[1] % p.planes_per_block != 0
    _check(card, shape, ASYM, up, down, pad, dtype, offset)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("name,shape,up,down,pad", EXTRA_NHWC, ids=[e[0] for e in EXTRA_NHWC])
def test_channels_last_shapes_match_the_plain_version(card, name, shape, up, down, pad, dtype):
    _check(card, shape, ASYM, up, down, pad, dtype, channels_last=True)


def _layout_kernels(prof):
    """(op, input shapes) of each op of ``prof`` that launched one of cuDNN's
    NCHW/NHWC transposes, and the number of such kernels."""
    ops, count = [], 0
    for evt in prof.events():
        n = sum(1 for k in evt.kernels if "nchwToNhwc" in k.name or "nhwcToNchw" in k.name)
        if n:
            ops.append((evt.name, evt.input_shapes))
            count += n
    return ops, count


def test_config_f_runs_no_layout_transposes(card):
    """Config-f's generator forward and VJP (b=8) and its discriminator's
    forward and backward (b=4) at full width, under bfloat16 autocast as the
    round runs them: every op that launches one of cuDNN's NCHW/NHWC
    transposes takes the 3-channel image (or a weight of 3 channels), and
    the generator's image comes back NCHW-contiguous float32."""
    from torch.profiler import ProfilerActivity, profile

    from mdgan_tpu_torch.core import registry

    spec = registry.get("LSUNChurch256")
    gen = torch.Generator().manual_seed(3)
    g = stylegan2f.stylegan2f_init_(spec.make_generator(), gen).to(card)
    d = stylegan2f.stylegan2f_init_(spec.make_discriminator(), gen).to(card)
    z = torch.randn(8, 512, device=card)
    noise = [torch.randn(8, *shape, device=card) for shape in g.noise_shapes()]

    def run():  # as a round runs them: G forward, D forward and backward, G's VJP
        with torch.autocast("cuda", dtype=torch.bfloat16):
            img = g(z, noise)
        assert img.dtype == torch.float32 and img.is_contiguous()
        x = img.detach()[:4].requires_grad_(True)
        with torch.autocast("cuda", dtype=torch.bfloat16):
            d(x).sum().backward()
        img.backward(torch.cat([x.grad, x.grad]))
        torch.cuda.synchronize()

    run()  # cuDNN's first calls pick their kernels
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        run()
    ops, count = _layout_kernels(prof)

    def three_channels(shapes):
        return any(len(s) == 4 and 3 in s[:2] for s in shapes)

    outside = [(name, shapes) for name, shapes in ops if not three_channels(shapes)]
    assert not outside, (count, outside[:8])
