"""The FIR resampling kernel (``csrc/upfirdn2d.cu``) on a CUDA card against
its plain version (``upfirdn2d_plain``), at every resampling of StyleGAN2
config-f (``chip_smoke.upfirdn2d_sites``), forward and backward, in float32
(within 1e-5 of the largest output, TF32 off) and bfloat16 (within one
rounding of the float32 sum); and at cases the sites do not reach: a plane
count that is not a multiple of the packed plan's planes a block, an input
that starts mid-pair, odd sizes with cropping pads.  Each call is one launch,
counted under the plan ``upfirdn2d.plan`` names.

Without a card every test skips.  This file imports no JAX, so on the card
it runs without the repository's ``conftest.py`` (which does):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_upfirdn2d_cuda.py
"""

import numpy as np
import pytest
import torch

from chip_smoke import upfirdn2d_sites
from mdgan_tpu_torch.models import stylegan2f
from mdgan_tpu_torch.ops import upfirdn2d as fir

pytestmark = pytest.mark.card

ASYM = np.array([[1.0, 2.0, 0.5, -1.0], [0.0, 3.0, 1.0, 2.0],
                 [-2.0, 1.0, 4.0, 0.5], [1.5, -0.5, 2.0, 1.0]], np.float32)
SITES = [(name, shape, up, pad) for name, shape, up, pad in upfirdn2d_sites()]
# (id, shape, up, down, pad): the packed plan's last job part full (679
# planes of 7x7 outputs, 3 a job), rows of odd width, cropping pads
EXTRA = [("packed_remainder", (7, 97, 8, 8), 1, 1, (1, 1, 1, 1)),
         ("odd_crop_down", (2, 3, 13, 40), 1, 2, (0, 3, 1, 2)),
         ("odd_crop_up", (2, 3, 13, 40), 2, 1, (3, -1, -2, 3)),
         ("odd_rows", (1, 2, 31, 301), 1, 1, (1, 1, -1, 2))]


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


def _check(dev, shape, k, up, down, pad, dtype, offset=0):
    gen = torch.Generator(device=dev).manual_seed(sum(shape) + up + 7 * down)
    flat = torch.randn(offset + int(np.prod(shape)), generator=gen, device=dev).to(dtype)
    x = flat[offset:].view(shape).requires_grad_(True)  # offset 1: rows start mid-pair
    launches, plans = fir.upfirdn2d.launches, dict(fir.upfirdn2d.plans)
    y = fir.upfirdn2d(x, k, up=up, down=down, pad=pad)
    dy = torch.randn(y.shape, generator=gen, device=dev).to(dtype)
    (dx,) = torch.autograd.grad(y, x, dy)
    torch.cuda.synchronize()
    assert fir.upfirdn2d.launches - launches == 2
    want_plans = [fir.plan(shape[0] * shape[1], *y.shape[2:], up, down).name,
                  fir.plan(shape[0] * shape[1], *shape[2:], down, up).name]
    for name in set(want_plans):
        assert fir.upfirdn2d.plans[name] - plans.get(name, 0) == want_plans.count(name)
    xr = x.detach().float().requires_grad_(True)
    yr = fir.upfirdn2d_plain(xr, k, up=up, down=down, pad=pad)
    (dxr,) = torch.autograd.grad(yr, xr, dy.float())
    assert y.dtype == dx.dtype == dtype and y.shape == yr.shape
    _close(y, yr, dtype)
    _close(dx, dxr, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("name,shape,up,pad", SITES, ids=[s[0] for s in SITES])
def test_config_f_sites_match_the_plain_version(card, name, shape, up, pad, dtype):
    k = stylegan2f._FIR_UP if name.startswith("g_") else stylegan2f._FIR
    _check(card, shape, k, up, 1, pad, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("name,shape,up,down,pad", EXTRA, ids=[e[0] for e in EXTRA])
def test_other_shapes_match_the_plain_version(card, name, shape, up, down, pad, offset, dtype):
    if name == "packed_remainder":
        p = fir.plan(shape[0] * shape[1], 7, 7, up, down)  # 8x8 at pads of 1: 7x7
        assert p.name == "planes" and p.planes_per_block > 1
        assert shape[0] * shape[1] % p.planes_per_block != 0
    _check(card, shape, ASYM, up, down, pad, dtype, offset)
