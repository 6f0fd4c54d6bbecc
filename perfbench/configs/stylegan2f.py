"""Plain reference of StyleGAN2 config-f (Karras et al., CVPR 2020;
NVlabs/stylegan2 ``training/networks_stylegan2.py``, ``dnnlib/tflib/ops/
upfirdn_2d.py``, ``run_training.py --config=config-f``), as functions of a
dict of parameters.

Written from the published equations, without the program: NCHW, OIHW
weights, float32, every resampling its own ``upfirdn2d`` (zeros inserted,
padded, a depthwise ``F.conv2d``).  Widths nf(s) = min(fmap_base / 2^s,
fmap_max) at resolution 2^(s+1); z = w = 512.

    mapping: pixel-norm; map_layers x (equalized dense 512, lr_mul 0.01, lrelu)
    G: const 4x4 -> modconv 3x3 + noise + bias + lrelu -> tRGB;
       per block 8..max_res: up-modconv (modulate, transposed conv stride 2
       with the kernel flipped, FIR [1,3,3,1] gain 4 pad (1,1), demodulate),
       modconv 3x3, each + noise + bias + lrelu; rgb = upfirdn2d(rgb, up 2,
       pad (2,1), gain 4) + tRGB (1x1 modconv, no demodulation, + bias);
       the image is rgb, linear
    D: fromRGB 1x1 + bias + lrelu; per block max_res..8: conv 3x3 + bias +
       lrelu, blur pad (2,2) + conv 3x3 stride 2 + bias + lrelu, skip: blur
       pad (1,1) + conv 1x1 stride 2, (x + skip) / sqrt(2); minibatch stddev
       (group 4, one feature); conv 3x3 + bias + lrelu; dense (NCHW
       flattened) + lrelu; dense -> logit

lrelu is leaky_relu(0.2) * sqrt(2); every conv and dense weight is drawn
N(0, 1) (the mapping's N(0, 100)) and scaled by lr_mul / sqrt(fan_in) when
used (NVlabs' run-time coefficient); the style affine of each modulated conv (bias 1) and the
demodulation are computed in float32, as the program does under autocast.
Noise: x += strength * n, one scalar strength a layer (init 0), n given per
round as (b, 1, r, r) (``noise_shapes``).  Departures from NVlabs' training,
kept by the program too: no R1 or path-length regularization, no style
mixing, no generator EMA, no truncation.

Every stored activation and resampled tensor goes through ``ops.act``
(float8 under the control, ``reference/ops.py``).  ``upfirdn2d_bytes`` gives
the bytes the resampling must move a sample and pass, counted from these
functions' own resampling calls.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

# the configuration keys that are the program's width keywords
WIDTHS = ("fmap_base", "fmap_max", "max_res", "map_layers")

ONE = ("normal", 0.0, 1.0)
MAPPING = ("normal", 0.0, 100.0)     # 1 / lr_mul
ZERO = ("const", 0.0)
MOD_BIAS = ("const", 1.0)
MAP_LR_MUL = 0.01
SQRT2 = math.sqrt(2.0)
_TAPS = np.array([1.0, 3.0, 3.0, 1.0])
FIR = np.outer(_TAPS, _TAPS) / np.outer(_TAPS, _TAPS).sum()

# while a list, each resampling call appends (input elements, output elements)
_CALLS = None


def _nf(cfg: dict, stage: int) -> int:
    return min(int(cfg["fmap_base"] / 2.0 ** stage), cfg["fmap_max"])


def _ch(cfg: dict, res: int) -> int:
    return _nf(cfg, int(math.log2(res)) - 1)


def _resolutions(cfg: dict):
    return [2 ** i for i in range(2, int(math.log2(cfg["max_res"])) + 1)]


def noise_shapes(cfg: dict):
    """Per-sample shapes of the generator's noise inputs, in forward order."""
    return [(1, 4, 4)] + [(1, r, r) for r in _resolutions(cfg)[1:] for _ in range(2)]


def leaves(cfg: dict, net: str):
    """[(name, shape, init)] of the generator ("g") or a discriminator
    ("d"); names are the parameter names the program's modules use."""
    z, c = cfg["z_dim"], cfg["image_shape"][2]
    out = []
    if net == "g":
        for i in range(cfg["map_layers"]):
            out += [(f"mapping.layers.{i}.weight", (z, z), MAPPING),
                    (f"mapping.layers.{i}.bias", (z,), ZERO)]
        c4 = _ch(cfg, 4)
        out.append(("const", (c4, 4, 4), ONE))

        def modconv(name, cin, cout, k):
            return [(f"{name}.weight", (cout, cin, k, k), ONE),
                    (f"{name}.mod.weight", (cin, z), ONE), (f"{name}.mod.bias", (cin,), MOD_BIAS)]

        def layer(name, cin, cout):
            return modconv(f"{name}.conv", cin, cout, 3) + [
                (f"{name}.noise_strength", (), ZERO), (f"{name}.bias", (cout,), ZERO)]

        def trgb(name, cin):
            return modconv(f"{name}.conv", cin, c, 1) + [(f"{name}.bias", (c,), ZERO)]

        out += layer("b4", c4, c4) + trgb("trgb4", c4)
        cin = c4
        for res in _resolutions(cfg)[1:]:
            f = _ch(cfg, res)
            out += layer(f"b{res}.0", cin, f) + layer(f"b{res}.1", f, f) + trgb(f"trgb{res}", f)
            cin = f
        return out
    if net == "d":
        out += [("from_rgb.weight", (_ch(cfg, cfg["max_res"]), c, 1, 1), ONE),
                ("from_rgb.bias", (_ch(cfg, cfg["max_res"]),), ZERO)]
        for res in _resolutions(cfg)[:0:-1]:
            cin, cout = _ch(cfg, res), _ch(cfg, res // 2)
            out += [(f"b{res}.conv0.weight", (cin, cin, 3, 3), ONE),
                    (f"b{res}.conv0.bias", (cin,), ZERO),
                    (f"b{res}.conv1.weight", (cout, cin, 3, 3), ONE),
                    (f"b{res}.conv1.bias", (cout,), ZERO),
                    (f"b{res}.skip.weight", (cout, cin, 1, 1), ONE)]
        c4, c0 = _nf(cfg, 1), _nf(cfg, 0)
        return out + [("conv_out.weight", (c4, c4 + 1, 3, 3), ONE), ("conv_out.bias", (c4,), ZERO),
                      ("fc.weight", (c0, c4 * 16), ONE), ("fc.bias", (c0,), ZERO),
                      ("out.weight", (1, c0), ONE), ("out.bias", (1,), ZERO)]
    raise ValueError(f"net must be 'g' or 'd', got {net!r}")


def upfirdn2d(x: torch.Tensor, k: np.ndarray, up: int = 1, pad=(0, 0, 0, 0)) -> torch.Tensor:
    """Each plane of x upsampled by ``up`` (zeros after each pixel), padded
    by (x0, x1, y0, y1), convolved with the 2-D FIR ``k`` (the filter
    flipped into a correlation; depthwise), in x's dtype."""
    n, c, h, w = x.shape
    y = torch.zeros(n * c, 1, h * up, w * up, dtype=x.dtype, device=x.device)
    y[:, :, ::up, ::up] = x.reshape(n * c, 1, h, w)
    y = F.pad(y, tuple(pad))
    weight = torch.tensor(np.ascontiguousarray(k[::-1, ::-1]), dtype=x.dtype,
                          device=x.device)[None, None]
    out = F.conv2d(y, weight).reshape(n, c, y.shape[2] - k.shape[0] + 1, y.shape[3] - k.shape[1] + 1)
    if _CALLS is not None:
        _CALLS.append((x.numel(), out.numel()))
    return out


def _lrelu(x):
    return F.leaky_relu(x, 0.2) * SQRT2


def _float32(x: torch.Tensor):
    """The style path's precision: float32 whatever autocast says."""
    return torch.autocast(device_type="cuda" if x.is_cuda else "cpu", enabled=False)


def _modconv(p, name, x, w_lat, ops, demodulate=True, up=False):
    weight = p[f"{name}.weight"]
    cout, cin, k, _ = weight.shape
    with _float32(x):
        mod_w = p[f"{name}.mod.weight"]
        s = F.linear(w_lat.float(), mod_w * (1.0 / math.sqrt(mod_w.shape[1])),
                     p[f"{name}.mod.bias"])
        w = weight * (1.0 / math.sqrt(cin * k * k))
        d = torch.rsqrt((s * s) @ (w * w).sum(dim=(2, 3)).t() + 1e-8) if demodulate else None
    x = x * s[:, :, None, None]
    if up:
        y = ops.conv_transpose2d(x, w.transpose(0, 1).flip(2, 3), stride=2)
        y = ops.act(upfirdn2d(y, FIR * 4.0, pad=(1, 1, 1, 1)))
    else:
        y = ops.conv2d(x, w, padding=k // 2)
    return y if d is None else y * d[:, :, None, None]


def generator(cfg: dict, p: dict, z: torch.Tensor, ops, noise) -> torch.Tensor:
    x = z * torch.rsqrt((z * z).mean(dim=1, keepdim=True) + 1e-8)
    for i in range(cfg["map_layers"]):
        w = p[f"mapping.layers.{i}.weight"]
        x = ops.act(_lrelu(ops.linear(x, w * (MAP_LR_MUL / math.sqrt(w.shape[1])),
                                      p[f"mapping.layers.{i}.bias"] * MAP_LR_MUL)))
    w_lat = x

    def layer(name, x, n, up=False):
        y = _modconv(p, f"{name}.conv", x, w_lat, ops, up=up)
        y = y + p[f"{name}.noise_strength"] * n
        return ops.act(_lrelu(y + p[f"{name}.bias"][None, :, None, None]))

    def trgb(name, x):
        return _modconv(p, f"{name}.conv", x, w_lat, ops, demodulate=False) \
            + p[f"{name}.bias"][None, :, None, None]

    x = layer("b4", p["const"][None].expand(z.shape[0], -1, -1, -1), noise[0])
    rgb = trgb("trgb4", x)
    for i, res in enumerate(_resolutions(cfg)[1:]):
        x = layer(f"b{res}.0", x, noise[1 + 2 * i], up=True)
        x = layer(f"b{res}.1", x, noise[2 + 2 * i])
        rgb = ops.act(upfirdn2d(rgb, FIR * 4.0, up=2, pad=(2, 1, 2, 1))) + trgb(f"trgb{res}", x)
    return rgb.float()


def _conv(p, name, x, ops, stride=1, padding=0):
    w = p[f"{name}.weight"]
    return ops.conv2d(x, w * (1.0 / math.sqrt(w[0].numel())), p.get(f"{name}.bias"), stride,
                      padding)


def _dense(p, name, x, ops):
    w = p[f"{name}.weight"]
    return ops.linear(x, w * (1.0 / math.sqrt(w.shape[1])), p[f"{name}.bias"])


def minibatch_stddev(x: torch.Tensor, group: int = 4) -> torch.Tensor:
    """NVlabs' ``minibatch_stddev_layer`` with one feature: groups of g
    samples strided b/g apart, their stddev averaged over C, H, W, tiled."""
    b, c, h, w = x.shape
    g = min(group, b)
    y = x.float().reshape(g, b // g, c, h, w)
    y = torch.sqrt((y - y.mean(dim=0)).square().mean(dim=0) + 1e-8).mean(dim=(1, 2, 3))
    y = y.repeat(g).reshape(b, 1, 1, 1).expand(b, 1, h, w).to(x.dtype)
    return torch.cat([x, y], dim=1)


def discriminator(cfg: dict, p: dict, x: torch.Tensor, ops) -> torch.Tensor:
    b = x.shape[0]
    y = ops.act(_lrelu(_conv(p, "from_rgb", x, ops)))
    for res in _resolutions(cfg)[:0:-1]:
        t = y
        y = ops.act(_lrelu(_conv(p, f"b{res}.conv0", y, ops, padding=1)))
        y = ops.act(upfirdn2d(y, FIR, pad=(2, 2, 2, 2)))
        y = ops.act(_lrelu(_conv(p, f"b{res}.conv1", y, ops, stride=2)))
        t = ops.act(upfirdn2d(t, FIR, pad=(1, 1, 1, 1)))
        y = (y + _conv(p, f"b{res}.skip", t, ops, stride=2)) * (1.0 / SQRT2)
    y = ops.act(_lrelu(_conv(p, "conv_out", minibatch_stddev(y), ops, padding=1)))
    y = ops.act(_lrelu(_dense(p, "fc", y.reshape(b, -1), ops)))
    return _dense(p, "out", y, ops).reshape(b).float()


def upfirdn2d_bytes(cfg: dict, batch: int = 2) -> dict:
    """Bytes a sample the resampling must move in each pass, at the
    configuration's compute dtype: each call's input read once and output
    written once, counted from :func:`upfirdn2d`'s calls in a forward on the
    meta device.  A backward moves each call's bytes again (the gradient
    of a resampling is a resampling of the output's gradient to the
    input's size), and every call lies on the path from the parameters (or
    the image) to the output, so each backward pass moves what its forward
    does."""
    from perfbench.reference.ops import Ops

    size = {"bfloat16": 2, "float32": 4}[cfg["compute_dtype"]]
    meta, ops = torch.device("meta"), Ops("float32")

    def counted(fn) -> int:
        global _CALLS
        _CALLS = []
        try:
            fn()
            total = sum(i + o for i, o in _CALLS) * size
        finally:
            _CALLS = None
        if total % batch:
            raise ValueError(f"{total} bytes do not split over {batch} samples")
        return total // batch

    def params(net):
        return {name: torch.empty(shape, device=meta) for name, shape, _ in leaves(cfg, net)}

    h, w, c = cfg["image_shape"]
    z = torch.empty(batch, cfg["z_dim"], device=meta)
    noise = [torch.zeros(batch, *s, device=meta) for s in noise_shapes(cfg)]
    x = torch.empty(batch, c, h, w, device=meta)
    g = counted(lambda: generator(cfg, params("g"), z, ops, noise))
    d = counted(lambda: discriminator(cfg, params("d"), x, ops))
    return {"g_fwd": g, "g_bwd": g, "d_fwd": d, "d_bwd_train": d, "d_bwd_input": d}
