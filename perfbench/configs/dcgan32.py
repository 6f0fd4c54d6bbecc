"""Plain reference of the DCGAN-32 pair (Radford et al. 2016, at the MD-GAN
reference's widths), as functions of a dict of parameters.

A frozen copy of the semantics of ``mdgan_tpu_torch/models/dcgan32.py`` and
``models/layers.py``, written without them: NCHW, OIHW weights (IOHW for the
transposed convolutions), every forward in train mode.  BatchNorm
normalizes with the batch's mean and ``max(E[x^2] - E[x]^2, 0)`` (flax's
fast variance), eps 1e-5; running statistics feed no forward in train mode,
so the reference keeps none.

    D: Conv(3->ndf, k4 s2 p1) LReLU(0.2); Conv(ndf->2ndf) BN LReLU;
       Conv(2ndf->4ndf) BN LReLU; Conv(4ndf->1, k4 s1 p0) -> logit
    G: ConvT(z->8ngf, k4 s1 p0) BN ReLU; ConvT(8ngf->4ngf, k4 s2 p1) BN ReLU;
       ConvT(4ngf->2ngf) BN ReLU; ConvT(2ngf->3) tanh

Every stored activation goes through ``ops.act`` (float8 under the
control, ``reference/ops.py``).

Init (the DCGAN init): convolution weights N(0, 0.02), BatchNorm scale
N(1, 0.02), BatchNorm bias 0.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# the configuration keys that are the program's width keywords
WIDTHS = ("ngf", "ndf")

W_INIT = ("normal", 0.0, 0.02)
BN_SCALE_INIT = ("normal", 1.0, 0.02)
ZERO = ("const", 0.0)
BN_EPS = 1e-5


def leaves(cfg: dict, net: str):
    """[(name, shape, init)] of the generator ("g") or a discriminator
    ("d"); names are the parameter names the program's modules use."""
    z, c = cfg["z_dim"], cfg["image_shape"][2]
    out = []
    if net == "g":
        ch = [z, cfg["ngf"] * 8, cfg["ngf"] * 4, cfg["ngf"] * 2]
        for i in range(3):
            out += [(f"block{i}.conv.weight", (ch[i], ch[i + 1], 4, 4), W_INIT),
                    (f"block{i}.bn.weight", (ch[i + 1],), BN_SCALE_INIT),
                    (f"block{i}.bn.bias", (ch[i + 1],), ZERO)]
        return out + [("out.weight", (ch[3], c, 4, 4), W_INIT)]
    if net == "d":
        ch = [c, cfg["ndf"], cfg["ndf"] * 2, cfg["ndf"] * 4]
        out.append(("block0.conv.weight", (ch[1], ch[0], 4, 4), W_INIT))
        for i in (1, 2):
            out += [(f"block{i}.conv.weight", (ch[i + 1], ch[i], 4, 4), W_INIT),
                    (f"block{i}.bn.weight", (ch[i + 1],), BN_SCALE_INIT),
                    (f"block{i}.bn.bias", (ch[i + 1],), ZERO)]
        return out + [("out.weight", (1, ch[3], 4, 4), W_INIT)]
    raise ValueError(f"net must be 'g' or 'd', got {net!r}")


def batch_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    mean = x.mean(dim=(0, 2, 3))
    var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
    mul = torch.rsqrt(var + BN_EPS) * weight
    return (x - mean[None, :, None, None]) * mul[None, :, None, None] + bias[None, :, None, None]


def generator(cfg: dict, p: dict, z: torch.Tensor, ops) -> torch.Tensor:
    x = z.reshape(z.shape[0], -1, 1, 1)
    for i, (stride, pad) in enumerate(((1, 0), (2, 1), (2, 1))):
        x = ops.conv_transpose2d(x, p[f"block{i}.conv.weight"], stride, pad)
        x = ops.act(F.relu(batch_norm(x, p[f"block{i}.bn.weight"], p[f"block{i}.bn.bias"])))
    return torch.tanh(ops.conv_transpose2d(x, p["out.weight"], 2, 1))


def discriminator(cfg: dict, p: dict, x: torch.Tensor, ops) -> torch.Tensor:
    b = x.shape[0]
    x = ops.act(F.leaky_relu(ops.conv2d(x, p["block0.conv.weight"], stride=2, padding=1), 0.2))
    for i in (1, 2):
        x = ops.conv2d(x, p[f"block{i}.conv.weight"], stride=2, padding=1)
        x = ops.act(F.leaky_relu(batch_norm(x, p[f"block{i}.bn.weight"], p[f"block{i}.bn.bias"]),
                                 0.2))
    return ops.conv2d(x, p["out.weight"]).reshape(b)
