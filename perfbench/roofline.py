"""The yardstick's constants and counts: the H100's peaks, and the bytes and
operations the benchmark charges a round.

Peaks: NVIDIA's H100 SXM data sheet, dense (no sparsity), at the 700 W
power limit.  The FLOPs of a round come from the frozen reference
(:func:`per_sample_flops`, counted once and written into each
configuration's file); a test counts them again.
"""

from __future__ import annotations

from typing import Dict

import torch

HBM_BYTES_PER_S = 3.35e12
# dense tensor-core peak by the configuration's compute dtype; float32
# convolutions run in TF32 on this card
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 494.7e12}
MOMENT_BYTES = {"float32": 4, "bfloat16": 2}


def adam_bytes(elements: int, moment_dtype: str) -> int:
    """Bytes Adam must move for ``elements`` parameters: the parameter read
    and written, the gradient read, each moment read and written."""
    return elements * (4 + 4 + 4 + 4 * MOMENT_BYTES[moment_dtype])


def sampling_bytes(rows: int, image_shape) -> int:
    """Bytes of gathering ``rows`` images: uint8 H*W*C read, float32 C*H*W
    written, one int32 index read."""
    hwc = int(image_shape[0]) * int(image_shape[1]) * int(image_shape[2])
    return rows * (hwc + 4 * hwc + 4)


def leaf_elements(fam, cfg: dict, net: str) -> int:
    total = 0
    for _, shape, _ in fam.leaves(cfg, net):
        n = 1
        for s in shape:
            n *= s
        total += n
    return total


def per_sample_flops(fam, cfg: dict, batch: int = 2) -> Dict[str, int]:
    """FLOPs a sample of each pass of the frozen reference, counted by
    ``FlopCounterMode`` on the meta device (convolutions and matrix products):
    the generator's forward and its backward to its parameters (the latent
    needs none), a discriminator's forward, its backward to its parameters
    (the D step: the image needs none) and its backward to the image alone
    (the error feedback).  A generator that takes noise (the family's
    ``noise_shapes``) gets zeros of the declared shapes."""
    from torch.utils.flop_counter import FlopCounterMode

    from perfbench import spec
    from perfbench.reference.ops import Ops

    ops = Ops("float32")
    meta = torch.device("meta")

    def leaves(net, grad):
        return {name: torch.empty(shape, device=meta, requires_grad=grad)
                for name, shape, _ in fam.leaves(cfg, net)}

    def count(fn) -> int:
        with FlopCounterMode(display=False) as counter:
            fn()
        total = counter.get_total_flops()
        if total % batch:
            raise ValueError(f"a pass's {total} FLOPs do not split over {batch} samples")
        return total // batch

    h, w, c = cfg["image_shape"]
    z = torch.empty(batch, cfg["z_dim"], device=meta)
    shapes = spec.noise_shapes(fam, cfg)
    extra = {} if shapes is None else {
        "noise": [torch.zeros(batch, *s, device=meta) for s in shapes]}
    g = leaves("g", True)
    img = fam.generator(cfg, g, z, ops, **extra)
    d = leaves("d", True)
    x = torch.empty(batch, c, h, w, device=meta)
    logits = fam.discriminator(cfg, d, x, ops)
    xg = torch.empty(batch, c, h, w, device=meta, requires_grad=True)
    logits_g = fam.discriminator(cfg, d, xg, ops)
    return {
        "g_fwd": count(lambda: fam.generator(cfg, g, z, ops, **extra)),
        "g_bwd": count(lambda: torch.autograd.grad(img, list(g.values()), torch.ones_like(img),
                                                   allow_unused=True)),
        "d_fwd": count(lambda: fam.discriminator(cfg, d, x, ops)),
        "d_bwd_train": count(lambda: torch.autograd.grad(logits.sum(), list(d.values()),
                                                         allow_unused=True)),
        "d_bwd_input": count(lambda: torch.autograd.grad(logits_g.sum(), xg)),
    }
