"""The reference rounds: MD-GAN (Hardy et al., IPDPS 2019) and the
standalone GAN, with plain float32 Adam.

MD-GAN round, N discriminators, k = max(floor(ln N), 2) fake batches:

 1. k*b fakes from one generator forward;
 2. worker n trains on fake batch (n+1) % k and gives feedback on n % k;
 3. each worker's ``local_epochs`` Adam steps on
    ``BCE(D(real), 1) + BCE(D(fake), 0)`` (two train-mode forwards, each
    with its own batch statistics);
 4. error feedback through the updated discriminator: the gradient of
    ``BCE(D(X_g), 1)`` with respect to the images X_g;
 5. the feedbacks summed onto their source batches, scaled by 1/(b*N),
    pushed through the generator's backward, and a generator Adam step.

Standalone round: one fake batch from the round-start generator, then per
local epoch a discriminator step on (real, that batch) and a generator step
on ``BCE(D(G(z)), 1)`` through the updated discriminator.

Where the family's generator takes noise (``noise_shapes``), ``noise``
holds each noise input's (rounds, samples, *shape), and every generator
forward of round t gets each input's slice t; otherwise the generator gets
no noise argument.

Leaves are named ``g/<name>`` and ``d<w>/<name>`` (w the worker).  A
``fault`` plants one of the faults the benchmark's check must catch, in the
reference put in the program's place: ``"half"`` (half of each real batch
left out, the mean taken over the rest), ``"loss"`` (the reported
discriminator loss is its real term alone), ``("exchange", lo, hi)`` (the
generator hears only workers lo..hi-1: the exchange between chips left out).
The gather fault (a chunk's rounds reading another round's rows) is planted
in the inputs (``harness.reference``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F


def k_batches(num_workers: int) -> int:
    return max(math.floor(math.log(num_workers)), 2)


def bce_real(logits: torch.Tensor) -> torch.Tensor:
    return F.softplus(-logits).mean()


def bce_fake(logits: torch.Tensor) -> torch.Tensor:
    return F.softplus(logits).mean()


class Net:
    """One network's float32 parameters by name, with Adam's moments."""

    def __init__(self, params: Dict[str, torch.Tensor]):
        self.p = {k: v.detach().clone().float().requires_grad_(True) for k, v in params.items()}
        self.m = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.v = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.count = 0

    def adam(self, grads: Sequence[torch.Tensor], opt: dict) -> None:
        b1, b2 = opt["beta_1"], opt["beta_2"]
        self.count += 1
        lr_c1 = opt["lr"] / (1.0 - b1 ** self.count)
        inv_c2 = 1.0 / (1.0 - b2 ** self.count)
        with torch.no_grad():
            for (k, p), g in zip(self.p.items(), grads):
                g = torch.zeros_like(p) if g is None else g
                m, v = self.m[k], self.v[k]
                m.mul_(b1).add_(g, alpha=1.0 - b1)
                v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
                p.sub_(lr_c1 * m / (torch.sqrt(v * inv_c2) + opt["eps"]))


def _named(prefix: str, net: Net, grads) -> Dict[str, torch.Tensor]:
    """A network's gradients by leaf name; an unused leaf's is zero."""
    return {f"{prefix}/{name}": torch.zeros_like(p) if gv is None else gv.detach().clone()
            for (name, p), gv in zip(net.p.items(), grads)}


def _generate(fam, cfg, p, z, ops, noise, t: int):
    """The generator's forward of round t."""
    if noise is None:
        return fam.generator(cfg, p, z, ops)
    return fam.generator(cfg, p, z, ops, noise=[x[t] for x in noise])


def _d_train_loss(fam, cfg, d: Net, real, fake, ops, fault):
    if fault == "half":
        real = real[:real.shape[0] // 2]
    lr = fam.discriminator(cfg, d.p, real, ops)
    lf = fam.discriminator(cfg, d.p, fake, ops)
    return bce_real(lr) + bce_fake(lf), bce_real(lr)


def mdgan_rounds(fam, cfg: dict, num_workers: int, g_params, d_params: List[dict],
                 reals: Sequence[torch.Tensor], zs: Sequence[torch.Tensor], ops,
                 fault=None, noise=None) -> dict:
    """len(reals) rounds from the given weights.  reals[t]: (N, b, C, H, W)
    float32 in [-1, 1]; zs[t]: (k*b, z_dim); noise (or None): a list of
    (rounds, k*b, *shape).  Returns ``losses`` (a dict a round:
    ``mean_d_loss`` and ``g_feedback_loss`` (N,), ``feedback_norm`` ()),
    ``grads`` (the first round's gradient of every leaf as Adam got it) and
    ``params`` (every leaf after the last round)."""
    n, k = num_workers, k_batches(num_workers)
    g, ds = Net(g_params), [Net(p) for p in d_params]
    grads0: Dict[str, torch.Tensor] = {}
    out = []
    for t, (real, z) in enumerate(zip(reals, zs)):
        b = real.shape[1]
        x_all = _generate(fam, cfg, g.p, z, ops, noise, t)
        x_k = x_all.detach().view(k, b, *x_all.shape[1:])
        d_loss = torch.zeros(n, device=z.device)
        g_loss = torch.zeros(n, device=z.device)
        cot = torch.zeros_like(x_k)
        fb_sq = torch.zeros((), device=z.device)
        for w, d in enumerate(ds):
            for e in range(cfg["local_epochs"]):
                loss, real_term = _d_train_loss(fam, cfg, d, real[w], x_k[(w + 1) % k], ops, fault)
                gr = torch.autograd.grad(loss, list(d.p.values()), allow_unused=True)
                if t == 0 and e == 0:
                    grads0.update(_named(f"d{w}", d, gr))
                d.adam(gr, cfg)
                d_loss[w] += (real_term if fault == "loss" else loss).detach()
            x_g = x_k[w % k].clone().requires_grad_(True)
            gl = bce_real(fam.discriminator(cfg, d.p, x_g, ops))
            (fb,) = torch.autograd.grad(gl, x_g)
            g_loss[w] = gl.detach()
            fb_sq += fb.square().sum()
            if not (isinstance(fault, tuple) and not fault[1] <= w < fault[2]):
                cot[w % k] += fb
        gr = torch.autograd.grad(x_all, list(g.p.values()),
                                 grad_outputs=cot.view_as(x_all) / (b * n), allow_unused=True)
        if t == 0:
            grads0.update(_named("g", g, gr))
        g.adam(gr, cfg)
        out.append({"mean_d_loss": d_loss / cfg["local_epochs"], "g_feedback_loss": g_loss,
                    "feedback_norm": fb_sq.sqrt()})
    params = {f"g/{k_}": v.detach() for k_, v in g.p.items()}
    for w, d in enumerate(ds):
        params.update({f"d{w}/{k_}": v.detach() for k_, v in d.p.items()})
    return {"losses": out, "grads": grads0, "params": params}


def standalone_rounds(fam, cfg: dict, g_params, d_params: dict,
                      reals: Sequence[torch.Tensor], zs: Sequence[torch.Tensor], ops,
                      fault=None, noise=None) -> dict:
    """len(reals) standalone rounds.  reals[t]: (b, C, H, W); zs[t]:
    (b, z_dim); noise (or None): a list of (rounds, b, *shape).  Returns
    ``losses`` (``mean_d_loss``, ``mean_g_loss`` a round), ``grads`` (the
    first local epoch's gradients) and ``params``."""
    g, d = Net(g_params), Net(d_params)
    grads0: Dict[str, torch.Tensor] = {}
    out = []
    epochs = cfg["local_epochs"]
    for t, (real, z) in enumerate(zip(reals, zs)):
        with torch.no_grad():
            fake0 = _generate(fam, cfg, g.p, z, ops, noise, t)
        d_sum = torch.zeros((), device=z.device)
        g_sum = torch.zeros((), device=z.device)
        for e in range(epochs):
            loss, real_term = _d_train_loss(fam, cfg, d, real, fake0, ops, fault)
            gd = torch.autograd.grad(loss, list(d.p.values()), allow_unused=True)
            d.adam(gd, cfg)
            fake = _generate(fam, cfg, g.p, z, ops, noise, t)
            gl = bce_real(fam.discriminator(cfg, d.p, fake, ops))
            gg = torch.autograd.grad(gl, list(g.p.values()), allow_unused=True)
            if t == 0 and e == 0:
                grads0.update({**_named("d0", d, gd), **_named("g", g, gg)})
            g.adam(gg, cfg)
            d_sum += (real_term if fault == "loss" else loss).detach()
            g_sum += gl.detach()
        out.append({"mean_d_loss": d_sum / epochs, "mean_g_loss": g_sum / epochs})
    params = {f"g/{k_}": v.detach() for k_, v in g.p.items()}
    params.update({f"d0/{k_}": v.detach() for k_, v in d.p.items()})
    return {"losses": out, "grads": grads0, "params": params}
