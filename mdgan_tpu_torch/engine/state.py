"""Network state on flat arenas, and the Adam step.

Port of ``mdgan_tpu/engine/state.py:23-95, 195-266``.  The JAX package keeps
one pytree per network, the N discriminators stacked on a leading axis, with
optax's Adam state (one shared ``count``, ``mu``/``nu`` shaped like the
params).  Here a :class:`NetState` holds n copies of one ``nn.Module`` (n=1
for the generator, N for the discriminators) whose parameters, gradients,
Adam moments and BatchNorm running statistics live in flat contiguous
arenas, worker-major:

    params[w * P : (w + 1) * P]  ==  module w's parameters, in named order

Every ``nn.Parameter`` (and its ``.grad``) and every BN buffer is a view into
its arena.  So one kernel launch runs Adam over a whole network (all N
discriminators at once, as the stacked JAX leaves do), and a discriminator
swap is one gather along the worker axis of each arena.  A leaf of all n
copies at once is a strided (n, *shape) view of its arena
(:meth:`NetState.stacked`), which the discriminators that run as one
grouped network read and write (``engine/mdgan.py``).

``apply_train_pair`` (``state.py:62-95``) fuses the real and fake D forwards
with a chained running-stat formula that reproduces two sequential
train-mode forwards; the port runs exactly those two forwards instead.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np
import torch
from torch import nn

from mdgan_tpu_torch.core.config import OptimizerConfig
from mdgan_tpu_torch.ops.adam import adam_update, bias_scalars


def moment_dtype(cfg: OptimizerConfig) -> torch.dtype:
    """The torch dtype of an optimizer config's Adam moments."""
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    if cfg.mu_dtype not in dtypes or cfg.nu_dtype != cfg.mu_dtype:
        raise ValueError(f"Adam moments must be both float32 or both bfloat16 "
                         f"(--moment_dtype), got mu {cfg.mu_dtype!r}, nu {cfg.nu_dtype!r}")
    return dtypes[cfg.mu_dtype]


class NetState:
    """n copies of one network on flat arenas, with Adam state in optax's
    layout: ``mu``/``nu`` shaped like the params, one shared ``count``.
    ``moment_dtype`` is the moments' storage dtype, float32 or bfloat16
    (``--moment_dtype``; the params and gradients stay float32)."""

    def __init__(self, modules: Sequence[nn.Module], device,
                 moment_dtype: torch.dtype = torch.float32):
        if not modules:
            raise ValueError("NetState needs at least one module")
        self.n = len(modules)
        self.modules: List[nn.Module] = [m.to(device).train() for m in modules]
        first = self.modules[0]
        self.param_names = [k for k, _ in first.named_parameters()]
        self.param_shapes = [tuple(p.shape) for _, p in first.named_parameters()]
        self.stat_names = [k for k, _ in first.named_buffers()]
        self.stat_shapes = [tuple(b.shape) for _, b in first.named_buffers()]
        self.numel = sum(int(np.prod(s)) for s in self.param_shapes)
        self.stat_numel = sum(int(np.prod(s)) for s in self.stat_shapes)

        kw = dict(dtype=torch.float32, device=device)
        self.params = torch.empty(self.n * self.numel, **kw)
        self.grads = torch.zeros(self.n * self.numel, **kw)
        self.mu = torch.zeros(self.n * self.numel, dtype=moment_dtype, device=device)
        self.nu = torch.zeros(self.n * self.numel, dtype=moment_dtype, device=device)
        self.stats = torch.empty(self.n * self.stat_numel, **kw)
        self.count = 0
        with torch.no_grad():
            for w, m in enumerate(self.modules):
                self._bind(m, w)

    def _bind(self, m: nn.Module, w: int) -> None:
        """Move module ``w``'s tensors into the arenas and make them views."""
        named = dict(m.named_parameters())
        off = w * self.numel
        for name, shape in zip(self.param_names, self.param_shapes):
            p = named[name]
            size = p.numel()
            if tuple(p.shape) != shape:
                raise ValueError(f"module {w}: {name} {tuple(p.shape)} != {shape}")
            self.params[off:off + size].copy_(p.detach().reshape(-1))
            p.data = self.params[off:off + size].view(shape)
            p.grad = self.grads[off:off + size].view(shape)
            off += size
        off = w * self.stat_numel
        for name, shape in zip(self.stat_names, self.stat_shapes):
            owner_name, _, attr = name.rpartition(".")
            owner = m.get_submodule(owner_name)
            buf = getattr(owner, attr)
            size = buf.numel()
            self.stats[off:off + size].copy_(buf.reshape(-1))
            setattr(owner, attr, self.stats[off:off + size].view(shape))
            off += size

    # --- per-copy views (tests, weight import/export) ---
    def views(self, arena: torch.Tensor, w: int) -> Dict[str, torch.Tensor]:
        """Named per-parameter views of copy ``w`` of a params-shaped arena
        (``params``, ``grads``, ``mu`` or ``nu``, or a clone of one)."""
        return self._named(arena, w * self.numel, self.param_names, self.param_shapes)

    def stat_views(self, arena: torch.Tensor, w: int) -> Dict[str, torch.Tensor]:
        """Named views of copy ``w`` of a stats-shaped arena (``stats`` or a
        clone of it)."""
        return self._named(arena, w * self.stat_numel, self.stat_names, self.stat_shapes)

    def stacked(self, arena: torch.Tensor, stats: bool = False) -> Dict[str, torch.Tensor]:
        """Named (n, *shape) views of every copy's leaves of a params-shaped
        arena (of a stats-shaped one with ``stats``): row w is copy w's."""
        size = self.stat_numel if stats else self.numel
        names, shapes = ((self.stat_names, self.stat_shapes) if stats
                         else (self.param_names, self.param_shapes))
        rows = arena.view(self.n, size)
        out, off = {}, 0
        for name, shape in zip(names, shapes):
            numel = int(np.prod(shape))
            out[name] = rows[:, off:off + numel].view(self.n, *shape)
            off += numel
        return out

    @staticmethod
    def _named(arena, off, names, shapes) -> Dict[str, torch.Tensor]:
        out = {}
        for name, shape in zip(names, shapes):
            size = int(np.prod(shape))
            out[name] = arena[off:off + size].view(shape)
            off += size
        return out

    def snapshot(self) -> Dict:
        """Device-side clones of the arenas a checkpoint stores, and the Adam
        ``count``.  The arenas are updated in place every round, so a
        background thread must read a clone, never the live tensors."""
        return {"params": self.params.clone(), "stats": self.stats.clone(),
                "mu": self.mu.clone(), "nu": self.nu.clone(), "count": self.count}

    def zero_grad(self) -> None:
        self.grads.zero_()

    def adam_step(self, cfg: OptimizerConfig) -> None:
        """One Adam step over every copy: one kernel launch on CUDA, the
        kernel of the moments' dtype (``state.optimizer_step``,
        ``state.py:261-266``)."""
        self.count += 1
        lr_c1, inv_c2 = bias_scalars(cfg.lr, cfg.beta_1, cfg.beta_2, self.count)
        adam_update(self.params, self.grads, self.mu, self.nu, lr_c1, inv_c2,
                    cfg.beta_1, cfg.beta_2, cfg.eps)

    @torch.no_grad()
    def permute_(self, perm: torch.Tensor, with_opt_state: bool = False) -> None:
        """Copy w takes copy perm[w]'s params and BN stats (and Adam moments
        if ``with_opt_state``): the gather swap of ``mdgan.py:570-590``."""
        arenas = [(self.params, self.numel), (self.stats, self.stat_numel)]
        if with_opt_state:
            arenas += [(self.mu, self.numel), (self.nu, self.numel)]
        for arena, size in arenas:
            stacked = arena.view(self.n, size)
            stacked.copy_(stacked[perm])


@dataclasses.dataclass
class MDGANState:
    """Generator (n=1), the discriminators this process holds (all N, or
    its rank's N/W under ``torch.distributed``), the run's seed and round
    counter."""

    g: NetState
    d: NetState
    seed: int
    step: int = 0


@dataclasses.dataclass
class StandaloneState:
    """Generator and one discriminator (both n=1), the run's seed and round
    counter (``mdgan_tpu/engine/state.py`` ``StandaloneState``)."""

    g: NetState
    d: NetState
    seed: int
    step: int = 0
