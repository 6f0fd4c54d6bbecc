"""The generator over the mesh's tensor axis: Megatron-style column
parallelism (counterpart of ``generator_sharding``,
``mdgan_tpu/core/mesh.py:80-106``).

JAX shards every generator leaf, and its Adam moments, whose trailing (flax)
dim T divides, and lets XLA insert the activation collectives.  Mapped onto
the port's layouts by ``models/from_jax.py``'s kinds, that trailing dim is
dim 0 of an ``nn.Linear``/``EqualDense``/``nn.Conv2d``/``ModulatedConv``
weight, dim 1 of an ``nn.ConvTranspose2d`` weight (torch stores it (in, out,
kh, kw)), the channel dim of StyleGAN2's constant, and dim 0 of every
vector (biases, BatchNorm scales and statistics).  :func:`shard_module`
keeps this rank's slice of each such leaf as the parameter itself, so the
generator's ``NetState`` arenas hold the slices and the replicated leaves,
and one Adam launch still covers them, and makes the layers compute with it:

  * a sharded layer computes its output-channel slice from the whole input,
    which enters through ``copy_to_group`` (its gradient is summed over the
    axis), and ``gather`` hands the whole activation to what follows (its
    gradient keeps this rank's slice);
  * a DCGAN ``ConvTransposeBlock`` does so around conv, BatchNorm and ReLU:
    the statistics of a channel slice are local;
  * a ``ModulatedConv`` with sharded output channels also takes its style
    scales through ``copy_to_group``: the scales feed this rank's slice only;
  * vectors used elementwise outside a layer (StyleGAN2's synthesis biases
    and constant) are gathered whole where the forward reads them
    (``distributed.whole``);
  * replicated layers (the 3-channel output convs at T=2 or 4) compute on
    the whole input on every rank, with no collective.

:func:`gather_arenas` puts the slices back together, into the arenas of the
unsharded generator (:func:`full_layout`), for evals, exports and
checkpoints.
"""

from __future__ import annotations

import copy
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from mdgan_tpu_torch.core import distributed
from mdgan_tpu_torch.models import from_jax
from mdgan_tpu_torch.models.layers import ConvTransposeBlock
from mdgan_tpu_torch.models.stylegan2 import EqualDense, ModulatedConv, StyleGAN2Generator, \
    SynthesisBlock
from mdgan_tpu_torch.models.stylegan2f import StyleGAN2FGenerator

# the port dim of each weight-map kind's flax trailing dim
_TRAILING = {"conv": 0, "convt": 1, "dense": 0, "const": 0, "vec": 0, "stat": 0}


def sharded_dims(module: nn.Module, size: int) -> Dict[str, int]:
    """The leaves of ``module`` (by state-dict name) that JAX's rule splits
    over a tensor axis of ``size``, each with the port dim it splits."""
    if size <= 1:
        return {}
    shapes = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    out = {}
    for name, _, kind in from_jax.entries(from_jax.role_of(module)):
        dim = _TRAILING.get(kind)
        if dim is not None and shapes[name][dim] % size == 0:
            out[name] = dim
    return out


def _column(m: nn.Module, axis, dim: int, copy_out: bool = False) -> None:
    """``m`` as a column-parallel layer: input through ``copy_to_group``,
    output slices gathered along ``dim`` (and, with ``copy_out``, passed on
    through ``copy_to_group`` to a layer that uses them on its own slice)."""
    def pre(_, args):
        return (distributed.copy_to_group(args[0], axis),) + tuple(args[1:])

    def post(_, args, out):
        out = distributed.gather(out, axis, dim)
        return distributed.copy_to_group(out, axis) if copy_out else out

    m.register_forward_pre_hook(pre)
    m.register_forward_hook(post)


@torch.no_grad()
def shard_module(module: nn.Module, axis) -> nn.Module:
    """``module`` (a generator of any family, with its weights) in place as
    its tensor-parallel form on ``axis``: this rank's slices of the sharded
    leaves, and the layers computing with them.  Tags the module with
    ``tensor_shards`` (name -> dim) and ``tensor_rank`` (index, size), which
    ``models/from_jax.py`` reads to load whole leaves onto the slices."""
    if axis.size > 1 and isinstance(module, StyleGAN2FGenerator):
        raise NotImplementedError("StyleGAN2 config-f (StyleGAN2FGenerator, dataset "
                                  "LSUNChurch256) has no tensor-parallel form: run it with "
                                  "--num_tensor 1")
    dims = sharded_dims(module, axis.size)
    module.tensor_shards, module.tensor_rank = dims, (axis.index, axis.size)
    if not dims:
        return module
    for name, dim in dims.items():
        owner_name, _, attr = name.rpartition(".")
        owner = module.get_submodule(owner_name)
        slot = owner._parameters if attr in owner._parameters else owner._buffers
        piece = slot[attr].chunk(axis.size, dim)[axis.index].clone()
        slot[attr] = nn.Parameter(piece) if attr in owner._parameters else piece

    covered, copied = set(), set()
    for mname, m in module.named_modules():
        pre = f"{mname}." if mname else ""
        weight = pre + "weight"
        if isinstance(m, ConvTransposeBlock) and pre + "conv.weight" in dims:
            block = {pre + k for k in ("conv.weight", "bn.weight", "bn.bias",
                                       "bn.running_mean", "bn.running_var")}
            if not block <= set(dims):
                raise ValueError(f"{mname}: conv and BatchNorm must split together")
            _column(m, axis, 1)
            covered |= block
        elif weight in covered:
            continue  # inside a block
        elif isinstance(m, ModulatedConv) and weight in dims:
            _column(m, axis, 1)
            covered.add(weight)
            copied.add(pre + "mod")
            if pre + "mod.weight" not in dims:  # whole scales, used on a slice
                m.mod.register_forward_hook(
                    lambda _, args, out: distributed.copy_to_group(out, axis))
        elif isinstance(m, (nn.Linear, EqualDense, nn.Conv2d, nn.ConvTranspose2d)) \
                and weight in dims:
            gather_dim = -1 if isinstance(m, (nn.Linear, EqualDense)) else 1
            _column(m, axis, gather_dim, copy_out=mname in copied)
            covered |= {weight, pre + "bias"} & set(dims)
    for name in set(dims) - covered:
        owner_name, _, attr = name.rpartition(".")
        owner = module.get_submodule(owner_name)
        read_whole = ((isinstance(owner, SynthesisBlock) and attr in ("bias0", "bias1"))
                      or (isinstance(owner, StyleGAN2Generator) and attr == "const"))
        if not read_whole or dims[name] != 0:
            raise ValueError(f"no tensor-parallel form for {name}")
        getattr(owner, attr).tensor_axis = axis  # distributed.whole gathers it
    return module


def full_layout(net):
    """``net``'s layout with every sharded leaf whole: a shallow copy of the
    ``NetState`` whose views (``views``/``stat_views``) read arenas of the
    unsharded generator; ``net`` itself when nothing is sharded."""
    module = net.modules[0]
    dims = getattr(module, "tensor_shards", None)
    if not dims:
        return net
    size = module.tensor_rank[1]

    def grow(names, shapes):
        out = []
        for name, shape in zip(names, shapes):
            shape = list(shape)
            if name in dims:
                shape[dims[name]] *= size
            out.append(tuple(shape))
        return out

    lay = copy.copy(net)
    lay.param_shapes = grow(net.param_names, net.param_shapes)
    lay.stat_shapes = grow(net.stat_names, net.stat_shapes)
    lay.numel = sum(int(np.prod(s)) for s in lay.param_shapes)
    lay.stat_numel = sum(int(np.prod(s)) for s in lay.stat_shapes)
    return lay


def gather_arenas(net, axis, arenas: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """This rank's arenas of a one-copy ``net`` (``params``/``grads``/``mu``/
    ``nu``, or ``stats``) -> the arenas of the whole generator in
    :func:`full_layout`'s order, one all-gather over ``axis`` each; every
    rank of the axis must call it.  Unsharded arenas come back as they
    are."""
    dims = getattr(net.modules[0], "tensor_shards", None)
    if not dims or not axis.active:
        return dict(arenas)
    out = {}
    for key, arena in arenas.items():
        if arena.numel() == 0:
            out[key] = arena
            continue
        views, names = ((net.stat_views, net.stat_names) if key == "stats"
                        else (net.views, net.param_names))
        parts = [views(p, 0) for p in distributed.all_gather(arena, axis)]
        out[key] = torch.cat([
            (torch.cat([p[name] for p in parts], dims[name]) if name in dims
             else parts[0][name]).reshape(-1) for name in names])
    return out
