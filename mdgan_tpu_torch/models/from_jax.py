"""JAX (flax) weights -> port modules, and back.

A copy, not an import, of the layout rules of
``mdgan_tpu/models/torch_interop.py:18-97``:

  * flax ``Conv``          (kh, kw, I, O)  ->  ``nn.Conv2d``          (O, I, kh, kw)
  * flax ``ConvTranspose`` (kh, kw, I, O)  ->  ``nn.ConvTranspose2d`` (I, O, kh, kw),
    spatially flipped first (``lax.conv_transpose`` does not flip the kernel,
    torch's gradient-of-conv definition does)
  * flax ``Dense``         (I, O)          ->  ``nn.Linear``-style    (O, I)
  * BatchNorm ``scale``/``bias`` + batch_stats ``mean``/``var``  ->
    ``weight``/``bias`` + ``running_mean``/``running_var``.  The port's
    BatchNorm keeps flax's biased variance, so values copy verbatim.
  * StyleGAN2's 4x4 ``const`` (H, W, C) -> (C, H, W); its 0-d noise gains
    copy as 0-d.

Every model family has one map per role (:func:`role_of`): DCGAN-32
(``generator``/``discriminator``), DCGAN-64, the MLP pair and StyleGAN2,
whose map follows the module's resolutions and mapping depth.  Networks
without BatchNorm (MLP, StyleGAN2) have no ``stat`` entries: their stats
trees are empty.

Trees are nested dicts of numpy arrays, or the flat ``params/...`` and
``batch_stats/...`` keys of a weights npz (``utils/checkpoint.py:117-137``).
A stacked tree (every leaf with a leading N axis, as the JAX engine keeps its
discriminators) is read one worker at a time with :func:`index_tree`.

:func:`inception_to_port` carries the JAX InceptionV3's variables into the
port's ``metrics/inception.py`` (the parity tests use it).
"""

from __future__ import annotations

import functools
from typing import Dict, Hashable, List, Mapping, Sequence, Tuple

import numpy as np
import torch

from mdgan_tpu_torch.models import dcgan32, dcgan64, mlp_gan, stylegan2

# (port state-dict key, flax path, kind);
# kind in conv | convt | dense | const | scalar | vec | stat
_Entry = Tuple[str, Tuple[str, ...], str]


def _bn(port: str, flax: Tuple[str, ...]) -> List[_Entry]:
    return [
        (f"{port}.weight", flax + ("scale",), "vec"),
        (f"{port}.bias", flax + ("bias",), "vec"),
        (f"{port}.running_mean", flax + ("mean",), "stat"),
        (f"{port}.running_var", flax + ("var",), "stat"),
    ]


def _dcgan_g(stages: int) -> List[_Entry]:
    return [
        e for i in range(stages) for e in (
            [(f"block{i}.conv.weight",
              (f"ConvTransposeBlock_{i}", "ConvTranspose_0", "kernel"), "convt")]
            + _bn(f"block{i}.bn", (f"ConvTransposeBlock_{i}", "BatchNorm_0")))
    ] + [("out.weight", ("ConvTranspose_0", "kernel"), "convt")]


def _dcgan_d(stages: int, biased=()) -> List[_Entry]:
    out = [("block0.conv.weight", ("ConvBlock_0", "Conv_0", "kernel"), "conv")]
    for i in range(1, stages):
        out.append((f"block{i}.conv.weight", (f"ConvBlock_{i}", "Conv_0", "kernel"), "conv"))
        if i in biased:
            out.append((f"block{i}.conv.bias", (f"ConvBlock_{i}", "Conv_0", "bias"), "vec"))
        out += _bn(f"block{i}.bn", (f"ConvBlock_{i}", "BatchNorm_0"))
    return out + [("out.weight", ("Conv_0", "kernel"), "conv")]


def _dense(port: str, flax: Tuple[str, ...]) -> List[_Entry]:
    return [(f"{port}.weight", flax + ("kernel",), "dense"),
            (f"{port}.bias", flax + ("bias",), "vec")]


def _mlp(n_hidden: int) -> List[_Entry]:
    return [e for i in range(n_hidden) for e in _dense(f"hidden.{i}", (f"Dense_{i}",))] \
        + _dense("out", (f"Dense_{n_hidden}",))


MAPS: Dict[str, List[_Entry]] = {
    "generator": _dcgan_g(3),                     # DCGAN-32
    "discriminator": _dcgan_d(3),
    "dcgan64_generator": _dcgan_g(4),
    "dcgan64_discriminator": _dcgan_d(4, biased=(1, 2)),
    "mlp_generator": _mlp(len(mlp_gan.G_DIMS)),
    "mlp_discriminator": _mlp(len(mlp_gan.D_DIMS)),
}


def _modconv(port: str, flax: Tuple[str, ...]) -> List[_Entry]:
    return [(f"{port}.weight", flax + ("kernel",), "conv")] + _dense(f"{port}.mod",
                                                                     flax + ("mod",))


@functools.lru_cache(maxsize=None)
def _stylegan2_g(resolutions: Tuple[int, ...], map_layers: int) -> List[_Entry]:
    out = [e for i in range(map_layers)
           for e in _dense(f"mapping.layers.{i}", ("MappingNetwork_0", f"EqualDense_{i}"))]
    out.append(("const", ("const",), "const"))
    for res in resolutions:
        blk = f"b{res}"
        for i in range(2):
            out += _modconv(f"{blk}.conv{i}", (blk, f"conv{i}"))
            out += [(f"{blk}.noise_gain{i}", (blk, f"noise_gain{i}"), "scalar"),
                    (f"{blk}.bias{i}", (blk, f"bias{i}"), "vec")]
        out += _modconv(f"trgb{res}", (f"trgb{res}",))
    return out


@functools.lru_cache(maxsize=None)
def _stylegan2_d(resolutions: Tuple[int, ...]) -> List[_Entry]:
    def conv(port, flax, bias=True):
        return [(f"{port}.weight", flax + ("kernel",), "conv")] + (
            [(f"{port}.bias", flax + ("bias",), "vec")] if bias else [])

    out = conv("from_rgb", ("Conv_0",))
    for res in resolutions:
        blk = f"b{res}"
        out += conv(f"{blk}.skip", (blk, "Conv_0"), bias=False)
        out += conv(f"{blk}.conv1", (blk, "Conv_1")) + conv(f"{blk}.conv2", (blk, "Conv_2"))
    return (out + conv("conv_out", ("Conv_1",)) + _dense("fc", ("EqualDense_0",))
            + _dense("out", ("EqualDense_1",)))


_FIXED_ROLES = {
    dcgan32.DCGANGenerator32: "generator",
    dcgan32.DCGANDiscriminator32: "discriminator",
    dcgan64.DCGANGenerator64: "dcgan64_generator",
    dcgan64.DCGANDiscriminator64: "dcgan64_discriminator",
    mlp_gan.MLPGenerator: "mlp_generator",
    mlp_gan.MLPDiscriminator: "mlp_discriminator",
}


def role_of(module: torch.nn.Module) -> Hashable:
    """The key of ``module``'s weight map: a name for the fixed-shape
    families, a tuple with the resolutions (and the mapping depth) for
    StyleGAN2."""
    if type(module) in _FIXED_ROLES:
        return _FIXED_ROLES[type(module)]
    if isinstance(module, stylegan2.StyleGAN2Generator):
        return ("stylegan2_generator", tuple(module.resolutions), len(module.mapping.layers))
    if isinstance(module, stylegan2.StyleGAN2Discriminator):
        return ("stylegan2_discriminator", tuple(module.resolutions))
    raise TypeError(f"no JAX weight map for {type(module).__name__}")


def entries(role: Hashable) -> List[_Entry]:
    """The weight map of ``role``, a key from :func:`role_of`."""
    if isinstance(role, str):
        return MAPS[role]
    kind, *args = role
    build = {"stylegan2_generator": _stylegan2_g, "stylegan2_discriminator": _stylegan2_d}
    return build[kind](*args)


def split_npz(flat: Mapping[str, np.ndarray]) -> Tuple[Dict, Dict]:
    """Flat ``params/...``/``batch_stats/...`` keys -> (params, stats)."""
    trees: Dict[str, Dict] = {"params": {}, "batch_stats": {}}
    for key, value in flat.items():
        top, *path = key.split("/")
        if top not in trees:
            raise KeyError(f"unexpected weights key {key!r}")
        node = trees[top]
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.asarray(value)
    return trees["params"], trees["batch_stats"]


def load_npz(path) -> Tuple[Dict, Dict]:
    """A weights npz written by the JAX package -> (params, stats)."""
    with np.load(path) as z:
        return split_npz({k: z[k] for k in z.files})


def index_tree(tree, i: int):
    """Worker ``i`` of a stacked tree."""
    if isinstance(tree, Mapping):
        return {k: index_tree(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def _get(tree: Mapping, path: Tuple[str, ...]) -> np.ndarray:
    node = tree
    for i, p in enumerate(path):
        try:
            node = node[p]
        except (KeyError, TypeError):
            raise KeyError(f"tree lacks {'/'.join(path)!r} (missing at "
                           f"{'/'.join(path[: i + 1])!r})") from None
    return np.asarray(node)


def to_port(a: np.ndarray, kind: str) -> np.ndarray:
    if kind == "conv":
        return a.transpose(3, 2, 0, 1)
    if kind == "convt":
        return a[::-1, ::-1].transpose(2, 3, 0, 1)
    if kind == "dense":
        return a.T
    if kind == "const":
        return a.transpose(2, 0, 1)
    return a


def to_jax(a: np.ndarray, kind: str) -> np.ndarray:
    if kind == "conv":
        return a.transpose(2, 3, 1, 0)
    if kind == "convt":
        return a.transpose(2, 3, 0, 1)[::-1, ::-1]
    if kind == "dense":
        return a.T
    if kind == "const":
        return a.transpose(1, 2, 0)
    return a


def params_to_port(tree: Mapping, role) -> Dict[str, np.ndarray]:
    """A params-shaped tree (params, or an Adam moment) -> port parameter
    names and layouts."""
    return {name: np.array(to_port(_get(tree, path), kind), np.float32, order="C")
            for name, path, kind in entries(role) if kind != "stat"}


def stats_to_port(stats: Mapping, role) -> Dict[str, np.ndarray]:
    return {name: np.array(_get(stats, path), np.float32)
            for name, path, kind in entries(role) if kind == "stat"}


def params_to_jax(named: Mapping[str, np.ndarray], role) -> Dict:
    """Port parameter names -> a nested flax params-shaped tree."""
    out: Dict = {}
    for name, path, kind in entries(role):
        if kind == "stat":
            continue
        node = out
        for p in path[:-1]:
            node = node.setdefault(p, {})
        # np.ascontiguousarray would make a 0-d leaf 1-d
        node[path[-1]] = np.array(to_jax(np.asarray(named[name]), kind), order="C")
    return out


def stats_to_jax(named: Mapping[str, np.ndarray], role) -> Dict:
    out: Dict = {}
    for name, path, kind in entries(role):
        if kind != "stat":
            continue
        node = out
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.asarray(named[name])
    return out


@torch.no_grad()
def load_into(module: torch.nn.Module, params: Mapping, stats: Mapping) -> torch.nn.Module:
    """Copy flax (params, stats) into ``module`` in place.  Copies into the
    existing tensors, so parameters that are views of an arena stay so."""
    role = role_of(module)
    sd = module.state_dict(keep_vars=True)
    named = {**params_to_port(params, role), **stats_to_port(stats, role)}
    if set(named) != set(sd):
        raise KeyError(f"{role} keys differ: missing={sorted(set(sd) - set(named))} "
                       f"extra={sorted(set(named) - set(sd))}")
    for name, value in named.items():
        dst = sd[name]
        if tuple(dst.shape) != value.shape:
            raise ValueError(f"{role} {name}: shape {value.shape} != {tuple(dst.shape)}")
        dst.copy_(torch.from_numpy(value))
    return module


def export(module: torch.nn.Module) -> Tuple[Dict, Dict]:
    """``module`` -> flax (params, stats) numpy trees."""
    role = role_of(module)
    sd = {k: np.array(v.detach().cpu()) for k, v in module.state_dict().items()}
    return params_to_jax(sd, role), stats_to_jax(sd, role)


@torch.no_grad()
def load_net(net, params: Mapping, stats: Mapping, mu: Mapping = None,
             nu: Mapping = None, count: int = None, rows: Sequence[int] = None):
    """Copy a JAX network state into an arena-backed ``NetState``
    (``engine/state.py``): params and BN stats, and optionally optax's Adam
    ``mu``/``nu`` (trees shaped like the params) and shared ``count``.  With
    ``net.n > 1`` every tree is stacked on a leading N axis and copy w reads
    row w; ``rows`` names the rows the copies read instead (a rank's
    workers, from trees of all N)."""
    role = role_of(net.modules[0])

    def pick(tree, w):
        if rows is not None:
            return index_tree(tree, rows[w])
        return index_tree(tree, w) if net.n > 1 else tree

    for w, module in enumerate(net.modules):
        load_into(module, pick(params, w), pick(stats, w))
        for arena, tree in ((net.mu, mu), (net.nu, nu)):
            if tree is None:
                continue
            views = net.views(arena, w)
            for name, value in params_to_port(pick(tree, w), role).items():
                views[name].copy_(torch.from_numpy(value))
    if count is not None:
        net.count = int(count)
    return net


def _stack(trees):
    if isinstance(trees[0], Mapping):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def export_arenas(net, arenas: Mapping[str, torch.Tensor], copies: int = None) -> Dict[str, Dict]:
    """Flat arenas in ``net``'s layout (the live ``params``/``stats``/
    ``mu``/``nu`` or clones of them, on any device) -> flax trees of numpy
    float32 arrays under the same keys (``stats``: BatchNorm statistics; the
    others: params-shaped), stacked on a leading N axis when the arenas hold
    more than one copy.  ``copies``: how many copies the arenas hold
    (default ``net.n``; all N when a rank's ``net`` has gathered every
    rank's)."""
    role = role_of(net.modules[0])
    copies = net.n if copies is None else copies
    out = {}
    for key, arena in arenas.items():
        # float32 on the host (bfloat16 moments widen exactly); the trees
        # must not alias the arena
        host = arena.detach().to("cpu", torch.float32, copy=True)
        views, to_jax = ((net.stat_views, stats_to_jax) if key == "stats"
                         else (net.views, params_to_jax))
        trees = [to_jax({k: v.numpy() for k, v in views(host, w).items()}, role)
                 for w in range(copies)]
        out[key] = trees[0] if copies == 1 else _stack(trees)
    return out


def export_net(net) -> Tuple[Dict, Dict]:
    """An arena-backed ``NetState`` -> flax (params, stats), stacked on a
    leading N axis when ``net.n > 1``."""
    trees = export_arenas(net, {"params": net.params, "stats": net.stats})
    return trees["params"], trees["stats"]


# --- InceptionV3 (metrics/inception.py) ------------------------------------

def inception_to_port(variables: Mapping) -> Dict[str, np.ndarray]:
    """JAX ``InceptionV3`` variables (``{"params", "batch_stats"}``, numpy;
    the whole network or any block of it) -> the port's state dict, which
    uses torchvision's names.  The inverse of
    ``mdgan_tpu/metrics/inception.py:load_torch_npz`` (``:243-293``): conv
    kernels HWIO -> OIHW, Dense (in, out) -> (out, in), BatchNorm
    ``scale``/``bias``/``mean``/``var`` -> ``weight``/``bias``/
    ``running_mean``/``running_var``."""
    out: Dict[str, np.ndarray] = {}

    def walk(tree, prefix, stats):
        for name, node in tree.items():
            key = f"{prefix}{name}"
            if isinstance(node, Mapping):
                walk(node, key + ".", stats)
                continue
            a = np.array(node, np.float32)
            mod, _, leaf = key.rpartition(".")
            if stats:
                out[f"{mod}.running_{leaf}"] = a
            elif leaf == "kernel" and a.ndim == 4:
                out[f"{mod}.weight"] = np.ascontiguousarray(a.transpose(3, 2, 0, 1))
            elif leaf == "kernel":
                out[f"{mod}.weight"] = np.ascontiguousarray(a.T)
            elif leaf == "scale":
                out[f"{mod}.weight"] = a
            elif leaf == "bias":
                out[key] = a
            else:
                raise KeyError(f"unmapped inception leaf {key!r}")

    walk(variables["params"], "", stats=False)
    walk(variables.get("batch_stats", {}), "", stats=True)
    return out
