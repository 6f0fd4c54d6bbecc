"""JAX (flax) weights -> port modules, and back.

A copy, not an import, of the layout rules of
``mdgan_tpu/models/torch_interop.py:18-97``:

  * flax ``Conv``          (kh, kw, I, O)  ->  ``nn.Conv2d``          (O, I, kh, kw)
  * flax ``ConvTranspose`` (kh, kw, I, O)  ->  ``nn.ConvTranspose2d`` (I, O, kh, kw),
    spatially flipped first (``lax.conv_transpose`` does not flip the kernel,
    torch's gradient-of-conv definition does)
  * BatchNorm ``scale``/``bias`` + batch_stats ``mean``/``var``  ->
    ``weight``/``bias`` + ``running_mean``/``running_var``.  The port's
    BatchNorm keeps flax's biased variance, so values copy verbatim.

Trees are nested dicts of numpy arrays, or the flat ``params/...`` and
``batch_stats/...`` keys of a weights npz (``utils/checkpoint.py:117-137``).
A stacked tree (every leaf with a leading N axis, as the JAX engine keeps its
discriminators) is read one worker at a time with :func:`index_tree`.

:func:`inception_to_port` carries the JAX InceptionV3's variables into the
port's ``metrics/inception.py`` (the parity tests use it).
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

from mdgan_tpu_torch.models.dcgan32 import DCGANDiscriminator32, DCGANGenerator32

# (port state-dict key, flax path, kind); kind in conv | convt | vec | stat
_Entry = Tuple[str, Tuple[str, ...], str]


def _bn(port: str, flax: Tuple[str, ...]) -> List[_Entry]:
    return [
        (f"{port}.weight", flax + ("scale",), "vec"),
        (f"{port}.bias", flax + ("bias",), "vec"),
        (f"{port}.running_mean", flax + ("mean",), "stat"),
        (f"{port}.running_var", flax + ("var",), "stat"),
    ]


MAPS: Dict[str, List[_Entry]] = {
    "generator": [
        e for i in range(3) for e in (
            [(f"block{i}.conv.weight",
              (f"ConvTransposeBlock_{i}", "ConvTranspose_0", "kernel"), "convt")]
            + _bn(f"block{i}.bn", (f"ConvTransposeBlock_{i}", "BatchNorm_0")))
    ] + [("out.weight", ("ConvTranspose_0", "kernel"), "convt")],
    "discriminator": [
        ("block0.conv.weight", ("ConvBlock_0", "Conv_0", "kernel"), "conv"),
    ] + [
        e for i in (1, 2) for e in (
            [(f"block{i}.conv.weight", (f"ConvBlock_{i}", "Conv_0", "kernel"), "conv")]
            + _bn(f"block{i}.bn", (f"ConvBlock_{i}", "BatchNorm_0")))
    ] + [("out.weight", ("Conv_0", "kernel"), "conv")],
}


def role_of(module: torch.nn.Module) -> str:
    if isinstance(module, DCGANGenerator32):
        return "generator"
    if isinstance(module, DCGANDiscriminator32):
        return "discriminator"
    raise TypeError(f"no JAX weight map for {type(module).__name__}")


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


def _to_port(a: np.ndarray, kind: str) -> np.ndarray:
    if kind == "conv":
        return a.transpose(3, 2, 0, 1)
    if kind == "convt":
        return a[::-1, ::-1].transpose(2, 3, 0, 1)
    return a


def _to_jax(a: np.ndarray, kind: str) -> np.ndarray:
    if kind == "conv":
        return a.transpose(2, 3, 1, 0)
    if kind == "convt":
        return a.transpose(2, 3, 0, 1)[::-1, ::-1]
    return a


def params_to_port(tree: Mapping, role: str) -> Dict[str, np.ndarray]:
    """A params-shaped tree (params, or an Adam moment) -> port parameter
    names and layouts."""
    return {name: np.array(_to_port(_get(tree, path), kind), np.float32, order="C")
            for name, path, kind in MAPS[role] if kind != "stat"}


def stats_to_port(stats: Mapping, role: str) -> Dict[str, np.ndarray]:
    return {name: np.array(_get(stats, path), np.float32)
            for name, path, kind in MAPS[role] if kind == "stat"}


def params_to_jax(named: Mapping[str, np.ndarray], role: str) -> Dict:
    """Port parameter names -> a nested flax params-shaped tree."""
    out: Dict = {}
    for name, path, kind in MAPS[role]:
        if kind == "stat":
            continue
        node = out
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(_to_jax(np.asarray(named[name]), kind))
    return out


def stats_to_jax(named: Mapping[str, np.ndarray], role: str) -> Dict:
    out: Dict = {}
    for name, path, kind in MAPS[role]:
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
             nu: Mapping = None, count: int = None):
    """Copy a JAX network state into an arena-backed ``NetState``
    (``engine/state.py``): params and BN stats, and optionally optax's Adam
    ``mu``/``nu`` (trees shaped like the params) and shared ``count``.  With
    ``net.n > 1`` every tree is stacked on a leading N axis."""
    role = role_of(net.modules[0])

    def pick(tree, w):
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


def export_arenas(net, arenas: Mapping[str, torch.Tensor]) -> Dict[str, Dict]:
    """Flat arenas in ``net``'s layout (the live ``params``/``stats``/
    ``mu``/``nu`` or clones of them, on any device) -> flax trees under the
    same keys (``stats``: BatchNorm statistics; the others: params-shaped),
    stacked on a leading N axis when ``net.n > 1``."""
    role = role_of(net.modules[0])
    out = {}
    for key, arena in arenas.items():
        host = arena.detach().to("cpu", copy=True)  # the trees must not alias the arena
        views, to_jax = ((net.stat_views, stats_to_jax) if key == "stats"
                         else (net.views, params_to_jax))
        trees = [to_jax({k: v.numpy() for k, v in views(host, w).items()}, role)
                 for w in range(net.n)]
        out[key] = trees[0] if net.n == 1 else _stack(trees)
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
