"""Reference-checkpoint interop: torch ``state_dict`` <-> flax-named trees.

Port of ``mdgan_tpu/models/torch_interop.py:40-240`` without flax or JAX.
The reference saves trained weights as plain ``torch.save(model.state_dict())``
files (``generator.pt`` from its server, ``discriminator.pth`` from each
worker, ``netG/netD_epoch_<e>.pth`` from the standalone baseline).  This
module converts them losslessly into the flax-named param / batch-stat trees
of the weights npz that both packages read and write
(``utils/checkpoint.save_weights_only``, ``models/from_jax.load_npz``), and
back.  Trees are nested dicts of numpy arrays.

The six ``(dataset, role)`` tables of :data:`MAPS` are copies of
``torch_interop.py:45-110``, in the reference's own attribute and Sequential
index naming.  The layout transforms are ``models/from_jax.py``'s
(:func:`~mdgan_tpu_torch.models.from_jax.to_port` and ``to_jax``), the
same as the JAX package's:

  * ``nn.Conv2d``           (O, I, kh, kw)  <->  flax ``Conv``          (kh, kw, I, O)
  * ``nn.ConvTranspose2d``  (I, O, kh, kw)  <->  flax ``ConvTranspose`` (kh, kw, I, O),
    **spatially flipped**
  * ``nn.Linear``           (O, I)          <->  flax ``Dense``         (I, O)
  * ``nn.BatchNorm2d``  weight/bias/running_mean/running_var  <->
    params ``scale``/``bias`` + batch_stats ``mean``/``var``;
    ``num_batches_tracked`` is dropped on import and written as 0 on export

Values are copied verbatim, the reference's *unbiased* ``running_var``
included (``torch_interop.py:28-33``), as the JAX package copies them.
These tables name the reference's modules; the port's own modules use
``models/from_jax.py``'s maps.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from mdgan_tpu_torch.models import from_jax
from mdgan_tpu_torch.utils import checkpoint

# (torch key prefix, layer kind, flax params path) per model, in the
# reference's own attribute/Sequential-index naming.
_Entry = Tuple[str, str, Tuple[str, ...]]

MAPS: Dict[Tuple[str, str], List[_Entry]] = {
    # reference src/datasets/CIFAR10.py:108-140 (self.main Sequential)
    ("CIFAR10", "generator"): [
        ("main.0", "convt", ("ConvTransposeBlock_0", "ConvTranspose_0")),
        ("main.1", "bn", ("ConvTransposeBlock_0", "BatchNorm_0")),
        ("main.3", "convt", ("ConvTransposeBlock_1", "ConvTranspose_0")),
        ("main.4", "bn", ("ConvTransposeBlock_1", "BatchNorm_0")),
        ("main.6", "convt", ("ConvTransposeBlock_2", "ConvTranspose_0")),
        ("main.7", "bn", ("ConvTransposeBlock_2", "BatchNorm_0")),
        ("main.9", "convt", ("ConvTranspose_0",)),
    ],
    # reference src/datasets/CIFAR10.py:76-106
    ("CIFAR10", "discriminator"): [
        ("main.0", "conv", ("ConvBlock_0", "Conv_0")),
        ("main.2", "conv", ("ConvBlock_1", "Conv_0")),
        ("main.3", "bn", ("ConvBlock_1", "BatchNorm_0")),
        ("main.5", "conv", ("ConvBlock_2", "Conv_0")),
        ("main.6", "bn", ("ConvBlock_2", "BatchNorm_0")),
        ("main.8", "conv", ("Conv_0",)),
    ],
    # reference src/datasets/CelebA.py:104-140 (named attributes)
    ("CelebA", "generator"): [
        ("tconv1", "convt", ("ConvTransposeBlock_0", "ConvTranspose_0")),
        ("bn1", "bn", ("ConvTransposeBlock_0", "BatchNorm_0")),
        ("tconv2", "convt", ("ConvTransposeBlock_1", "ConvTranspose_0")),
        ("bn2", "bn", ("ConvTransposeBlock_1", "BatchNorm_0")),
        ("tconv3", "convt", ("ConvTransposeBlock_2", "ConvTranspose_0")),
        ("bn3", "bn", ("ConvTransposeBlock_2", "BatchNorm_0")),
        ("tconv4", "convt", ("ConvTransposeBlock_3", "ConvTranspose_0")),
        ("bn4", "bn", ("ConvTransposeBlock_3", "BatchNorm_0")),
        ("tconv5", "convt", ("ConvTranspose_0",)),
    ],
    # reference src/datasets/CelebA.py:75-101 (cv2/cv3 carry biases — the
    # preserved reference quirk; see models/dcgan64.py)
    ("CelebA", "discriminator"): [
        ("cv1", "conv", ("ConvBlock_0", "Conv_0")),
        ("cv2", "conv", ("ConvBlock_1", "Conv_0")),
        ("bn2", "bn", ("ConvBlock_1", "BatchNorm_0")),
        ("cv3", "conv", ("ConvBlock_2", "Conv_0")),
        ("bn3", "bn", ("ConvBlock_2", "BatchNorm_0")),
        ("cv4", "conv", ("ConvBlock_3", "Conv_0")),
        ("bn4", "bn", ("ConvBlock_3", "BatchNorm_0")),
        ("cv5", "conv", ("Conv_0",)),
    ],
    # reference src/datasets/MNIST.py:99-120 / 74-96 (fc1..fc4 attributes)
    ("MNIST", "generator"): [
        (f"fc{i + 1}", "linear", (f"Dense_{i}",)) for i in range(4)
    ],
    ("MNIST", "discriminator"): [
        (f"fc{i + 1}", "linear", (f"Dense_{i}",)) for i in range(4)
    ],
}


# MAPS's layer kinds -> from_jax's
_KIND = {"conv": "conv", "convt": "convt", "linear": "dense"}


def _nest(flat: Dict[Tuple[str, ...], np.ndarray]) -> Dict:
    return checkpoint.unflatten({"/".join(path): v for path, v in flat.items()})


def _get(tree: Dict, path: Tuple[str, ...], what: str) -> Dict:
    node = tree
    for i, p in enumerate(path):
        try:
            node = node[p]
        except (KeyError, TypeError):
            raise KeyError(
                f"{what} tree lacks {'/'.join(path)!r} (missing at "
                f"{'/'.join(path[: i + 1])!r}) — not a weights export of "
                f"this (dataset, role) model?") from None
    return node


def _map_for(dataset: str, role: str) -> List[_Entry]:
    try:
        return MAPS[(dataset, role)]
    except KeyError:
        supported = sorted({d for d, _ in MAPS})
        raise ValueError(
            f"no torch interop map for ({dataset!r}, {role!r}); the reference "
            f"ships torch models only for {supported} "
            f"(role 'generator' or 'discriminator')") from None


def torch_to_flax(state_dict: Dict, dataset: str, role: str
                  ) -> Tuple[Dict, Dict]:
    """Reference ``state_dict`` (tensors or ndarrays) -> (params, batch_stats).

    Strict: every torch key must be consumed (``num_batches_tracked`` aside)
    and every mapped weight must be present — a key mismatch means the file
    is not a checkpoint of the reference's ``(dataset, role)`` model.
    """
    sd = {k: np.asarray(getattr(v, "detach", lambda: v)().cpu().numpy()
                        if hasattr(v, "cpu") else v)
          for k, v in state_dict.items()}
    params: Dict[Tuple[str, ...], np.ndarray] = {}
    stats: Dict[Tuple[str, ...], np.ndarray] = {}

    def take(key: str) -> np.ndarray:
        try:
            return sd.pop(key)
        except KeyError:
            raise KeyError(
                f"state dict lacks {key!r} — not a reference "
                f"({dataset}, {role}) checkpoint?") from None

    for prefix, kind, path in _map_for(dataset, role):
        if kind == "bn":
            params[path + ("scale",)] = take(f"{prefix}.weight")
            params[path + ("bias",)] = take(f"{prefix}.bias")
            stats[path + ("mean",)] = take(f"{prefix}.running_mean")
            stats[path + ("var",)] = take(f"{prefix}.running_var")
            sd.pop(f"{prefix}.num_batches_tracked", None)
            continue
        params[path + ("kernel",)] = np.ascontiguousarray(
            from_jax.to_jax(take(f"{prefix}.weight"), _KIND[kind]))
        if kind == "linear" or f"{prefix}.bias" in sd:
            params[path + ("bias",)] = take(f"{prefix}.bias")
    if sd:
        raise KeyError(f"unconsumed torch keys {sorted(sd)} — not a reference "
                       f"({dataset}, {role}) checkpoint?")
    return _nest(params), _nest(stats)


def flax_to_torch(params: Dict, stats: Dict, dataset: str, role: str) -> Dict:
    """(params, batch_stats) -> a state dict loadable with ``strict=True``
    into the reference's torch model (plain ndarrays; callers `torch.save`
    after wrapping in tensors — see ``cli/convert_weights.py``)."""
    out: Dict[str, np.ndarray] = {}
    for prefix, kind, path in _map_for(dataset, role):
        leaf = _get(params, path, f"({dataset}, {role}) params")
        if kind == "bn":
            out[f"{prefix}.weight"] = np.asarray(leaf["scale"])
            out[f"{prefix}.bias"] = np.asarray(leaf["bias"])
            s = _get(stats, path, f"({dataset}, {role}) batch_stats")
            out[f"{prefix}.running_mean"] = np.asarray(s["mean"])
            out[f"{prefix}.running_var"] = np.asarray(s["var"])
            out[f"{prefix}.num_batches_tracked"] = np.asarray(0, np.int64)
            continue
        out[f"{prefix}.weight"] = np.ascontiguousarray(
            from_jax.to_port(np.asarray(leaf["kernel"]), _KIND[kind]))
        if kind == "linear" or "bias" in leaf:
            out[f"{prefix}.bias"] = np.asarray(leaf["bias"])
    return out


def validate_against_model(params: Dict, stats: Dict, dataset: str,
                           role: str) -> None:
    """Raise unless a converted tree has exactly the keys and shapes of the
    port's ``(dataset, role)`` model, as exported by ``from_jax.export``
    (the flax names) — catches truncated or mismatched files before a
    forward fails on them."""
    from mdgan_tpu_torch.core.registry import get as get_spec

    spec = get_spec(dataset)
    module = (spec.make_generator() if role == "generator"
              else spec.make_discriminator())
    ref_params, ref_stats = from_jax.export(module)

    def shapes(p, s):
        tree = {"params": p} | ({"batch_stats": s} if s else {})
        return {k: np.shape(v) for k, v in checkpoint.flatten(tree).items()}

    got, want = shapes(params, stats), shapes(ref_params, ref_stats)
    if got != want:
        missing = sorted(set(want) - set(got))
        extra = sorted(set(got) - set(want))
        wrong = sorted(k for k in set(got) & set(want) if got[k] != want[k])
        raise ValueError(
            f"converted tree does not match {dataset} {role}: "
            f"missing={missing} extra={extra} shape-mismatch={wrong}")
