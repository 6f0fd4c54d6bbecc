"""Built-in dataset plugins: MNIST, CIFAR-10, CelebA, FFHQ-128 and the
procedural Synthetic32 / SyntheticMNIST.

Copies of ``mdgan_tpu/data/builtin.py:36-77`` (:func:`synthesize`),
``:83-281`` (the idx reader and :func:`load_mnist`, :func:`load_cifar10`,
:func:`load_celeba`, :func:`load_ffhq128`, each with its synthetic fallback)
and the six registry entries.  Output bytes are identical to the JAX
package's (tests hold them equal).  Images are uint8 NHWC; normalization to
[-1, 1] happens on the device at sample time.

Raw MNIST idx files and CIFAR-10's binary batches (``cifar-10-batches-bin``)
go through the native decoders of ``data/native``, as in the JAX package.
One deliberate difference (ROADMAP.md C.4): where a ``.bin`` folder is
present and the library is unavailable, the port decodes it with the plain
numpy version, and where its files are missing or corrupt it raises; the JAX
package falls through to the pickle batches and from there to synthetic
data.
"""

from __future__ import annotations

import gzip
import os
import pickle
import struct
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from mdgan_tpu_torch.core import registry
from mdgan_tpu_torch.data import native
from mdgan_tpu_torch.models import dcgan32, dcgan64, layers, mlp_gan, stylegan2


def synthesize(
    shape: Tuple[int, int, int],
    num_examples: int,
    num_classes: int = 10,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic class-conditional toy images (uint8 NHWC): one 2-D
    Gaussian blob per class with per-example jitter (``builtin.py:36-73``)."""
    h, w, c = shape
    rng = np.random.default_rng(seed)
    labels = np.arange(num_examples, dtype=np.int64) % num_classes
    cy = rng.uniform(0.25, 0.75, num_classes)
    cx = rng.uniform(0.25, 0.75, num_classes)
    sigma = rng.uniform(0.08, 0.2, num_classes)
    color = rng.uniform(0.3, 1.0, (num_classes, c))
    jy = rng.normal(0, 0.05, num_examples)
    jx = rng.normal(0, 0.05, num_examples)
    js = rng.normal(1.0, 0.1, num_examples).clip(0.6, 1.4)
    yy = np.linspace(0, 1, h)[None, :, None]
    xx = np.linspace(0, 1, w)[None, None, :]
    out = np.empty((num_examples, h, w, c), dtype=np.uint8)
    chunk = 2048
    for s in range(0, num_examples, chunk):
        e = min(s + chunk, num_examples)
        lab = labels[s:e]
        d2 = (yy - (cy[lab] + jy[s:e])[:, None, None]) ** 2 + (
            xx - (cx[lab] + jx[s:e])[:, None, None]
        ) ** 2
        blob = np.exp(-d2 / (2 * (sigma[lab] * js[s:e])[:, None, None] ** 2))
        img = blob[..., None] * color[lab][:, None, None, :]
        out[s:e] = (img * 255).astype(np.uint8)
    return out, labels


def _read_idx(path: Path) -> np.ndarray:
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(dims)


def _find(data_dir: str, *candidates: str) -> Optional[Path]:
    for cand in candidates:
        p = Path(data_dir) / cand
        if p.exists():
            return p
    return None


def _idx_candidates(stem: str, kind: str) -> Tuple[str, ...]:
    name = f"{stem}-{kind}"
    return (f"mnist/{name}", f"mnist/{name}.gz", f"mnist/MNIST/raw/{name}",
            f"mnist/MNIST/raw/{name}.gz", name, f"{name}.gz")


def load_mnist(data_dir: str, split: str = "train", fallback: str = "synthetic",
               max_examples: Optional[int] = None):
    """MNIST from idx files (raw or ``.gz``, any of the usual layouts), else
    synthetic (``builtin.py:89-129``).  Raw files go through the native
    decoder, and through ``_read_idx`` where it returns None."""
    stem = "train" if split == "train" else "t10k"
    img = _find(data_dir, *_idx_candidates(stem, "images-idx3-ubyte"))
    if img is None:
        if fallback != "synthetic":
            raise FileNotFoundError(f"MNIST raw files not found under {data_dir}")
        n = max_examples or (60000 if split == "train" else 10000)
        return synthesize((28, 28, 1), n, seed=28)
    lbl = _find(data_dir, *_idx_candidates(stem, "labels-idx1-ubyte"))
    if img.suffix != ".gz" and not (lbl and lbl.suffix == ".gz"):
        # the native decoder reads raw idx only; any gzipped piece goes to
        # _read_idx so labels are never silently dropped
        decoded = native.decode_mnist(img, lbl, max_examples or 60000)
        if decoded is not None:
            return decoded
    data = _read_idx(img)[..., None]  # (n, 28, 28, 1)
    labels = _read_idx(lbl).astype(np.int64) if lbl else np.zeros(len(data), np.int64)
    if max_examples:
        data, labels = data[:max_examples], labels[:max_examples]
    return data, labels


def load_cifar10(data_dir: str, split: str = "train", fallback: str = "synthetic",
                 max_examples: Optional[int] = None):
    """CIFAR-10: the binary batches through the native decoder (its numpy
    version where the library is unavailable), the python pickle batches,
    else synthetic (``builtin.py:131-158``).  A binary folder whose files
    are missing or corrupt raises, never falls through."""
    bin_dir = _find(data_dir, "cifar10/cifar-10-batches-bin", "cifar-10-batches-bin")
    if bin_dir is not None:
        return _load_cifar10_bin(bin_dir, split, max_examples)
    base = _find(data_dir, "cifar10/cifar-10-batches-py", "cifar-10-batches-py")
    if base is None:
        if fallback != "synthetic":
            raise FileNotFoundError(f"CIFAR-10 raw files not found under {data_dir}")
        n = max_examples or (50000 if split == "train" else 10000)
        return synthesize((32, 32, 3), n, seed=32)
    files = ([f"data_batch_{i}" for i in range(1, 6)] if split == "train"
             else ["test_batch"])
    xs, ys = [], []
    for name in files:
        with open(base / name, "rb") as f:
            d = pickle.load(f, encoding="bytes")
        xs.append(np.asarray(d[b"data"], np.uint8))
        ys.append(np.asarray(d[b"labels"], np.int64))
    data = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)  # NCHW->NHWC
    labels = np.concatenate(ys)
    if max_examples:
        data, labels = data[:max_examples], labels[:max_examples]
    return np.ascontiguousarray(data), labels


def _load_cifar10_bin(bin_dir: Path, split: str, max_examples: Optional[int]):
    cap = max_examples or (50000 if split == "train" else 10000)
    train = split == "train"
    decode = (native.decode_cifar10_bin if native.available()
              else native.decode_cifar10_bin_plain)
    decoded = decode(bin_dir, cap, train=train)
    if decoded is not None:
        return decoded
    for path in native.cifar10_bin_files(bin_dir, train):
        if not path.is_file():
            raise FileNotFoundError(f"CIFAR-10 binary batch {path} is missing")
    raise ValueError(f"no whole {native.CIFAR_RECORD}-byte CIFAR-10 record in "
                     f"{native.cifar10_bin_files(bin_dir, train)[0]}")


def load_celeba(data_dir: str, split: str = "train", fallback: str = "synthetic",
                max_examples: Optional[int] = None):
    """CelebA 64x64: packed npz if present, else the jpg folder through PIL
    (when PIL imports), else synthetic (``builtin.py:166-212``).  The
    reference center-crops and resizes to 64x64 (``src/datasets/CelebA.py:29-35``)."""
    npz = _find(data_dir, "celeba/celeba64.npz", "celeba64.npz")
    if npz is not None:
        return _load_npz(npz, max_examples)
    imgdir = _find(data_dir, "celeba/img_align_celeba", "img_align_celeba")
    if imgdir is not None:
        try:
            from PIL import Image
        except ImportError:
            imgdir = None
    if imgdir is not None:
        names = sorted(os.listdir(imgdir))
        if max_examples:
            names = names[:max_examples]
        out = np.empty((len(names), 64, 64, 3), np.uint8)
        for i, name in enumerate(names):
            im = Image.open(imgdir / name).convert("RGB")
            # center-crop to square then resize, as torchvision does
            w, h = im.size
            side = min(w, h)
            im = im.crop(((w - side) // 2, (h - side) // 2, (w + side) // 2, (h + side) // 2))
            out[i] = np.asarray(im.resize((64, 64), Image.BILINEAR), np.uint8)
        return out, np.zeros(len(out), np.int64)
    if fallback != "synthetic":
        raise FileNotFoundError(f"CelebA files not found under {data_dir}")
    n = min(max_examples or 202599, 50000)  # keep the synthetic stand-in a sane size
    return synthesize((64, 64, 3), n, seed=64)


def load_ffhq128(data_dir: str, split: str = "train", fallback: str = "synthetic",
                 max_examples: Optional[int] = None):
    """FFHQ-128: packed npz of (n, 128, 128, 3) uint8 if present, else
    synthetic (``builtin.py:261-277``)."""
    npz = _find(data_dir, "ffhq/ffhq128.npz", "ffhq128.npz")
    if npz is not None:
        return _load_npz(npz, max_examples)
    if fallback != "synthetic":
        raise FileNotFoundError(f"FFHQ-128 files not found under {data_dir}")
    n = min(max_examples or 20000, 20000)
    return synthesize((128, 128, 3), n, seed=128)


def _load_npz(path: Path, max_examples: Optional[int]):
    with np.load(path) as z:
        data = z["images"]
        labels = z.get("labels", np.zeros(len(data), np.int64))
    if max_examples:
        data, labels = data[:max_examples], labels[:max_examples]
    return data, labels


def load_synthetic32(data_dir: str, split: str = "train", fallback: str = "synthetic",
                     max_examples: Optional[int] = None):
    """Always procedural, whatever is on disk (``builtin.py:233-241``)."""
    return synthesize((32, 32, 3), max_examples or 50000, seed=32)


def load_synthetic_mnist(data_dir: str, split: str = "train", fallback: str = "synthetic",
                         max_examples: Optional[int] = None):
    """Always procedural, whatever is on disk (``builtin.py:243-249``)."""
    return synthesize((28, 28, 1), max_examples or 60000, seed=28)


def _register(name, module, g, d, load, **extra):
    registry.register(registry.DatasetSpec(
        name=name, shape=module.SHAPE, z_dim=module.Z_DIM, make_generator=g,
        make_discriminator=d, load=load, **extra))


_MLP = dict(init_weights=layers.torch_linear_init_, g_widths=(), d_widths=())
_register("MNIST", mlp_gan, mlp_gan.MLPGenerator, mlp_gan.MLPDiscriminator, load_mnist, **_MLP)
_register("CIFAR10", dcgan32, dcgan32.DCGANGenerator32, dcgan32.DCGANDiscriminator32,
          load_cifar10)
_register("CelebA", dcgan64, dcgan64.DCGANGenerator64, dcgan64.DCGANDiscriminator64,
          load_celeba)
_register("Synthetic32", dcgan32, dcgan32.DCGANGenerator32, dcgan32.DCGANDiscriminator32,
          load_synthetic32)
_register("SyntheticMNIST", mlp_gan, mlp_gan.MLPGenerator, mlp_gan.MLPDiscriminator,
          load_synthetic_mnist, **_MLP)
_register("FFHQ128", stylegan2, stylegan2.StyleGAN2Generator,
          stylegan2.StyleGAN2Discriminator, load_ffhq128,
          init_weights=stylegan2.stylegan2_init_,
          g_widths=("base_features", "max_res", "map_layers"),
          d_widths=("base_features", "max_res"))
