"""Opt-in, checksum-verified dataset acquisition (``--download``).

A copy of ``mdgan_tpu/data/download.py:1-158`` (the module imports no JAX).
The reference's loaders fetch their data on first use (torchvision
``download=True`` — reference ``src/datasets/CIFAR10.py:37``,
``MNIST.py:42``); the loaders of ``data/builtin.py`` only read files already
in place.  This module fetches them behind the explicit ``--download`` flag:

  * every file is streamed to a per-process ``.part`` temp name,
    checksum-verified, and only then moved into place (a failed or corrupt
    fetch never half-populates the layout);
  * files land in the EXACT layouts ``data/builtin.py`` reads
    (``<data_dir>/mnist/*-ubyte.gz``, ``<data_dir>/cifar10/cifar-10-batches-py/``);
  * sources and checksums are parameterizable, so the whole path is testable
    offline through ``file://`` URLs.

CelebA and FFHQ-128 have no recipe: CelebA's official distribution sits
behind authenticated Google Drive quotas; place ``celeba64.npz`` (or the jpg
folder) and ``ffhq128.npz`` by hand.
"""

from __future__ import annotations

import hashlib
import logging
import os
import shutil
import tarfile
import urllib.request
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

log = logging.getLogger("mdgan_tpu_torch")

# Canonical sources.  MNIST checksums are the md5 values published in the
# torchvision source the reference builds on; the CIFAR-10 sha256 is the
# widely published value for cifar-10-python.tar.gz (cs.toronto.edu).
MNIST_BASE = "https://ossci-datasets.s3.amazonaws.com/mnist"
MNIST_FILES: Sequence[Tuple[str, str]] = (
    ("train-images-idx3-ubyte.gz", "md5:f68b3c2dcbeaaa9fbdd348bbdeb94873"),
    ("train-labels-idx1-ubyte.gz", "md5:d53e105ee54ea40749a09fcbcd1e9432"),
    ("t10k-images-idx3-ubyte.gz", "md5:9fb629c4189551a2d022fa330f9573f3"),
    ("t10k-labels-idx1-ubyte.gz", "md5:ec29112dd5afa0611ce80d1b7f02629c"),
)
CIFAR10_BASE = "https://www.cs.toronto.edu/~kriz"
CIFAR10_ARCHIVE = (
    "cifar-10-python.tar.gz",
    "sha256:6d958be074577803d12ecdefd02955f39262c83c16fe9348329d7fe0b5c001ce",
)


def _fetch(url: str, dest: Path, checksum: Optional[str]) -> None:
    """Stream ``url`` to ``dest`` with checksum verification.

    ``checksum`` is ``"<algo>:<hexdigest>"`` (md5/sha256/...) or None to skip
    verification (discouraged; used only when a caller supplies trusted local
    sources without digests).

    Concurrent-safe: the temp name is per-process (every rank of a
    ``torch.distributed.run`` launch calls ``ensure_dataset`` against a
    shared ``--data_dir``), so racing fetches never
    share a partial file; the digest covers exactly the bytes this process
    wrote to its own temp file, and the final ``replace`` is atomic — either
    winner installs verified content."""
    dest.parent.mkdir(parents=True, exist_ok=True)
    tmp = dest.with_name(f"{dest.name}.part.{os.getpid()}")
    h = hashlib.new(checksum.split(":", 1)[0]) if checksum else None
    log.info("downloading %s -> %s", url, dest)
    try:
        with urllib.request.urlopen(url) as r, open(tmp, "wb") as f:
            while True:
                chunk = r.read(1 << 20)
                if not chunk:
                    break
                if h is not None:
                    h.update(chunk)
                f.write(chunk)
        if checksum:
            want = checksum.split(":", 1)[1].lower()
            got = h.hexdigest()
            if got != want:
                raise ValueError(
                    f"checksum mismatch for {url}: got {got}, want {want} "
                    "(refusing to install a corrupt/tampered file)")
        tmp.replace(dest)
    finally:
        tmp.unlink(missing_ok=True)


def download_mnist(data_dir: str, base_url: str = MNIST_BASE,
                   checksums: Optional[Dict[str, str]] = None) -> Path:
    """Fetch the four MNIST idx.gz files into ``<data_dir>/mnist/`` (the
    layout ``builtin.load_mnist`` reads).  Present files are kept."""
    out = Path(data_dir) / "mnist"
    for name, default_sum in MNIST_FILES:
        dest = out / name
        if dest.exists() or dest.with_suffix("").exists():
            continue
        csum = (checksums or {}).get(name, default_sum)
        _fetch(f"{base_url}/{name}", dest, csum)
    return out


def download_cifar10(data_dir: str, base_url: str = CIFAR10_BASE,
                     checksum: Optional[str] = None) -> Path:
    """Fetch + extract the CIFAR-10 python batches into
    ``<data_dir>/cifar10/cifar-10-batches-py/`` (the layout
    ``builtin.load_cifar10`` reads)."""
    root = Path(data_dir) / "cifar10"
    batches = root / "cifar-10-batches-py"
    if batches.exists():
        return batches
    name, default_sum = CIFAR10_ARCHIVE
    archive = root / name
    if not archive.exists():
        _fetch(f"{base_url}/{name}", archive, checksum or default_sum)
    # extract into a per-process staging dir, then atomically rename the
    # batch directory into place — concurrent extractors (the ranks of one
    # launch, shared --data_dir) must never interleave writes into the same
    # final files
    stage = root / f".extract.{os.getpid()}"
    try:
        with tarfile.open(archive, "r:gz") as tf:
            try:
                tf.extractall(stage, filter="data")  # py>=3.12 safe-extract
            except TypeError:  # older tarfile: no filter kwarg
                tf.extractall(stage)
        extracted = stage / batches.name
        if not extracted.exists():
            raise FileNotFoundError(
                f"{name} extracted but no {batches.name}/ inside — "
                "unexpected archive layout")
        if not batches.exists():
            try:
                extracted.rename(batches)
            except OSError:
                if not batches.exists():  # lost the race != other failure
                    raise
    finally:
        shutil.rmtree(stage, ignore_errors=True)
    return batches


def ensure_dataset(name: str, data_dir: str) -> None:
    """``--download`` entry point: make ``name``'s raw files present in the
    layout the registry loader reads, fetching if necessary."""
    if name == "MNIST":
        download_mnist(data_dir)
    elif name == "CIFAR10":
        download_cifar10(data_dir)
    elif name.startswith("Synthetic"):
        pass  # procedural — nothing to fetch
    else:
        raise ValueError(
            f"no download recipe for dataset {name!r} (CelebA/FFHQ require "
            "manual placement — see mdgan_tpu_torch/data/download.py)")
