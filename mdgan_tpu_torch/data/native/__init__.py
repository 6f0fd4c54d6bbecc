"""ctypes bindings for the native (C++) host data path, and a plain numpy
version of each function.

Port of ``mdgan_tpu/data/native/__init__.py:1-134``.  ``fastloader.cpp``
(``mdgan_tpu/data/native/fastloader.cpp``'s functions, the CIFAR-10 decode
reading 8,192 records per ``fread`` and interleaving them on up to 8
threads) is compiled at first use
with ``g++ -O3 -shared -fPIC -pthread`` into
``build/libfastloader_<hash>.so`` at the repository root (the hash covers the
source and the flags), under the file lock of ``utils/build.py``, with the
compiler's output kept beside it as ``.log``.  It exposes:

  * :func:`decode_cifar10_bin` — CIFAR-10 binary-format decode to NHWC uint8
  * :func:`decode_mnist` — MNIST idx decode
  * :func:`gather_rows` — threaded row gather (shard materialization)

Each returns None when the library is unavailable (``MDGAN_TPU_NO_NATIVE``
set, as the JAX package reads it at first use, ``:54``, or no compiler) and
for a missing or corrupt file, as the JAX entry points do.
``decode_cifar10_bin_plain``, ``decode_mnist_plain`` and
``gather_rows_plain`` compute the same bytes in numpy, with the same return
conventions.  :func:`build` raises with the compiler's output where
:func:`get_lib` returns None; :func:`available` says whether the library
loaded, and each entry point counts its native calls in ``.native_calls``.
"""

from __future__ import annotations

import ctypes
import logging
import os
import struct
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from mdgan_tpu_torch.utils.build import BUILD_DIR, build_locked, hash_of

SOURCE = Path(__file__).resolve().parent / "fastloader.cpp"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread")
CIFAR_RECORD = 1 + 3072  # label byte, then 3x32x32 CHW pixels
MNIST_IMAGE_MAGIC, MNIST_LABEL_MAGIC = 0x00000803, 0x00000801

log = logging.getLogger("mdgan_tpu_torch")
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def library_path() -> Path:
    return BUILD_DIR / f"libfastloader_{hash_of(GXX_FLAGS, [SOURCE])}.so"


def command(out: Path) -> List[str]:
    return ["g++", *GXX_FLAGS, str(SOURCE), "-o", str(out)]


def build() -> Path:
    """Compile the library unless a current one exists; raises with the
    compiler's output when the build fails."""
    return build_locked(library_path(), command)


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, or None (``MDGAN_TPU_NO_NATIVE``, no compiler, a
    failed build); decided once per process, as the JAX package does."""
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        if os.environ.get("MDGAN_TPU_NO_NATIVE"):
            return None
        try:
            lib = ctypes.CDLL(str(build()))
        except (OSError, RuntimeError) as err:
            log.warning("native data path unavailable, using numpy: %s", err)
            return None
        lib.decode_cifar10_bin.restype = ctypes.c_int64
        lib.decode_cifar10_bin.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int]
        lib.decode_mnist_idx.restype = ctypes.c_int64
        lib.decode_mnist_idx.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64)]
        lib.decode_mnist_labels.restype = ctypes.c_int64
        lib.decode_mnist_labels.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64]
        lib.gather_rows.restype = None
        lib.gather_rows.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int]
        _LIB = lib
        return _LIB


def available() -> bool:
    return get_lib() is not None


def cifar10_bin_files(dir_path, train: bool = True) -> List[Path]:
    """The batch files a split reads, in order (``fastloader.cpp``)."""
    names = [f"data_batch_{i}.bin" for i in range(1, 6)] if train else ["test_batch.bin"]
    return [Path(dir_path) / name for name in names]


def decode_cifar10_bin(dir_path, max_examples: int = 50000,
                       train: bool = True) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    lib = get_lib()
    if lib is None:
        return None
    out = np.empty((max_examples, 32, 32, 3), np.uint8)
    labels = np.empty(max_examples, np.int64)
    n = lib.decode_cifar10_bin(str(dir_path).encode(), out.ctypes.data, labels.ctypes.data,
                               max_examples, 1 if train else 0)
    decode_cifar10_bin.native_calls += 1
    if n <= 0:
        return None
    return out[:n], labels[:n]


def decode_cifar10_bin_plain(dir_path, max_examples: int = 50000,
                             train: bool = True) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """:func:`decode_cifar10_bin` in numpy: whole 3,073-byte records of each
    file in turn, CHW -> HWC, until ``max_examples``; None when a file it
    reaches is missing or no record was read."""
    records = []
    n = 0
    for path in cifar10_bin_files(dir_path, train):
        try:
            raw = np.fromfile(path, np.uint8)
        except OSError:
            return None
        take = min(len(raw) // CIFAR_RECORD, max_examples - n)
        records.append(raw[:take * CIFAR_RECORD].reshape(take, CIFAR_RECORD))
        n += take
        if n >= max_examples:
            break
    if n <= 0:
        return None
    recs = np.concatenate(records)
    images = recs[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return np.ascontiguousarray(images), recs[:, 0].astype(np.int64)


def decode_mnist(images_path, labels_path, max_examples: int = 60000
                 ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    lib = get_lib()
    if lib is None:
        return None
    buf = np.empty(max_examples * 28 * 28, np.uint8)
    rows, cols = ctypes.c_int64(), ctypes.c_int64()
    n = lib.decode_mnist_idx(str(images_path).encode(), buf.ctypes.data, max_examples,
                             buf.size, ctypes.byref(rows), ctypes.byref(cols))
    decode_mnist.native_calls += 1
    if n <= 0:
        return None
    images = buf[: n * rows.value * cols.value].reshape(n, rows.value, cols.value, 1)
    labels = np.zeros(n, np.int64)
    if labels_path:
        lbl = np.empty(n, np.int64)
        if lib.decode_mnist_labels(str(labels_path).encode(), lbl.ctypes.data, n) == n:
            labels = lbl
    return images, labels


def _idx_dims(f, magic: int, ndim: int) -> Optional[Tuple[int, ...]]:
    """An idx file's big-endian dims, or None for a short header or another
    magic."""
    head = f.read(4 + 4 * ndim)
    if len(head) != 4 + 4 * ndim or struct.unpack(">I", head[:4])[0] != magic:
        return None
    return struct.unpack(">" + "I" * ndim, head[4:])


def decode_mnist_plain(images_path, labels_path, max_examples: int = 60000
                       ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """:func:`decode_mnist` in numpy, with the same guards: the header's
    dims may not exceed a buffer of ``max_examples`` 28x28 images, and
    labels that do not cover every image read as zeros."""
    try:
        with open(images_path, "rb") as f:
            dims = _idx_dims(f, MNIST_IMAGE_MAGIC, 3)
            if dims is None or dims[1] == 0 or dims[2] == 0:
                return None
            n, rows, cols = min(dims[0], max_examples), dims[1], dims[2]
            if n * rows * cols > max_examples * 28 * 28:
                return None
            payload = f.read(n * rows * cols)
    except OSError:
        return None
    if n <= 0 or len(payload) != n * rows * cols:
        return None
    images = np.frombuffer(payload, np.uint8).reshape(n, rows, cols, 1).copy()
    labels = np.zeros(n, np.int64)
    if labels_path:
        try:
            with open(labels_path, "rb") as f:
                dims = _idx_dims(f, MNIST_LABEL_MAGIC, 1)
                lbl = f.read(n) if dims is not None and dims[0] >= n else b""
        except OSError:
            lbl = b""
        if len(lbl) == n:
            labels = np.frombuffer(lbl, np.uint8).astype(np.int64)
    return images, labels


def gather_rows(data: np.ndarray, idx: np.ndarray,
                num_threads: Optional[int] = None) -> Optional[np.ndarray]:
    """out[i] = data[idx[i]]; threaded memcpy.  None if the library is
    unavailable.  Indices outside [0, len(data)) raise IndexError."""
    lib = get_lib()
    if lib is None:
        return None
    data = np.ascontiguousarray(data)
    idx = np.ascontiguousarray(idx.reshape(-1), dtype=np.int64)
    if idx.size and (idx.min() < 0 or idx.max() >= len(data)):
        raise IndexError(f"gather_rows: index outside [0, {len(data)})")
    row_bytes = int(np.prod(data.shape[1:])) * data.dtype.itemsize
    out = np.empty((len(idx),) + data.shape[1:], data.dtype)
    if num_threads is None:
        num_threads = min(8, os.cpu_count() or 1)
    lib.gather_rows(data.ctypes.data, idx.ctypes.data, out.ctypes.data,
                    len(idx), row_bytes, num_threads)
    gather_rows.native_calls += 1
    return out


def gather_rows_plain(data: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """:func:`gather_rows` in numpy (one thread)."""
    return data[np.asarray(idx).reshape(-1)]


# successful or not, calls that reached the library since the last reset
decode_cifar10_bin.native_calls = decode_mnist.native_calls = gather_rows.native_calls = 0
