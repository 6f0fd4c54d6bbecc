"""The port's native host data path against the JAX package's, on the CPU.

``mdgan_tpu_torch/data/native`` (the C++ decoders and the threaded gather,
built with ``g++``) and its plain numpy versions must give the JAX package's
``mdgan_tpu/data/native`` results byte for byte, return None where JAX
returns None (missing or corrupt files, oversized idx headers), and feed
``load_cifar10``, ``load_mnist`` and ``shard_data`` the same bytes as the JAX
loaders.  One deliberate difference is pinned: a ``cifar-10-batches-bin``
folder never falls through to synthetic data in the port (ROADMAP.md C.4).
"""

import struct

import numpy as np
import pytest

from mdgan_tpu.data import builtin as jbuiltin
from mdgan_tpu.data import native as jnative
from mdgan_tpu.data import partitioner as jpartitioner
from mdgan_tpu_torch.data import builtin, native, partitioner


@pytest.fixture(scope="module")
def libs():
    if jnative.get_lib() is None or not native.available():
        pytest.skip("no C++ toolchain available")


@pytest.fixture()
def no_native(monkeypatch):
    """The port with its library unavailable, as ``MDGAN_TPU_NO_NATIVE``
    leaves it (decided at first use, so the cached decision is replaced)."""
    monkeypatch.setenv("MDGAN_TPU_NO_NATIVE", "1")
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setattr(native, "_LIB", None)


def _write_cifar_bin(d, n_per, seed=1, files=range(1, 6), test=False):
    """Binary-format CIFAR batches of ``n_per`` random records each; returns
    the NHWC images and labels in file order."""
    rng = np.random.default_rng(seed)
    d.mkdir(parents=True, exist_ok=True)
    imgs, labels = [], []
    names = ["test_batch.bin"] if test else [f"data_batch_{b}.bin" for b in files]
    for name in names:
        lab = rng.integers(0, 10, n_per).astype(np.uint8)
        chw = rng.integers(0, 256, (n_per, 3, 32, 32), dtype=np.uint8)
        recs = np.concatenate([lab[:, None], chw.reshape(n_per, -1)], axis=1)
        (d / name).write_bytes(recs.tobytes())
        imgs.append(chw.transpose(0, 2, 3, 1))
        labels.append(lab.astype(np.int64))
    return np.concatenate(imgs), np.concatenate(labels)


def _write_mnist(d, n, rows=28, cols=28, n_labels=None, seed=2):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (n, rows, cols), dtype=np.uint8)
    labels = rng.integers(0, 10, n).astype(np.uint8)
    d.mkdir(parents=True, exist_ok=True)
    ipath, lpath = d / "train-images-idx3-ubyte", d / "train-labels-idx1-ubyte"
    ipath.write_bytes(struct.pack(">IIII", 0x803, n, rows, cols) + imgs.tobytes())
    m = n if n_labels is None else n_labels
    lpath.write_bytes(struct.pack(">II", 0x801, m) + labels[:m].tobytes())
    return ipath, lpath, imgs, labels


def _same(*results):
    first = results[0]
    for other in results[1:]:
        if first is None or other is None:
            assert first is None and other is None
            continue
        assert len(first) == len(other)
        for a, b in zip(first, other):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype,shape", [(np.uint8, (1000, 7, 3)), (np.float32, (500, 16)),
                                         (np.uint8, (9000, 28, 28, 1))])
def test_gather_rows_matches_jax(libs, dtype, shape):
    rng = np.random.default_rng(0)
    data = (rng.integers(0, 256, shape).astype(dtype) if dtype == np.uint8
            else rng.normal(size=shape).astype(dtype))
    idx = rng.integers(0, shape[0], 5000)
    calls = native.gather_rows.native_calls
    got = native.gather_rows(data, idx)
    assert native.gather_rows.native_calls == calls + 1
    _same((got,), (native.gather_rows_plain(data, idx),), (jnative.gather_rows(data, idx),),
          (data[idx],))
    with pytest.raises(IndexError):
        native.gather_rows(data, np.array([0, shape[0]]))


@pytest.mark.parametrize("max_examples,train", [(100, True), (7, True), (1000, True),
                                                (30, False)])
def test_cifar_bin_decode_matches_jax(libs, tmp_path, max_examples, train):
    d = tmp_path / "cifar-10-batches-bin"
    imgs, labels = _write_cifar_bin(d, 20, test=not train)
    got = native.decode_cifar10_bin(d, max_examples, train=train)
    _same(got, native.decode_cifar10_bin_plain(d, max_examples, train=train),
          jnative.decode_cifar10_bin(d, max_examples, train=train))
    n = min(max_examples, len(imgs))
    _same(got, (imgs[:n], labels[:n]))


@pytest.mark.parametrize("n_per,max_examples,train", [(1500, 5000, True), (8200, 10000, False)])
def test_cifar_bin_bulk_decode_matches_jax(libs, tmp_path, n_per, max_examples, train):
    """Files past the native decode's threading threshold (1,024 records)
    and its 8,192-record read size, each ending in a partial record that
    every decoder ignores."""
    d = tmp_path / "cifar-10-batches-bin"
    imgs, labels = _write_cifar_bin(d, n_per, test=not train)
    for path in d.iterdir():
        path.write_bytes(path.read_bytes() + b"\7" * 100)
    got = native.decode_cifar10_bin(d, max_examples, train=train)
    _same(got, native.decode_cifar10_bin_plain(d, max_examples, train=train),
          jnative.decode_cifar10_bin(d, max_examples, train=train))
    n = min(max_examples, len(imgs))
    _same(got, (imgs[:n], labels[:n]))


@pytest.mark.parametrize("n_labels", [None, 9, 0])
def test_mnist_idx_decode_matches_jax(libs, tmp_path, n_labels):
    ipath, lpath, imgs, labels = _write_mnist(tmp_path, 15, n_labels=n_labels)
    for lbl, cap in ((lpath, 60000), (None, 60000), (lpath, 10)):
        got = native.decode_mnist(ipath, lbl, cap)
        _same(got, native.decode_mnist_plain(ipath, lbl, cap),
              jnative.decode_mnist(ipath, lbl, cap))
        n = min(15, cap)
        want_labels = (labels[:n].astype(np.int64) if lbl and n_labels is None
                       else np.zeros(n, np.int64))
        _same(got, (imgs[:n, ..., None], want_labels))


def _corrupt_case(tmp_path, case):
    """A (function, args) whose decode JAX rejects: None for each."""
    d = tmp_path / "cifar-10-batches-bin"
    if case == "mnist_garbage":
        (tmp_path / "train-images-idx3-ubyte").write_bytes(b"garbage")
        return "mnist", (tmp_path / "train-images-idx3-ubyte", None, 60000)
    if case == "mnist_oversized_dims":  # > the 28x28 buffer of 100 images
        big = tmp_path / "train-images-idx3-ubyte"
        big.write_bytes(struct.pack(">IIII", 0x803, 100, 64, 64) + b"\0" * (100 * 64 * 64))
        return "mnist", (big, None, 100)
    if case == "mnist_truncated":
        ipath, _, _, _ = _write_mnist(tmp_path, 15)
        ipath.write_bytes(ipath.read_bytes()[:-1])
        return "mnist", (ipath, None, 60000)
    if case == "mnist_missing":
        return "mnist", (tmp_path / "absent", None, 60000)
    if case == "cifar_no_files":
        d.mkdir()
        return "cifar", (d, 10, True)
    if case == "cifar_missing_later_batch":
        _write_cifar_bin(d, 5, files=[1, 2])
        return "cifar", (d, 50, True)
    if case == "cifar_short_records":
        d.mkdir()
        for b in range(1, 6):
            (d / f"data_batch_{b}.bin").write_bytes(b"\1" * 3072)
        return "cifar", (d, 50, True)
    raise KeyError(case)


@pytest.mark.parametrize("case", ["mnist_garbage", "mnist_oversized_dims", "mnist_truncated",
                                  "mnist_missing", "cifar_no_files",
                                  "cifar_missing_later_batch", "cifar_short_records"])
def test_corrupt_and_missing_files_give_none(libs, tmp_path, case):
    kind, args = _corrupt_case(tmp_path, case)
    if kind == "mnist":
        fns = (native.decode_mnist, native.decode_mnist_plain, jnative.decode_mnist)
    else:
        fns = (native.decode_cifar10_bin, native.decode_cifar10_bin_plain,
               jnative.decode_cifar10_bin)
    for fn in fns:
        assert fn(*args) is None, fn


def test_no_native_switch(libs, no_native, tmp_path):
    d = tmp_path / "cifar-10-batches-bin"
    _write_cifar_bin(d, 3)
    assert not native.available()
    assert native.decode_cifar10_bin(d, 10) is None
    assert native.gather_rows(np.zeros((4, 2)), np.arange(4)) is None
    assert native.decode_cifar10_bin_plain(d, 10) is not None


def test_library_build_is_hashed_and_logged(libs, monkeypatch, tmp_path):
    """The library lives in build/ under a hash of its source and flags, with
    the compiler's output beside it; a changed source or flag set names
    another library, so a stale one is never loaded."""
    path = native.library_path()
    assert path.parent == native.BUILD_DIR and path.is_file()
    assert path.with_suffix(".log").is_file()
    assert native.command(tmp_path / "x.so")[:5] == ["g++", "-O3", "-shared", "-fPIC",
                                                     "-pthread"]
    with monkeypatch.context() as m:
        m.setattr(native, "GXX_FLAGS", native.GXX_FLAGS + ("-g",))
        assert native.library_path() != path
    src = tmp_path / "fastloader.cpp"
    src.write_bytes(native.SOURCE.read_bytes() + b"\n")
    monkeypatch.setattr(native, "SOURCE", src)
    assert native.library_path() != path


def test_shard_data_above_64mib_matches_jax(libs, no_native, monkeypatch):
    """> 64 MiB: the threaded gather, then numpy with the library off; both
    equal JAX's shard_data."""
    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, (70000, 32, 32, 1), dtype=np.uint8)
    assert data.nbytes >= partitioner.NATIVE_GATHER_BYTES
    s_numpy, i_numpy = partitioner.shard_data(data, 4, iid=True, seed=0)
    monkeypatch.delenv("MDGAN_TPU_NO_NATIVE")
    monkeypatch.setattr(native, "_TRIED", False)
    calls = native.gather_rows.native_calls
    s_native, i_native = partitioner.shard_data(data, 4, iid=True, seed=0)
    assert native.gather_rows.native_calls == calls + 1
    s_jax, i_jax = jpartitioner.shard_data(data, 4, iid=True, seed=0)
    for s, i in ((s_numpy, i_numpy), (s_native, i_native)):
        np.testing.assert_array_equal(i, i_jax)
        np.testing.assert_array_equal(s, s_jax)


@pytest.mark.parametrize("layout", ["cifar10/cifar-10-batches-bin", "cifar-10-batches-bin"])
def test_load_cifar10_bin_matches_jax(libs, tmp_path, monkeypatch, layout):
    imgs, labels = _write_cifar_bin(tmp_path / layout, 20)
    calls = native.decode_cifar10_bin.native_calls
    for cap in (None, 7):
        got = builtin.load_cifar10(str(tmp_path), max_examples=cap)
        _same(got, jbuiltin.load_cifar10(str(tmp_path), max_examples=cap))
        _same(got, (imgs[:cap or 100], labels[:cap or 100]))
    assert native.decode_cifar10_bin.native_calls == calls + 2
    # the library off: the plain version, the same bytes
    monkeypatch.setenv("MDGAN_TPU_NO_NATIVE", "1")
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setattr(native, "_LIB", None)
    _same(builtin.load_cifar10(str(tmp_path)), (imgs, labels))
    assert native.decode_cifar10_bin.native_calls == calls + 2


@pytest.mark.parametrize("native_on", [True, False])
def test_bin_folder_never_falls_to_synthetic(libs, tmp_path, monkeypatch, native_on):
    """The port raises, naming the file, where JAX returns synthetic data
    (ROADMAP.md C.4)."""
    if not native_on:
        monkeypatch.setenv("MDGAN_TPU_NO_NATIVE", "1")
        monkeypatch.setattr(native, "_TRIED", False)
        monkeypatch.setattr(native, "_LIB", None)
    d = tmp_path / "cifar-10-batches-bin"
    _write_cifar_bin(d, 4, files=[1, 2, 3, 4])
    synthetic = jbuiltin.synthesize((32, 32, 3), 50, seed=32)
    _same(jbuiltin.load_cifar10(str(tmp_path), max_examples=50), synthetic)
    with pytest.raises(FileNotFoundError, match="data_batch_5.bin"):
        builtin.load_cifar10(str(tmp_path), max_examples=50)
    for b in range(1, 6):
        (d / f"data_batch_{b}.bin").write_bytes(b"\0" * 100)
    with pytest.raises(ValueError, match="data_batch_1.bin"):
        builtin.load_cifar10(str(tmp_path), max_examples=50)
    (d / "test_batch.bin").write_bytes(b"")
    with pytest.raises(ValueError, match="test_batch.bin"):
        builtin.load_cifar10(str(tmp_path), split="test")


@pytest.mark.parametrize("gz", ["none", "labels", "both"])
def test_load_mnist_raw_goes_native_and_matches_jax(libs, tmp_path, gz):
    import gzip

    ipath, lpath, imgs, labels = _write_mnist(tmp_path / "mnist", 15)
    for path, zipped in ((ipath, gz == "both"), (lpath, gz in ("labels", "both"))):
        if zipped:
            path.with_name(path.name + ".gz").write_bytes(gzip.compress(path.read_bytes()))
            path.unlink()
    calls = native.decode_mnist.native_calls
    for cap in (None, 6):
        got = builtin.load_mnist(str(tmp_path), max_examples=cap)
        _same(got, jbuiltin.load_mnist(str(tmp_path), max_examples=cap))
        _same(got, (imgs[:cap or 15, ..., None], labels[:cap or 15].astype(np.int64)))
    # only raw idx pairs reach the native decoder; gzipped pieces go to _read_idx
    assert native.decode_mnist.native_calls == calls + (2 if gz == "none" else 0)
