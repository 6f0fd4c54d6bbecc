"""The port's user tools against the JAX package's, on the CPU.

``data/download.py`` (offline, through ``file://`` sources and checksums
written here: nothing is fetched from a network), ``models/torch_interop.py``
with ``cli/convert_weights.py`` on the six ``(dataset, role)`` pairs,
``cli/generate.py`` (JAX's latents injected; narrow DCGAN-32, MLP-GAN and
DCGAN-64; the port's checkpoints of both trainer modes), ``cli/analyze.py``
on the committed span and host-metrics CSVs, and the train CLI on a
CIFAR-10 ``.bin`` folder and after ``--download``.
"""

import dataclasses
import functools
import gzip
import hashlib
import io
import json
import pickle
import struct
import tarfile
import urllib.request
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from mdgan_tpu.cli import analyze as janalyze
from mdgan_tpu.cli import convert_weights as jconvert
from mdgan_tpu.cli import generate as jgenerate
from mdgan_tpu.core import registry as jregistry
from mdgan_tpu.data import builtin as jbuiltin
from mdgan_tpu.models import dcgan32 as jdcgan32
from mdgan_tpu.models import dcgan64 as jdcgan64
from mdgan_tpu.models import torch_interop as jinterop
from mdgan_tpu.obs import images as jimages
from mdgan_tpu_torch.cli import analyze, convert_weights, generate
from mdgan_tpu_torch.cli import train as cli
from mdgan_tpu_torch.core import registry
from mdgan_tpu_torch.data import builtin, download, native
from mdgan_tpu_torch.models import dcgan32, dcgan64, from_jax, layers, torch_interop
from mdgan_tpu_torch.obs import images
from mdgan_tpu_torch.utils import checkpoint as ckpt

ROOT = Path(__file__).resolve().parents[1]
PAIRS = [(d, r) for d in ("CIFAR10", "CelebA", "MNIST") for r in ("generator", "discriminator")]
TRAINER = "TorchPortTools32"  # narrow DCGAN-32 on synthetic data, for the trainers


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small tensors."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture()
def stub_inception(monkeypatch):
    """FID/IS stubbed, as ``tests/test_torch_port_train_loop.py`` stubs them."""
    from mdgan_tpu_torch.metrics import fid as fid_mod

    class FakeTracker:
        def __init__(self, real, device=None):
            self.real = float(np.mean(real))

        def score(self, fakes):
            return 100.0 + float(np.mean(fakes)) - self.real

        def inception_score(self, fakes, splits=1):
            return (1.0 + float(np.std(fakes)), 0.0)

    monkeypatch.setattr(fid_mod, "FIDTracker", FakeTracker)


@pytest.fixture()
def offline(monkeypatch):
    """Any fetch other than from a file:// source fails the test."""
    real = urllib.request.urlopen

    def urlopen(url, *a, **k):
        assert str(url).startswith("file://"), f"network fetch of {url}"
        return real(url, *a, **k)

    monkeypatch.setattr(urllib.request, "urlopen", urlopen)


# --- downloads ----------------------------------------------------------------

def _idx_bytes(arr: np.ndarray) -> bytes:
    head = struct.pack(">I", (0x08 << 8) | arr.ndim) + b"".join(
        struct.pack(">I", d) for d in arr.shape)
    return head + arr.astype(np.uint8).tobytes()


def _mnist_sources(src: Path, n: int, seed: int = 0):
    """The four MNIST ``.gz`` files of n train and n test examples, and their
    sha256 checksums."""
    rng = np.random.default_rng(seed)
    src.mkdir(parents=True, exist_ok=True)
    sums = {}
    for name, _ in download.MNIST_FILES:
        shape = (n, 28, 28) if "images" in name else (n,)
        raw = gzip.compress(_idx_bytes(rng.integers(0, 10 if len(shape) == 1 else 256, shape,
                                                    dtype=np.uint8)))
        (src / name).write_bytes(raw)
        sums[name] = "sha256:" + hashlib.sha256(raw).hexdigest()
    return sums


def _cifar_archive(path: Path, n: int = 4, seed: int = 1) -> str:
    rng = np.random.default_rng(seed)
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w:gz") as tf:
        for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
            payload = pickle.dumps({b"data": rng.integers(0, 256, (n, 3072), dtype=np.uint8),
                                    b"labels": list(rng.integers(0, 10, n))})
            info = tarfile.TarInfo(f"cifar-10-batches-py/{name}")
            info.size = len(payload)
            tf.addfile(info, io.BytesIO(payload))
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(buf.getvalue())
    return "sha256:" + hashlib.sha256(buf.getvalue()).hexdigest()


def test_download_mnist_offline_file_url(tmp_path, offline):
    src = tmp_path / "src"
    sums = _mnist_sources(src, 8)
    data_dir = tmp_path / "data"
    out = download.download_mnist(str(data_dir), base_url=src.as_uri(), checksums=sums)
    # the layout load_mnist reads, and no .part.<pid> left behind
    assert sorted(p.name for p in out.iterdir()) == sorted(n for n, _ in download.MNIST_FILES)
    got = builtin.load_mnist(str(data_dir), fallback="error")
    want = jbuiltin.load_mnist(str(data_dir), fallback="error")
    assert got[0].shape == (8, 28, 28, 1)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    for name, _ in download.MNIST_FILES:  # present files are kept: nothing fetched
        (src / name).unlink()
    download.download_mnist(str(data_dir), base_url=src.as_uri(), checksums=sums)
    # a corrupt source is refused and leaves nothing behind
    bad = tmp_path / "bad"
    sums = _mnist_sources(src, 8)
    sums["train-images-idx3-ubyte.gz"] = "md5:" + "0" * 32
    with pytest.raises(ValueError, match="checksum mismatch"):
        download.download_mnist(str(bad), base_url=src.as_uri(), checksums=sums)
    assert not (bad / "mnist" / "train-images-idx3-ubyte.gz").exists()
    assert not list((bad / "mnist").glob("*.part*"))


def test_download_cifar10_offline_and_checksum_rejection(tmp_path, offline):
    src = tmp_path / "src"
    good = _cifar_archive(src / download.CIFAR10_ARCHIVE[0])
    bad_dir = tmp_path / "bad"
    with pytest.raises(ValueError, match="checksum mismatch"):
        download.download_cifar10(str(bad_dir), base_url=src.as_uri(),
                                  checksum="sha256:" + "0" * 64)
    assert not (bad_dir / "cifar10" / "cifar-10-batches-py").exists()
    assert not list((bad_dir / "cifar10").glob("*.tar.gz*"))
    data_dir = tmp_path / "data"
    batches = download.download_cifar10(str(data_dir), base_url=src.as_uri(), checksum=good)
    assert batches == data_dir / "cifar10" / "cifar-10-batches-py" and batches.is_dir()
    assert not list((data_dir / "cifar10").glob(".extract.*"))
    assert not list((data_dir / "cifar10").glob("*.part.*"))
    got = builtin.load_cifar10(str(data_dir), fallback="error")
    want = jbuiltin.load_cifar10(str(data_dir), fallback="error")
    assert got[0].shape == (20, 32, 32, 3)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    # extracted already: nothing fetched again
    (src / download.CIFAR10_ARCHIVE[0]).unlink()
    assert download.download_cifar10(str(data_dir), base_url=src.as_uri()) == batches


def test_ensure_dataset_recipes(tmp_path, offline):
    download.ensure_dataset("Synthetic32", str(tmp_path))  # procedural: nothing to fetch
    download.ensure_dataset("SyntheticMNIST", str(tmp_path))
    assert not any(tmp_path.iterdir())
    for name in ("CelebA", "FFHQ128"):
        with pytest.raises(ValueError, match="no download recipe"):
            download.ensure_dataset(name, str(tmp_path))


# --- weight conversion --------------------------------------------------------

def _random_tree(dataset, role, seed=0):
    """Flax-named (params, stats) of the port's full-width ``(dataset, role)``
    model, every leaf random (variances positive)."""
    spec = registry.get(dataset)
    module = spec.make_generator() if role == "generator" else spec.make_discriminator()
    params, stats = from_jax.export(module)
    rng = np.random.default_rng(seed)

    def fill(tree, positive=False):
        return {k: fill(v, positive) if isinstance(v, dict) else
                (np.abs if positive else np.asarray)(
                    rng.standard_normal(np.shape(v)).astype(np.float32))
                for k, v in tree.items()}
    return fill(params), fill(stats, positive=True)


def _assert_trees_equal(a, b):
    fa, fb = ckpt.flatten(a), ckpt.flatten(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        x, y = np.asarray(fa[k]), np.asarray(fb[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)


@pytest.mark.parametrize("dataset,role", PAIRS)
def test_conversion_matches_jax_bit_for_bit(dataset, role):
    params, stats = _random_tree(dataset, role)
    sd = torch_interop.flax_to_torch(params, stats, dataset, role)
    want = jinterop.flax_to_torch(params, stats, dataset, role)
    assert list(sd) == list(want)
    for k in sd:
        assert sd[k].dtype == want[k].dtype and sd[k].shape == want[k].shape, k
        np.testing.assert_array_equal(sd[k], want[k], err_msg=k)
    assert all(int(v) == 0 for k, v in sd.items() if k.endswith("num_batches_tracked"))
    tensors = {k: torch.tensor(np.asarray(v)) for k, v in sd.items()}
    back = torch_interop.torch_to_flax(tensors, dataset, role)
    jback = jinterop.torch_to_flax(tensors, dataset, role)
    for got, jgot, orig in zip(back, jback, (params, stats)):
        _assert_trees_equal(got, jax.tree.map(np.asarray, jgot))
        _assert_trees_equal(got, orig)


@pytest.mark.parametrize("dataset,role", PAIRS)
def test_validation_rejects_like_jax(dataset, role):
    """The port's model and JAX's flax init agree on every key and shape;
    a truncated kernel and a missing leaf are rejected with JAX's message."""
    params, stats = _random_tree(dataset, role)
    torch_interop.validate_against_model(params, stats, dataset, role)
    jinterop.validate_against_model(params, stats, dataset, role)
    flat = ckpt.flatten(params)
    keys = sorted(flat)
    flat[keys[0]] = flat[keys[0]][:1]
    del flat[keys[-1]]
    broken = ckpt.unflatten(flat)
    msgs = []
    for validate in (torch_interop.validate_against_model, jinterop.validate_against_model):
        with pytest.raises(ValueError, match="shape-mismatch") as err:
            validate(broken, stats, dataset, role)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
    assert f"params/{keys[0]}" in msgs[0] and f"missing=['params/{keys[-1]}']" in msgs[0]


def test_unknown_dataset_and_bad_state_dict_error():
    with pytest.raises(ValueError, match="no torch interop map"):
        torch_interop.torch_to_flax({}, "FFHQ128", "generator")
    params, stats = _random_tree("CIFAR10", "discriminator")
    sd = torch_interop.flax_to_torch(params, stats, "CIFAR10", "discriminator")
    sd.pop("main.3.running_mean")
    with pytest.raises(KeyError, match="main.3.running_mean"):
        torch_interop.torch_to_flax(sd, "CIFAR10", "discriminator")
    sd["main.3.running_mean"] = sd["main.3.running_var"]
    sd["main.99.weight"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="unconsumed"):
        torch_interop.torch_to_flax(sd, "CIFAR10", "discriminator")


@pytest.mark.parametrize("dataset,role", PAIRS)
def test_convert_cli_round_trips_bit_exact(tmp_path, dataset, role, capsys):
    """pt -> npz -> pt and npz -> pt -> npz are bit-exact; the npz equals
    the JAX CLI's from the same .pt; both CLIs return None."""
    params, stats = _random_tree(dataset, role, seed=1)
    sd = {k: torch.tensor(np.asarray(v))
          for k, v in torch_interop.flax_to_torch(params, stats, dataset, role).items()}
    torch.save(sd, tmp_path / "ref.pt")
    base = ["--dataset", dataset, "--role", role]
    assert convert_weights.main(base + ["--input", str(tmp_path / "ref.pt"),
                                        "--out", str(tmp_path / "port.npz")]) is None
    assert jconvert.main(base + ["--input", str(tmp_path / "ref.pt"), "--out",
                                 str(tmp_path / "jax.npz"), "--no_validate"]) is None
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "jax.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    assert convert_weights.main(base + ["--input", str(tmp_path / "port.npz"),
                                        "--out", str(tmp_path / "back.pth")]) is None
    back = torch.load(tmp_path / "back.pth", weights_only=True)
    assert list(back) == list(sd)
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    assert convert_weights.main(base + ["--input", str(tmp_path / "back.pth"),
                                        "--out", str(tmp_path / "again.npz")]) is None
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "again.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert all(np.array_equal(a[k], b[k]) for k in a.files)
    with pytest.raises(SystemExit):
        convert_weights.main(base + ["--input", str(tmp_path / "ref.pt"),
                                     "--out", str(tmp_path / "x.pt")])
    capsys.readouterr()


# --- generate -----------------------------------------------------------------

# family -> (port dataset, port G, JAX G)
GENERATORS = {
    "dcgan32": ("CIFAR10", functools.partial(dcgan32.DCGANGenerator32, ngf=8),
                functools.partial(jdcgan32.DCGANGenerator32, ngf=8)),
    "mlp": ("MNIST", None, None),
    "dcgan64": ("CelebA", functools.partial(dcgan64.DCGANGenerator64, ngf=8),
                functools.partial(jdcgan64.DCGANGenerator64, ngf=8)),
}


def _narrow_specs(family):
    dataset, g, jg = GENERATORS[family]
    spec, jspec = registry.get(dataset), jregistry.get(dataset)
    if g is not None:
        spec = dataclasses.replace(spec, make_generator=g)
        jspec = dataclasses.replace(jspec, make_generator=jg)
    return spec, jspec


@pytest.mark.parametrize("family", list(GENERATORS))
def test_generate_matches_jax_sample(tmp_path, family):
    spec, jspec = _narrow_specs(family)
    g = spec.make_generator()
    (spec.init_weights or layers.dcgan_init_)(g, torch.Generator().manual_seed(3))
    params, stats = from_jax.export(g)
    num, seed = 12, 5
    want = jgenerate._sample(jspec, params, stats, num, seed)
    z = np.array(jax.random.normal(jax.random.key(seed), (num, jspec.z_dim)))
    got = generate.sample_images(spec, params, stats, num, seed, device="cpu",
                                 z=torch.from_numpy(z))
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    images.save_image_grid(got, tmp_path / "port.png", nrow=4)
    jimages.save_image_grid(want, tmp_path / "jax.png", nrow=4)
    a = images.load_png(tmp_path / "port.png").astype(np.int16)
    b = jimages.load_png(tmp_path / "jax.png").astype(np.int16)
    assert a.shape == b.shape and np.abs(a - b).max() <= 1


def test_sample_leaves_g_statistics_unchanged():
    spec, _ = _narrow_specs("dcgan32")
    g = generate.load_generator(spec, *from_jax.export(spec.make_generator()), "cpu")
    before = [b.clone() for b in g.buffers()]
    imgs = generate.sample(g, generate.latents(spec, 6, 0, "cpu"))
    assert imgs.shape == (6, 32, 32, 3) and 0 <= imgs.min() and imgs.max() <= 1
    assert all(torch.equal(a, b) for a, b in zip(before, g.buffers()))
    again = generate.sample(g, generate.latents(spec, 6, 0, "cpu"))
    np.testing.assert_array_equal(imgs, again)  # same seed, same images


def _trainer_spec():
    try:
        return registry.get(TRAINER)
    except KeyError:
        return registry.register(registry.DatasetSpec(
            name=TRAINER, shape=dcgan32.SHAPE, z_dim=dcgan32.Z_DIM,
            make_generator=functools.partial(dcgan32.DCGANGenerator32, ngf=8),
            make_discriminator=functools.partial(dcgan32.DCGANDiscriminator32, ndf=8),
            load=lambda *a, **k: builtin.synthesize((32, 32, 3), 96, seed=32)))


def _dirs(root):
    return [arg for flag in ("log_dir", "image_dir", "weights_dir", "checkpoint_dir")
            for arg in (f"--{flag}", str(root / flag))]


@pytest.mark.parametrize("mode", ["mdgan", "standalone"])
def test_generate_reads_port_checkpoints(tmp_path, stub_inception, capsys, mode):
    """--checkpoint reads a port checkpoint of either mode (latest step by
    default, or --step), samples from its generator and leaves the file as
    it was; --weights and --filmstrip read the run's exports."""
    _trainer_spec()
    argv = ["--mode", mode, "--dataset", TRAINER, "--num_workers", "2", "--batch_size", "4",
            "--epochs", "5", "--swap_interval", "3", "--log_interval", "2",
            "--checkpoint_interval", "2", "--chunk_size", "2", "--device", "cpu",
            "--compute_dtype", "float32"] + _dirs(tmp_path)
    assert cli.main(argv) == 0
    name = f"mdgan.2.{TRAINER}" if mode == "mdgan" else f"{TRAINER}.standalone"
    directory = tmp_path / "checkpoint_dir" / name
    assert ckpt.checkpoint_steps(directory) == [2, 4]
    digest = hashlib.sha256((directory / "ckpt_4.pt").read_bytes()).hexdigest()
    out = tmp_path / "grid.png"
    common = ["--dataset", TRAINER, "--num", "6", "--nrow", "3", "--device", "cpu"]
    assert generate.main(common + ["--checkpoint", str(directory), "--out", str(out)]) == 0
    assert "from step 4" in capsys.readouterr().out
    assert images.load_png(out).shape == (64, 96, 3)
    assert hashlib.sha256((directory / "ckpt_4.pt").read_bytes()).hexdigest() == digest
    params, stats = generate.load_from_checkpoint(str(directory), 2)
    payload, _ = ckpt.load_payload(directory, 2)
    saved = payload["nets"]["g"]
    for key, t in ckpt.flatten({"params": params, "batch_stats": stats}).items():
        top, _, leaf = key.partition("/")
        np.testing.assert_array_equal(t, saved[top][leaf].numpy())
    # the checkpoint's generator is the one the run exported at that step
    wd = tmp_path / "weights_dir"
    final = "generator_final.npz" if mode == "mdgan" else "netG_epoch_4.npz"
    exported = from_jax.load_npz(wd / final)
    for a, b in zip(generate.load_from_checkpoint(str(directory), None), exported):
        _assert_trees_equal(a, b)
    spec = registry.get(TRAINER)
    z = generate.latents(spec, 6, 0, "cpu")
    want = generate.sample_images(spec, *exported, 6, 0, "cpu", z=z)
    assert generate.main(common + ["--weights", str(wd / final), "--out",
                                   str(tmp_path / "w.png")]) == 0
    np.testing.assert_array_equal(images.load_png(tmp_path / "w.png"),
                                  images.load_png(out))
    np.testing.assert_array_equal(generate.sample_images(spec, *exported, 6, 0, "cpu"), want)
    if mode == "mdgan":
        strip = tmp_path / "strip.png"
        assert generate.main(["--dataset", TRAINER, "--device", "cpu", "--weights_glob",
                              str(wd / "generator_*.npz"), "--filmstrip", str(strip)]) == 0
        frames = len(list(wd.glob("generator_*.npz")))
        assert images.load_png(strip).shape == (32, 32 * frames, 3)
    with pytest.raises(FileNotFoundError):
        generate.main(common + ["--checkpoint", str(tmp_path / "none")])
    capsys.readouterr()


# --- analyze ------------------------------------------------------------------

LOG_DIRS = ["golden/cifar10_w8_r2000", "golden/cifar10_standalone_r2000",
            "headline/cifar10_w8_r30000", "scale/cifar10_w20_r10000"]


@pytest.mark.parametrize("logs", LOG_DIRS)
def test_analyze_reports_equal_jax(logs):
    paths = sorted((ROOT / "artifacts" / logs / "logs").iterdir())
    if logs.startswith("scale"):  # the gzipped workers
        paths = [p for p in paths if p.suffix == ".gz"]
        assert len(paths) == 19
    for path in paths:
        host = analyze.is_host_csv(path)
        assert host == janalyze.is_host_csv(path)
        if host:
            assert analyze.analyze_host_file(path) == janalyze.analyze_host_file(path)
        else:
            rep = analyze.analyze_file(path)
            assert rep == janalyze.analyze_file(path)
            assert rep["ops"]


def test_analyze_cli_json_and_plots_match_jax(tmp_path, capsys):
    logs = ROOT / "artifacts/golden/cifar10_w8_r2000/logs"
    csvs = [str(logs / n) for n in ("mdgan.8.CIFAR10.server.logs.csv",
                                    "mdgan.8.CIFAR10.worker.1.logs.csv", "host.csv")]
    csvs.append(str(ROOT / "artifacts/golden/cifar10_standalone_r2000/logs/"
                    "CIFAR10.standalone.logs.csv"))
    assert analyze.main(["--json"] + csvs) == 0
    port = json.loads(capsys.readouterr().out)
    assert janalyze.main(["--json"] + csvs) == 0
    assert port == json.loads(capsys.readouterr().out)
    for impl, out in ((analyze, tmp_path / "port"), (janalyze, tmp_path / "jax")):
        assert impl.main(["--plot", str(out), "--compare", "--timeline_rounds", "3"]
                         + csvs) == 0
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert "timeline.png" in names and "host.host.png" in names
    assert any(n.startswith("compare.") for n in names)
    capsys.readouterr()


def test_analyze_plot_without_matplotlib_exits_clearly(monkeypatch, tmp_path):
    import sys

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    csv = str(ROOT / "artifacts/headline/cifar10_w8_r30000/logs/mdgan.8.CIFAR10.server.logs.csv")
    with pytest.raises(SystemExit, match="needs matplotlib"):
        analyze.main(["--plot", str(tmp_path), csv])
    assert analyze.main([csv]) == 0  # the report needs none


# --- the train CLI --------------------------------------------------------------

def test_cli_trains_on_bin_folder_and_after_download(tmp_path, stub_inception, offline,
                                                     monkeypatch, capsys):
    """A cifar-10-batches-bin folder trains through the native decoder (its
    bytes, not synthetic ones); --download on a filled MNIST folder fetches
    nothing and trains."""
    rng = np.random.default_rng(4)
    d = tmp_path / "data" / "cifar10" / "cifar-10-batches-bin"
    d.mkdir(parents=True)
    recs = rng.integers(0, 256, (5, 8, 3073), dtype=np.uint8)
    for b in range(5):
        (d / f"data_batch_{b + 1}.bin").write_bytes(recs[b].tobytes())
    loaded = []
    spec = registry.get("CIFAR10")
    monkeypatch.setitem(registry._REGISTRY, "CIFAR10", dataclasses.replace(
        spec, load=lambda *a, **k: loaded.append(spec.load(*a, **k)) or loaded[-1]))
    calls = native.decode_cifar10_bin.native_calls
    argv = ["--epochs", "1", "--device", "cpu", "--num_workers", "2", "--max_examples", "40",
            "--data_dir", str(tmp_path / "data"), "--compute_dtype", "float32"]
    assert cli.main(argv + _dirs(tmp_path / "cifar")) == 0
    assert native.decode_cifar10_bin.native_calls == calls + (1 if native.available() else 0)
    want = recs.reshape(40, 3073)[:, 1:].reshape(40, 3, 32, 32).transpose(0, 2, 3, 1)
    np.testing.assert_array_equal(loaded[0][0], want)

    _mnist_sources(tmp_path / "data" / "mnist", 40)
    argv = ["--epochs", "1", "--device", "cpu", "--num_workers", "2", "--dataset", "MNIST",
            "--batch_size", "4",
            "--data_dir", str(tmp_path / "data"), "--download", "--compute_dtype", "float32"]
    assert cli.main(argv + _dirs(tmp_path / "mnist")) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["all_finite"]
