"""The port's trainers, checkpoints and exports, on the CPU, against the JAX
package's formats.

Narrow DCGAN-32 (ngf=ndf=8) on synthetic data, registered as a dataset of
the port's registry.  FID/IS are stubbed, as ``tests/test_train_loop.py``
stubs them (their parity is ``tests/test_torch_port_metrics.py``'s).
"""

import functools
import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from mdgan_tpu.cli.analyze import analyze_file
from mdgan_tpu.data import sampler as jsampler
from mdgan_tpu.engine.state import apply_train
from mdgan_tpu.engine.train_loop import _next_event
from mdgan_tpu.models import dcgan32 as jdcgan32
from mdgan_tpu.obs import spans as jspans
from mdgan_tpu.utils import checkpoint as jckpt
from mdgan_tpu_torch.cli import train as cli
from mdgan_tpu_torch.core import registry
from mdgan_tpu_torch.data import builtin, sampler
from mdgan_tpu_torch.engine import train_loop
from mdgan_tpu_torch.models import dcgan32
from mdgan_tpu_torch.utils import checkpoint as ckpt

NAME, WIDTH = "TorchPortTrainer32", 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small tensors: extra threads
    buy nothing at these sizes and spin against the other test processes
    the suite runs beside this one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)



def _spec():
    try:
        return registry.get(NAME)
    except KeyError:
        return registry.register(registry.DatasetSpec(
            name=NAME, shape=dcgan32.SHAPE, z_dim=dcgan32.Z_DIM,
            make_generator=functools.partial(dcgan32.DCGANGenerator32, ngf=WIDTH),
            make_discriminator=functools.partial(dcgan32.DCGANDiscriminator32, ndf=WIDTH),
            load=lambda *a, **k: builtin.synthesize((32, 32, 3), 96, seed=32)))


@pytest.fixture()
def stub_inception(monkeypatch):
    from mdgan_tpu_torch.metrics import fid as fid_mod

    class FakeTracker:
        def __init__(self, real, device=None):
            self.real = float(np.mean(real))

        def score(self, fakes):
            return 100.0 + float(np.mean(fakes)) - self.real

        def inception_score(self, fakes, splits=1):
            return (1.0 + float(np.std(fakes)), 0.0)

    monkeypatch.setattr(fid_mod, "FIDTracker", FakeTracker)


def _argv(root, mode, epochs, *extra):
    _spec()
    argv = ["--mode", mode, "--dataset", NAME, "--num_workers", "2", "--batch_size", "4",
            "--epochs", str(epochs), "--swap_interval", "3", "--log_interval", "2",
            "--checkpoint_interval", "2", "--chunk_size", "2", "--metrics_flush", "2",
            "--compute_dtype", "float32", "--device", "cpu", "--eval_n_samples", "6"]
    for flag in ("log_dir", "image_dir", "weights_dir", "checkpoint_dir"):
        argv += [f"--{flag}", str(root / flag)]
    return argv + list(extra)


def _run(root, mode, epochs, *extra):
    """(trainer after its run, summary)."""
    cfg = cli.config_from_args(cli.build_parser().parse_args(_argv(root, mode, epochs, *extra)))
    trainer = (train_loop.MDGANTrainer if mode == "mdgan" else train_loop.StandaloneTrainer)(cfg)
    try:
        summary = trainer.train()
    finally:
        trainer.close()
    return trainer, summary


def _csv(path):
    return jspans.read_spans(path)


def _columns(path):
    with open(path) as f:
        return f.readline().strip().split(",")


def _arenas(st):
    return {(n, a): getattr(getattr(st, n), a).clone()
            for n in ("g", "d") for a in ("params", "stats", "mu", "nu")}


def test_next_event_matches_jax():
    for cur in range(0, 40):
        for swap, log_i, n, ck in ((5, 7, 4, 6), (0, 3, 1, 4), (4, 0, 2, 0), (3, 3, 2, 3)):
            assert train_loop.next_event(cur, 40, swap, log_i, n, ck) == \
                _next_event(cur, 40, swap, log_i, n, ck)


def test_sampler_checkpoint_helpers_match_jax():
    ps, js = sampler.ShardSampler(2, 30, 7, seed=0), jsampler.ShardSampler(2, 30, 7, seed=0)
    ps.next_chunk(5)
    js.next_chunk(5)
    a, b = ps.state_dict(), js.state_dict()
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    restored = sampler.ShardSampler(2, 30, 7, seed=0)
    restored.load_state_dict(a)
    np.testing.assert_array_equal(restored.next_chunk(6), js.next_chunk(6))


def test_mdgan_run_writes_jax_files(tmp_path, stub_inception):
    trainer, summary = _run(tmp_path, "mdgan", 9)
    name = f"mdgan.2.{NAME}"
    server = tmp_path / "log_dir" / f"{name}.server.logs.csv"
    assert _columns(server) == list(jspans.server_row_template(0, 0.0, 0.0).keys())
    for r in (1, 2):
        worker = tmp_path / "log_dir" / f"{name}.worker.{r}.logs.csv"
        assert _columns(worker) == list(jspans.worker_row_template(0, 0.0).keys())
        rows = _csv(worker)
        assert [row["epoch"] for row in rows] == list(range(9))  # one row per round
        assert all(np.isfinite(row["mean_d_loss"]) for row in rows)
        assert [row["swap_with"] for row in rows if row["swap_with"]] == \
            [float(3 - r)] * 2  # swaps after rounds 3 and 6
    rows = _csv(server)
    assert [row["epoch"] for row in rows] == [0, 2, 3, 4, 6, 8]  # chunk ends
    assert [row["epoch"] for row in rows if row["fid"] is not None] == [0, 2, 4, 6, 8]
    for a, b in zip(rows, rows[1:]):
        assert a["end.epoch"] <= b["start.epoch"]
    rep = analyze_file(server)
    assert rep["rows"] == 6 and rep["best_fid"] > 0 and rep["rounds"] == 9
    assert summary["rounds"] == 9 and summary["swaps"] == 2 and summary["all_finite"]
    assert [e["epoch"] for e in summary["evals"]] == [0, 2, 4, 6, 8]
    assert all("fid_standard" in e for e in summary["evals"])  # eval_standard_interval 1
    images = sorted(p.name for p in (tmp_path / "image_dir").iterdir())
    assert images == [f"generated_epoch_{e}.png" for e in (0, 2, 4, 6, 8)] + ["real_images.png"]
    weights = tmp_path / "weights_dir"
    assert sorted(p.name for p in weights.glob("*.npz")) == sorted(
        [f"generator_{e}.npz" for e in (0, 2, 4, 6, 8)] + ["generator_final.npz"])
    ckpts = ckpt.CheckpointManager(tmp_path / "checkpoint_dir" / name)
    assert ckpts.steps() == [4, 6, 8]  # max_to_keep 3 of 2, 4, 6, 8
    assert sorted(p.name for p in ckpts.directory.glob("host_rng_*.json")) == [
        "host_rng_4.json", "host_rng_6.json", "host_rng_8.json"]

    # the exports read with the JAX loaders, and JAX's forward of them is the port's
    z = np.random.default_rng(0).standard_normal((4, 100), np.float32)
    params, stats = jckpt.load_weights_only(weights / "generator_final.npz")
    want, _ = apply_train(jdcgan32.DCGANGenerator32(ngf=WIDTH), params, stats, jnp.asarray(z))
    got = trainer.engine.generate(trainer.state.g, torch.from_numpy(z))
    np.testing.assert_allclose(got.numpy(), np.asarray(want).transpose(0, 3, 1, 2),
                               rtol=1e-4, atol=1e-5)
    x = np.random.default_rng(1).uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32)
    for r in range(2):
        params, stats = jckpt.load_weights_only(weights / f"worker_{r + 1}" / "discriminator.npz")
        want, _ = apply_train(jdcgan32.DCGANDiscriminator32(ndf=WIDTH), params, stats,
                              jnp.asarray(x))
        with torch.no_grad():
            saved = trainer.state.d.stats.clone()
            got = trainer.state.d.modules[r](torch.from_numpy(x).permute(0, 3, 1, 2))
            trainer.state.d.stats.copy_(saved)
        np.testing.assert_allclose(got.numpy(), np.asarray(want).reshape(-1), rtol=1e-4,
                                   atol=1e-5)


def test_standalone_run_writes_jax_files(tmp_path, stub_inception):
    _, summary = _run(tmp_path, "standalone", 5)
    csv = tmp_path / "log_dir" / f"{NAME}.standalone.logs.csv"
    assert _columns(csv) == list(jspans.server_row_template(0, 0.0, 0.0).keys())
    rows = _csv(csv)
    assert [row["epoch"] for row in rows] == [0, 2, 4]
    # the standalone run has no final-round 5-sample eval; the standard one
    # runs at every eval event and the last round
    assert [e["epoch"] for e in summary["evals"]] == [0, 2, 4]
    assert all("fid" in e and "fid_standard" in e for e in summary["evals"])
    assert sorted(p.name for p in (tmp_path / "image_dir").iterdir()) == [
        "fake_samples_0.png", "fake_samples_2.png", "fake_samples_4.png"]
    for net, cls, x in (("netG", jdcgan32.DCGANGenerator32(ngf=WIDTH), jnp.zeros((2, 100))),
                        ("netD", jdcgan32.DCGANDiscriminator32(ndf=WIDTH),
                         jnp.zeros((2, 32, 32, 3)))):
        params, stats = jckpt.load_weights_only(tmp_path / "weights_dir" / f"{net}_epoch_4.npz")
        out, _ = apply_train(cls, params, stats, x)
        assert np.isfinite(np.asarray(out)).all()
    assert summary["rounds"] == 5 and np.isfinite(summary["final_mean_g_loss"])


@pytest.mark.parametrize("mode", ["mdgan", "standalone"])
def test_seeded_runs_repeat_and_async_eval_changes_nothing(tmp_path, stub_inception, mode):
    runs = [_run(tmp_path / str(i), mode, 5, *extra)
            for i, extra in enumerate([(), (), ("--sync_eval",)])]
    name = f"mdgan.2.{NAME}.server" if mode == "mdgan" else f"{NAME}.standalone"
    cols = ("fid", "is", "fid_standard", "is_standard", "epoch")
    tables = [[{k: row[k] for k in cols} for row in _csv(tmp_path / str(i) / "log_dir" /
                                                         f"{name}.logs.csv")]
              for i in range(3)]
    assert tables[0] == tables[1] == tables[2]
    if mode == "mdgan":
        losses = [[row["mean_d_loss"] for row in _csv(
            tmp_path / str(i) / "log_dir" / f"mdgan.2.{NAME}.worker.1.logs.csv")]
            for i in range(3)]
        assert losses[0] == losses[1] == losses[2]
    for (a, sa), (b, sb) in zip(runs, runs[1:]):
        assert sa["evals"] == sb["evals"]
        assert sa["final_mean_d_loss"] == sb["final_mean_d_loss"]
        for key, t in _arenas(a.state).items():
            assert torch.equal(t, getattr(getattr(b.state, key[0]), key[1])), key


@pytest.mark.parametrize("mode", ["mdgan", "standalone"])
def test_resume_continues_bit_identically(tmp_path, stub_inception, mode):
    """2E rounds in one run equal E rounds, then --resume for the rest, with
    checkpoints at checkpoint_interval (swaps and the sampler cursor cross
    the break)."""
    full, _ = _run(tmp_path / "full", mode, 8)
    _run(tmp_path / "split", mode, 4)
    resumed, summary = _run(tmp_path / "split", mode, 8, "--resume")
    assert summary["rounds"] == 4  # only this run's rounds
    assert resumed.state.step == full.state.step == 8
    for key, t in _arenas(full.state).items():
        assert torch.equal(t, getattr(getattr(resumed.state, key[0]), key[1])), key
    assert resumed.state.g.count == full.state.g.count
    assert resumed.state.d.count == full.state.d.count
    for k, v in full.sampler.state_dict().items():
        np.testing.assert_array_equal(resumed.sampler.state_dict()[k], v)
    if mode == "mdgan":
        assert resumed.swap_rng.bit_generator.state == full.swap_rng.bit_generator.state


def test_checkpoint_is_leaf_named_and_loads_weights_only(tmp_path, stub_inception):
    trainer, _ = _run(tmp_path, "mdgan", 3)
    path = tmp_path / "checkpoint_dir" / f"mdgan.2.{NAME}" / "ckpt_2.pt"
    payload = torch.load(path, weights_only=True)
    assert payload["format"] == ckpt.FORMAT and payload["step"] == 3
    d = payload["nets"]["d"]
    params, stats = jax.device_get(jckpt.load_weights_only(
        tmp_path / "weights_dir" / "worker_2" / "discriminator.npz"))
    flat_params = ckpt.flatten(params)
    assert set(d["params"]) == set(flat_params) == set(d["mu"]) == set(d["nu"])
    assert set(d["batch_stats"]) == set(ckpt.flatten(stats))
    for k, v in flat_params.items():  # stacked on N; worker 2 is row 1
        assert tuple(d["params"][k].shape) == (2, *v.shape)
        np.testing.assert_array_equal(d["params"][k][1].numpy(), v)
    assert d["count"] == payload["nets"]["g"]["count"] == 3
    assert json.loads((path.parent / "host_rng_2.json").read_text())["bit_generator"] == "PCG64"


def test_cli_standalone_and_resume(tmp_path, stub_inception, capsys):
    assert cli.main(_argv(tmp_path, "standalone", 3)) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.strip().splitlines()]
    assert [ln["round"] for ln in lines[:-1]] == [0, 2]
    assert lines[-1]["rounds"] == 3 and lines[-1]["all_finite"]
    assert cli.main(_argv(tmp_path, "standalone", 5, "--resume")) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["rounds"] == 2


def test_cli_profile_and_host_metrics(tmp_path, stub_inception, capsys):
    argv = _argv(tmp_path, "mdgan", 3, "--profile_dir", str(tmp_path / "prof"),
                 "--host_metrics", str(tmp_path / "host.csv"))
    assert cli.main(argv) == 0
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    assert (tmp_path / "host.csv").read_text().startswith("time,cpu_percent")
