"""``examples_torch/`` and the port's launch scripts, each run as a real
subprocess on the CPU (``--device cpu``) with tiny overrides, as a user
would start it (the pattern of ``tests/test_examples.py:20-32``): exit 0
and the outputs each promises.  Launches of ranks hold the port's tests'
lock (``tests/test_torch_port_distributed.py:run_ranks``)."""

import json
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from test_torch_port_distributed import rank_env, run_ranks

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples_torch"
TRAINER_ARGS = ["--device", "cpu", "--dataset", "SyntheticMNIST", "--max_examples", "64",
                "--batch_size", "2", "--chunk_size", "4", "--log_interval", "0",
                "--checkpoint_interval", "0", "--compute_dtype", "float32", "--n_samples", "4"]


def _run(argv, cwd, timeout=300, env=None):
    proc = subprocess.run(argv, env=env or rank_env(), cwd=str(cwd), capture_output=True,
                          text=True, timeout=timeout)
    assert proc.returncode == 0, (
        f"{argv} failed (rc={proc.returncode}):\n{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
    return proc.stdout


def _ranks(argv, cwd, world, timeout=300, env=None):
    rc, out = run_ranks([sys.executable, "-m", "torch.distributed.run", "--standalone",
                         "--nproc_per_node", str(world), *argv], timeout, cwd, env)
    assert rc == 0, f"{argv} on {world} ranks failed (rc={rc}):\n{out[-4000:]}"
    return out


def _out_dirs(root: Path):
    return ["--log_dir", str(root / "logs"), "--image_dir", str(root / "images"),
            "--weights_dir", str(root / "weights"), "--checkpoint_dir", str(root / "ckpt")]


def _summary(out: str) -> dict:
    return json.loads([ln for ln in out.splitlines() if ln.startswith('{"rounds"')][-1])


def test_train_mdgan_minimal_example(tmp_path):
    out = _run([sys.executable, str(EXAMPLES / "train_mdgan_minimal.py"), "--device", "cpu",
                "--dataset", "SyntheticMNIST", "--rounds", "10", "--chunk_size", "5",
                "--num_workers", "2", "--batch_size", "2", "--swap_interval", "5",
                "--compute_dtype", "float32"], cwd=tmp_path)
    rounds = [ln for ln in out.splitlines() if ln.startswith("round")]
    assert [ln.split()[1] for ln in rounds] == ["5", "10"]
    assert all("d_loss=" in ln and "g_feedback_loss=" in ln for ln in rounds)
    assert out.count("swapped discriminator pairs") == 2
    png = tmp_path / "mdgan_samples.png"
    assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    from mdgan_tpu_torch.obs.images import load_png

    assert load_png(png).shape[:2] == (8 * 28, 8 * 28)  # 64 samples, 8 a row


@pytest.mark.parametrize("world,flags,mesh,workers", [
    (2, [], "{'replica': 1, 'workers': 2, 'tensor': 1}", 2),
    (4, ["--num_replicas", "2", "--num_tensor", "2"], "{'replica': 2, 'workers': 1, 'tensor': 2}",
     1),
], ids=["workers", "three_axes"])
def test_multichip_mesh_example(tmp_path, world, flags, mesh, workers):
    out = _ranks([str(EXAMPLES / "multichip_mesh.py"), "--device", "cpu", *flags],
                 tmp_path, world)
    assert f"devices: {world}, mesh: {mesh}, workers: {workers}" in out
    assert out.count("d_loss=") == 3
    assert ("swap OK" in out) == (workers % 2 == 0)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_multihost_trainer_example_rank0_writes(tmp_path):
    """The every-host script as 2 gloo ranks started by hand, each in its own
    folder, as two hosts would run it: rank 0 alone writes the exports, the
    worker CSVs and the summary."""
    env = dict(rank_env(), MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()),
               WORLD_SIZE="2", LOCAL_RANK="0")
    cmd = [sys.executable, str(EXAMPLES / "multihost_trainer.py"), *TRAINER_ARGS,
           "--epochs", "8", "--swap_interval", "4"]
    dirs = [tmp_path / f"host{r}" for r in range(2)]
    for d in dirs:
        d.mkdir()
    rc, _ = run_ranks(["/bin/sh", "-c", " & ".join(
        f"(cd {d} && RANK={r} {' '.join(cmd)} > out.txt 2> err.txt)"
        for r, d in enumerate(dirs)) + "; wait"], 300, tmp_path, env)
    outs = [(d / "out.txt").read_text() for d in dirs]
    errs = [(d / "err.txt").read_text()[-3000:] for d in dirs]
    assert rc == 0, errs
    summary = _summary(outs[0])
    assert summary["rounds"] == 8 and summary["swaps"] == 1 and summary["all_finite"]
    assert (dirs[0] / "weights" / "generator_final.npz").exists()
    assert len(list((dirs[0] / "logs").glob("mdgan.8.SyntheticMNIST.worker.*.csv"))) == 8
    assert len(list((dirs[0] / "weights").glob("worker_*/discriminator.npz"))) == 8
    assert outs[1].strip() == ""
    assert not (dirs[1] / "weights").exists()
    assert not list(dirs[1].rglob("*.csv")) and not list(dirs[1].rglob("*.npz"))


def test_run_standalone_torch_script(tmp_path):
    out = _run(["bash", str(ROOT / "run-standalone-torch.sh"), *TRAINER_ARGS, "--epochs", "4",
                *_out_dirs(tmp_path)], cwd=tmp_path, env=dict(rank_env(), PYTHON=sys.executable))
    summary = _summary(out)
    assert summary["rounds"] == 4 and summary["all_finite"] and summary["device"] == "cpu"
    assert (tmp_path / "logs" / "SyntheticMNIST.standalone.logs.csv").exists()
    assert {p.name for p in (tmp_path / "weights").iterdir()} == {"netG_epoch_3.npz",
                                                                   "netD_epoch_3.npz"}


@pytest.mark.parametrize("nproc", [1, 2])
def test_run_distributed_torch_script(tmp_path, nproc):
    """``$1`` is N; ``nproc`` ranks share the N discriminators, started by
    ``torch.distributed.run`` above 1; the run is the same either way."""
    argv = ["bash", str(ROOT / "run-distributed-torch.sh"), "4", *TRAINER_ARGS,
            "--epochs", "4", "--swap_interval", "2", *_out_dirs(tmp_path)]
    env = dict(rank_env(), nproc=str(nproc), PYTHON=sys.executable)
    if nproc == 1:
        out = _run(argv, tmp_path, env=env)
    else:
        rc, out = run_ranks(argv, 300, tmp_path, env)
        assert rc == 0, out[-4000:]
    summary = _summary(out)
    assert summary["rounds"] == 4 and summary["swaps"] == 1 and summary["all_finite"]
    csvs = sorted((tmp_path / "logs").glob("mdgan.4.SyntheticMNIST.worker.*.csv"))
    assert len(csvs) == 4
    losses = [np.genfromtxt(c, delimiter=",", names=True)["mean_d_loss"] for c in csvs]
    assert all(np.isfinite(x).all() and x.size == 4 for x in losses)
