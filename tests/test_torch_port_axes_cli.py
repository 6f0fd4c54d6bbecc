"""The MD-GAN trainer through the CLI on the replica and tensor axes, on the
CPU with gloo: ``--num_replicas 2 --num_tensor 2`` on 4 ranks against one
process (where both flags are ignored, as JAX ignores them on one device),
and checkpoints crossing layouts: the 4-rank checkpoint resumed in one
process and, on 3 ranks, by JAX's idle fallback (a workers axis of 2, rank 2
idle), and a single-process checkpoint resumed on 4 ranks, each to the
single-process run's round 6.  The run is
``tests/test_torch_port_distributed.py``'s (SyntheticMNIST, N=4, b=4, the
straggler policy and bfloat16 moments), its ranks started by
``tests/test_torch_port_axes.py``'s rank program.
"""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

import test_torch_port_axes as axes
from test_torch_port_distributed import N, _cli_argv, _csv_rows, _one_process

AXES = ["--num_replicas", "2", "--num_tensor", "2"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _launch_cli(world, argv):
    return axes.launch(Path(axes.__file__).resolve(), world, ["cli", *argv], timeout=240)


def _check_runs_agree(got_root, want_root, rounds):
    """CSV rows (clock readings dropped) and npz exports of two runs: the
    losses at rtol 1e-5, the exports by ``check_close``'s rule."""
    got, want = _csv_rows(got_root), _csv_rows(want_root)
    assert sorted(got) == sorted(want) and len(got) == 1 + N
    for name, rows in want.items():
        assert len(got[name]) == len(rows), name
        for a, b in zip(got[name], rows):
            assert a.keys() == b.keys(), name
            for key, value in b.items():
                if isinstance(value, float):
                    np.testing.assert_allclose(a[key], value, rtol=1e-5, err_msg=f"{name} {key}")
                else:
                    assert a[key] == value, (name, key)
    exports = sorted(p.relative_to(want_root) for p in (want_root / "weights_dir").rglob("*.npz"))
    assert exports and exports == sorted(p.relative_to(got_root)
                                         for p in (got_root / "weights_dir").rglob("*.npz"))
    for rel in exports:
        a, b = np.load(got_root / rel), np.load(want_root / rel)
        assert sorted(a.files) == sorted(b.files), rel
        for key in b.files:
            axes.check_close(a[key], b[key], f"{rel} {key}", rounds=rounds,
                             params=key.startswith("params/"))


def test_cli_on_replica_and_tensor_axes_and_crossed_checkpoints(tmp_path, monkeypatch, capsys):
    from mdgan_tpu_torch.metrics import fid as fid_mod

    monkeypatch.setattr(fid_mod, "FIDTracker", fid_mod.FIDTracker)  # restored afterwards
    ranks, single = tmp_path / "ranks", tmp_path / "single"
    out = _launch_cli(4, _cli_argv(ranks, 4, *AXES))
    assert "rank 3: (replica, worker slot, tensor slot) (1, 0, 1) of the (R, W, T) = " \
           "(2, 1, 2) mesh" in out and "idle" not in out
    _one_process(_cli_argv(single, 4, *AXES))
    _check_runs_agree(ranks, single, 4)
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1])["swaps"] == 1

    idle, crossed = tmp_path / "idle", tmp_path / "crossed"
    shutil.copytree(ranks, idle)
    shutil.copytree(single, crossed)
    _one_process(_cli_argv(ranks, 6, "--resume"))
    out = _launch_cli(3, _cli_argv(idle, 6, "--resume"))
    assert "mesh uses 2 of 3 devices" in out and "rank 2 idle" in out
    _launch_cli(4, _cli_argv(crossed, 6, "--resume", *AXES))
    _one_process(_cli_argv(single, 6, "--resume"))
    for root in (ranks, idle, crossed):
        _check_runs_agree(root, single, 6)


def test_axes_flags_in_one_process_and_standalone(tmp_path, capsys, caplog):
    """In one process ``--num_replicas 2 --num_tensor 2`` change nothing (as
    JAX ignores them on one device): the MD-GAN run prints what it prints
    without them; ``--mode standalone`` ignores them too, with a log line."""
    from test_torch_port_distributed import _stub_inception
    from mdgan_tpu_torch.cli import train
    from mdgan_tpu_torch.metrics import fid as fid_mod

    saved = fid_mod.FIDTracker
    _stub_inception()
    try:
        printed = []
        for i, extra in enumerate(([], AXES)):
            argv = _cli_argv(tmp_path / f"run{i}", 3, *extra)
            assert train.main(argv) == 0
            lines = [json.loads(ln) for ln in capsys.readouterr().out.strip().splitlines()]
            printed.append([{k: v for k, v in ln.items()
                             if k not in ("elapsed_s", "wall_time_s", "steps_per_sec")}
                            for ln in lines])
        assert printed[0] == printed[1]
        with caplog.at_level("INFO", logger="mdgan_tpu_torch"):
            argv = ["--mode", "standalone", "--dataset", "SyntheticMNIST", "--epochs", "2",
                    "--batch_size", "4", "--max_examples", "40", "--device", "cpu",
                    "--compute_dtype", "float32", *AXES,
                    *[a for flag in ("log_dir", "image_dir", "weights_dir", "checkpoint_dir")
                      for a in (f"--{flag}", str(tmp_path / "sa" / flag))]]
            assert train.main(argv) == 0
        assert "standalone baseline runs in one process" in caplog.text
        assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["rounds"] == 2
    finally:
        fid_mod.FIDTracker = saved
