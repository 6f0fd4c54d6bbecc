"""The port's per-part breakdown of a round
(``mdgan_tpu_torch/cli/profile_parts.py``) on the CPU, against the JAX
script's (``scripts/profile_parts.py``) ``--json`` output at the same size,
run as a subprocess: the same part names and derived quantities."""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from mdgan_tpu_torch.cli import profile_parts

ROOT = Path(__file__).resolve().parents[1]
SIZE = ["--workers", "2", "--batch", "2", "--iters", "2"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_parts_match_the_jax_script(tmp_path, capsys):
    assert profile_parts.main([*SIZE, "--device", "cpu", "--json",
                               str(tmp_path / "port.json")]) == 0
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    port = json.loads((tmp_path / "port.json").read_text())
    assert printed == port

    env = dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu",
               MDGAN_TPU_COMPILE_CACHE=str(tmp_path / "xla_cache"))
    proc = subprocess.run([sys.executable, str(ROOT / "scripts" / "profile_parts.py"), *SIZE,
                           "--json", str(tmp_path / "jax.json")], cwd=str(tmp_path), env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    jax = json.loads((tmp_path / "jax.json").read_text())

    assert list(port["components_us"]) == list(jax["components_us"])
    assert list(port["derived_us"]) == list(jax["derived_us"])
    assert port["config"] == jax["config"]
    assert list(port["components_device_ms"]) == list(port["components_kernels"]) == list(
        jax["components_us"])
    assert list(port["derived_device_ms"]) == list(jax["derived_us"])
    assert port["components_us"][profile_parts.NOOP] == 0.0
    for name, us in port["components_us"].items():
        assert math.isfinite(us), name
    for name in (profile_parts.G_FWD, profile_parts.G_VJP_ADAM, profile_parts.FULL):
        assert port["components_us"][name] > 0, name
    # no device time is read on the CPU
    assert port["device"] == "cpu" and port["power_limit_w"] is None
    assert set(port["components_device_ms"].values()) == {None}
    assert set(port["derived_device_ms"].values()) == {None}


def test_parts_run_the_engine_and_need_a_device(monkeypatch):
    """The parts move the engine's state as rounds do, and without
    ``--device cpu`` the script needs a card."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            profile_parts.profile(2, 2, 1)
    from mdgan_tpu_torch.engine.mdgan import MDGANEngine

    steps = []
    real_step = MDGANEngine.step

    def step(self, st, *a, **kw):
        out = real_step(self, st, *a, **kw)
        steps.append(st.step)
        return out

    monkeypatch.setattr(MDGANEngine, "step", step)
    profile_parts.profile(2, 2, 1, "cpu")
    assert steps == [1, 2, 3, 4]  # 3 warm-up rounds and 1 timed, on one state
