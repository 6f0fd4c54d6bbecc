"""mdgan_tpu_torch stands alone: no JAX, no mdgan_tpu, no quiet CPU fallback.

The machine with the GPU has no JAX, so the port, its examples
(``examples_torch/``) and ``chip_smoke.py`` must import none of it, nor any
module of the JAX package (not even its JAX-free ones): a subprocess imports
every port module and example with those packages made unimportable, and an
AST scan finds no import of them.
"""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "mdgan_tpu_torch"
EXAMPLES = ROOT / "examples_torch"
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "mdgan_tpu")

_CHILD = r"""
import importlib, importlib.util, pkgutil, sys
BLOCKED = %r

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import mdgan_tpu_torch
names = [m.name for m in pkgutil.walk_packages(mdgan_tpu_torch.__path__, "mdgan_tpu_torch.")]
for name in names:
    importlib.import_module(name)
scripts = %r
for path in scripts:
    spec = importlib.util.spec_from_file_location("script", path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
print("IMPORTED", len(names), "SCRIPTS", len(scripts), "BAD", bad)
"""


def _scripts():
    return sorted(EXAMPLES.glob("*.py")) + [ROOT / "chip_smoke.py"]


def _port_files():
    return sorted(PORT.rglob("*.py")) + _scripts()


def test_port_imports_with_jax_and_mdgan_tpu_blocked():
    env = {"PYTHONPATH": str(ROOT), "PATH": os.environ.get("PATH", ""),
           "HOME": os.environ.get("HOME", str(ROOT))}
    scripts = [str(p) for p in _scripts()]
    proc = subprocess.run([sys.executable, "-c", _CHILD % (BLOCKED, scripts)],
                          cwd=str(ROOT), env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    n_modules = len([p for p in PORT.rglob("*.py") if p.name != "__init__.py"])
    # every subpackage, nested ones (data/native) included
    n_subpackages = len([p for p in PORT.rglob("__init__.py") if p.parent != PORT])
    assert (f"IMPORTED {n_modules + n_subpackages} SCRIPTS {len(scripts)} BAD []"
            in proc.stdout), proc.stdout


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_names_a_blocked_package(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in BLOCKED, f"{path}:{node.lineno} imports {name}"


def test_kernel_sources_include_no_torch_headers():
    for path in (PORT / "csrc").glob("*.cu"):
        assert not re.search(r'#include\s*[<"](torch|ATen|c10)/', path.read_text()), path
    assert "cpp_extension.load" not in (PORT / "ops" / "_build.py").read_text()


def test_engine_without_device_needs_cuda():
    from mdgan_tpu_torch.core.config import TrainConfig
    from mdgan_tpu_torch.core.registry import get
    from mdgan_tpu_torch.engine.mdgan import MDGANEngine

    spec = get("Synthetic32")
    if torch.cuda.is_available():
        assert MDGANEngine(spec, TrainConfig(), 2).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MDGANEngine(spec, TrainConfig(), 2)
    with pytest.raises(RuntimeError, match="--device cpu"):
        from mdgan_tpu_torch.cli import train
        train.main(["--epochs", "1", "--num_workers", "2", "--max_examples", "40"])
    assert MDGANEngine(spec, TrainConfig(device="cpu"), 2).device.type == "cpu"
