"""A configuration added as new files and entries only, in a copy of the
benchmark: a family whose generator takes per-pixel noise (DCGAN-32's
reference with the noise added at weight zero, so that the port's DCGAN-32
stands for its program), its configuration, CPU sizes, traffic mix, limits
and cell.  The copy's own tests, parametrized over its cells and
configurations, run on it; a tiny run of the cell is correct, with the
program and the reference handed the same noise; no file that was there
changes.

The port has no generator that takes noise yet: the hook
``perfbench.tests.noise_record:record`` (a new file of the copy) records
the noise each ``run_rounds`` call is handed and drops it before the call,
and records what the family's reference generator is handed."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

from perfbench import spec
from perfbench.tests.test_perfbench_runs import run_cell

CONFIG, FAMILY, TRAFFIC, CELL = ("noisy_dcgan32_cifar10", "noisy_dcgan32", "mdgan_n4_c100",
                                 "noisy_mdgan_n4")
SHAPES = [(1, 4, 4), (1, 8, 8), (1, 16, 16)]

FAMILY_PY = f'''"""DCGAN-32's reference whose generator adds per-pixel noise, at weight
zero, after each of its first three blocks."""

import torch
import torch.nn.functional as F

from perfbench.configs.dcgan32 import WIDTHS, batch_norm, discriminator, leaves  # noqa: F401

NOISE_WEIGHT = 0.0


def noise_shapes(cfg):
    return {SHAPES!r}


def generator(cfg, p, z, ops, noise):
    x = z.reshape(z.shape[0], -1, 1, 1)
    for i, (stride, pad) in enumerate(((1, 0), (2, 1), (2, 1))):
        x = ops.conv_transpose2d(x, p[f"block{{i}}.conv.weight"], stride, pad)
        x = ops.act(F.relu(batch_norm(x, p[f"block{{i}}.bn.weight"], p[f"block{{i}}.bn.bias"])))
        x = x + NOISE_WEIGHT * noise[i]
    return torch.tanh(ops.conv_transpose2d(x, p["out.weight"], 2, 1))
'''

HOOK_PY = f'''"""Records the noise the program and the reference are handed; the
program's ``run_rounds`` gets none (the port's DCGAN-32 takes none)."""

import atexit
import os

import torch

SEEN = {{"program": [], "reference": []}}


def record():
    from mdgan_tpu_torch.engine.mdgan import MDGANEngine

    from perfbench.configs import {FAMILY} as fam

    run_rounds, generator = MDGANEngine.run_rounds, fam.generator

    def dropping(self, *args, noise=None, **kwargs):
        SEEN["program"].append(noise)
        return run_rounds(self, *args, **kwargs)

    def recording(cfg, p, z, ops, noise):
        SEEN["reference"].append(noise)
        return generator(cfg, p, z, ops, noise)

    MDGANEngine.run_rounds, fam.generator = dropping, recording
    out = os.environ.get("NOISE_RECORD")
    if out:
        atexit.register(lambda: torch.save(SEEN, out))
'''

# the copy's own pytest runs take the hook too
CONFTEST_PY = '''from perfbench.tests import noise_record

noise_record.record()
'''


def _files_of(root):
    return {p.relative_to(root): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    """The copy's root."""
    root = tmp_path_factory.mktemp("checkout")
    shutil.copytree(spec.HERE, root / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = spec.benchmark()
    bench["configs"].append({"name": CONFIG, "source": "test",
                             "file": f"perfbench/configs/{CONFIG}.json", "reduced": [],
                             "why": "test"})
    bench["workloads"].append({"name": CELL, "config": CONFIG, "traffic": TRAFFIC, "chips": 1,
                               "why": "test"})
    next(m for m in bench["end_to_end"]
         if m["name"] == "device_ms_per_round")["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    pb = root / "perfbench"
    config = json.loads((spec.HERE / "configs" / "dcgan32_cifar10.json").read_text())
    traffic = json.loads((spec.HERE / "traffic" / "mdgan_n8_c100.json").read_text())
    added = {
        f"configs/{FAMILY}.py": FAMILY_PY,
        f"configs/{CONFIG}.json": json.dumps({**config, "family": FAMILY}),
        f"tests/tiny/{CONFIG}.json": (spec.HERE / "tests" / "tiny" / "dcgan32_cifar10.json"
                                      ).read_text(),
        f"traffic/{TRAFFIC}.json": json.dumps({**traffic, "num_workers": 4}),
        f"limits/{CELL}.json": (spec.HERE / "limits" / "dcgan32_mdgan_n8.json").read_text(),
        "tests/noise_record.py": HOOK_PY,
    }
    for rel, text in added.items():
        assert not (pb / rel).exists(), rel
        (pb / rel).write_text(text)
    (root / "conftest.py").write_text(CONFTEST_PY)
    return root


def _nothing_there_changed(root):
    """Every file of the benchmark is in the copy, byte for byte; its
    BENCHMARK.json only appends entries, and the new cell's name to the
    end-to-end metric it reports."""
    copy = _files_of(root / "perfbench")
    assert all(copy.get(rel) == data for rel, data in _files_of(spec.HERE).items())
    old, new = spec.benchmark(), json.loads((root / "BENCHMARK.json").read_text())
    assert new.keys() == old.keys()
    for key, value in old.items():
        if not isinstance(value, list):
            assert new[key] == value
            continue
        assert len(new[key]) >= len(value)
        for was, now in zip(value, new[key]):
            if isinstance(was, dict) and was != now:
                assert {k: v for k, v in now.items() if k != "workloads"} == \
                    {k: v for k, v in was.items() if k != "workloads"}
                assert now["workloads"] == was["workloads"] + [CELL]
            else:
                assert now == was


def test_tiny_run_is_correct_with_the_same_noise_on_both_sides(checkout, tmp_path, monkeypatch):
    record = tmp_path / "noise.pt"
    monkeypatch.setenv("NOISE_RECORD", str(record))
    out = run_cell(CELL, 2 ** 31 + 4242, hook="perfbench.tests.noise_record:record",
                   root=checkout)
    res = out["result"]
    assert out["forbidden"] == [] and res["correct"] is True and res["failed"] == 0, res
    seen = torch.load(record)
    k_b = 2 * 10           # k = 2 fake batches of b = 10 at N = 4
    # every chunk handed the program its noise: (rounds, k*b, *shape) an input
    assert seen["program"] and all(
        [tuple(x.shape[1:]) for x in noise] == [(k_b, *s) for s in SHAPES]
        for noise in seen["program"])
    # the check's chunks (1 round, then 2) against the reference's 3 rounds
    program = [[x[t] for x in noise] for noise in seen["program"][:2]
               for t in range(noise[0].shape[0])]
    reference = seen["reference"]
    assert len(program) == len(reference) == 3
    assert all(len(pr) == len(rr) == len(SHAPES) and all(map(torch.equal, pr, rr))
               for pr, rr in zip(program, reference))
    _nothing_there_changed(checkout)


def test_copys_own_tests_on_the_new_configuration(checkout):
    """The copy's counts (parameters, the leaves against the program's, the
    frozen FLOPs, a round's FLOPs), its check at small sizes (the first
    round against the reference, the control and the gather fault not
    correct), its cell found by name and BENCHMARK.json within the
    contract."""
    files = [f"perfbench/tests/test_perfbench_{f}.py" for f in ("counts", "parity", "spec")]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(spec.ROOT))
    proc = subprocess.run([sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
                           "-k", "noisy or contract", *files], cwd=checkout, env=env,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-2000:]
    # 4 counts, 3 of the check, 1 cell by name, 1 contract
    assert re.search(r"\b9 passed\b", proc.stdout), proc.stdout[-2000:]
    _nothing_there_changed(checkout)
