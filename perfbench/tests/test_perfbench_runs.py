"""Whole runs of every cell at small sizes on the CPU, each in a process of
its own: the result line's schema, the import isolation, and faults planted
in the timed path coming out as not correct; and the harness's path over
four ranks, in a checkout that adds the four-card cell (PERF.md's open
questions) as a later change would: a traffic mix there already, a limits
file and an entry."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from perfbench import spec
from perfbench.tests import tiny

FOUR = "dcgan32_mdgan_n8_4gpu"
FAULTS = ("unchanged", "half_batch", "loss_altered", "gather_shift")


def run_cell(cell, seed, trace=0, hook="", root=spec.ROOT):
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(spec.ROOT))
    runner = root / "perfbench" / "tests" / "runner.py"
    proc = subprocess.run([sys.executable, str(runner), cell, str(seed), str(trace), hook],
                          capture_output=True, text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", tiny.cells())
def test_run_schema_and_isolation(cell):
    out = run_cell(cell, 2 ** 31 + 77)
    res = out["result"]
    assert out["forbidden"] == [] and out["port_loaded"]
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0
    c = spec.cell(cell)
    # on the CPU no device event is traced: the device's end-to-end metrics
    # are left out of the line
    assert set(res["metrics"]) == {m["name"] for m in c.end_to_end
                                   if m["source"] != "device_trace"}
    assert all(m["value"] > 0 and m["unit"] for m in res["metrics"].values())
    assert res["device"]["count"] == c.chips
    assert set(res["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(res["checks"]) == set(c.limits)
    assert all(v["value"] <= v["limit"] for v in res["checks"].values())
    # the compared numbers are the last lines of standard error
    assert [ln.split()[1] for ln in out["lines"][-len(c.limits):]] == list(c.limits)


@pytest.mark.parametrize("cell", tiny.cells())
def test_traced_run_schema(cell):
    res = run_cell(cell, 5, trace=1)["result"]
    assert res["device"]["window_s"] > 0 and "busy_s" in res["device"]
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert all(len(v) <= 10 for v in res["breakdown"].values())
    # on the CPU no device event is traced: only the metrics that need none
    assert set(res["metrics"]) <= {"wall_rounds_per_s"}
    assert set(res["metrics"]) <= {m["name"] for m in spec.cell(cell).per_layer}


@pytest.mark.parametrize("cell,fault", [(c, f) for c in tiny.cells() for f in FAULTS])
def test_planted_fault_is_not_correct(cell, fault):
    res = run_cell(cell, 2 ** 31 + 91, hook=f"perfbench.tests.faults:{fault}")["result"]
    assert res["correct"] is False, res["checks"]


@pytest.fixture(scope="module")
def four_card_root(tmp_path_factory):
    """A checkout whose BENCHMARK.json adds the four-card cell, held to the
    headline cell's limits."""
    root = tmp_path_factory.mktemp("checkout")
    shutil.copytree(spec.HERE, root / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = spec.benchmark()
    bench["workloads"].append({"name": FOUR, "config": "dcgan32_cifar10",
                               "traffic": "mdgan_n8_c100_r4", "chips": 4, "why": "test"})
    next(m for m in bench["end_to_end"]
         if m["name"] == "device_ms_per_round")["workloads"].append(FOUR)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    shutil.copy(spec.HERE / "limits" / "dcgan32_mdgan_n8.json",
                root / "perfbench" / "limits" / f"{FOUR}.json")
    return root


@pytest.mark.parametrize("fault", ["", "no_exchange", "gather_shift"])
def test_four_rank_run(four_card_root, fault):
    hook = f"perfbench.tests.faults:{fault}" if fault else ""
    out = run_cell(FOUR, 2 ** 31 + 93, hook=hook, root=four_card_root)
    res = out["result"]
    assert out["forbidden"] == [] and res["device"]["count"] == 4
    assert res["correct"] is (not fault), res["checks"]
