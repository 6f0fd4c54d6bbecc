"""BENCHMARK.json against the benchmark's contract, and the harness finding
cells, configurations, traffic mixes and metrics by name, new files too."""

import json
import re
import shutil

import pytest

from perfbench import spec
from perfbench.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "mdgan_tpu"}


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_benchmark_json_contract():
    raw = (spec.ROOT / "BENCHMARK.json").read_bytes()
    assert len(raw) <= 64 * 1024
    b = json.loads(raw)
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert 1 <= len(b["paths"]) <= 16 and all(PATH.match(p) for p in b["paths"])
    assert 1 <= len(b["command"]) <= 32 and all(_line(w) for w in b["command"])
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    assert 2 + 14 * 24 * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith(b["paths"][0] + "/") and (spec.ROOT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        names.add(c["name"])
    assert {w["config"] for w in b["workloads"]} == names
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    four = sum(w["chips"] == 4 for w in b["workloads"])
    assert four <= max(1, len(b["workloads"]) // 4)
    metric_names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    assert "setup_s" in {m["name"] for m in b["end_to_end"]}
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and _line(m["layer"])
        assert spec.metric_path(m["name"]).is_file()
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("name", tiny.cells())
def test_cell_loads_by_name(name):
    cell = spec.cell(name)
    assert cell.family.leaves(cell.config, "g") and cell.mode.Program
    assert cell.traffic.get("ranks", 1) == cell.chips
    assert {"setup_s"} < {m["name"] for m in cell.end_to_end} and cell.per_layer
    assert set(cell.limits) and all(v > 0 for v in cell.limits.values())


def test_new_files_are_found_without_edits(tmp_path, monkeypatch):
    """A cell, traffic mix and metric added as files and entries."""
    root = tmp_path / "checkout"
    shutil.copytree(spec.HERE, root / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = spec.benchmark()
    bench["workloads"].append({"name": "dcgan32_mdgan_n2", "config": "dcgan32_cifar10",
                               "traffic": "mdgan_n2_c100", "chips": 1, "why": "test"})
    # the new cell reports the headline's end-to-end metric, so its
    # per-layer metrics without a list of cells come along
    next(m for m in bench["end_to_end"]
         if m["name"] == "device_ms_per_round")["workloads"].append("dcgan32_mdgan_n2")
    bench["per_layer"].append({"name": "rounds_traced", "unit": "rounds", "better": "higher",
                               "source": "device_trace", "layer": "round",
                               "moves": "device_ms_per_round"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    traffic = json.loads((spec.HERE / "traffic" / "mdgan_n8_c100.json").read_text())
    (root / "perfbench" / "traffic" / "mdgan_n2_c100.json").write_text(
        json.dumps({**traffic, "num_workers": 2}))
    (root / "perfbench" / "limits" / "dcgan32_mdgan_n2.json").write_text('{"loss_gap": 0.1}')
    (root / "perfbench" / "metrics" / "rounds_traced.py").write_text(
        "def read(r):\n    return r.rounds\n")
    monkeypatch.setattr(spec, "ROOT", root)
    monkeypatch.setattr(spec, "HERE", root / "perfbench")
    cell = spec.cell("dcgan32_mdgan_n2")
    assert cell.traffic["num_workers"] == 2 and cell.limits == {"loss_gap": 0.1}
    assert {"rounds_traced", "launches_per_round.device"} <= {m["name"] for m in cell.per_layer}
    assert "launches_per_round" not in {m["name"] for m in cell.per_layer}
    assert spec.metric_reader("rounds_traced").read(type("R", (), {"rounds": 7})) == 7


def test_python_files_import_nothing_forbidden():
    """No file of the benchmark imports JAX or the JAX package (top-level
    names compared whole), and the reference imports nothing of the
    program."""
    import ast

    for path in spec.HERE.rglob("*.py"):
        tops = set()
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                tops |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
                tops.add(node.module.split(".")[0])
        assert not tops & FORBIDDEN, path
        rel = path.relative_to(spec.HERE).parts
        if rel[0] in ("reference", "configs") or path.name in ("inputs.py", "check.py",
                                                               "roofline.py"):
            assert "mdgan_tpu_torch" not in tops, path
