"""Loading a cell and its parts by name, as ``BENCHMARK.json`` names them.

A cell (``workloads`` entry) names a configuration and a traffic mix:

* the configuration's JSON file is the one ``configs`` gives it; its
  ``family`` names the reference module beside it,
  ``perfbench/configs/<family>.py``, which may declare the generator's
  noise inputs (``noise_shapes``);
* the traffic mix is ``perfbench/traffic/<traffic>.json``; its ``mode``
  names the module that drives the program, ``perfbench/modes/<mode>.py``;
* the limits of the check are ``perfbench/limits/<cell>.json``;
* a per-layer metric is read by ``perfbench/metrics/<metric>.py``; a
  quantity split by the end-to-end metric it moves
  (``launches_per_round.device``) is read by the file of its first part,
  where the whole name has none.

So a new cell, configuration, traffic mix or metric is a new file and a new
entry, and no file here changes.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _load_path(path: Path, name: str) -> ModuleType:
    loaded = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(loaded)
    loaded.loader.exec_module(module)
    return module


def family(name: str) -> ModuleType:
    return importlib.import_module(f"perfbench.configs.{name}")


def noise_shapes(fam: ModuleType, cfg: dict) -> Optional[List[tuple]]:
    """The per-sample shapes of the generator's noise inputs, in order, where
    the family declares them (``noise_shapes(cfg)``); None where its
    generator takes no noise."""
    declared = getattr(fam, "noise_shapes", None)
    return None if declared is None else [tuple(s) for s in declared(cfg)]


def mode(name: str) -> ModuleType:
    return importlib.import_module(f"perfbench.modes.{name}")


def metric_path(name: str) -> Path:
    """``perfbench/metrics/<name>.py``, else the file of the name's part
    before its first dot."""
    path = HERE / "metrics" / f"{name}.py"
    return path if path.is_file() else HERE / "metrics" / f"{name.split('.')[0]}.py"


def metric_reader(name: str) -> ModuleType:
    return _load_path(metric_path(name), f"perfbench_metric_{name}")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict          # the configuration file's contents
    traffic: dict         # the traffic file's contents
    limits: Dict[str, float]
    per_layer: List[dict]     # the per-layer metric entries this cell reports
    end_to_end: List[dict]

    @property
    def family(self) -> ModuleType:
        return family(self.config["family"])

    @property
    def mode(self) -> ModuleType:
        return mode(self.traffic["mode"])


def _reports(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def cell(name: str, overrides: Dict[str, dict] = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``; ``overrides`` (tests) replaces
    keys of its ``config``, ``traffic`` and ``limits``."""
    bench = benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are "
                       f"{[w['name'] for w in bench['workloads']]}")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    parts = {
        "config": json.loads((ROOT / conf["file"]).read_text()),
        "traffic": json.loads((HERE / "traffic" / f"{entry['traffic']}.json").read_text()),
        "limits": json.loads((HERE / "limits" / f"{name}.json").read_text()),
    }
    for key, values in (overrides or {}).items():
        parts[key].update(values)
    if parts["traffic"].get("ranks", 1) != entry["chips"]:
        raise ValueError(f"{name}: traffic {entry['traffic']!r} runs "
                         f"{parts['traffic'].get('ranks', 1)} ranks on {entry['chips']} chips")
    end_to_end = [m for m in bench["end_to_end"] if _reports(m, name)]
    # a per-layer metric is the cell's where it lists the cell, or, without
    # a list, where the cell reports the end-to-end metric it moves
    moved = {m["name"] for m in end_to_end}
    return Cell(name=name, chips=entry["chips"], config=parts["config"],
                traffic=parts["traffic"], limits=parts["limits"],
                per_layer=[m for m in bench["per_layer"]
                           if _reports(m, name) and m["moves"] in moved],
                end_to_end=end_to_end)
