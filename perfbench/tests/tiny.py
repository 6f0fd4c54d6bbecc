"""Small sizes of every cell for CPU runs: each configuration's widths cut,
float32 compute (the CPU's bfloat16 is slow), chunks of 2 rounds.

A configuration's sizes are the keys of its ``configs`` file that the CPU
runs change, in ``tests/tiny/<config>.json``: a new configuration brings its
own file, and no file here changes."""

import json


def overrides(cell_name: str) -> dict:
    from perfbench import spec

    bench = spec.benchmark()
    entry = next(w for w in bench["workloads"] if w["name"] == cell_name)
    path = spec.HERE / "tests" / "tiny" / f"{entry['config']}.json"
    if not path.is_file():
        raise FileNotFoundError(f"configuration {entry['config']!r} (cell {cell_name!r}) has "
                                f"no CPU sizes: add {path}")
    return {"config": json.loads(path.read_text()), "traffic": {"chunk": 2}}


def cells():
    from perfbench import spec

    return [w["name"] for w in spec.benchmark()["workloads"]]
