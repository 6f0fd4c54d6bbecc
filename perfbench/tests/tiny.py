"""Small sizes of every cell for CPU runs: each configuration's widths cut,
float32 compute (the CPU's bfloat16 is slow), chunks of 2 rounds."""

OVERRIDES = {
    "dcgan32_cifar10": {"ngf": 32, "ndf": 32, "num_images": 800, "compute_dtype": "float32"},
}


def overrides(cell_name: str) -> dict:
    from perfbench import spec

    bench = spec.benchmark()
    entry = next(w for w in bench["workloads"] if w["name"] == cell_name)
    return {"config": dict(OVERRIDES[entry["config"]]), "traffic": {"chunk": 2}}


def cells():
    from perfbench import spec

    return [w["name"] for w in spec.benchmark()["workloads"]]
