"""MLP-GAN and DCGAN-32 on 8 gloo ranks, (replica 2, workers 2, tensor 2),
against the single-process port and JAX's single-device engine
(``tests/test_parallel.py:143-186`` holds JAX's three-axis mesh to it), JAX's
weights, latents and (MLP) dropout masks injected.  The rank program and the
checks are ``tests/test_torch_port_axes.py``'s: the gathered generator and
the metrics bit-equal on every rank, each worker slot's discriminators
bit-equal over its replicas and tensor slots, and both held to one process
and to JAX by that file's rules.
"""

import numpy as np
import pytest
import torch

import test_torch_port_axes as axes


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_eight_ranks_all_three_axes(tmp_path, eight_devices):
    runs = {family: axes.jax_run(family, tmp_path) for family in ("dcgan32", "mlp")}
    specs = [{"family": family, "replicas": 2, "tensor": 2, "init": runs[family][0]}
             for family in runs]
    results = axes.launch_engine(tmp_path, 8, specs, timeout=300)
    for (family, (init, jm, jst)), ranks in zip(runs.items(), results):
        assert sorted(tuple(r["coords"]) for r in ranks) == [
            (r, w, t) for r in range(2) for w in range(2) for t in range(2)]
        axes.check_against_one_process(ranks, axes.run_engine({"family": family,
                                                               "init": init}))
        axes.check_against_jax(family, ranks, jm, jst)
        # the two tensor slots hold the two halves of the generator's split leaves
        local = [r["g_local/params"] for r in ranks[:2]]
        assert local[0].size == local[1].size < ranks[0]["g/params"].size
        assert not np.array_equal(local[0], local[1])
