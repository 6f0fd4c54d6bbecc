"""The MD-GAN round's discriminators as one grouped-convolution network
(``MDGANEngine._d_region_stacked``, ``models/layers.py`` ``stacked_forward``)
against the per-worker loop (``_d_region_loop``), on the CPU in float32.

Held here:

  * the D region of DCGAN-32 and DCGAN-64 (narrow) at N in {1, 3, 8} and
    ``local_epochs`` in {1, 2}, each path called directly on the same state
    and inputs: the losses, the feedbacks, and the ``grads``, ``params``,
    ``mu``, ``nu`` and ``stats`` arenas after it;
  * which discriminators take the stacked path: under ``torch.profiler``,
    ``engine.d_stacked`` is counted twice a local epoch and once a feedback
    for DCGAN-32, and never for MLP-GAN, StyleGAN2 or the standalone
    engine, while ``engine.d_step`` and ``engine.feedback`` keep their
    counts;
  * one 2-rank gloo launch (this file run under ``torch.distributed.run``,
    as ``tests/test_torch_port_axes.py`` runs its ranks): DCGAN-32 on a
    (R=2, W=1) mesh, stacked against the loop on each replica's rows (the
    stacked BatchNorm's one all-reduce over N*C channels against the loop's
    one per worker) and against one process on the whole batch.

The two paths reduce in other orders.  At the default Adam (lr 2e-4, eps
1e-8) a step moves a weight by about lr*sign(grad), so an element whose
gradient sits at rounding noise (all of a pre-BatchNorm conv bias:
DCGAN-64's blocks 1 and 2) may go either way, and over two local epochs
the loop departs from itself under a 1e-7 relative perturbation of its
weights by up to 1.6e-4 of a feedback's largest element (at eps 1e-3, by
21%: DCGAN-64, N=8, a worker whose second step crosses LeakyReLU kinks).
The comparisons therefore run Adam at lr 2e-5, eps 1e-3, where two steps
stay continuous in the gradients (the same perturbation moves the
feedbacks by at most 5e-6 of their largest element), and hold every number
at rtol 1e-4 with an atol of 1e-5 of its array's largest magnitude.  The
parity tests against JAX (``tests/test_torch_port_round.py``,
``_families.py``) hold the stacked path at the default Adam, sign flips
allowed.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mdgan_tpu_torch.core.config import OptimizerConfig, TrainConfig
from mdgan_tpu_torch.core.registry import get as get_spec
from mdgan_tpu_torch.data import builtin, sampler
from mdgan_tpu_torch.engine.mdgan import MDGANEngine
from mdgan_tpu_torch.engine.standalone import StandaloneEngine
from mdgan_tpu_torch.models.layers import stackable
from mdgan_tpu_torch.obs import spans

B, WIDTH, SEED = 4, 8, 3
SG2 = {"max_res": 32, "base_features": 32, "map_layers": 2}
# family -> (port dataset, width keywords, image side)
FAMILY = {
    "dcgan32": ("Synthetic32", {"ngf": WIDTH, "ndf": WIDTH}, 32),
    "dcgan64": ("CelebA", {"ngf": WIDTH, "ndf": WIDTH}, 64),
    "mlp": ("SyntheticMNIST", {}, 28),
    "stylegan2": ("FFHQ128", SG2, 32),
}
ARENAS = ("params", "grads", "mu", "nu", "stats")
OPT = OptimizerConfig(lr=2e-5, eps=1e-3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def engine(family: str, n: int, local_epochs: int = 1, layout=None) -> MDGANEngine:
    dataset, kw, _ = FAMILY[family]
    return MDGANEngine(get_spec(dataset), TrainConfig(
        batch_size=B, compute_dtype="float32", device="cpu", local_epochs=local_epochs,
        discriminator_opt=OPT), n, model_kwargs=kw, layout=layout)


def inputs(family: str, n: int, k: int):
    """Real batches (n, B, 3, H, W) and fakes (k, B, 3, H, W), seeded by n."""
    side = FAMILY[family][2]
    gen = torch.Generator().manual_seed(100 + n)
    real = torch.rand(n, B, 3, side, side, generator=gen) * 2 - 1
    fake = torch.randn(k, B, 3, side, side, generator=gen).tanh()
    return real, fake


def region(eng: MDGANEngine, stacked: bool, real, fake) -> dict:
    """One D region through the chosen path on a fresh state: its outputs
    and the discriminators' arenas after it."""
    st = eng.init_state(SEED)
    run = eng._d_region_stacked if stacked else eng._d_region_loop
    d_loss, g_loss, feedback = run(st, real, fake)
    out = {"mean_d_loss": d_loss, "g_feedback_loss": g_loss, "feedback": feedback}
    out.update({a: getattr(st.d, a).float() for a in ARENAS})
    return {k: v.detach().numpy() for k, v in out.items()}


def check_close(got: dict, want: dict, keys=None):
    for key in keys or want:
        g, w = got[key], want[key]
        assert g.shape == w.shape, key
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5 * np.abs(w).max() + 1e-12,
                                   err_msg=key)


@pytest.mark.parametrize("local_epochs", [1, 2])
@pytest.mark.parametrize("n", [1, 3, 8])
@pytest.mark.parametrize("family", ["dcgan32", "dcgan64"])
def test_stacked_d_region_matches_loop(family, n, local_epochs):
    eng = engine(family, n, local_epochs)
    real, fake = inputs(family, n, eng.k)
    loop = region(eng, False, real, fake)
    stacked = region(eng, True, real, fake)
    # the region moved the state: the comparison is not of two idle runs
    assert np.abs(loop["stats"] - engine(family, n).init_state(SEED).d.stats.numpy()).max() > 0
    check_close(stacked, loop)


def test_stackable_families():
    got = {f: stackable(engine(f, 1).init_state(SEED).d.modules[0]) for f in FAMILY}
    assert got == {"dcgan32": True, "dcgan64": True, "mlp": False, "stylegan2": False}


def _profiled_totals(fn) -> dict:
    """``fn()`` under a profiler, the record holding this run alone: the
    spans' counts."""
    with spans.phase("engine.idle"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        fn()
    return {name: v[0] for name, v in spans.totals().items()}


ROUNDS = 2


@pytest.mark.parametrize("family,n,local_epochs,stacked", [
    ("dcgan32", 8, 1, 3), ("dcgan32", 2, 2, 5), ("dcgan64", 2, 1, 3),
    ("mlp", 2, 1, 0), ("stylegan2", 2, 1, 0)])
def test_stacked_span_counts_where_the_path_engages(family, n, local_epochs, stacked):
    eng = engine(family, n, local_epochs)
    side = FAMILY[family][2]
    ch = 1 if family == "mlp" else 3
    data = builtin.synthesize((side, side, ch), 8 * n, seed=32)[0]
    pdata = eng.shard_data(data.reshape(n, -1, side, side, ch))
    smp = sampler.ShardSampler(n, pdata.shape[1], B, seed=0)
    st = eng.init_state(SEED)
    counts = _profiled_totals(lambda: eng.run_rounds(st, pdata, smp, ROUNDS))
    assert counts.get("engine.d_stacked", 0) == stacked * ROUNDS
    assert counts["engine.d_step"] == local_epochs * ROUNDS
    assert counts["engine.feedback"] == ROUNDS
    assert counts["engine.round"] == ROUNDS


def test_standalone_never_stacks():
    dataset, kw, side = FAMILY["dcgan32"]
    eng = StandaloneEngine(get_spec(dataset), TrainConfig(
        batch_size=B, compute_dtype="float32", device="cpu"), model_kwargs=kw)
    data = eng.put_data(builtin.synthesize((side, side, 3), 16, seed=32)[0])
    smp = sampler.ShardSampler(1, data.shape[1], B, seed=0)
    st = eng.init_state(SEED)
    counts = _profiled_totals(lambda: eng.run_rounds(st, data, smp, ROUNDS))
    assert "engine.d_stacked" not in counts
    assert counts["engine.d_step"] == ROUNDS and counts["engine.round"] == ROUNDS


# --- the replica axis: one 2-rank gloo launch ----------------------------------

N_REPLICA, REPLICAS = 4, 2


def replica_region(local_epochs: int = 2) -> dict:
    """This process's (R=2, W=1) rank, or one process when there is no
    group: DCGAN-32's D region through both paths on its rows of the same
    whole batches, and its rows' indices."""
    from mdgan_tpu_torch.core.mesh import rank_layout

    replicas = REPLICAS if torch.distributed.is_initialized() else 1
    eng = engine("dcgan32", N_REPLICA, local_epochs,
                 layout=rank_layout(N_REPLICA, replicas, 1))
    real, fake = inputs("dcgan32", N_REPLICA, eng.k)
    rows = eng._rows
    out = {"rows": np.arange(B)[rows]}
    for name, stacked in (("loop", False), ("stacked", True)):
        got = region(eng, stacked, real[:, rows].contiguous(), fake[:, rows].contiguous())
        out.update({f"{name}/{k}": v for k, v in got.items()})
    return out


def test_replica_axis_stacked_matches_loop_and_one_process(tmp_path):
    from test_torch_port_distributed import launch

    prefix = tmp_path / "rank"
    launch(Path(__file__).resolve(), REPLICAS, [prefix], timeout=240)
    ranks = [dict(np.load(f"{prefix}{r}.npz")) for r in range(REPLICAS)]
    whole = replica_region()
    for r in ranks:
        stacked = {k[len("stacked/"):]: v for k, v in r.items() if k.startswith("stacked/")}
        loop = {k[len("loop/"):]: v for k, v in r.items() if k.startswith("loop/")}
        check_close(stacked, loop)
        # the replicas' discriminators: the whole batch's statistics and
        # gradients, bit-equal over the replicas
        check_close(stacked, {k[len("stacked/"):]: v for k, v in whole.items()
                              if k.startswith("stacked/")}, ARENAS)
        for a in ARENAS:
            assert np.array_equal(stacked[a], ranks[0][f"stacked/{a}"]), a
    # the losses are the replicas' parts of the whole batch's, the feedbacks
    # its rows
    for key in ("mean_d_loss", "g_feedback_loss"):
        parts = sum(r[f"stacked/{key}"] for r in ranks)
        np.testing.assert_allclose(parts, whole[f"stacked/{key}"], rtol=1e-5, atol=1e-6)
    feedback = np.zeros_like(whole["stacked/feedback"])
    for r in ranks:
        feedback[:, r["rows"]] = r["stacked/feedback"]
    check_close({"feedback": feedback}, {"feedback": whole["stacked/feedback"]})


def _rank_main(prefix: str) -> int:
    from mdgan_tpu_torch.core import distributed

    torch.set_num_threads(1)
    distributed.maybe_initialize("cpu")
    try:
        np.savez(f"{prefix}{torch.distributed.get_rank()}.npz", **replica_region())
    finally:
        distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    sys.exit(_rank_main(sys.argv[1]))
