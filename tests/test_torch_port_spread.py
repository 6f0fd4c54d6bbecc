"""Measure the spreads that the port's parity bounds are set from.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_port_spread.py

Prints, on the CPU, the largest relative gap between the port and the JAX
package for:

  * one teacher-forced bfloat16 round, MD-GAN (N 2 and 8) and standalone,
    at widths 8 and 16 and seeds 1-4 (``test_one_round_bfloat16_teacher_forced``);
  * three free-running float32 MD-GAN rounds at ``local_epochs`` 1 and 2,
    from a fresh state and after 4 teacher-forced rounds
    (``FREE_RUNNING_RTOL`` in ``tests/test_torch_port_round.py``);
  * every Inception block in both graph variants at seeds 0 and 5, relative
    to the output's largest magnitude (``tests/test_torch_port_metrics.py``);
  * for each model family of ``tests/test_torch_port_families.py``, two
    teacher-forced float32 rounds (MD-GAN at N=2, and standalone) at seeds
    1-6: the metrics' relative gaps and the share of parameter updates off
    by more than the delta check allows (``ROUND_TOL`` there);
  * the SyntheticMNIST goldens of ``tests/test_golden.py`` reproduced by
    the port (``GOLDEN_RTOL`` there).

It holds no test (pytest collects nothing here) and runs only as a
script; it takes a few minutes.
"""

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import test_torch_port_families as families_tests  # noqa: E402
import test_torch_port_metrics as metrics_tests  # noqa: E402
import test_torch_port_round as round_tests  # noqa: E402
import test_torch_port_standalone as standalone_tests  # noqa: E402


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / np.abs(want)))


def bfloat16_rounds():
    worst = {}
    for n in (2, 8):
        for width in (8, 16):
            for seed in (1, 2, 3, 4):
                pair = round_tests.Pair(n, dtype="bfloat16", seed=seed, width=width)
                jm, pm, _ = pair.round()
                for key in ("mean_d_loss", "g_feedback_loss", "feedback_norm"):
                    worst[f"mdgan {key}"] = max(worst.get(f"mdgan {key}", 0.0),
                                                _rel(pm[key], jm[key]))
    for width in (8, 16):
        for seed in (1, 2, 3, 4):
            pair = standalone_tests.StandalonePair(1, dtype="bfloat16", width=width, seed=seed)
            jm, pm, _, _ = pair.chunk(1)
            for key in ("mean_d_loss", "mean_g_loss"):
                worst[f"standalone {key}"] = max(worst.get(f"standalone {key}", 0.0),
                                                 _rel(pm[key].numpy(), jm[key]))
            x_err = float(np.abs(pm["x_eval"].numpy()
                                 - np.asarray(jm["x_eval"]).transpose(0, 3, 1, 2)).max())
            worst["standalone x_eval (absolute)"] = max(
                worst.get("standalone x_eval (absolute)", 0.0), x_err)
    return worst


def free_running_drift():
    worst = {}
    for local_epochs in (1, 2):
        for n in (2, 8):
            for warm in (0, 4):
                pair = round_tests.Pair(n, local_epochs=local_epochs)
                for _ in range(warm):
                    pair.carry_jax_state()
                    pair.round()
                pair.carry_jax_state()
                for _ in range(3):
                    jm, pm, _ = pair.round()
                    gap = max(_rel(pm[k], jm[k]) for k in ("mean_d_loss", "g_feedback_loss"))
                    key = f"local_epochs={local_epochs} losses"
                    worst[key] = max(worst.get(key, 0.0), gap)
    return worst


def inception_blocks():
    worst = 0.0
    for block in metrics_tests.BLOCKS:
        for fid in (False, True):
            for seed in (0, 5):
                jmod, variables, port, x = metrics_tests._pair(*block[1:], fid, seed)
                want = np.asarray(jmod.apply(variables, jnp.asarray(x)))
                with torch.no_grad():
                    got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
                worst = max(worst, float(np.abs(got.numpy() - want).max() / np.abs(want).max()))
    return {"inception blocks (of the largest magnitude)": worst}


def _delta_gaps(jold, jnew, pold, pnew, worst, prefix, atol):
    for name in ("g", "d"):
        d_jax = (families_tests._flat(jax.device_get(getattr(jnew, name).params))
                 - families_tests._flat(jax.device_get(getattr(jold, name).params)))
        d_port = families_tests._flat(pnew[name][0]) - families_tests._flat(pold[name][0])
        for tol, label in ((1e-6, "1e-6"), (atol, "the family's atol")):
            off = 1.0 - np.isclose(d_port, d_jax, rtol=1e-2, atol=tol).mean()
            key = f"{prefix} {name} updates off (atol {label})"
            worst[key] = max(worst.get(key, 0.0), off)
        key = f"{prefix} {name} max update gap / lr"
        worst[key] = max(worst.get(key, 0.0), float(np.abs(d_port - d_jax).max()) / 2e-4)


def family_rounds():
    worst = {}
    for family in families_tests.FAMILIES:
        atol = families_tests.ROUND_TOL[family][4]
        for seed in range(1, 7):
            pair = families_tests.MDGANPair(family, seed=seed)
            for r in range(2):
                pair.carry_jax_state()
                jm, pm, (jold, pold) = pair.round()
                prefix = f"{family} mdgan round {r}"
                for key in jm:
                    worst[f"{prefix} {key}"] = max(worst.get(f"{prefix} {key}", 0.0),
                                                   _rel(pm[key], jm[key]))
                _delta_gaps(jold, pair.jst, pold, pair.port_trees(), worst, prefix, atol)
            sa = families_tests.StandalonePair(family, seed=seed)
            for r in range(2):
                jm, pm, (jold, pold) = sa.round()
                prefix = f"{family} standalone round {r}"
                for key in ("mean_d_loss", "mean_g_loss"):
                    worst[f"{prefix} {key}"] = max(worst.get(f"{prefix} {key}", 0.0),
                                                   _rel(pm[key].numpy(), jm[key][0]))
                _delta_gaps(jold, sa.jst, pold, sa.port_trees(), worst, prefix, atol)
    return worst


def goldens():
    got = families_tests.golden_trajectories()
    return {key: _rel(value, want) for key, (value, want) in got.items()}


if __name__ == "__main__":
    only = sys.argv[1:]
    for part in (bfloat16_rounds, free_running_drift, inception_blocks, family_rounds, goldens):
        if only and part.__name__ not in only:
            continue
        for key, value in part().items():
            print(f"{part.__name__:20s} {key:45s} {value:.3g}", flush=True)
