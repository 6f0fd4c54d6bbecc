"""The numbers that decide ``correct``: the program's first rounds against
the reference's, from the same weights and inputs.

The program runs them as the window runs its rounds, through
``run_rounds``, in the chunks of ``CHECK_CHUNKS``: one round alone, whose
optimizer state gives the first gradients, then one chunk of the rest,
which takes the window's multi-round path (one gather of the chunk's real
rows for all its rounds, the losses stacked over them).

* ``loss_gap``: the largest relative gap |p - r| / |r| of any loss the
  rounds return (each worker's, each round's); ``first_loss_gap`` the same
  over the first round alone, which no earlier step's rounding feeds;
* ``grad_gap``: the first gradient each leaf got, as the optimizer's state
  holds it after one step, by its norm: the worst leaf's
  | ||g_p|| - ||g_r|| | over the larger of ||g_r|| and the median leaf's
  ||g_r|| (generator and discriminators each their own median);
  ``median_grad_gap`` the median leaf's gap; ``median_grad_err`` the
  median leaf's ||g_p - g_r|| / max(||g_r||, median ||g_r||): the first
  gradients are taken at the same weights and inputs on both sides, so
  they compare element by element, and the norm of their difference sees
  the rounding noise that a gap of norms averages away;
* ``change_gap``: the same for each leaf's change over the rounds,
  ||p_3 - p_0||, leaving out the leaves whose reference gradient is under
  a thousandth of the median leaf's (they move under Adam by round-off
  alone).

A number with a limit in the cell's ``limits`` file is held to it; the run
is correct when each is at most its limit.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional, Tuple

import torch

CHECK_CHUNKS = (1, 2)     # rounds a run_rounds call
STILL_SHARE = 1e-3     # a leaf whose reference gradient is under this share of the median's


def norms(tensors: Dict[str, torch.Tensor], scale: float = 1.0) -> Dict[str, float]:
    """Each tensor's float64 2-norm (times ``scale``), read in one copy."""
    keys = list(tensors)
    if not keys:
        return {}
    stacked = torch.stack([torch.linalg.vector_norm(tensors[k].detach().double()) for k in keys])
    return dict(zip(keys, (stacked * scale).cpu().tolist()))


def host_copy(tensors: Dict[str, torch.Tensor], scale: float = 1.0) -> Dict[str, torch.Tensor]:
    """The tensors (times ``scale``) in host memory, in one device-to-host
    copy."""
    keys = list(tensors)
    flat = torch.cat([tensors[k].detach().reshape(-1) for k in keys]).mul_(scale).cpu()
    parts = flat.split([tensors[k].numel() for k in keys])
    return {k: part.view(tensors[k].shape) for k, part in zip(keys, parts)}


def _group(leaf: str) -> str:
    return "g" if leaf.startswith("g/") else "d"


def _medians(ref: Dict[str, float]) -> Dict[str, float]:
    groups: Dict[str, List[float]] = {}
    for leaf, v in ref.items():
        groups.setdefault(_group(leaf), []).append(v)
    return {g: statistics.median(v) for g, v in groups.items()}


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
             leaves=None) -> Tuple[float, Optional[str]]:
    """(the worst leaf's gap, that leaf) over ``leaves`` (default: all of
    the reference's).  A leaf the program lacks reads 1."""
    med = _medians(ref)
    worst, at = 0.0, None
    for leaf in (ref if leaves is None else leaves):
        r = ref[leaf]
        p = prog.get(leaf)
        gap = 1.0 if p is None else abs(p - r) / max(r, med[_group(leaf)], 1e-30)
        gap = float("inf") if gap != gap else gap
        if gap > worst or at is None:
            worst, at = gap, leaf
    return worst, at


def moving_leaves(ref_grads: Dict[str, float]) -> List[str]:
    med = _medians(ref_grads)
    return [k for k, v in ref_grads.items() if v >= STILL_SHARE * med[_group(k)]]


def error_norms(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """||p - r|| by leaf, on the reference's device; a leaf the program
    lacks counts as zero."""
    return norms({k: (prog[k].to(r.device) - r) if k in prog else r for k, r in ref.items()})


def median_gap(distance: Dict[str, float], ref: Dict[str, float]) -> Tuple[float, str]:
    """(the median leaf's distance over the larger of its reference norm
    and the median leaf's, that leaf)."""
    med = _medians(ref)
    gaps = sorted((d / max(ref[k], med[_group(k)], 1e-30), k) for k, d in distance.items())
    gap, leaf = gaps[len(gaps) // 2]
    return (float("inf") if gap != gap else gap), leaf


def loss_gap(prog: List[Dict[str, list]], ref: List[Dict[str, list]]) -> Tuple[float, str]:
    worst, at = 0.0, ""
    for t, (p, r) in enumerate(zip(prog, ref)):
        for key, rv in r.items():
            for i, (a, b) in enumerate(zip(p[key], rv)):
                gap = abs(a - b) / max(abs(b), 1e-30) if a == a else float("inf")
                if gap > worst or not at:
                    worst, at = gap, f"round {t + 1} {key}[{i}]"
    return worst, at


def numbers(prog: dict, ref: dict) -> Dict[str, Tuple[float, str]]:
    """{name: (value, where)}; ``prog`` and ``ref`` each hold ``losses``
    (a list a round of {name: [floats]}), ``grads`` and ``change`` (norms
    by leaf) and ``grad_tensors`` (the first gradients by leaf)."""
    grads = ref["grads"]
    return {
        "loss_gap": loss_gap(prog["losses"], ref["losses"]),
        "first_loss_gap": loss_gap(prog["losses"][:1], ref["losses"][:1]),
        "grad_gap": leaf_gap(prog["grads"], grads),
        "median_grad_gap": median_gap({k: abs(prog["grads"].get(k, 0.0) - r)
                                       for k, r in grads.items()}, grads),
        "median_grad_err": median_gap(error_norms(prog["grad_tensors"], ref["grad_tensors"]),
                                      grads),
        "change_gap": leaf_gap(prog["change"], ref["change"], moving_leaves(grads)),
    }


def reduce_reference(out: dict, init: Dict[str, torch.Tensor]) -> dict:
    """A reference run's output (``reference.rounds``) as norms and floats."""
    return {
        "losses": [{k: v.reshape(-1).cpu().tolist() for k, v in r.items()} for r in out["losses"]],
        "grads": norms(out["grads"]),
        "grad_tensors": out["grads"],
        "change": norms({k: out["params"][k] - init[k] for k in out["params"]}),
    }


def verdict(values: Dict[str, Tuple[float, str]], limits: Dict[str, float]) -> bool:
    return all(values[k][0] <= lim for k, lim in limits.items())
