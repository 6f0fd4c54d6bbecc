"""Checkpoint / resume, and weights-only exports.

Port of ``mdgan_tpu/utils/checkpoint.py:52-147`` without orbax: a
:class:`CheckpointManager` keeps the last ``max_to_keep`` full-state
checkpoints of a run, ``ckpt_<step>.pt`` (``torch.save`` of plain tensors,
ints and dicts, so ``torch.load(weights_only=True)`` reads it), and the host
swap-RNG state beside each in ``host_rng_<step>.json``, as the JAX manager
writes it (``:76-79``).

The state is stored by LEAF NAME, never as raw arenas: each network's params,
Adam ``mu``/``nu`` and BN statistics under the flax-flattened keys of
``models/from_jax.py:export_arenas`` (discriminator leaves stacked on a
leading N axis, as the JAX engine keeps them), with the Adam ``count``, the
round ``step``, the run ``seed`` (the root of every random lane) and the
sampler cursor.  So the file format does not depend on how the arenas are
laid out.

Adam moments keep their storage dtype in the file (bfloat16 under
``--moment_dtype bfloat16``, as orbax stores JAX's).  A run sharded over
``torch.distributed`` ranks writes the same file as a single-process run:
rank 0 gathers every rank's discriminators into the N-stacked leaves and
alone writes, and each rank restores its own workers' rows, so a checkpoint
resumes at any world size that divides N.

Saves run on one background thread, at most two in flight
(``train_loop.py:690-712``), from device-side clones taken by
:func:`snapshot_state` on the caller's thread.
"""

from __future__ import annotations

import json
import os
import re
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path
from typing import Any, Deque, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from mdgan_tpu_torch.core import distributed
from mdgan_tpu_torch.models import from_jax

FORMAT = 1
_MAX_IN_FLIGHT = 2
_CKPT = re.compile(r"ckpt_(\d+)\.pt")


def flatten(tree: Mapping, prefix: str = "") -> Dict[str, Any]:
    """Nested dicts -> ``a/b/c`` keys (``flax.traverse_util.flatten_dict``
    with ``sep="/"``)."""
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def unflatten(flat: Mapping[str, Any]) -> Dict:
    out: Dict = {}
    for key, value in flat.items():
        *path, leaf = key.split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = value
    return out


def snapshot_state(st, layout=None) -> Optional[Dict]:
    """Device-side clones of a train state (``MDGANState`` or
    ``StandaloneState``) for a background save: the port's form of
    ``_snapshot_state`` (``train_loop.py:316-327``).  Under a process group
    (``layout``, a ``core.mesh.RankLayout``) every rank must call it: the
    discriminators are gathered to rank 0, and the other ranks get None."""
    d = st.d.snapshot()
    d["copies"] = st.d.n
    if layout is not None and layout.distributed:
        for key in ("params", "stats", "mu", "nu"):
            d[key] = distributed.gather_cat(d[key], layout.world, layout.rank)
        d["copies"] = layout.num_workers
        if not layout.is_main:
            return None
    return {"step": int(st.step), "seed": int(st.seed),
            "nets": {"g": (st.g, st.g.snapshot()), "d": (st.d, d)}}


def _net_payload(net, snap: Mapping) -> Dict:
    keys = ("params", "stats", "mu", "nu")
    trees = from_jax.export_arenas(net, {k: snap[k] for k in keys}, snap.get("copies"))
    # each leaf in its arena's dtype: bfloat16 moments stay bfloat16
    out = {("batch_stats" if k == "stats" else k): {
        key: torch.from_numpy(np.asarray(a)).to(snap[k].dtype)
        for key, a in flatten(tree).items()} for k, tree in trees.items()}
    out["count"] = int(snap["count"])
    return out


class CheckpointManager:
    """Full-state checkpoints with retention (``max_to_keep``)."""

    def __init__(self, directory, max_to_keep: int = 3):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep
        self._pool: Optional[ThreadPoolExecutor] = None
        self._futs: Deque[Future] = deque()

    def save(self, step: int, state: Mapping, sampler_state: Optional[Mapping] = None,
             host_rng_state: Optional[Dict] = None) -> None:
        """Queue a save of ``state`` (from :func:`snapshot_state`) at
        ``step``.  The sampler and RNG states are copied here, on the
        caller's thread, before the caller moves them on."""
        sampler = (None if sampler_state is None else
                   {k: torch.from_numpy(np.array(v)) for k, v in sampler_state.items()})
        rng_json = None if host_rng_state is None else json.dumps(host_rng_state, default=int)
        if self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="mdgan-ckpt")
        while len(self._futs) >= _MAX_IN_FLIGHT:
            self._futs.popleft().result()
        self._futs.append(self._pool.submit(self._write, int(step), state, sampler, rng_json))

    def _write(self, step: int, state: Mapping, sampler, rng_json: Optional[str]) -> None:
        payload = {"format": FORMAT, "step": state["step"], "seed": state["seed"],
                   "nets": {name: _net_payload(net, snap)
                            for name, (net, snap) in state["nets"].items()}}
        if sampler is not None:
            payload["sampler"] = sampler
        # the sidecar first, so a visible checkpoint always has it
        if rng_json is not None:
            _atomic_write(self.directory / f"host_rng_{step}.json",
                          lambda f: f.write(rng_json.encode()))
        _atomic_write(self.directory / f"ckpt_{step}.pt", lambda f: torch.save(payload, f))
        for old in self.steps()[:-self.max_to_keep]:
            (self.directory / f"ckpt_{old}.pt").unlink()
            (self.directory / f"host_rng_{old}.json").unlink(missing_ok=True)

    def steps(self) -> list:
        return checkpoint_steps(self.directory)

    def latest_step(self) -> Optional[int]:
        self.wait_until_finished()
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, state, step: Optional[int] = None, d_rows: Optional[Sequence[int]] = None
                ) -> Tuple[Any, Optional[Dict], Optional[Dict], int]:
        """Load checkpoint ``step`` (default: the latest) into ``state`` in
        place; returns (state, sampler_state, host_rng_state, step).
        ``d_rows``: the rows of the stacked discriminator leaves that
        ``state.d``'s copies take (a rank's workers; default all)."""
        step = step if step is not None else self.latest_step()
        payload, step = load_payload(self.directory, step)
        for name in ("g", "d"):
            saved = payload["nets"][name]
            trees = net_trees(saved, ("params", "batch_stats", "mu", "nu"))
            from_jax.load_net(getattr(state, name), trees["params"], trees["batch_stats"],
                              trees["mu"], trees["nu"], saved["count"],
                              rows=d_rows if name == "d" else None)
        state.step, state.seed = int(payload["step"]), int(payload["seed"])
        sampler = payload.get("sampler")
        if sampler is not None:
            sampler = {k: v.numpy() for k, v in sampler.items()}
        rng_file = self.directory / f"host_rng_{step}.json"
        host_rng = json.loads(rng_file.read_text()) if rng_file.exists() else None
        return state, sampler, host_rng, step

    def wait_until_finished(self) -> None:
        """Block until every queued save is on disk; re-raise a failed one."""
        while self._futs:
            self._futs.popleft().result()

    def close(self) -> None:
        try:
            self.wait_until_finished()
        finally:
            if self._pool is not None:
                self._pool.shutdown(wait=True)
                self._pool = None


def checkpoint_steps(directory) -> list:
    """The steps of the ``ckpt_<step>.pt`` files in ``directory``, ascending."""
    return sorted(int(m.group(1)) for p in Path(directory).iterdir()
                  if (m := _CKPT.fullmatch(p.name)))


def load_payload(directory, step: Optional[int] = None) -> Tuple[Dict, int]:
    """Checkpoint ``step`` of ``directory`` (default: the latest) as saved,
    read with ``weights_only=True``; returns (payload, step)."""
    directory = Path(directory)
    if step is None:
        steps = checkpoint_steps(directory) if directory.is_dir() else []
        step = steps[-1] if steps else None
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    payload = torch.load(directory / f"ckpt_{step}.pt", map_location="cpu",
                         weights_only=True)
    if payload.get("format") != FORMAT:
        raise ValueError(f"ckpt_{step}.pt: format {payload.get('format')!r}, "
                         f"this reader knows {FORMAT}")
    return payload, step


def net_trees(saved: Mapping, keys: Sequence[str] = ("params", "batch_stats")) -> Dict:
    """A saved network's leaves as nested float32 numpy trees under ``keys``."""
    return {k: unflatten({key: t.float().numpy() for key, t in saved[k].items()})
            for k in keys}


def _atomic_write(path: Path, write) -> None:
    tmp = path.with_name(f".{path.name}.tmp")
    with open(tmp, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def save_weights_only(path, params: Mapping, stats: Optional[Mapping] = None) -> None:
    """Reference-style weights export (``generator_<epoch>.pt`` analogue):
    one npz of ``params/...`` (and ``batch_stats/...``) leaves, the keys and
    shapes of ``mdgan_tpu/utils/checkpoint.py:save_weights_only``
    (``:117-127``), so the JAX loaders read it."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    flat = flatten({"params": params})
    if stats:
        flat.update(flatten({"batch_stats": stats}))
    np.savez(path, **{k: np.asarray(v) for k, v in flat.items()})


def save_net_weights(path, net, arenas: Optional[Mapping[str, torch.Tensor]] = None) -> None:
    """Export a one-copy ``NetState`` (or clones of its ``params`` and
    ``stats`` arenas) with :func:`save_weights_only`."""
    trees = from_jax.export_arenas(net, arenas or {"params": net.params, "stats": net.stats})
    save_weights_only(path, trees["params"], trees["stats"])


def host_rng_state(rng: np.random.Generator) -> Dict:
    return rng.bit_generator.state


def restore_host_rng(state: Dict) -> np.random.Generator:
    rng = np.random.default_rng(0)
    rng.bit_generator.state = state
    return rng
