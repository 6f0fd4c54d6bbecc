"""Host-side training orchestration, on one device or over ranks.

Port of ``mdgan_tpu/engine/train_loop.py:54-959``: chunk scheduling,
swap-pair sampling, FID/IS evaluation, image grids, span CSVs, weight
exports and checkpoints.

Under ``torch.distributed`` (``python -m torch.distributed.run``, one rank a
GPU) the MD-GAN trainer runs as JAX's multi-host trainer does
(``train_loop.py:128-170, 265-275``): every rank runs the same chunk and
swap schedule in lockstep, with swap permutations from the same seeded host
RNG, over its N/W discriminators (``engine/mdgan.py``), on its rows of each
batch under a replica axis and its slice of the generator under a tensor
axis (``core/mesh.py``); chunk metrics are gathered to every rank; rank 0
alone writes the CSVs, image grids, exports and checkpoints and runs the
evals, and the discriminators are gathered to it for checkpoints and the
final exports.  At every log event and checkpoint each tensor group
gathers its generator whole on the main thread (``parallel/tensor.py``,
as ``train_loop.py:298-335, 757-775`` gather JAX's), so the eval thread
and the writers read a whole generator and never enter a collective.  The
other ranks keep the same row bookkeeping through null loggers.

Round/event semantics follow the JAX trainer exactly:
  * swap at end of round e when ``e % swap_interval == 0 and e > 0`` and N > 1;
  * eval/log at end of round e when ``e % log_interval == 0 or e == epochs-1``
    (MD-GAN; standalone evaluates at ``e % log_interval == 0`` only);
  * checkpoint at end of round e when ``e % checkpoint_interval == 0 and
    e > 0``, and at the last round.
Chunks of up to ``chunk_size`` rounds (one real-batch gather each) are
clipped at those events (:func:`next_event`).

The JAX trainer snapshots state with a jitted copy because donated buffers
die (``_snapshot_g``/``_snapshot_state``, ``:288-327``).  Here every arena is
updated in place each round, so the eval and checkpoint threads work on
device-side clones (``NetState.snapshot``), taken on the main thread on the
same CUDA stream as the rounds, hence ordered before the next round writes.

Each log event also prints one JSON line of the round's metrics.
"""

from __future__ import annotations

import json
import logging
import time
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from mdgan_tpu_torch.core import distributed, prng
from mdgan_tpu_torch.core.config import RunConfig
from mdgan_tpu_torch.core.mesh import RankLayout, rank_layout
from mdgan_tpu_torch.core.registry import get as get_spec
from mdgan_tpu_torch.data.partitioner import shard_data
from mdgan_tpu_torch.data.sampler import ShardSampler
from mdgan_tpu_torch.engine.mdgan import MDGANEngine
from mdgan_tpu_torch.engine.standalone import StandaloneEngine
from mdgan_tpu_torch.models import from_jax
from mdgan_tpu_torch.obs import images as images_lib
from mdgan_tpu_torch.obs import spans as spans_lib
from mdgan_tpu_torch.ops import losses
from mdgan_tpu_torch.parallel import tensor as tensor_lib
from mdgan_tpu_torch.utils import checkpoint as ckpt_lib

log = logging.getLogger("mdgan_tpu_torch")

_EVAL_BACKLOG = 4  # queued evals, each holding a generator snapshot (train_loop.py:677-689)


def next_event(cur: int, epochs: int, swap_interval: int, log_interval: int,
               n_workers: int, checkpoint_interval: int = 0) -> int:
    """Smallest round e >= cur whose END triggers a host event
    (``train_loop.py:54-70``)."""
    candidates = [epochs - 1]
    if n_workers > 1 and swap_interval > 0:
        nxt = ((cur + swap_interval - 1) // swap_interval) * swap_interval
        candidates.append(nxt if nxt > 0 else swap_interval)
    if log_interval > 0:
        candidates.append(((cur + log_interval - 1) // log_interval) * log_interval)
    if checkpoint_interval > 0:
        nxt = ((cur + checkpoint_interval - 1) // checkpoint_interval) * checkpoint_interval
        candidates.append(nxt if nxt > 0 else checkpoint_interval)
    return min(c for c in candidates if c >= cur)


def _to_unit_nhwc(x: torch.Tensor) -> np.ndarray:
    """(n, C, H, W) images in [-1, 1] on any device -> (n, H, W, C) in [0, 1]
    on the host, the layout the JAX trainer scores and draws."""
    return losses.denormalize_to_unit(x.float()).permute(0, 2, 3, 1).cpu().numpy()


def _checkpoint_due(tc, e: int) -> bool:
    return (tc.checkpoint_interval > 0 and e > 0
            and e % tc.checkpoint_interval == 0) or e == tc.epochs - 1


def _standard_protocol_eval(engine, g, tracker, full_data, tc, epoch: int):
    """Shared standard-protocol FID/IS (both trainers, ``train_loop.py:73-104``):
    ``eval_n_samples`` fakes from the post-round generator ``g`` in batches of
    256, latents (and noise) from lane (EVAL, epoch), against ``eval_n_samples`` reals
    drawn once with ``default_rng(1)``; IS over 10 splits.  Returns
    ``(tracker, result)``; the tracker is built on first use."""
    from mdgan_tpu_torch.metrics import fid as fid_lib

    n = tc.eval_n_samples
    if tracker is None:
        rng = np.random.default_rng(1)
        idx = rng.choice(len(full_data), min(n, len(full_data)), replace=False)
        tracker = fid_lib.FIDTracker(full_data[idx].astype(np.float32) / 255.0,
                                     device=engine.device)
    gen = prng.generator(tc.seed, prng.EVAL, epoch, device=engine.device)
    fakes01 = np.concatenate([_to_unit_nhwc(engine.sample(g, min(256, n - i), gen=gen))
                              for i in range(0, n, 256)])
    fid_std = tracker.score(fakes01)
    is_std, is_std_dev = tracker.inception_score(fakes01, splits=10)
    log.info("standard eval @ %d (n=%d): fid=%.2f is=%.3f±%.3f",
             epoch, n, fid_std, is_std, is_std_dev)
    return tracker, {"fid_standard": fid_std, "is_standard": is_std,
                     "is_standard_std": is_std_dev}


def _load_run_data(run_cfg: RunConfig, spec):
    data, _ = spec.load(run_cfg.data.data_dir, fallback=run_cfg.data.fallback,
                        max_examples=run_cfg.data.max_examples)
    return data


class MDGANTrainer:
    """End-to-end MD-GAN training run (the ``run-distributed.sh`` path)."""

    def __init__(self, run_cfg: RunConfig, layout: Optional[RankLayout] = None):
        """``layout``: this rank's place in the mesh (default: made from the
        process group and ``run_cfg.mesh``; an idle rank's raises)."""
        self.cfg = run_cfg
        tc = run_cfg.train
        self.n = run_cfg.mesh.num_workers
        if layout is None:
            layout = rank_layout(self.n, run_cfg.mesh.num_replicas, run_cfg.mesh.num_tensor)
        if tc.chunk_size < 1:
            raise ValueError(f"chunk_size must be at least 1, got {tc.chunk_size}")
        self.spec = get_spec(run_cfg.data.dataset)
        # the reference validates world-size parity at bootstrap
        if self.n > 1 and tc.swap_interval > 0 and self.n % 2 != 0:
            raise ValueError(
                f"num_workers={self.n} must be even when discriminator swaps "
                "are enabled (set --swap_interval 0 to disable)")
        self.engine = MDGANEngine(self.spec, tc, self.n, layout=layout)
        self.layout = self.engine.layout
        self._is_main = self.layout.is_main
        if self.layout.distributed:
            log.info("rank %d: (replica, worker slot, tensor slot) %s of the (R, W, T) = %s "
                     "mesh", self.layout.rank, self.layout.coords, self.layout.shape)
        data = _load_run_data(run_cfg, self.spec)
        self.full_data = data
        # seed 0 == the reference's device_generator.manual_seed(0)
        shards, self.shard_indices = shard_data(data, self.n, iid=run_cfg.data.iid, seed=0)
        self.shards = self.engine.shard_data(shards)
        self.sampler = ShardSampler(self.n, shards.shape[1], tc.batch_size, seed=0)
        self.state = self.engine.init_state(tc.seed)
        # the whole generator's arena layout, for exports of gathered arenas
        self._g_layout = tensor_lib.full_layout(self.state.g)
        self.swap_rng = np.random.default_rng(tc.seed)

        name = f"mdgan.{self.n}.{run_cfg.data.dataset}"
        h, w, c = self.spec.shape
        self._payload_mb = tc.batch_size * h * w * c * 4 / 1024**2
        size_data, size_fb = 2 * self._payload_mb, self.n * self._payload_mb
        straggler = tc.straggler_rate > 0.0  # adds the n_feedbacks column
        self._row_template = lambda e: spans_lib.server_row_template(
            e, size_data, size_fb, straggler=straggler)

        def make_logger(path, template):  # rank 0 owns the CSV files
            if self._is_main:
                return spans_lib.SpanLogger(path, template)
            return spans_lib.NullSpanLogger(template)

        self.logger = make_logger(Path(tc.log_dir) / f"{name}.server.logs.csv",
                                  self._row_template(0))
        model_size = self.state.d.numel * 4 / 1024**2
        self._worker_row_template = spans_lib.worker_row_template(0, float(model_size))
        self._worker_logs = [
            make_logger(Path(tc.log_dir) / f"{name}.worker.{r + 1}.logs.csv",
                        self._worker_row_template)
            for r in range(self.n)]
        self._worker_col_index = {k: i for i, k in enumerate(self._worker_row_template)}
        self._last_d_loss: Optional[float] = None
        self._last_log: Dict = {}  # the last printed metrics line
        self._prev_chunk_end = 0.0

        self.ckpt = ckpt_lib.CheckpointManager(Path(tc.checkpoint_dir) / name)
        self._fid_tracker = None
        self._fid_std_tracker = None
        self._eval_history: List[Dict] = []
        if tc.resume and self.ckpt.latest_step() is not None:
            self._resume()
        self._eval_g = None  # the standard protocol's generator, loaded from snapshots
        self._eval_pool: Optional[ThreadPoolExecutor] = None
        if tc.async_eval:
            self._eval_pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="mdgan-eval")
        self._eval_backlog: Deque[Future] = deque()
        self._pending_rows: Deque[Tuple[Dict, Optional[Future], List[Optional[Future]]]] = deque()
        self._log_pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="mdgan-log")
        self._log_futs: List[Future] = []
        self._metrics_batch: List[Dict] = []

    # ------------------------------------------------------------------

    def _resume(self) -> None:
        # each rank takes its workers' rows of the N-stacked leaves
        rows = list(self.layout.workers) if self.n > 1 else None
        _, sampler_state, host_rng, step = self.ckpt.restore(self.state, d_rows=rows)
        if sampler_state is not None:
            self.sampler.load_state_dict(sampler_state)
        if host_rng is not None:
            self.swap_rng = ckpt_lib.restore_host_rng(host_rng)
        log.info("resumed from checkpoint at step %d", step)

    def _real_eval_batch(self, n_samples: int) -> np.ndarray:
        """Fixed real sample for FID, in [0,1] (``server.py:128-140``)."""
        rng = np.random.default_rng(0)
        idx = rng.choice(len(self.full_data), size=min(n_samples, len(self.full_data)),
                         replace=False)
        return self.full_data[idx].astype(np.float32) / 255.0

    def _snapshot_g(self) -> Dict[str, torch.Tensor]:
        """Device-side clone of the whole generator at the current round
        (gathered over the tensor group; every rank of it must call)."""
        g = self.state.g
        return tensor_lib.gather_arenas(g, self.layout.tensor_axis,
                                        {"params": g.params.clone(), "stats": g.stats.clone()})

    def _evaluate_work(self, epoch: int, g_snap: Dict[str, torch.Tensor],
                       x_eval: torch.Tensor) -> Tuple[Dict, Dict]:
        """FID/IS + grid/weights IO for round ``epoch`` (``train_loop.py:341-407``).

        Runs on the eval thread (async) or inline (``--sync_eval``) and reads
        only ``x_eval`` (round ``epoch``'s own images, from the pre-update
        generator) and ``g_snap`` (the post-round generator, for the weights
        export and the standard protocol), never live training state.
        """
        from mdgan_tpu_torch.metrics import fid as fid_lib

        tc = self.cfg.train
        marks: Dict = {}
        fakes01 = _to_unit_nhwc(x_eval)
        images_lib.save_image_grid(fakes01, Path(tc.image_dir) / f"generated_epoch_{epoch}.png")

        n_eval = min(tc.n_samples, len(fakes01))
        if self._fid_tracker is None:
            real01 = self._real_eval_batch(tc.n_samples)
            images_lib.save_image_grid(real01, Path(tc.image_dir) / "real_images.png")
            self._fid_tracker = fid_lib.FIDTracker(real01, device=self.engine.device)
        marks["start.is"] = time.time()
        is_mean, _ = self._fid_tracker.inception_score(fakes01[:n_eval], splits=1)
        marks["end.is"] = time.time()
        marks["start.fid"] = time.time()
        fid = self._fid_tracker.score(fakes01[:n_eval])
        marks["end.fid"] = time.time()
        marks.update(fid=fid, **{"is": is_mean})

        result = {"epoch": epoch, "fid": fid, "is": is_mean}
        # every K-th eval event by index derived from the epoch (so a resumed
        # run standard-evals the same rounds), plus the final round
        k = max(tc.eval_standard_interval, 1)
        eval_idx = epoch // max(tc.log_interval, 1)
        if tc.eval_n_samples > 0 and (eval_idx % k == 0 or epoch == tc.epochs - 1):
            if self._eval_g is None:
                self._eval_g = self.engine.new_generator(tc.seed)
            self._eval_g.params.copy_(g_snap["params"])
            self._eval_g.stats.copy_(g_snap["stats"])
            self._fid_std_tracker, std = _standard_protocol_eval(
                self.engine, self._eval_g, self._fid_std_tracker, self.full_data, tc, epoch)
            result.update(std)
            marks.update(fid_standard=std["fid_standard"], is_standard=std["is_standard"])
        self._log_futs.append(self._log_pool.submit(
            ckpt_lib.save_net_weights, Path(tc.weights_dir) / f"generator_{epoch}.npz",
            self._g_layout, g_snap))
        log.info("eval @ %d: fid=%.2f is=%.3f", epoch, fid, is_mean)
        return marks, result

    def _write_worker_rows_batch(self, records: List[Dict]) -> None:
        """One device-to-host copy for a batch of chunks' losses, then their
        per-round worker CSV rows (``train_loop.py:419-451``).  Per-chunk
        completion times are synthesized by splitting the batch's measured
        window in proportion to round counts."""
        lengths = [r["d_loss"].shape[0] for r in records]
        fetched = np.split(torch.cat([r["d_loss"] for r in records]).cpu().numpy(),
                           np.cumsum(lengths)[:-1])
        n_fbs = [None] * len(records)
        if records[0]["n_fb"] is not None:
            n_fbs = np.split(torch.cat([r["n_fb"] for r in records]).cpu().numpy(),
                             np.cumsum(lengths)[:-1])
        t1 = time.time()
        t_start = min(max(records[0]["t0"], self._prev_chunk_end), t1)
        total_rows = sum(lengths) or 1
        cursor = t_start
        for i, (rec, d_losses, n_fb) in enumerate(zip(records, fetched, n_fbs)):
            if i == len(records) - 1:
                t_end = t1
            else:
                t_end = cursor + (t1 - t_start) * (d_losses.shape[0] / total_rows)
            self._write_rows_for_chunk(d_losses, cursor, t_end, rec["e"],
                                       rec["swapped_with"], rec["row"], n_fb)
            cursor = t_end
        self._prev_chunk_end = t1

    def _write_rows_for_chunk(self, d_losses: np.ndarray, t0: float, t1: float, e: int,
                              swapped_with, server_row: Optional[Dict],
                              n_fb: Optional[np.ndarray] = None) -> None:
        """One chunk's worker CSV rows, and its held server row's execution
        window and, under the straggler policy, its round's accepted-feedback
        count (``train_loop.py:453-565``)."""
        n_rows = d_losses.shape[0]
        self._last_d_loss = float(np.mean(d_losses[-1]))
        if server_row is not None:
            if n_fb is not None:
                server_row["n_feedbacks"] = int(n_fb[-1])
            for key in ("start.epoch", "start.calc_gradients", "start.epoch_calculation"):
                server_row[key] = t0
            for key in ("end.calc_gradients", "end.epoch_calculation", "end.epoch"):
                server_row[key] = t1
            # keep swap/checkpoint child spans, stamped at dispatch, inside
            # the back-filled window with their measured durations
            for child in ("swap", "checkpoint"):
                s, en = server_row.get(f"start.{child}"), server_row.get(f"end.{child}")
                if isinstance(s, float) and isinstance(en, float) and (s < t0 or en > t1):
                    d = min(en - s, t1 - t0)
                    server_row[f"start.{child}"] = t1 - d
                    server_row[f"end.{child}"] = t1
        dt = (t1 - t0) / max(n_rows, 1)
        tmpl, col = self._worker_row_template, self._worker_col_index
        base = list(tmpl.values())
        size_recv, size_sent = 2 * self._payload_mb, self._payload_mb
        if swapped_with is not None:
            swap_s = server_row.get("start.swap") if server_row else None
            swap_e = server_row.get("end.swap") if server_row else None
            if not (isinstance(swap_s, float) and isinstance(swap_e, float)):
                swap_s = swap_e = t1
            swap_s = min(max(swap_s, t1 - dt), t1)
            swap_e = min(max(swap_e, swap_s), t1)
        d_losses = d_losses.astype(float)
        for r in range(self.n):
            rows = []
            for t in range(n_rows):
                row = base.copy()
                row[col["epoch"]] = e - n_rows + 1 + t
                row[col["start.epoch"]] = row[col["start.calc_gradients"]] = t0 + t * dt
                row[col["end.epoch"]] = row[col["end.calc_gradients"]] = t0 + (t + 1) * dt
                row[col["mean_d_loss"]] = d_losses[t, r]
                row[col["size.recv"]] = size_recv
                row[col["size.sent"]] = size_sent
                rows.append(row)
            if swapped_with is not None:
                row = rows[-1]  # the swap lands on round e, the chunk's last
                row[col["swap_with"]] = int(swapped_with[r]) + 1
                row[col["size.recv"]] = size_recv + tmpl["size.model"]
                row[col["size.sent"]] = size_sent + tmpl["size.model"]
                for op in ("swap_recv_instruction", "swap_send", "swap_recv"):
                    row[col[f"start.{op}"]] = swap_s
                row[col["end.swap_recv_instruction"]] = swap_s
                row[col["end.swap_send"]] = row[col["end.swap_recv"]] = swap_e
                row[col["start.load_state_dict"]] = row[col["end.load_state_dict"]] = swap_e
            self._worker_logs[r].write_raw_rows(rows)

    @staticmethod
    def _drain_futures(futs) -> None:
        """Wait for every future; re-raise the first error; clear the list."""
        for fut in futs:
            fut.result()
        futs.clear()

    def _submit_metrics_batch(self) -> Optional[Future]:
        if not self._metrics_batch:
            return None
        records, self._metrics_batch = self._metrics_batch, []
        fut = self._log_pool.submit(self._write_worker_rows_batch, records)
        self._log_futs.append(fut)
        for rec in records:
            rec["fut_holder"][0] = fut
        return fut

    def _flush_rows(self, block: bool = False) -> None:
        """Write held server rows whose eval marks and metrics fetch have
        arrived, in round order (``train_loop.py:581-609``)."""
        while self._pending_rows:
            row, fut, holder = self._pending_rows[0]
            metrics_fut = holder[0]
            if metrics_fut is None:
                if not block:
                    return
                self._submit_metrics_batch()
                metrics_fut = holder[0]
            if not block and not metrics_fut.done():
                return
            metrics_fut.result()
            if fut is not None:
                if not block and not fut.done():
                    return
                marks, result = fut.result()
                row.update(marks)
                self._eval_history.append(result)
            self._pending_rows.popleft()
            self.logger.write_row(row)

    # ------------------------------------------------------------------

    def train(self, on_chunk: Optional[Callable[[], None]] = None) -> Dict:
        """Run to ``epochs`` rounds; ``on_chunk`` is called after each chunk
        (the CLI steps its profiler with it)."""
        tc = self.cfg.train
        dev = self.engine.device
        cur = int(self.state.step)
        t_start = time.time()
        rounds_done, swaps = 0, 0
        finite = torch.ones((), dtype=torch.bool, device=dev)  # read once, at the end
        inflight: Deque[Future] = deque()  # un-fetched metrics batches
        while cur < tc.epochs:
            event_end = next_event(cur, tc.epochs, tc.swap_interval, tc.log_interval,
                                   self.n, tc.checkpoint_interval)
            clen = min(tc.chunk_size, event_end - cur + 1, tc.epochs - cur)
            self.logger.begin_row(self._row_template(cur))
            with self.logger.span("epoch_calculation"):
                with self.logger.span("generate_data"):
                    pass  # inside the round
                with self.logger.span("agg_gradients"):
                    pass  # inside the round
                with self.logger.span("calc_gradients"):
                    t_chunk0 = time.time()
                    m = self.engine.run_rounds(self.state, self.shards, self.sampler, clen)
            cur += clen
            rounds_done += clen
            e = cur - 1
            self.logger.mark(epoch=e)
            for key in ("mean_d_loss", "g_feedback_loss", "feedback_norm"):
                finite &= torch.isfinite(m[key]).all()

            swapped_with = None
            if self.n > 1 and tc.swap_interval > 0 and e > 0 and e % tc.swap_interval == 0:
                with self.logger.span("swap"):
                    perm = self.engine.sample_swap_perm(self.swap_rng)
                    self.engine.swap(self.state, perm)
                self.logger.mark(swap=True)
                swapped_with = perm
                swaps += 1

            eval_fut: Optional[Future] = None
            log_event = (tc.log_interval > 0 and e % tc.log_interval == 0) or e == tc.epochs - 1
            if log_event and not self._is_main and self.layout.tensor_axis.active:
                self._snapshot_g()  # rank 0's tensor group gathers its generator
            if log_event and self._is_main:
                self._print_log(e, m, t_start)
                with spans_lib.phase("trainer.eval"):
                    g_snap = self._snapshot_g()
                    if self._eval_pool is not None:
                        # each queued eval holds a generator snapshot on the device
                        while len(self._eval_backlog) >= _EVAL_BACKLOG:
                            self._eval_backlog.popleft().result()
                        eval_fut = self._eval_pool.submit(self._evaluate_work, e, g_snap,
                                                          m["x_eval"])
                        self._eval_backlog.append(eval_fut)
                    else:
                        marks, result = self._evaluate_work(e, g_snap, m["x_eval"])
                        self.logger.mark(**marks)
                        self._eval_history.append(result)
            if _checkpoint_due(tc, e):
                with self.logger.span("checkpoint"):
                    # every rank joins the discriminators' gather; rank 0 saves
                    snap = ckpt_lib.snapshot_state(self.state, self.layout)
                    if self._is_main:
                        self.ckpt.save(e, snap, self.sampler.state_dict(),
                                       ckpt_lib.host_rng_state(self.swap_rng))
            row = self.logger.take_row()
            holder: List[Optional[Future]] = [None]
            self._metrics_batch.append(dict(d_loss=m["mean_d_loss"], n_fb=m.get("n_feedbacks"),
                                            t0=t_chunk0, e=e, swapped_with=swapped_with,
                                            row=row, fut_holder=holder))
            self._pending_rows.append((row, eval_fut, holder))
            if len(self._metrics_batch) >= max(1, min(tc.metrics_flush, 64)):
                inflight.append(self._submit_metrics_batch())
                if len(inflight) > 2:
                    inflight.popleft().result()
            self._flush_rows(block=False)
            if on_chunk is not None:
                on_chunk()

        self._submit_metrics_batch()
        self._flush_rows(block=True)
        self._eval_backlog.clear()
        self._drain_futures(self._log_futs)
        self.ckpt.wait_until_finished()

        # final exports (reference server.py:372-375, worker.py:289-293);
        # every rank joins the discriminators' gather, rank 0 writes
        snap = ckpt_lib.snapshot_state(self.state, self.layout)
        if self._is_main:
            wd = Path(tc.weights_dir)
            g_net, g_snap = snap["nets"]["g"]
            ckpt_lib.save_net_weights(wd / "generator_final.npz", g_net,
                                      {k: g_snap[k] for k in ("params", "stats")})
            d_net, d_snap = snap["nets"]["d"]
            d_trees = from_jax.export_arenas(
                d_net, {k: d_snap[k] for k in ("params", "stats")}, d_snap["copies"])
            for r in range(self.n):
                ckpt_lib.save_weights_only(
                    wd / f"worker_{r + 1}" / "discriminator.npz",
                    *(from_jax.index_tree(d_trees[k], r) if self.n > 1 else d_trees[k]
                      for k in ("params", "stats")))
        wall = time.time() - t_start
        from mdgan_tpu_torch.metrics.inception import feature_source_if_loaded

        summary = {
            "rounds": rounds_done,
            "wall_time_s": wall,
            "steps_per_sec": rounds_done / wall if wall > 0 else 0.0,
            "final_mean_d_loss": self._last_d_loss,
            "feature_source": feature_source_if_loaded(),
            "evals": self._eval_history,
            "swaps": swaps,
            "all_finite": bool(finite),
            "final_g_feedback_loss": self._last_log.get("g_feedback_loss"),
            "final_feedback_norm": self._last_log.get("feedback_norm"),
            "compute_dtype": tc.compute_dtype,
            "device": _device_name(dev),
        }
        log.info("done: %s", summary)
        return summary

    def _print_log(self, e: int, m: Dict, t_start: float) -> None:
        self._last_log = {"round": e,
                          "mean_d_loss": float(m["mean_d_loss"][-1].mean()),
                          "g_feedback_loss": float(m["g_feedback_loss"][-1].mean()),
                          "feedback_norm": float(m["feedback_norm"][-1])}
        self._last_log["elapsed_s"] = time.time() - t_start  # after the reads synced
        print(json.dumps(self._last_log), flush=True)

    def close(self):
        if self._eval_pool is not None:
            self._eval_pool.shutdown(wait=True)
            self._eval_pool = None
        try:
            self._flush_rows(block=True)
        except Exception:  # an eval future may re-raise; don't mask close()
            log.exception("pending eval failed during close()")
        self._log_pool.shutdown(wait=True)
        try:
            self._drain_futures(self._log_futs)
        except Exception:
            log.exception("pending worker-row write failed during close()")
        try:
            self.ckpt.close()
        except Exception:
            log.exception("pending checkpoint save failed during close()")
        self.logger.close()
        for wl in self._worker_logs:
            wl.close()


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


class StandaloneTrainer:
    """Single-device baseline run (the ``run-standalone.sh`` path,
    ``train_loop.py:820-959``): synchronous, with checkpoint/resume of the
    full state and the sampler cursor."""

    def __init__(self, run_cfg: RunConfig):
        self.cfg = run_cfg
        tc = run_cfg.train
        if tc.chunk_size < 1:
            raise ValueError(f"chunk_size must be at least 1, got {tc.chunk_size}")
        if distributed.world_size() > 1:
            raise ValueError("the standalone baseline runs in one process; start it "
                             "without torch.distributed.run")
        self.spec = get_spec(run_cfg.data.dataset)
        self.engine = StandaloneEngine(self.spec, tc)
        data = _load_run_data(run_cfg, self.spec)
        self.full_data = data
        self.data = self.engine.put_data(data)
        self.sampler = ShardSampler(1, len(data), tc.batch_size, seed=0)
        self.state = self.engine.init_state(tc.seed)
        name = f"{run_cfg.data.dataset}.standalone"
        self.ckpt = ckpt_lib.CheckpointManager(Path(tc.checkpoint_dir) / name)
        if tc.resume and self.ckpt.latest_step() is not None:
            _, sampler_state, _, step = self.ckpt.restore(self.state)
            if sampler_state is not None:
                self.sampler.load_state_dict(sampler_state)
            log.info("standalone: resumed from checkpoint at step %d", step)
        self.logger = spans_lib.SpanLogger(Path(tc.log_dir) / f"{name}.logs.csv",
                                           spans_lib.server_row_template(0, 0.0, 0.0))
        self._fid_std_tracker = None
        self._eval_history: List[Dict] = []

    def train(self, on_chunk: Optional[Callable[[], None]] = None) -> Dict:
        from mdgan_tpu_torch.metrics import fid as fid_lib

        tc = self.cfg.train
        dev = self.engine.device
        cur = int(self.state.step)
        rounds_done = 0
        m = None
        finite = torch.ones((), dtype=torch.bool, device=dev)
        t_start = time.time()
        while cur < tc.epochs:
            event_end = next_event(cur, tc.epochs, 0, tc.log_interval, 1,
                                   tc.checkpoint_interval)
            clen = min(tc.chunk_size, event_end - cur + 1, tc.epochs - cur)
            self.logger.begin_row(spans_lib.server_row_template(cur, 0.0, 0.0))
            with self.logger.span("calc_gradients"):
                m = self.engine.run_rounds(self.state, self.data, self.sampler, clen)
            cur += clen
            rounds_done += clen
            e = cur - 1
            self.logger.mark(epoch=e)
            for key in ("mean_d_loss", "mean_g_loss"):
                finite &= torch.isfinite(m[key]).all()
            # the reference standalone has NO final-round eval
            # (standalone_gan.py:233), unlike the MD-GAN server
            is_eval_round = tc.log_interval > 0 and e % tc.log_interval == 0
            if is_eval_round:
                print(json.dumps({"round": e, "mean_d_loss": float(m["mean_d_loss"][-1]),
                                  "mean_g_loss": float(m["mean_g_loss"][-1]),
                                  "elapsed_s": time.time() - t_start}), flush=True)
                # the round's own fake batch and its own real batch
                # (standalone_gan.py:190-191, 235-247), capped to n_samples
                fakes01 = _to_unit_nhwc(m["x_eval"])[: tc.n_samples]
                real01 = self.full_data[m["idx"][-1, 0]].astype(
                    np.float32)[: tc.n_samples] / 255.0
                images_lib.save_image_grid(fakes01, Path(tc.image_dir) / f"fake_samples_{e}.png")
                with self.logger.span("fid"):
                    tracker = fid_lib.FIDTracker(real01, device=dev)
                    fid = tracker.score(fakes01)
                with self.logger.span("is"):
                    is_mean, _ = tracker.inception_score(fakes01, splits=1)
                self.logger.mark(fid=fid, **{"is": is_mean})
                self._eval_history.append({"epoch": e, "fid": fid, "is": is_mean})
            if tc.eval_n_samples > 0:
                k = max(tc.eval_standard_interval, 1)
                eval_idx = e // max(tc.log_interval, 1)
                if (is_eval_round and eval_idx % k == 0) or e == tc.epochs - 1:
                    self._fid_std_tracker, std = _standard_protocol_eval(
                        self.engine, self.state.g, self._fid_std_tracker, self.full_data,
                        tc, e)
                    self.logger.mark(fid_standard=std["fid_standard"],
                                     is_standard=std["is_standard"])
                    if self._eval_history and self._eval_history[-1]["epoch"] == e:
                        self._eval_history[-1].update(std)
                    else:
                        self._eval_history.append({"epoch": e, **std})
            if _checkpoint_due(tc, e):
                with self.logger.span("checkpoint"):
                    self.ckpt.save(e, ckpt_lib.snapshot_state(self.state),
                                   self.sampler.state_dict())
            self.logger.end_row()
            if on_chunk is not None:
                on_chunk()

        self.ckpt.wait_until_finished()
        wd = Path(tc.weights_dir)
        ckpt_lib.save_net_weights(wd / f"netG_epoch_{tc.epochs - 1}.npz", self.state.g)
        ckpt_lib.save_net_weights(wd / f"netD_epoch_{tc.epochs - 1}.npz", self.state.d)
        wall = time.time() - t_start
        from mdgan_tpu_torch.metrics.inception import feature_source_if_loaded

        return {
            "rounds": rounds_done,
            "wall_time_s": wall,
            "steps_per_sec": rounds_done / wall if wall > 0 else 0.0,
            "final_mean_d_loss": float(m["mean_d_loss"][-1]) if m else None,
            "final_mean_g_loss": float(m["mean_g_loss"][-1]) if m else None,
            "feature_source": feature_source_if_loaded(),
            "evals": self._eval_history,
            "all_finite": bool(finite),
            "compute_dtype": tc.compute_dtype,
            "device": _device_name(dev),
        }

    def close(self):
        self.logger.close()
        self.ckpt.close()
