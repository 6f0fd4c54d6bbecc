"""Frechet Inception Distance and Inception Score.

Copy of the numpy math of ``mdgan_tpu/metrics/fid.py:27-173``
(``_matrix_sqrt_trace``, ``activation_statistics``,
``frechet_from_features``, ``_is_from_probs`` and ``FIDTracker`` with its
dense and low-rank paths) over the port's
``metrics/inception.py``.  Features run on ``device`` (the card, by default);
a tracker's calibrated BN statistics take the place of its calibrated
variables.

Rebuilds the reference's evaluation channel (torchmetrics
``FrechetInceptionDistance(normalize=True)`` / ``InceptionScore(normalize=True,
splits=1)`` — reference ``src/actors/server.py:20-43``), with two protocols:

  * **reference protocol** — ``n_samples=5`` images, splits=1, matching the
    reference's logging exactly (``server.py:82, 354-364``).  Statistically
    meaningless as an absolute quality number (SURVEY.md §5.5) but preserved
    for log-schema parity.
  * **standard protocol** — 10k+ samples, splits=10, comparable to literature
    (the rebuild's superset requirement, BASELINE.md).

Inputs are images in [0, 1] (the reference rescales from [-1, 1] first —
``server.py:140, 342``); use :func:`mdgan_tpu_torch.ops.losses.denormalize_to_unit`.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from mdgan_tpu_torch.core.config import resolve_device
from mdgan_tpu_torch.metrics.inception import calibrated_stats, inception_features


def _matrix_sqrt_trace(a: np.ndarray, b: np.ndarray) -> float:
    """tr(sqrtm(A @ B)) for symmetric PSD A, B, computed stably via
    eigendecomposition of A^(1/2) B A^(1/2) (no scipy dependency)."""
    wa, va = np.linalg.eigh(a)
    wa = np.clip(wa, 0, None)
    sqrt_a = (va * np.sqrt(wa)) @ va.T
    m = sqrt_a @ b @ sqrt_a
    w = np.linalg.eigvalsh((m + m.T) / 2)
    return float(np.sqrt(np.clip(w, 0, None)).sum())


def activation_statistics(feats: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    mu = feats.mean(axis=0)
    # torchmetrics uses the unbiased estimator; with n==1 fall back to zeros
    if feats.shape[0] > 1:
        sigma = np.cov(feats, rowvar=False)
    else:
        sigma = np.zeros((feats.shape[1], feats.shape[1]))
    return mu, sigma


def frechet_from_features(f1: np.ndarray, f2: np.ndarray) -> float:
    """FID from raw feature matrices, using the low-rank identity.

    With centered factors A_i = (f_i - mu_i)^T / sqrt(n_i - 1) (so
    Sigma_i = A_i A_i^T), the nonzero eigenvalues of Sigma_1 Sigma_2 are the
    squared singular values of A_2^T A_1, hence
        tr sqrtm(Sigma_1 Sigma_2) = ||A_2^T A_1||_* (nuclear norm).
    That replaces two dense (d x d) eigendecompositions (seconds at d=2048)
    with one SVD of an (n_2 x n_1) matrix — exact, not an approximation.
    """
    mu1, mu2 = f1.mean(axis=0), f2.mean(axis=0)
    diff = float(((mu1 - mu2) ** 2).sum())
    n1, n2 = len(f1), len(f2)
    if n1 < 2 or n2 < 2:
        return max(diff, 0.0)
    d = f1.shape[1]
    if min(n1, n2) > d:
        # high-sample regime (standard protocol): the (n2, n1) cross matrix is
        # bigger than d x d, so the dense route is the cheap one
        _, s1 = activation_statistics(f1)
        _, s2 = activation_statistics(f2)
        return max(diff + float(np.trace(s1) + np.trace(s2))
                   - 2.0 * _matrix_sqrt_trace(s1, s2), 0.0)
    a1 = (f1 - mu1).T / np.sqrt(n1 - 1)   # (d, n1)
    a2 = (f2 - mu2).T / np.sqrt(n2 - 1)   # (d, n2)
    tr1 = float((a1 * a1).sum())          # tr(Sigma_1)
    tr2 = float((a2 * a2).sum())
    cross = a2.T @ a1                     # (n2, n1)
    nuclear = float(np.linalg.svd(cross, compute_uv=False).sum())
    return max(diff + tr1 + tr2 - 2.0 * nuclear, 0.0)


def _is_from_probs(probs: np.ndarray, splits: int) -> Tuple[float, float]:
    n = probs.shape[0]
    scores = []
    for i in range(splits):
        part = probs[i * n // splits : (i + 1) * n // splits]
        if len(part) == 0:
            continue
        py = part.mean(axis=0, keepdims=True)
        kl = part * (np.log(part + 1e-16) - np.log(py + 1e-16))
        scores.append(float(np.exp(kl.sum(axis=1).mean())))
    return float(np.mean(scores)), float(np.std(scores))


class FIDTracker:
    """Precomputes real statistics once (the reference keeps one fixed real
    batch for all evals — ``server.py:128-140``) and scores fakes against it.

    Each tracker carries its OWN inception BN statistics, calibrated on its
    real images (``inception.calibrated_stats`` — the base statistics for
    pretrained weights).  ``device``: where the network runs (None: cuda).  That makes every score a pure function of (real set, fake set):
    nothing depends on which tracker a process happened to build first, so
    seeded runs produce identical FID/IS columns across recordings."""

    def __init__(self, real_images: np.ndarray, device=None):
        self.device = resolve_device(device)
        self.stats = calibrated_stats(real_images, self.device)
        self.real_feats, _ = inception_features(real_images, self.stats, self.device)
        # Dense-regime real-side statistics, computed ONCE: the standard
        # protocol scores 10k fakes against the same 10k reals every eval
        # round, and re-deriving mu/Sigma/sqrtm(Sigma) of the real side per
        # call costs ~8 s at d=2048 on a 1-vCPU host (half the dense Frechet
        # route).  sqrtm(Sigma_real) folds the per-eval eigendecomposition of
        # the real covariance into construction; score() then needs only
        # cov(fakes) + two gemms + one eigvalsh.
        d = self.real_feats.shape[1]
        self._dense = self.real_feats.shape[0] > max(d, 2)
        if self._dense:
            self._mu, sigma = activation_statistics(self.real_feats)
            self._tr_sigma = float(np.trace(sigma))
            w, v = np.linalg.eigh(sigma)
            self._sqrt_sigma = (v * np.sqrt(np.clip(w, 0, None))) @ v.T

    def score(self, fake_images: np.ndarray) -> float:
        ff, _ = inception_features(fake_images, self.stats, self.device)
        if self._dense and ff.shape[0] > ff.shape[1]:
            # both sides in the dense regime: reuse the cached real stats
            mu2, s2 = activation_statistics(ff)
            diff = float(((self._mu - mu2) ** 2).sum())
            m = self._sqrt_sigma @ s2 @ self._sqrt_sigma
            w = np.linalg.eigvalsh((m + m.T) / 2)
            tr_cross = float(np.sqrt(np.clip(w, 0, None)).sum())
            return max(diff + self._tr_sigma + float(np.trace(s2))
                       - 2.0 * tr_cross, 0.0)
        return frechet_from_features(self.real_feats, ff)

    def inception_score(self, fake_images: np.ndarray, splits: int = 1
                        ) -> Tuple[float, float]:
        """IS under this tracker's calibrated features (same weight set as
        :meth:`score`, so a run's FID and IS columns share one feature
        space)."""
        _, probs = inception_features(fake_images, self.stats, self.device)
        return _is_from_probs(probs, splits)
