"""Distribution metrics: FID, KID, Inception Score (feature-space math).

Counterpart of ``safe_denoiser_tpu/evals/metrics.py``, copied (numpy +
scipy, no framework) but for ``sqrtm``'s ``disp`` argument, which newer
scipy removed (the matrix is the same):

  * FID — Fréchet distance over InceptionV3 pool3 activations, with
    pytorch-fid's ε-offset retry when ``sqrtm`` is not finite and its
    imaginary-part check; the O(D³) ``sqrtm`` runs in scipy on the host,
    once per run.
  * KID — torchmetrics KernelInceptionDistance semantics: polynomial kernel
    (d=3, γ=1/D, c=1), unbiased MMD² over ``subsets`` random subsets of
    ``subset_size`` rows drawn from ``RandomState(seed)``.
  * IS — exp(mean KL(p(y|x) ‖ p(y))) over logit softmaxes, per split.

The features come from ``evals/inception.py``.
"""

from __future__ import annotations

import numpy as np


def stats_from_features(feats: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(μ [D], Σ [D, D]) of a feature matrix [N, D]."""
    feats = np.asarray(feats, dtype=np.float64)
    mu = feats.mean(axis=0)
    sigma = np.cov(feats, rowvar=False)
    return mu, sigma


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """FID between two Gaussians (pytorch-fid semantics incl. the eps-jitter
    retry and imaginary-part check)."""
    from scipy import linalg

    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2

    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            raise ValueError(
                f"Imaginary component {np.max(np.abs(covmean.imag))}")
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * np.trace(covmean))


def _poly_kernel(x: np.ndarray, y: np.ndarray, degree=3, gamma=None, coef=1.0):
    if gamma is None:
        gamma = 1.0 / x.shape[1]
    return (x @ y.T * gamma + coef) ** degree


def _mmd2_unbiased(k_xx, k_yy, k_xy) -> float:
    m = k_xx.shape[0]
    diag_x = np.diagonal(k_xx).sum()
    diag_y = np.diagonal(k_yy).sum()
    kt_xx = (k_xx.sum() - diag_x) / (m * (m - 1))
    kt_yy = (k_yy.sum() - diag_y) / (m * (m - 1))
    k_xy_m = k_xy.mean()
    return float(kt_xx + kt_yy - 2 * k_xy_m)


def kid_from_features(real: np.ndarray, fake: np.ndarray,
                      subsets: int = 100, subset_size: int = 50,
                      seed: int = 0) -> tuple[float, float]:
    """(mean, std) of MMD² over random subsets (torchmetrics KID defaults)."""
    rng = np.random.RandomState(seed)
    real = np.asarray(real, dtype=np.float64)
    fake = np.asarray(fake, dtype=np.float64)
    subset_size = min(subset_size, len(real), len(fake))
    vals = []
    for _ in range(subsets):
        ri = rng.choice(len(real), subset_size, replace=False)
        fi = rng.choice(len(fake), subset_size, replace=False)
        x, y = real[ri], fake[fi]
        vals.append(_mmd2_unbiased(_poly_kernel(x, x), _poly_kernel(y, y),
                                   _poly_kernel(x, y)))
    return float(np.mean(vals)), float(np.std(vals))


def inception_score_from_logits(logits: np.ndarray,
                                splits: int = 10) -> tuple[float, float]:
    """exp(mean KL(p(y|x) ‖ p(y))) per split; returns (mean, std)."""
    x = np.asarray(logits, dtype=np.float64)
    x = x - x.max(axis=1, keepdims=True)
    p = np.exp(x)
    p /= p.sum(axis=1, keepdims=True)
    scores = []
    n = len(p)
    for i in range(splits):
        part = p[i * n // splits:(i + 1) * n // splits]
        if len(part) == 0:
            continue
        py = part.mean(axis=0, keepdims=True)
        kl = (part * (np.log(part + 1e-16) - np.log(py + 1e-16))).sum(axis=1)
        scores.append(np.exp(kl.mean()))
    return float(np.mean(scores)), float(np.std(scores))
