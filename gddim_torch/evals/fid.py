"""FID, Inception Score and KID on feature arrays (counterpart of
``gddim_tpu/evals/fid.py``; numpy and scipy, any extractor).

- activation statistics (mu, sigma) of pooled features;
- the Frechet distance trace(s1 + s2 - 2 sqrtm(s1 s2)) + |mu1 - mu2|^2, as
  tfgan computes it, with an eps offset where sqrtm is not finite;
- the Inception Score from logits;
- KID, tfgan's block-averaged unbiased MMD^2 with the cubic polynomial kernel.

Stats files are ``.npz`` with ``mu`` / ``sigma`` and, where they were made
here, the raw ``pool_3`` activations (for KID).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import scipy.linalg
import scipy.special


def activation_stats(features: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(mu, sigma) of an (N, D) feature matrix."""
    features = np.asarray(features, dtype=np.float64)
    mu = features.mean(axis=0)
    sigma = np.cov(features, rowvar=False)
    return mu, sigma


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """FID between two Gaussians, tfgan-compatible."""
    mu1 = np.atleast_1d(np.asarray(mu1, dtype=np.float64))
    mu2 = np.atleast_1d(np.asarray(mu2, dtype=np.float64))
    sigma1 = np.atleast_2d(np.asarray(sigma1, dtype=np.float64))
    sigma2 = np.atleast_2d(np.asarray(sigma2, dtype=np.float64))

    diff = mu1 - mu2
    # sqrtm without ``disp``: newer scipy drops the argument, and without it
    # every version returns the root alone
    covmean = scipy.linalg.sqrtm(sigma1 @ sigma2)
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = scipy.linalg.sqrtm((sigma1 + offset) @ (sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))


def inception_score(logits: np.ndarray) -> float:
    """IS = exp(E_x KL(p(y|x) || p(y))) from (N, C) logits."""
    logits = np.asarray(logits, dtype=np.float64)
    logp = logits - scipy.special.logsumexp(logits, axis=1, keepdims=True)
    p = np.exp(logp)
    p_marg = p.mean(axis=0, keepdims=True)
    kl = (p * (logp - np.log(p_marg + 1e-16))).sum(axis=1)
    return float(np.exp(kl.mean()))


def kernel_distance(pools1: np.ndarray, pools2: np.ndarray,
                    max_block_size: int = 1024, seed: int = 0) -> float:
    """KID: block-averaged unbiased MMD^2 with the polynomial kernel
    k(x, y) = (x.y / dim + 1)^3, matching
    tfgan.eval.kernel_classifier_distance_from_activations (the reference
    computes KID alongside FID, run_lib.py:598-603).

    Both sets are split into ceil(n_max / max_block_size) equal-ish blocks
    (after a deterministic shuffle) and the unbiased estimator is averaged
    over paired blocks — tfgan's exact scheme.
    """
    x = np.asarray(pools1, dtype=np.float64)
    y = np.asarray(pools2, dtype=np.float64)
    n_x, dim = x.shape
    n_y = y.shape[0]
    if min(n_x, n_y) < 2:
        raise ValueError(
            f"KID needs >=2 samples per set (got {n_x} vs {n_y}); the "
            "unbiased within-set term is undefined otherwise"
        )
    n_blocks = int(np.ceil(max(n_x, n_y) / max_block_size))
    # the unbiased within-set terms need >=2 elements per block; cap the
    # block count so the SMALLER set still yields valid blocks (tfgan
    # instead raises on very uneven sizes — a graceful degradation here)
    n_blocks = max(1, min(n_blocks, min(n_x, n_y) // 2))
    rng = np.random.default_rng(seed)
    x = x[rng.permutation(n_x)]
    y = y[rng.permutation(n_y)]
    x_blocks = np.array_split(x, n_blocks)
    y_blocks = np.array_split(y, n_blocks)

    def poly_kernel(a, b):
        return (a @ b.T / dim + 1.0) ** 3

    ests = []
    for xb, yb in zip(x_blocks, y_blocks):
        m, n = len(xb), len(yb)
        k_xx = poly_kernel(xb, xb)
        k_yy = poly_kernel(yb, yb)
        k_xy = poly_kernel(xb, yb)
        # unbiased: drop diagonals of the within-set terms
        e_xx = (k_xx.sum() - np.trace(k_xx)) / (m * (m - 1))
        e_yy = (k_yy.sum() - np.trace(k_yy)) / (n * (n - 1))
        e_xy = k_xy.mean()
        ests.append(e_xx + e_yy - 2 * e_xy)
    return float(np.mean(ests))


def load_dataset_stats(path: str | Path) -> tuple[np.ndarray, np.ndarray]:
    """Load (mu, sigma) from an npz stats file (reference evaluation.py:45-60)."""
    with np.load(path) as z:
        if "mu" in z:
            return z["mu"], z["sigma"]
        # tfgan-era files store raw pool_3 activations
        return activation_stats(z["pool_3"])


def save_dataset_stats(path: str | Path, mu: np.ndarray, sigma: np.ndarray,
                       pools: np.ndarray | None = None):
    """Write a stats file; with `pools`, raw pool_3 activations are included
    (the reference's format, run_lib.py:839-844 — required for KID)."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    extra = {"pool_3": pools} if pools is not None else {}
    np.savez_compressed(path, mu=mu, sigma=sigma, **extra)
