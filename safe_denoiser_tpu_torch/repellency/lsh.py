"""LSH-bucketed approximate repellency (the ``lsh`` method).

Counterpart of ``safe_denoiser_tpu/repellency/lsh.py``: random-projection
LSH over PCA-reduced latents. The bank is bucketed once at set-up; a call
hashes x0, gathers its bucket and runs the RBF negative denoiser (squared
distances in the exponent) on those members only.

The PCA and the hashing run on the host in numpy, as the JAX package's do;
the PCA is scikit-learn's with its exact solver, re-typed here (the GPU
machine has no scikit-learn): an SVD of the centred bank, each component's
sign set so that its largest-magnitude loading is positive
(``svd_flip(U, Vt, u_based_decision=False)``), the bank reduced as U S and
a query as (x - mean) Vt^T. scikit-learn picks that solver only for banks
with at most 500 rows and columns; past that its default is a randomized
SVD with no fixed seed, so the JAX package's buckets are not reproducible
there while these are. Only the gather and the RBF run on the device
(``_bucket_scores``, plain PyTorch).
"""

from __future__ import annotations

import numpy as np
import torch

from .methods import RepellencyProcessor, register_conditioning_method


def _bucket_scores(flat_x: torch.Tensor, refs: torch.Tensor,
                   idx: torch.Tensor, mask: torch.Tensor, *, sigma: float,
                   scale: float, epsilon: float) -> torch.Tensor:
    """One batched bucket-local RBF step: ``idx`` [N, K] gathers each
    sample's padded bucket from the bank [M, D], ``mask`` [N, K] zeroes the
    padding (an empty bucket leaves its sample unchanged). Returns
    x - scale * score, [N, D]."""
    members = refs[idx]                                     # [N, K, D]
    d2 = ((flat_x[:, None, :] - members) ** 2).sum(-1)
    w = torch.exp(-d2 / (2.0 * sigma ** 2)) * mask          # [N, K]
    score = torch.einsum("nk,nkd->nd", w, members) / (
        w.sum(-1, keepdim=True) + epsilon)
    return flat_x - scale * score


class _PCA:
    """scikit-learn's ``PCA(n_components)`` with the exact (full) solver,
    in the input's precision."""

    def __init__(self, n_components: int):
        self.n_components = n_components

    def fit_transform(self, x: np.ndarray) -> np.ndarray:
        self.mean_ = x.mean(axis=0)
        u, s, vt = np.linalg.svd(x - self.mean_, full_matrices=False)
        # svd_flip(u, vt, u_based_decision=False)
        rows = np.arange(vt.shape[0])
        signs = np.sign(vt[rows, np.abs(vt).argmax(axis=1)])
        u, vt = u * signs[None, :], vt * signs[:, None]
        k = self.n_components
        self.components_ = np.ascontiguousarray(vt[:k])
        return u[:, :k] * s[:k]

    def transform(self, x: np.ndarray) -> np.ndarray:
        return x @ self.components_.T - self.mean_[None, :] @ \
            self.components_.T


class LSHash:
    """Multi-table random-projection LSH: a point's key in a table is the
    sign bits of its products with that table's ``hash_size`` planes,
    uniform in [-1, 1) from ``np.random.RandomState(seed)``."""

    def __init__(self, hash_size: int, input_dim: int,
                 num_hashtables: int = 1, seed: int = 0):
        rng = np.random.RandomState(seed)
        self.planes = [rng.uniform(-1, 1, (hash_size, input_dim))
                       for _ in range(num_hashtables)]
        self.tables: list[dict[str, list[int]]] = [
            {} for _ in range(num_hashtables)]

    def _hash(self, plane: np.ndarray, point: np.ndarray) -> str:
        bits = (plane @ point.reshape(-1)) > 0
        return "".join("1" if b else "0" for b in bits)

    def index(self, point: np.ndarray, extra_data: int) -> None:
        for plane, table in zip(self.planes, self.tables):
            table.setdefault(self._hash(plane, point), []).append(extra_data)

    def query(self, point: np.ndarray) -> list[int]:
        """The union of the point's buckets over the tables, in order of
        first appearance."""
        out: list[int] = []
        seen = set()
        for plane, table in zip(self.planes, self.tables):
            for idx in table.get(self._hash(plane, point), []):
                if idx not in seen:
                    seen.add(idx)
                    out.append(idx)
        return out


@register_conditioning_method(name="lsh")
class LSHRepellency(RepellencyProcessor):
    """PCA -> LSH bucketing -> bucket-local RBF score."""

    method_name = "lsh"

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.n_components = int(kwargs.get("n_components", 32))
        self.hash_size = int(kwargs.get("hash_size", 8))
        self.num_hashtables = int(kwargs.get("num_hashtables", 4))

        refs = self.proj_refs.float()
        self._flat_refs = refs.reshape(refs.shape[0], -1)
        flat = self._flat_refs.cpu().numpy()
        self.pca = _PCA(min(self.n_components, *flat.shape))
        reduced = self.pca.fit_transform(flat)
        self.lsh = LSHash(self.hash_size, reduced.shape[1],
                          self.num_hashtables)
        for i, p in enumerate(reduced):
            self.lsh.index(p, i)

    def buckets(self, flat: np.ndarray) -> list[list[int]]:
        """Each row's bank members, from the host-side hash."""
        reduced = self.pca.transform(flat)
        return [self.lsh.query(reduced[i]) for i in range(len(flat))]

    def conditioning(self, x_0_hat, **kwargs) -> dict:
        """One padded [N, K] bucket matrix from the host queries (K the
        next power of two over the largest bucket), then one gather + RBF
        pass on x0's device. No member in any bucket: x0 unchanged and
        is_negation False."""
        x = torch.as_tensor(x_0_hat).float()
        n = x.shape[0]
        flat_x = x.reshape(n, -1)
        buckets = self.buckets(flat_x.cpu().numpy())
        if not any(buckets):
            return {"x_0_hat": x, "is_negation": False, "mean_x_0_hat": None}
        k = max(1, 1 << (max(len(b) for b in buckets) - 1).bit_length())
        idx = np.zeros((n, k), dtype=np.int64)
        mask = np.zeros((n, k), dtype=np.float32)
        for i, b in enumerate(buckets):
            idx[i, :len(b)] = b
            mask[i, :len(b)] = 1.0
        out = _bucket_scores(
            flat_x, self._flat_refs.to(x.device),
            torch.from_numpy(idx).to(x.device),
            torch.from_numpy(mask).to(x.device),
            sigma=float(self.sigma), scale=float(self.scale),
            epsilon=float(self.epsilon))
        return {"x_0_hat": out.reshape(x.shape), "is_negation": True,
                "mean_x_0_hat": None}
