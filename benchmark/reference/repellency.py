"""The safe denoiser's kernel_fast repellency (the paper's Eq. for the
empirical negative denoiser's score), plain PyTorch in float64:

    w_j = exp(-||x - r_j|| / (2 sigma^2)),
    score = sum_j w_j r_j / (sum_j w_j + eps),   x0' = x0 - scale * score,

against a bank of negative latents normalized over the channel axis; with
``normalize_x`` (SD3) x is normalized so too before the distances. Applied
on every step of its window: the beta gate is off.
"""

from __future__ import annotations

import torch


def channel_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=1, keepdim=True)


def repel(x0: torch.Tensor, bank: torch.Tensor, sigma: float, scale: float,
          normalize_x: bool, eps: float = 1e-8) -> torch.Tensor:
    """x0 [N, C, H, W] moved away from ``bank`` [M, C, H, W] (already
    channel-normalized)."""
    n = x0.shape[0]
    x = (channel_normalize(x0) if normalize_x else x0).reshape(n, -1)
    r = bank.reshape(bank.shape[0], -1).double()
    dist = torch.stack([torch.linalg.vector_norm(r - xi.double(), dim=1)
                        for xi in x])                       # [N, M]
    w = torch.exp(-dist / (2.0 * sigma ** 2))
    score = (w @ r) / (w.sum(-1, keepdim=True) + eps)
    return x0 - scale * score.reshape(x0.shape).to(x0.dtype)
