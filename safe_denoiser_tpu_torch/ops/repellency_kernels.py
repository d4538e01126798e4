"""Repellency math: the kernel_fast RBF score (CUDA kernel ``csrc/rbf.cu``
plus its plain PyTorch version) and the plain pairwise-distance and sparse
(SPELL) force.

Counterpart of ``safe_denoiser_tpu/ops/repellency_kernels.py``. For
x [N, D] and a bank R [M, D]:

    w_ij = exp(-||x_i - r_j|| / (2 sigma^2))
    score_i = sum_j w_ij r_j / (sum_j w_ij + eps),   beta_i = sum_j w_ij + eps

``normalize=False`` returns the raw partials (sum_j w_ij r_j, sum_j w_ij).
All of it runs in f32. The plain products are full f32 on the GPU as long
as ``torch.backends.cuda.matmul.allow_tf32`` keeps its default (False),
the counterpart of the reference's Precision.HIGHEST.
"""

from __future__ import annotations

import torch

from . import _build

launches = 0   # kernel launches of rbf_negative_score on CUDA tensors
N_MAX = 16     # rows of x the kernel takes (csrc/rbf.cu NMAX)


def _pairwise_dist(x: torch.Tensor, refs: torch.Tensor) -> torch.Tensor:
    """Euclidean distance matrix [N, M] via the Gram decomposition (f32)."""
    x = x.float()
    refs = refs.float()
    x2 = (x * x).sum(-1, keepdim=True)              # [N, 1]
    r2 = (refs * refs).sum(-1)[None, :]             # [1, M]
    g = x @ refs.T                                  # [N, M]
    return torch.sqrt(torch.clamp(x2 + r2 - 2.0 * g, min=0.0))


def rbf_negative_score_ref(x: torch.Tensor, refs: torch.Tensor, sigma: float,
                           epsilon: float = 1e-8, normalize: bool = True):
    """Plain version. x [N, D], refs [M, D] -> (score [N, D], beta [N])."""
    dist = _pairwise_dist(x, refs)
    w = torch.exp(-dist / (2.0 * sigma ** 2))
    num = w @ refs.float()
    if not normalize:
        return num, w.sum(-1)
    beta = w.sum(-1) + epsilon
    return num / beta[:, None], beta


def _rbf_cuda(x, refs, sigma: float, epsilon: float, normalize: bool):
    global launches
    if not (x.is_cuda and x.device == refs.device):
        raise ValueError("x and refs must both lie on one GPU")
    if x.dtype != torch.float32 or refs.dtype != torch.float32:
        raise ValueError(f"rbf kernel takes f32, got {x.dtype}/{refs.dtype}")
    if x.dim() != 2 or refs.dim() != 2 or x.shape[1] != refs.shape[1]:
        raise ValueError(f"x [N,D] and refs [M,D] expected: "
                         f"{tuple(x.shape)} {tuple(refs.shape)}")
    if not (x.is_contiguous() and refs.is_contiguous()):
        raise ValueError("x and refs must be contiguous")
    n, d = x.shape
    m = refs.shape[0]
    if not 1 <= n <= N_MAX or m < 1:
        raise ValueError(f"rbf kernel takes 1..{N_MAX} rows of x and a "
                         f"non-empty bank, got N={n}, M={m}")
    fn = _build.library("rbf").sdt_rbf_score_f32
    w =torch.empty((n, m), dtype=torch.float32, device=x.device)
    num = torch.empty((n, d), dtype=torch.float32, device=x.device)
    beta = torch.empty((n,), dtype=torch.float32, device=x.device)
    err = fn(x.data_ptr(), refs.data_ptr(), w.data_ptr(), num.data_ptr(),
             beta.data_ptr(), n, m, d, float(2.0 * sigma ** 2),
             float(epsilon), int(bool(normalize)),
             _build.stream_ptr(x.device))
    _build.check(err, "sdt_rbf_score_f32")
    launches += 1
    return num, beta


def rbf_negative_score(x: torch.Tensor, refs: torch.Tensor, sigma: float,
                       epsilon: float = 1e-8, normalize: bool = True):
    """(score [N, D], beta [N]); ``normalize=False`` gives the raw partials.
    A CUDA tensor launches the kernel or raises; a CPU tensor takes the
    plain version."""
    if x.device.type == "cpu":
        return rbf_negative_score_ref(x, refs, sigma, epsilon, normalize)
    return _rbf_cuda(x, refs, sigma, epsilon, normalize)


def sparse_repellency_force(x: torch.Tensor, refs: torch.Tensor,
                            radius: float, raw: bool = False):
    """SPELL-style truncated repulsion: force_i = sum_j c_ij (x_i - r_j) with
    c_ij = relu(radius/d_ij - 1) for d_ij < radius. Returns (force [N, D],
    sum_j c_ij [N]); ``raw=True`` returns (sum_j c_ij r_j, sum_j c_ij).
    Plain PyTorch."""
    dist = _pairwise_dist(x, refs)
    c = torch.where(dist < radius,
                    torch.relu(radius / torch.clamp(dist, min=1e-20) - 1.0),
                    torch.zeros_like(dist))
    c_sum = c.sum(-1)
    cr = c @ refs.float()
    if raw:
        return cr, c_sum
    return x.float() * c_sum[:, None] - cr, c_sum
