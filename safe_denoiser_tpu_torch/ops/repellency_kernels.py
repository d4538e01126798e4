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

import functools
from typing import NamedTuple

import torch

from . import _build
from ._grad import check_no_grad

launches = 0   # kernel launches of rbf_negative_score on CUDA tensors
N_MAX = 16     # rows of x the kernel takes (csrc/rbf.cu NMAX)


class RBFPlan(NamedTuple):
    """The kernel's walk of one shape (``csrc/rbf.cu``)."""
    vec: int      # floats a load: 4 (16 bytes) or 1
    mr: int       # pass 1: bank rows a block (its 8 warps split the slice;
    #               a lane reads x once for all of them)
    cl1: int      # pass 1: blocks a cluster, splitting D
    ds: int       # pass 1: columns a block's D-slice (the last one fewer)
    cl2: int      # pass 2: blocks a cluster, splitting M
    ms: int       # pass 2: bank rows a block (the last one fewer)


_RBF_WARPS = 8               # warps of a pass-1 block: parts of its slice
_RBF_TILE = 128              # threads of a pass-2 block: a tile of 128 * vec
_RBF_FILL1 = 2 * 132         # pass-1 blocks: two a SM (one wave)
_RBF_FILL2 = 4 * 132         # pass-2 blocks: four a SM
_RBF_SLICE_MIN = 1024        # columns: the least D-slice worth a block


def _pow2_at_least(v: int) -> int:
    return 1 << max(0, v - 1).bit_length()


def _pow2_at_most(v: int) -> int:
    return 1 << (max(1, v).bit_length() - 1)


@functools.lru_cache(maxsize=64)
def rbf_plan(n: int, m: int, d: int, vec: int) -> RBFPlan:
    """The kernel's plan for x [n, d] against a bank [m, d]. Pass 1: the
    most bank rows a block (8, or 4 for n > 8, then fewer) at which
    clusters of up to 16 D-slices of at least 1024 columns fill the card
    in one wave (132 to 264 blocks: two a SM fit). Pass 2: clusters of
    enough of M's runs (up to 16) beside the D tiles for 528 blocks.
    Cluster sizes are powers of two (the last blocks may find no work)."""
    slices = _pow2_at_most(d // _RBF_SLICE_MIN)
    for mr in (8, 4, 2, 1):
        if mr > (8 if n <= 8 else 4):
            continue
        chunks = -(-m // mr)
        cl1 = min(16, slices, _pow2_at_most(_RBF_FILL1 // chunks))
        if chunks * cl1 >= _RBF_FILL1 // 2:
            break
    tiles = -(-d // (_RBF_TILE * vec))
    cl2 = min(16, _pow2_at_least(m), _pow2_at_least(-(-_RBF_FILL2 // tiles)))
    return RBFPlan(vec, mr, cl1, -(-(-(-d // cl1)) // 4) * 4, cl2,
                   -(-m // cl2))


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
    check_no_grad("rbf (B2)", x, refs)
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
    w = torch.empty((n, m), dtype=torch.float32, device=x.device)
    num = torch.empty((n, d), dtype=torch.float32, device=x.device)
    beta = torch.empty((n,), dtype=torch.float32, device=x.device)
    aligned = (x.data_ptr() | refs.data_ptr()) % 16 == 0
    plan = rbf_plan(n, m, d, 4 if d % 4 == 0 and aligned else 1)
    err = fn(x.data_ptr(), refs.data_ptr(), w.data_ptr(), num.data_ptr(),
             beta.data_ptr(), n, m, d, float(2.0 * sigma ** 2),
             float(epsilon), int(bool(normalize)), *plan,
             _build.stream_ptr(x.device))
    _build.check(err, "sdt_rbf_score_f32")
    launches += 1
    return num, beta


def rbf_negative_score(x: torch.Tensor, refs: torch.Tensor, sigma: float,
                       epsilon: float = 1e-8, normalize: bool = True):
    """(score [N, D], beta [N]); ``normalize=False`` gives the raw partials.
    A CUDA tensor launches the kernel or raises; a CPU tensor takes the
    plain version."""
    if _build.takes_plain(x):
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
