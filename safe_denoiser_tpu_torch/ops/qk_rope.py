"""FLUX's per-head RMSNorm and rotary position embedding on the attention's
q and k in one pass (CUDA, ``csrc/qk_rope.cu``), writing the joint q and k
(and, for two streams, v) buffers that the attention kernel reads; its
plain version; the test of which tensors the kernel takes.

The joint sequence is one or two *segments*, in joint order, each a tuple
``(q, k, v, wq, wk)``: q, k, v [B, S_i, H, D] (views of the projections'
[B, S_i, H*D] rows) and the RMSNorm weights [D] of q and k. FLUX's double
block gives two ([text ; image], each stream its own projections and
weights), its single block one. For every head row of q and k:

    y = x * rsqrt(mean(x^2) + eps) * w,
    out = y * cos[s] + rot(y) * sin[s],   rot: (a, b) -> (-b, a) pairwise,

with s the row's position in the joint sequence and cos, sin the f32
[S, D] rotary tables (``models/flux.py::rope_tables``). Returns the joint
(q, k, v), each contiguous [B, S, H, D]: v is the segment's own where there
is one, else the segments' v joined (the same launch copies it).

The kernel replaces no TPU kernel (the JAX package has no FLUX). The eager
form is about ten launches a tensor with an f32 round trip, then the cat;
the kernel is bound by bytes: at FLUX.1-dev's double block [1, 4608, 24,
128] bf16 it moves 174.6 MB, 52 us at 3.35 TB/s. Design notes in the
source.

Numerics are ``qk_rope_ref``'s: f32 inside, each output rounded to the
stream's dtype once. A CUDA tensor launches the kernel or raises (``fits``
says which it takes); a CPU tensor takes the plain version. The kernel has
no backward: its CUDA wrapper raises under autograd (``_grad.
check_no_grad``); the plain version is differentiable as it stands.
"""

from __future__ import annotations

from typing import Sequence

import torch

from . import _build
from ._grad import acc_dtype, check_no_grad

launches = 0   # kernel launches of qk_rope on CUDA tensors

EPS = 1e-6
HEAD_DIMS = (32, 64, 128, 256)   # csrc/qk_rope.cu: D / 8 lanes a head row
_DTYPES = {torch.bfloat16: 0, torch.float32: 2}


def rotate_pairs(y: torch.Tensor) -> torch.Tensor:
    """Each adjacent pair (a, b) of the last dim mapped to (-b, a): the
    rotary's quarter turn with its frequencies repeated pairwise
    (diffusers' ``apply_rotary_emb`` with ``use_real_unbind_dim=-1``)."""
    a, b = y[..., 0::2], y[..., 1::2]
    return torch.stack([-b, a], dim=-1).flatten(-2)


def rms_rope_ref(x: torch.Tensor, w: torch.Tensor, cos: torch.Tensor,
                 sin: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """Plain version on one tensor x [B, S, H, D] with cos, sin [S, D]: the
    head's RMSNorm with weight w [D] and the rotary in f32 (f64 for f64 x),
    rounded to x's dtype once."""
    acc = acc_dtype(x)
    xf = x.to(acc)
    y = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps) * w.to(acc)
    c, s = cos.to(acc)[:, None], sin.to(acc)[:, None]
    return (y * c + rotate_pairs(y) * s).to(x.dtype)


def qk_rope_ref(segments: Sequence[tuple], cos: torch.Tensor,
                sin: torch.Tensor, eps: float = EPS) -> tuple:
    """Plain version of the kernel: the joint (q, k, v) of the module's
    docstring."""
    qs, ks, start = [], [], 0
    for q, k, _, wq, wk in segments:
        n = q.shape[1]
        qs.append(rms_rope_ref(q, wq, cos[start:start + n],
                               sin[start:start + n], eps))
        ks.append(rms_rope_ref(k, wk, cos[start:start + n],
                               sin[start:start + n], eps))
        start += n
    if len(segments) == 1:
        return qs[0], ks[0], segments[0][2]
    return (torch.cat(qs, 1), torch.cat(ks, 1),
            torch.cat([seg[2] for seg in segments], 1))


def _row_layout(t: torch.Tensor, head_dim: int) -> bool:
    """Heads contiguous in a row (head stride D, unit last stride), batch
    and token strides whole vectors of 8 values, a 16-byte aligned start."""
    return (t.stride(3) == 1 and t.stride(2) == head_dim
            and t.stride(0) % 8 == 0 and t.stride(1) % 8 == 0
            and t.data_ptr() % 16 == 0)


def fits(segments: Sequence[tuple], cos: torch.Tensor,
         sin: torch.Tensor) -> bool:
    """Whether the kernel takes these tensors, on any device: one or two
    segments of q, k, v [B, S_i, H, D] of one bf16 or f32 dtype, one shape
    and one stride a segment (``_row_layout``), B, H and D shared, D in
    ``HEAD_DIMS``; weights [D] contiguous of that dtype; cos and sin f32
    [sum S_i, D] contiguous; all on one device, 16-byte aligned."""
    if not 1 <= len(segments) <= 2:
        return False
    q0 = segments[0][0]
    if q0.dim() != 4 or q0.dtype not in _DTYPES:
        return False
    b, _, h, d = q0.shape
    total = sum(seg[0].shape[1] for seg in segments)
    tables = all(t.dtype == torch.float32 and t.shape == (total, d)
                 and t.is_contiguous() and t.device == q0.device
                 and t.data_ptr() % 16 == 0 for t in (cos, sin))
    ok = d in HEAD_DIMS and tables
    for q, k, v, wq, wk in segments:
        ok = ok and all(
            t.dim() == 4 and t.shape == q.shape and t.stride() == q.stride()
            and t.dtype == q0.dtype and t.device == q0.device
            and _row_layout(t, d) for t in (q, k, v))
        ok = ok and q.shape[0] == b and q.shape[2:] == (h, d)
        ok = ok and all(w.shape == (d,) and w.dtype == q0.dtype
                        and w.is_contiguous() and w.device == q0.device
                        and w.data_ptr() % 16 == 0 for w in (wq, wk))
    return ok


def _qk_rope_cuda(segments, cos, sin, eps):
    global launches
    check_no_grad("qk_rope", *(t for seg in segments for t in seg))
    if not segments[0][0].is_cuda or not fits(segments, cos, sin):
        q = segments[0][0]
        raise ValueError(
            f"qk_rope takes one or two segments of bf16 or f32 q/k/v [B, S, "
            f"H, D] with D in {HEAD_DIMS}, contiguous heads and 16-byte "
            f"strides and starts, [D] weights of their dtype and f32 [S, D] "
            f"cos/sin tables, on one GPU; got q {q.dtype} {tuple(q.shape)} "
            f"strides {q.stride()} on {q.device}")
    q0 = segments[0][0]
    b, _, h, d = q0.shape
    total = cos.shape[0]
    shape = (b, total, h, d)
    q_out = torch.empty(shape, dtype=q0.dtype, device=q0.device)
    k_out = torch.empty_like(q_out)
    v_out = torch.empty_like(q_out) if len(segments) == 2 else None

    def seg_args(seg):
        if seg is None:
            return (0,) * 5 + (0, 0, 0)
        q, k, v, wq, wk = seg
        return (q.data_ptr(), k.data_ptr(), v.data_ptr(), wq.data_ptr(),
                wk.data_ptr(), q.stride(0), q.stride(1), q.shape[1])

    second = segments[1] if len(segments) == 2 else None
    err = _build.library("qk_rope").sdt_qk_rope(
        *seg_args(segments[0]), *seg_args(second), cos.data_ptr(),
        sin.data_ptr(), q_out.data_ptr(), k_out.data_ptr(),
        0 if v_out is None else v_out.data_ptr(), _DTYPES[q0.dtype], b, h,
        d, float(eps), _build.stream_ptr(q0.device))
    _build.check(err, "sdt_qk_rope")
    launches += 1
    return q_out, k_out, (segments[0][2] if v_out is None else v_out)


def qk_rope(segments: Sequence[tuple], cos: torch.Tensor, sin: torch.Tensor,
            eps: float = EPS) -> tuple:
    """The joint (q, k, v) of the module's docstring: the kernel for CUDA
    tensors (or a ``ValueError``), the plain version for CPU tensors."""
    if _build.takes_plain(segments[0][0]):
        return qk_rope_ref(segments, cos, sin, eps)
    return _qk_rope_cuda(segments, cos, sin, eps)
