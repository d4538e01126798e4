"""GroupNorm with f32 statistics: the plain forms, the affine coefficients,
and the one-read statistics kernel (Triton) with its plain version.

Counterpart of ``safe_denoiser_tpu/ops/group_norm.py`` (the default path:
the fused ``_gn_kernel`` behind SDT_FUSED_GN is not ported yet). Layout is
the JAX package's ``[B, S, C]``.

The statistics kernel replaces ``_gn_stats_kernel``: per-(b, c) f32 sum and
sum of squares of a [B, S, C] activation in one read. It is bound by bytes
(the read of x at 3.35 TB/s: 268 MB, ~80 us, at the VAE's 512^2 x 128 x 4
bf16). Design: pass 1 splits S across programs so that even the VAE's
[4, 262144, 128], which has only 4 (b, c-tile) pairs, fills the 132 SMs;
each program sums its row range of one 128-channel tile with masked
coalesced block loads and writes f32 partials; pass 2 adds the partials in
a fixed order (no atomics, so the sums are deterministic). ``triton`` is
imported inside the launching function: the CPU host has none.
"""

from __future__ import annotations

import functools

import torch

launches = 0   # kernel launches of gn_stats on CUDA tensors

_STATS_MAX_ELEMS = 1 << 19
_STATS_MIN_ELEMS = 1 << 21   # the JAX package's SDT_GN_STATS_MIN default
_BLOCK_S, _BLOCK_C = 32, 128
_TARGET_PROGRAMS = 4 * 132   # a few waves of the H100's SMs


def _stats_chunk(s: int, c: int) -> int:
    """The JAX package's row chunk for its stats kernel; kept so the
    dispatch gate below takes exactly the same shapes."""
    chunk = s
    while chunk * c > _STATS_MAX_ELEMS and chunk % 2 == 0:
        chunk //= 2
    return chunk


def gn_stats_ref(x: torch.Tensor):
    """Plain version: [B, S, C] -> (sum [B, C], sumsq [B, C]) in f32."""
    xf = x.float()
    return xf.sum(1), (xf * xf).sum(1)


# The Triton kernels are plain functions here and become kernels in
# _triton_kernels(), which imports triton at first launch; ``tl`` is bound
# there too (the annotations stay strings, see the __future__ import).
tl = None


def _partial_sums(x_ptr, p1_ptr, p2_ptr, S, C, rows_per_split, n_split,
                  BLOCK_S: tl.constexpr, BLOCK_C: tl.constexpr):
    b = tl.program_id(0)
    sp = tl.program_id(1)
    cb = tl.program_id(2)
    cols = cb * BLOCK_C + tl.arange(0, BLOCK_C)
    cmask = cols < C
    base = x_ptr + b.to(tl.int64) * S * C
    acc1 = tl.zeros((BLOCK_S, BLOCK_C), dtype=tl.float32)
    acc2 = tl.zeros((BLOCK_S, BLOCK_C), dtype=tl.float32)
    start = sp * rows_per_split
    for r0 in range(0, rows_per_split, BLOCK_S):
        rows = start + r0 + tl.arange(0, BLOCK_S)
        mask = (rows < S)[:, None] & cmask[None, :]
        ptrs = base + rows.to(tl.int64)[:, None] * C + cols[None, :]
        xv = tl.load(ptrs, mask=mask, other=0.0).to(tl.float32)
        acc1 += xv
        acc2 += xv * xv
    off = (b * n_split + sp) * C + cols
    tl.store(p1_ptr + off, tl.sum(acc1, axis=0), mask=cmask)
    tl.store(p2_ptr + off, tl.sum(acc2, axis=0), mask=cmask)


def _finish(p1_ptr, p2_ptr, s1_ptr, s2_ptr, C, n_split,
            BLOCK_C: tl.constexpr):
    b = tl.program_id(0)
    cb = tl.program_id(1)
    cols = cb * BLOCK_C + tl.arange(0, BLOCK_C)
    cmask = cols < C
    a1 = tl.zeros((BLOCK_C,), dtype=tl.float32)
    a2 = tl.zeros((BLOCK_C,), dtype=tl.float32)
    for sp in range(0, n_split):
        off = (b * n_split + sp) * C + cols
        a1 += tl.load(p1_ptr + off, mask=cmask, other=0.0)
        a2 += tl.load(p2_ptr + off, mask=cmask, other=0.0)
    tl.store(s1_ptr + b * C + cols, a1, mask=cmask)
    tl.store(s2_ptr + b * C + cols, a2, mask=cmask)


@functools.lru_cache(maxsize=None)
def _triton_kernels():
    global tl
    import triton
    import triton.language

    tl = triton.language
    return triton.jit(_partial_sums), triton.jit(_finish)


def _split(b: int, s: int, c: int) -> tuple[int, int]:
    """(n_split, rows_per_split): enough programs to fill the card."""
    c_tiles = -(-c // _BLOCK_C)
    max_split = -(-s // _BLOCK_S)
    n_split = max(1, min(max_split, -(-_TARGET_PROGRAMS // (b * c_tiles))))
    rows = -(-s // n_split)
    rows = -(-rows // _BLOCK_S) * _BLOCK_S
    return -(-s // rows), rows


def _gn_stats_cuda(x: torch.Tensor):
    global launches
    if not x.is_cuda:
        raise ValueError("x must lie on the GPU")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"gn_stats takes a contiguous [B,S,C], got "
                         f"{tuple(x.shape)} strides {x.stride()}")
    if x.dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise ValueError(f"gn_stats: unsupported dtype {x.dtype}")
    b, s, c = x.shape
    partial_sums, finish = _triton_kernels()
    n_split, rows = _split(b, s, c)
    c_tiles = -(-c // _BLOCK_C)
    p1 = torch.empty((b, n_split, c), dtype=torch.float32, device=x.device)
    p2 = torch.empty_like(p1)
    s1 = torch.empty((b, c), dtype=torch.float32, device=x.device)
    s2 = torch.empty_like(s1)
    partial_sums[(b, n_split, c_tiles)](x, p1, p2, s, c, rows, n_split,
                                        BLOCK_S=_BLOCK_S, BLOCK_C=_BLOCK_C,
                                        num_warps=4)
    finish[(b, c_tiles)](p1, p2, s1, s2, c, n_split, BLOCK_C=_BLOCK_C,
                         num_warps=4)
    launches += 1
    return s1, s2


def gn_stats(x: torch.Tensor):
    """[B, S, C] -> (sum [B, C], sumsq [B, C]) in f32, reading x once. A
    CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
    version."""
    if x.device.type == "cpu":
        return gn_stats_ref(x)
    return _gn_stats_cuda(x)


def takes_stats_kernel(s: int, c: int) -> bool:
    """Whether ``gn_affine_coefs`` sends an [B, S, C] activation to the
    one-read statistics kernel: C >= 128 and S*C >= 2**21, the JAX
    package's gate, with a row chunk that fits its block."""
    return (c >= 128 and s * c >= _STATS_MIN_ELEMS
            and _stats_chunk(s, c) * c <= _STATS_MAX_ELEMS)


def gn_affine_coefs(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    groups: int, epsilon: float = 1e-6):
    """[B, S, C] -> f32 (a_c, b_c) [B, C] with GN(x)*scale+bias ==
    x*a_c + b_c. Large activations (``takes_stats_kernel``) take the
    one-read statistics kernel."""
    b, s, c = x.shape
    if takes_stats_kernel(s, c):
        s1, s2 = gn_stats(x)
    else:
        s1, s2 = gn_stats_ref(x)
    n = float(s * (c // groups))
    mean = s1.reshape(b, groups, -1).sum(-1) / n
    var = s2.reshape(b, groups, -1).sum(-1) / n - mean * mean
    inv = torch.rsqrt(var + epsilon)                       # [B, G]
    a_c = inv.repeat_interleave(c // groups, dim=1) * scale.float()
    b_c = bias.float() - mean.repeat_interleave(c // groups, dim=1) * a_c
    return a_c, b_c


def group_norm_ref(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   groups: int, epsilon: float = 1e-6,
                   act: str | None = None) -> torch.Tensor:
    """GroupNorm over [B, S, C] with f32 statistics (+ SiLU).

    f32 inputs take the two-pass mean/variance. bf16 inputs take the fast
    form of the JAX package: one-pass sum/sumsq statistics folded into
    per-channel (a_c, b_c), and the affine and SiLU applied at bf16."""
    b, s, c = x.shape
    if x.dtype == torch.bfloat16:
        a_c, b_c = gn_affine_coefs(x, scale, bias, groups, epsilon)
        y = x * a_c.to(x.dtype)[:, None, :] + b_c.to(x.dtype)[:, None, :]
        if act == "silu":
            y = y * torch.sigmoid(y)
        return y
    xf = x.float().reshape(b, s, groups, c // groups)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=(1, 3), keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + epsilon)
    y = y.reshape(b, s, c) * scale.float() + bias.float()
    if act == "silu":
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)
