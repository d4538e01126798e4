"""GroupNorm with f32 statistics: the plain forms, the affine coefficients,
the one-read statistics kernel (Triton) and the fused GroupNorm(+SiLU)
kernel (CUDA, ``csrc/group_norm.cu``), each with its plain version, and the
dispatch between them.

Counterpart of ``safe_denoiser_tpu/ops/group_norm.py``. Layout is the JAX
package's ``[B, S, C]``. The switches are read at each call:
SDT_FAST_SILU (default 1: bf16 takes the fast forms), SDT_GN_STATS_MIN
(log2 elements above which ``gn_affine_coefs`` takes the statistics
kernel, default 21) and SDT_FUSED_GN (1: ``group_norm`` takes the fused
kernel for the shapes the JAX package's gate admits).

The statistics kernel replaces ``_gn_stats_kernel``: per-(b, c) f32 sum and
sum of squares of a [B, S, C] activation in one read. It is bound by bytes
(the read of x at 3.35 TB/s: 268 MB, ~80 us, at the VAE's 512^2 x 128 x 4
bf16). Design: pass 1 splits S across programs so that even the VAE's
[4, 262144, 128], which has only 4 (b, c-tile) pairs, fills the 132 SMs;
each program sums its row range of one 128-channel tile with masked
coalesced block loads and writes f32 partials; pass 2 adds the partials in
a fixed order (no atomics, so the sums are deterministic). ``triton`` is
imported inside the launching function: the CPU host has none.

The fused kernel replaces ``_gn_kernel``: the whole GroupNorm (+SiLU) of a
[B, S, C] activation in one launch, bound by one read and one write of x
(41.9 MB, 12.5 us, at the UNet's [8, 4096, 320] bf16). ``gn_plan`` cuts
each batch row into tiles of whole groups along C, one thread-block
cluster a tile, whose blocks split the rows; a block keeps its slice of x
in shared memory where it fits (one read of x), sums it per group, and the
cluster adds its blocks' sums in rank order through distributed shared
memory before the block writes y (design notes in the source). The
numerics are those of ``group_norm_fused_ref``.
"""

from __future__ import annotations

import functools
import os
from typing import NamedTuple

import torch

from . import _build
from ._grad import acc_dtype, check_no_grad, needs_grad

launches = 0         # kernel launches of gn_stats on CUDA tensors
bwd_launches = 0     # kernel launches of its backward (B5b, Triton)
fused_launches = 0   # kernel launches of group_norm_fused on CUDA tensors

_STATS_MAX_ELEMS = 1 << 19
_BLOCK_S, _BLOCK_C = 32, 128
_TARGET_PROGRAMS = 4 * 132   # a few waves of the H100's SMs
# the JAX package's gate of its fused kernel (one VMEM tile of x per batch
# row, S tiles of 512 rows)
_FUSED_MAX_ELEMS = 4096 * 320
_S_TILE = 512


def fast_act_ok(dtype: torch.dtype) -> bool:
    """Whether bf16 takes the fast forms (GroupNorm's one-pass statistics
    with the affine and SiLU at bf16, LayerNorm's affine at bf16): bf16 and
    SDT_FAST_SILU (default "1") equal to "1". Counterpart of
    ``_fast_act_ok``; read at each call."""
    return (dtype == torch.bfloat16
            and os.environ.get("SDT_FAST_SILU", "1") == "1")


def _stats_chunk(s: int, c: int) -> int:
    """The JAX package's row chunk for its stats kernel; kept so the
    dispatch gate below takes exactly the same shapes."""
    chunk = s
    while chunk * c > _STATS_MAX_ELEMS and chunk % 2 == 0:
        chunk //= 2
    return chunk


def gn_stats_ref(x: torch.Tensor):
    """Plain version: [B, S, C] -> (sum [B, C], sumsq [B, C]) in f32 (f64
    for f64 x)."""
    xf = x.to(acc_dtype(x))
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


def _stats_bwd(x_ptr, ds1_ptr, ds2_ptr, dx_ptr, S, C, BLOCK_S: tl.constexpr,
               BLOCK_C: tl.constexpr):
    b = tl.program_id(0)
    sb = tl.program_id(1)
    cb = tl.program_id(2)
    rows = sb * BLOCK_S + tl.arange(0, BLOCK_S)
    cols = cb * BLOCK_C + tl.arange(0, BLOCK_C)
    cmask = cols < C
    mask = (rows < S)[:, None] & cmask[None, :]
    off = (b.to(tl.int64) * S * C + rows.to(tl.int64)[:, None] * C
           + cols[None, :])
    xv = tl.load(x_ptr + off, mask=mask, other=0.0).to(tl.float32)
    d1 = tl.load(ds1_ptr + b * C + cols, mask=cmask, other=0.0)
    d2 = tl.load(ds2_ptr + b * C + cols, mask=cmask, other=0.0)
    dx = d1[None, :] + 2.0 * xv * d2[None, :]
    tl.store(dx_ptr + off, dx.to(dx_ptr.dtype.element_ty), mask=mask)


@functools.lru_cache(maxsize=None)
def _triton_kernels():
    global tl
    import triton
    import triton.language

    tl = triton.language
    return (triton.jit(_partial_sums), triton.jit(_finish),
            triton.jit(_stats_bwd))


def _split(b: int, s: int, tiles: int) -> tuple[int, int]:
    """(n_split, rows_per_split) of S for a grid of b x n_split x tiles
    programs: enough programs to fill the card."""
    max_split = -(-s // _BLOCK_S)
    n_split = max(1, min(max_split, -(-_TARGET_PROGRAMS // (b * tiles))))
    rows = -(-s // n_split)
    rows = -(-rows // _BLOCK_S) * _BLOCK_S
    return -(-s // rows), rows


def _gn_stats_cuda(x: torch.Tensor):
    global launches
    check_no_grad("gn_stats (B5) outside GNStats", x)
    if not x.is_cuda:
        raise ValueError("x must lie on the GPU")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"gn_stats takes a contiguous [B,S,C], got "
                         f"{tuple(x.shape)} strides {x.stride()}")
    if x.dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise ValueError(f"gn_stats: unsupported dtype {x.dtype}")
    _build.require_current(x.device)
    b, s, c = x.shape
    partial_sums, finish, _ = _triton_kernels()
    c_tiles = -(-c // _BLOCK_C)
    n_split, rows = _split(b, s, c_tiles)
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


def gn_stats_bwd_ref(x: torch.Tensor, ds1: torch.Tensor, ds2: torch.Tensor
                     ) -> torch.Tensor:
    """Plain version of B5's backward, from its formula: dx[b,s,c] =
    ds1[b,c] + 2 x[b,s,c] ds2[b,c] in f32 (f64 for f64 x), in x's
    dtype."""
    acc = acc_dtype(x)
    dx = ds1.to(acc)[:, None, :] + 2.0 * x.to(acc) * ds2.to(acc)[:, None, :]
    return dx.to(x.dtype)


def _gn_stats_bwd_cuda(x, ds1, ds2) -> torch.Tensor:
    """B5b (Triton): one read of x, one write of dx."""
    global bwd_launches
    b, s, c = x.shape
    ds1, ds2 = (t.float().contiguous() for t in (ds1, ds2))
    if ds1.shape != (b, c) or ds2.shape != (b, c):
        raise ValueError(f"gn_stats backward: ds1/ds2 must be [B, C] = "
                         f"{[b, c]}")
    _build.require_current(x.device)
    _, _, stats_bwd = _triton_kernels()
    dx = torch.empty_like(x)
    grid = (b, -(-s // _BLOCK_S), -(-c // _BLOCK_C))
    stats_bwd[grid](x, ds1, ds2, dx, s, c, BLOCK_S=_BLOCK_S,
                    BLOCK_C=_BLOCK_C, num_warps=4)
    bwd_launches += 1
    return dx


class GNStats(torch.autograd.Function):
    """B5 with a backward: on CUDA the forward launches B5 as the no-grad
    path does, bit for bit and counted the same, and the backward launches
    B5b; on the CPU the plain version and ``gn_stats_bwd_ref``."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        if x.device.type == "cpu":
            return gn_stats_ref(x)
        return _gn_stats_cuda(x)

    @staticmethod
    def backward(ctx, ds1, ds2):
        (x,) = ctx.saved_tensors
        if x.device.type == "cpu":
            return gn_stats_bwd_ref(x, ds1, ds2)
        return _gn_stats_bwd_cuda(x, ds1, ds2)


def gn_stats(x: torch.Tensor):
    """[B, S, C] -> (sum [B, C], sumsq [B, C]) in f32, reading x once. A
    CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
    version; under autograd both go through ``GNStats``."""
    if needs_grad(x):
        return GNStats.apply(x)
    if x.device.type == "cpu":
        return gn_stats_ref(x)
    return _gn_stats_cuda(x)


def takes_stats_kernel(s: int, c: int) -> bool:
    """Whether ``gn_affine_coefs`` sends an [B, S, C] activation to the
    one-read statistics kernel: C >= 128 and S*C >= 2**SDT_GN_STATS_MIN
    (default 21), the JAX package's gate, with a row chunk that fits its
    block."""
    min_elems = 1 << int(os.environ.get("SDT_GN_STATS_MIN", "21"))
    return (c >= 128 and s * c >= min_elems
            and _stats_chunk(s, c) * c <= _STATS_MAX_ELEMS)


def _affine_from_sums(s1, s2, scale, bias, groups: int, n: float,
                      epsilon: float):
    """Per-channel sums [B, C] -> f32 (a_c, b_c) [B, C]: group mean and
    E[x^2] - mean^2 folded with the affine."""
    b, c = s1.shape
    mean = s1.reshape(b, groups, -1).sum(-1) / n
    var = s2.reshape(b, groups, -1).sum(-1) / n - mean * mean
    inv = torch.rsqrt(var + epsilon)                       # [B, G]
    a_c = inv.repeat_interleave(c // groups, dim=1) * scale.float()
    b_c = bias.float() - mean.repeat_interleave(c // groups, dim=1) * a_c
    return a_c, b_c


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
    return _affine_from_sums(s1, s2, scale, bias, groups,
                             float(s * (c // groups)), epsilon)


def group_norm_ref(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   groups: int, epsilon: float = 1e-6,
                   act: str | None = None) -> torch.Tensor:
    """GroupNorm over [B, S, C] with f32 statistics (+ SiLU).

    Where ``fast_act_ok`` holds (bf16, SDT_FAST_SILU=1) the fast form of
    the JAX package: one-pass sum/sumsq statistics folded into per-channel
    (a_c, b_c), and the affine and SiLU applied at bf16. Otherwise the
    two-pass mean/variance in f32, the output in x's dtype."""
    b, s, c = x.shape
    if fast_act_ok(x.dtype):
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


# ------------------------------------------------------- fused GroupNorm
def group_norm_fused_ref(x: torch.Tensor, scale: torch.Tensor,
                         bias: torch.Tensor, groups: int,
                         epsilon: float = 1e-6,
                         act: str | None = None) -> torch.Tensor:
    """Plain version of the fused kernel, in its numerics (those of the
    JAX package's ``_gn_kernel``, not of ``group_norm_ref``): one-pass f32
    group statistics, a = rsqrt(var + eps) * scale and b = bias - mean * a
    per channel, y = x*a + b in f32; SiLU in f32, or, where
    ``fast_act_ok`` holds, on y rounded to bf16 and at bf16; the output in
    x's dtype."""
    b, s, c = x.shape
    s1, s2 = gn_stats_ref(x)
    a_c, b_c = _affine_from_sums(s1, s2, scale, bias, groups,
                                 float(s * (c // groups)), epsilon)
    y = x.float() * a_c[:, None, :] + b_c[:, None, :]
    if act == "silu":
        if fast_act_ok(x.dtype):
            y = y.to(x.dtype)
            y = (y * torch.sigmoid(y)).float()
        else:
            y = y * torch.sigmoid(y)
    return y.to(x.dtype)


class GNPlan(NamedTuple):
    """The fused kernel's walk of one shape (``csrc/group_norm.cu``)."""
    ct: int         # channels a tile (whole groups)
    tiles: int      # tiles a batch row: C // ct
    cl: int         # blocks a tile: the cluster, splitting the rows
    rows: int       # rows a block (the last one fewer)
    pass_rows: int  # rows a pass of the copies into shared memory
    vb: int         # bytes a vector of the copies and of the output
    chunks: int     # row chunks of the sums: a thread sums one channel's
    #                 rows of one chunk, the block the chunks in order
    resident: bool  # the slice stays in shared memory: x is read once
    smem: int       # dynamic shared memory of a block, bytes


_GN_THREADS = 1024           # threads a block (csrc/group_norm.cu THREADS)
_GN_CT_MAX = 4 * _GN_THREADS  # channels a tile (CH_MAX * THREADS)
_GN_FILL = 128               # blocks that fill the H100 at one a SM
_GN_PASS_BYTES = 32768       # bytes a pass of the copies
_GN_SEGMENT = 256            # bytes: the re-read form's least row segment
_GN_SEGMENT_WIDE = 320       # bytes: a row segment no wider pays off
_GN_SMEM_MAX = 232448        # shared memory a block can opt into (H100)
_GN_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _gn_smem(esize: int, ct: int, cg: int, rows: int, pass_rows: int,
             resident: bool) -> int:
    """csrc/group_norm.cu::smem_bytes: the staged rows, the f64 sums of
    the chunks, the channels, the runs and the groups."""
    chunks = _GN_THREADS // ct if ct < _GN_THREADS else 1
    staged = -(-(rows if resident else 2 * pass_rows) * ct * esize // 16) * 16
    k = ct // cg
    return staged + 16 * chunks * ct + 16 * (ct + k * -(-cg // 8) + k)


@functools.lru_cache(maxsize=256)
def gn_plan(b: int, s: int, c: int, groups: int, esize: int,
            align: int = 16) -> GNPlan | None:
    """The fused kernel's plan for [b, s, c] x of ``esize``-byte elements
    whose pointers (x's and y's) are ``align``-byte aligned, or None where
    a group is wider than a tile can be. One read of x where a block's
    slice fits its shared memory: among tiles of whole groups and clusters
    of 1 or 2 blocks splitting the rows (larger clusters of blocks this
    size were measured to start late on an H100), the plan with the most
    blocks up to 128 (one a SM), then the widest row segment up to 320
    bytes, then the smaller cluster, then the wider tile. Else the re-read
    form, on tiles of the fewest whole groups whose row segment reaches
    256 bytes, 2 blocks a tile. Vectors of 16 bytes where the tile, the
    row pitch and the pointers allow, else 8, 4 or 2."""
    cg = c // groups
    divisors = [d for d in range(1, groups + 1)
                if groups % d == 0 and d * cg <= _GN_CT_MAX]
    if not divisors:
        return None
    best = None
    for k in divisors:
        ct = k * cg
        pass_rows = max(1, _GN_PASS_BYTES // (ct * esize))
        for cl in (1, 2):
            rows = -(-s // cl)
            cl = -(-s // rows)
            if _gn_smem(esize, ct, cg, rows, pass_rows, True) > _GN_SMEM_MAX:
                continue
            key = (min(b * (groups // k) * cl, _GN_FILL),
                   min(ct * esize, _GN_SEGMENT_WIDE), -cl, k)
            if best is None or key > best[0]:
                best = (key, ct, cl, rows, pass_rows, True)
    if best is None:
        k = next((d for d in divisors if d * cg * esize >= _GN_SEGMENT),
                 divisors[-1])
        ct = k * cg
        rows = -(-s // min(2, s))
        best = (None, ct, -(-s // rows), rows,
                max(1, _GN_PASS_BYTES // (ct * esize)), False)
    _, ct, cl, rows, pass_rows, resident = best
    vb = 16
    while vb > esize and ((ct * esize) % vb or (c * esize) % vb
                          or align % vb):
        vb //= 2
    return GNPlan(ct, c // ct, cl, rows, pass_rows, vb,
                  _GN_THREADS // ct if ct < _GN_THREADS else 1, resident,
                  _gn_smem(esize, ct, cg, rows, pass_rows, resident))


def _align(*tensors) -> int:
    """The largest power of two up to 16 dividing every data pointer."""
    bits = 16
    for t in tensors:
        bits |= t.data_ptr()
    return bits & -bits


def _group_norm_fused_cuda(x, scale, bias, groups, epsilon, act, *,
                           one_read: bool = True):
    """``one_read=False`` takes the re-read form even where the slice fits
    (tests compare the two forms at one shape)."""
    global fused_launches
    check_no_grad("group_norm_fused (B6)", x, scale, bias)
    if not x.is_cuda or scale.device != x.device or bias.device != x.device:
        raise ValueError("x, scale and bias must lie on one GPU")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"group_norm_fused takes a contiguous [B,S,C], got "
                         f"{tuple(x.shape)} strides {x.stride()}")
    if x.dtype not in _GN_DTYPES:
        raise ValueError(f"group_norm_fused: unsupported dtype {x.dtype}")
    b, s, c = x.shape
    if c % groups or scale.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"group_norm_fused: C={c} must split into {groups} "
                         f"groups and scale/bias be [C], got "
                         f"{tuple(scale.shape)}/{tuple(bias.shape)}")
    if act not in (None, "silu"):
        raise ValueError(f"act must be None or 'silu', got {act!r}")
    y = torch.empty_like(x)
    plan = gn_plan(b, s, c, groups, x.element_size(), _align(x, y))
    if plan is None or plan.smem > _GN_SMEM_MAX:
        raise ValueError(f"group_norm_fused: groups of {c // groups} "
                         f"channels are wider than the kernel's tiles")
    sc, bi = scale.float().contiguous(), bias.float().contiguous()
    err = _build.library("group_norm").sdt_group_norm_fused(
        x.data_ptr(), sc.data_ptr(), bi.data_ptr(), y.data_ptr(),
        _GN_DTYPES[x.dtype], b, s, c, groups, plan.ct, plan.cl, plan.rows,
        plan.pass_rows, plan.vb, int(plan.resident and one_read),
        float(epsilon),
        int(act == "silu"), int(fast_act_ok(x.dtype)),
        _build.stream_ptr(x.device))
    _build.check(err, "sdt_group_norm_fused")
    fused_launches += 1
    return y


def group_norm_fused(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     groups: int, epsilon: float = 1e-6,
                     act: str | None = None) -> torch.Tensor:
    """The fused GroupNorm (+SiLU) of [B, S, C] x; scale and bias [C]. A
    CUDA tensor launches the kernel or raises; a CPU tensor takes the
    plain version."""
    if x.device.type == "cpu":
        return group_norm_fused_ref(x, scale, bias, groups, epsilon, act)
    return _group_norm_fused_cuda(x, scale, bias, groups, epsilon, act)


def takes_fused_kernel(s: int, c: int, groups: int) -> bool:
    """The JAX package's gate of its fused kernel, on any device:
    SDT_FUSED_GN=1, S*C <= 4096*320, C % groups == 0 and S a multiple of
    min(512, S)."""
    return (os.environ.get("SDT_FUSED_GN") == "1"
            and s * c <= _FUSED_MAX_ELEMS and c % groups == 0
            and s % min(_S_TILE, s) == 0)


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               groups: int, epsilon: float = 1e-6,
               act: str | None = None) -> torch.Tensor:
    """GroupNorm (+SiLU) of [B, S, C] x: the fused kernel where
    ``takes_fused_kernel`` holds, else ``group_norm_ref`` (counterpart of
    the JAX package's ``group_norm``)."""
    b, s, c = x.shape
    if takes_fused_kernel(s, c, groups):
        return group_norm_fused(x, scale, bias, groups, epsilon, act)
    return group_norm_ref(x, scale, bias, groups, epsilon, act)
