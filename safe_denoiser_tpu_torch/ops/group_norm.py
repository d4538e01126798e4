"""GroupNorm with f32 statistics: the plain forms, the affine coefficients,
the one-read statistics kernel and the fused GroupNorm(+SiLU) kernel (both
Triton), each with its plain version, and the dispatch between them.

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
[B, S, C] activation with S*C <= 4096*320, one read for the statistics and
one read and one write for the output. Bound by bytes: one read and one
write of x (41.9 MB, 12.5 us, at the UNet's [8, 4096, 320] bf16). The TPU
kernel's one-hot [C, G] products (an MXU device for group sums) have no
counterpart here. Design: pass 1 is the statistics kernel's partial-sum
pass (per-(b, row range, c) f32 sums, programs spread over S); pass 2 gives
each program one batch row, a row range and a tile of whole groups, laid
out [groups, group width padded to a power of two] so that a group's sum
is a reduction over one axis; it adds the partials of its channels, folds
them into group mean and rsqrt(var + eps), forms a = rsqrt * scale and
b = bias - mean * a, and writes y = x*a + b (then SiLU) for its rows. The
second read of x can hit the 50 MB L2 (x is at most 21 MB at the UNet's
shapes). Both launches count as one.
"""

from __future__ import annotations

import functools
import os

import torch

launches = 0         # kernel launches of gn_stats on CUDA tensors
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


def _gn_apply(x_ptr, y_ptr, p1_ptr, p2_ptr, scale_ptr, bias_ptr, S, C, CG,
              G, n_part, rows_per_split, n_per_group, eps,
              SILU: tl.constexpr, FAST: tl.constexpr, BLOCK_S: tl.constexpr,
              GPB: tl.constexpr, CGP: tl.constexpr):
    """Pass 2 of the fused GroupNorm: program (b, row range, group tile);
    channels as [GPB groups, CGP >= CG lanes], the group's channels
    contiguous from grp * CG."""
    b = tl.program_id(0)
    sp = tl.program_id(1)
    gt = tl.program_id(2)
    grp = gt * GPB + tl.arange(0, GPB)
    j = tl.arange(0, CGP)
    cols = grp[:, None] * CG + j[None, :]
    cmask = (grp[:, None] < G) & (j[None, :] < CG)
    a1 = tl.zeros((GPB, CGP), dtype=tl.float32)
    a2 = tl.zeros((GPB, CGP), dtype=tl.float32)
    for k in range(0, n_part):
        off = (b * n_part + k) * C + cols
        a1 += tl.load(p1_ptr + off, mask=cmask, other=0.0)
        a2 += tl.load(p2_ptr + off, mask=cmask, other=0.0)
    mean = tl.sum(a1, axis=1) / n_per_group
    var = tl.sum(a2, axis=1) / n_per_group - mean * mean
    inv = tl.rsqrt(var + eps)
    a = inv[:, None] * tl.load(scale_ptr + cols, mask=cmask, other=0.0)
    sh = tl.load(bias_ptr + cols, mask=cmask, other=0.0) - mean[:, None] * a
    base = x_ptr + b.to(tl.int64) * S * C
    out = y_ptr + b.to(tl.int64) * S * C
    start = sp * rows_per_split
    for r0 in range(0, rows_per_split, BLOCK_S):
        rows = start + r0 + tl.arange(0, BLOCK_S)
        mask = (rows < S)[:, None, None] & cmask[None, :, :]
        off = rows.to(tl.int64)[:, None, None] * C + cols[None, :, :]
        xv = tl.load(base + off, mask=mask, other=0.0).to(tl.float32)
        y = xv * a[None, :, :] + sh[None, :, :]
        if SILU:
            if FAST:   # round to bf16 first, SiLU at bf16 (fast_act)
                y = y.to(tl.bfloat16).to(tl.float32)
                sg = tl.sigmoid(y).to(tl.bfloat16).to(tl.float32)
                y = y * sg
            else:
                y = y * tl.sigmoid(y)
        tl.store(out + off, y.to(y_ptr.dtype.element_ty), mask=mask)


@functools.lru_cache(maxsize=None)
def _triton_kernels():
    global tl
    import triton
    import triton.language

    tl = triton.language
    return (triton.jit(_partial_sums), triton.jit(_finish),
            triton.jit(_gn_apply))


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
    if not x.is_cuda:
        raise ValueError("x must lie on the GPU")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"gn_stats takes a contiguous [B,S,C], got "
                         f"{tuple(x.shape)} strides {x.stride()}")
    if x.dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise ValueError(f"gn_stats: unsupported dtype {x.dtype}")
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


def gn_stats(x: torch.Tensor):
    """[B, S, C] -> (sum [B, C], sumsq [B, C]) in f32, reading x once. A
    CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
    version."""
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


def _pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def _group_norm_fused_cuda(x, scale, bias, groups, epsilon, act):
    global fused_launches
    if not x.is_cuda or scale.device != x.device or bias.device != x.device:
        raise ValueError("x, scale and bias must lie on one GPU")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"group_norm_fused takes a contiguous [B,S,C], got "
                         f"{tuple(x.shape)} strides {x.stride()}")
    if x.dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise ValueError(f"group_norm_fused: unsupported dtype {x.dtype}")
    b, s, c = x.shape
    if c % groups or scale.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"group_norm_fused: C={c} must split into {groups} "
                         f"groups and scale/bias be [C], got "
                         f"{tuple(scale.shape)}/{tuple(bias.shape)}")
    if act not in (None, "silu"):
        raise ValueError(f"act must be None or 'silu', got {act!r}")
    partial_sums, _, apply = _triton_kernels()
    cg = c // groups
    cgp = _pow2(cg)
    gpb = max(1, _BLOCK_C // cgp)                # whole groups per tile
    g_tiles = -(-groups // gpb)
    c_tiles = -(-c // _BLOCK_C)
    n_part, rows1 = _split(b, s, c_tiles)
    p1 = torch.empty((b, n_part, c), dtype=torch.float32, device=x.device)
    p2 = torch.empty_like(p1)
    partial_sums[(b, n_part, c_tiles)](x, p1, p2, s, c, rows1, n_part,
                                       BLOCK_S=_BLOCK_S, BLOCK_C=_BLOCK_C,
                                       num_warps=4)
    n_split, rows2 = _split(b, s, g_tiles)
    y = torch.empty_like(x)
    apply[(b, n_split, g_tiles)](
        x, y, p1, p2, scale.float().contiguous(), bias.float().contiguous(),
        s, c, cg, groups, n_part, rows2, float(s * cg), float(epsilon),
        SILU=act == "silu", FAST=fast_act_ok(x.dtype), BLOCK_S=_BLOCK_S,
        GPB=gpb, CGP=cgp, num_warps=4)
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
