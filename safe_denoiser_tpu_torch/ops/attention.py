"""Unmasked self-attention: the CUDA kernels and their plain PyTorch
versions, and the dispatch over the TPU kernels' layouts.

Counterpart of ``safe_denoiser_tpu/ops/attention.py``. The public layout is
the JAX package's ``[B, S, H, D]``. A CPU tensor takes the plain version; a
CUDA tensor launches the kernel or raises. ``self_attention`` takes the JAX
package's branches in its order (``SDT_FLASH2_LAYOUT``, ``SDT_ATTN_REPACK``,
``SDT_INT8_ATTN``):

| branch                   | kernel, source                 | JAX kernel      |
| ------------------------ | ------------------------------ | --------------- |
| bhsd (default)           | attention, attention.cu        | _attn_kernel    |
| bhsd + SDT_INT8_ATTN=1   | attention_i8, attention_i8.cu  | (quant_i8)      |
| nt                       | attention_nt, attention_nt.cu  | _attn_kernel_nt |
| nt + SDT_ATTN_REPACK=1   | repack_to_heads x3, nt,        | _repack_*       |
|                          | repack_from_heads (repack_heads.cu) |            |
| bshd, S % 512 == 0       | attention_bshd, ..._bshd.cu    | _attn_kernel_bshd |

A wide head (D > 256) takes the q-chunked plain path in every layout.
"""

from __future__ import annotations

import math
import os

import torch
import torch.nn.functional as F

from . import _build
from ._grad import acc_dtype, check_no_grad, needs_grad

launches = 0        # kernel launches of the bf16/f32 kernel on CUDA tensors
bwd_launches = 0    # calls of the bf16 backward (B1b, two launches a call)
# bf16 calls (B1, B9, B10) whose q/k/v the wrapper first copied into
# contiguous tensors, because the kernels' tensor maps cannot take their
# strides, head dim or alignment (0 on every main path)
staging_copies = 0
i8_launches = 0     # kernel launches of the int8-QK^T kernel
nt_launches = 0     # ... of the head-major kernel
bshd_launches = 0   # ... of the natural-layout kernel
to_heads_launches = 0
from_heads_launches = 0
BLOCK = 512         # the TPU kernels' sequence grid
LOG2E = math.log2(math.e)

# max |d| a bf16 kernel call is held to against the plain version on the
# same values in f32 (chip_smoke.py, tests/test_torch_port_cuda.py), no
# relative term. The kernel's bf16 probabilities and output leave 1.9e-3
# at the main path's shapes on an H100. With q, k, v ~ N(0, 1) outputs
# have an rms of sqrt(e/S), 0.026..0.067 for S = 4096..600, so a kernel
# that loses ~4% of each output, as one without the tail mask does at
# S=600, exceeds it.
BF16_ATOL = 5e-3


def supports(s_q: int, s_kv: int, head_dim: int, block_q: int = 512) -> bool:
    """Shapes the self-attention path handles (same predicate as the JAX
    package): unmasked self-attention with S >= 512 and D <= 256, or a wide
    full-lane head (the VAE mid-block's D=512), which takes the q-chunked
    plain path."""
    if s_q != s_kv or s_q < block_q:
        return False
    if head_dim > 256:
        return head_dim % 128 == 0 and head_dim <= 1024 and s_q % 512 == 0
    return True


def _softmax_pv(logits: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """f32 softmax over [B, H, Sq, Skv] logits, probabilities cast to v's
    dtype for the product with v [B, S, H, D]; output in v's dtype (f64
    inputs stay in f64)."""
    acc = acc_dtype(v)
    p = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(acc), v.to(acc))
    return out.to(v.dtype)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  sm_scale: float, mask: torch.Tensor | None = None
                  ) -> torch.Tensor:
    """Plain version: f32 logits and softmax, probabilities cast to v's
    dtype for the second product, output in v's dtype. q/k/v [B, S, H, D];
    ``mask`` broadcasts against [B, H, Sq, Skv] (True keeps)."""
    acc = acc_dtype(q)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(acc) * sm_scale, k.to(acc))
    if mask is not None:
        logits = logits.masked_fill(~mask, torch.finfo(acc).min)
    return _softmax_pv(logits, v)


def quantize_rows_i8(x: torch.Tensor):
    """Symmetric int8 over the last dim, as the TPU kernel's ``_i8``:
    r = 127 / max(amax, 1e-20), round half to even, clip to +-127. Returns
    (the int8 values as f32, amax [..., 1] f32)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    r = 127.0 / torch.clamp(amax, min=1e-20)
    return torch.clamp(torch.round(xf * r), -127.0, 127.0), amax


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      sm_scale: float, chunk_q: int = 512) -> torch.Tensor:
    """Wide-head attention in q-chunks (the VAE mid-block's one head at
    D=512, S=4096): per chunk an f32 [B,H,cq,S] logits block, a softmax, and
    the second product, so the full [S,S] logits never exist at once.
    Counterpart of ``_chunked_einsum_attention``; plain PyTorch."""
    s = q.shape[1]
    outs = [attention_ref(q[:, i:i + chunk_q], k, v, sm_scale)
            for i in range(0, s, chunk_q)]
    return torch.cat(outs, dim=1)


def tensor_map_ready(q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor) -> bool:
    """Whether the bf16 kernel's TMA tensor maps over (D, H, S, B) take
    q/k/v as they are: D % 8 == 0, 16-byte aligned bases, strides that are
    multiples of 8 elements (16 bytes) and nest as the dims do (head
    stride >= D, row stride >= H x head stride, batch stride >= S x row
    stride). ``sdt_self_attention_bf16`` checks the first three."""
    b, s, h, d = q.shape
    sb, ss, sh = q.stride()[:3]
    return (d % 8 == 0
            and all(t.data_ptr() % 16 == 0 for t in (q, k, v))
            and sb % 8 == 0 and ss % 8 == 0 and sh % 8 == 0
            and sh >= d and ss >= h * sh and sb >= s * ss)


def _staged(q, k, v):
    """q/k/v as the tensor maps of B1, B9 and B10 take them: unchanged when
    ``tensor_map_ready``, else contiguous copies with D zero-padded to a
    multiple of 8 (counted in ``staging_copies``); the padded columns add
    0 to every logit and give output columns that are dropped."""
    global staging_copies
    if tensor_map_ready(q, k, v):
        return q, k, v
    d8 = -(-q.shape[3] // 8) * 8
    staging_copies += 1
    return tuple(F.pad(t, (0, d8 - t.shape[3])).contiguous()
                 for t in (q, k, v))


_ENTRY = {torch.bfloat16: "sdt_self_attention_bf16",
          torch.float32: "sdt_self_attention_f32"}


def _check_qkv(q, k, v, dtypes) -> None:
    if not (q.is_cuda and q.device == k.device == v.device):
        raise ValueError("q, k and v must all lie on one GPU")
    if not (q.dtype == k.dtype == v.dtype and q.dtype in dtypes):
        raise ValueError(f"attention kernel takes {dtypes} q/k/v, got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q/k/v must share one [B,S,H,D] shape: "
                         f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    if not (q.stride() == k.stride() == v.stride()) or q.stride(3) != 1:
        raise ValueError("q/k/v must share strides with a unit last stride")
    if q.shape[3] > 256:
        raise ValueError(f"head dim {q.shape[3]} > 256 is not taken by the "
                         "kernel")


def lse_pitch(s: int) -> int:
    """The row pitch of the logsumexp and Delta rows B1b reads through a
    tensor map: S rounded up to 4 (a 16-byte multiple of f32)."""
    return -(-s // 4) * 4


def _launch_lse(q, k, v, out, sm_scale: float) -> torch.Tensor:
    """B1's bf16 kernel into ``out`` that also writes each row's logsumexp
    (exp2 domain): returns it as f32 [B, H, lse_pitch(S)], the columns past
    S unwritten. q/k/v as the tensor maps take them, D <= 128."""
    b, s, h, d = q.shape
    if d > 128:
        raise ValueError(f"the attention backward (B1b) takes D <= 128, got "
                         f"D={d}")
    lse = torch.empty((b, h, lse_pitch(s)), dtype=torch.float32,
                      device=q.device)
    err = _build.library("attention").sdt_self_attention_lse_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b, s, h, d, q.stride(0), q.stride(1), q.stride(2),
        float(sm_scale), lse.shape[2], _build.stream_ptr(q.device))
    _build.check(err, "sdt_self_attention_lse_bf16")
    return lse


def _self_attention_cuda(q, k, v, sm_scale: float, with_lse: bool = False):
    """B1 on CUDA tensors. ``with_lse`` (bf16, D <= 128; the forward under
    autograd): also each query row's logsumexp in the exp2 domain for B1b,
    returned as ``(out, lse)`` with lse f32 [B, H, S] (a view of rows
    ``lse_pitch(S)`` apart); the output is the no-grad kernel's bit for bit
    and counts the same one launch."""
    global launches
    check_no_grad("attention (B1) in f32 or outside SelfAttention", q, k,
                  v)
    _check_qkv(q, k, v, tuple(_ENTRY))
    if with_lse and q.dtype != torch.bfloat16:
        raise ValueError("the logsumexp is kept by the bf16 kernel only")
    d_out = q.shape[3]
    if q.dtype == torch.bfloat16:
        q, k, v = _staged(q, k, v)
    b, s, h, d = q.shape
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    if with_lse:
        lse = _launch_lse(q, k, v, out, sm_scale)
    else:
        fn = getattr(_build.library("attention"), _ENTRY[q.dtype])
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, s, h, d, q.stride(0), q.stride(1), q.stride(2),
                 float(sm_scale), _build.stream_ptr(q.device))
        _build.check(err, _ENTRY[q.dtype])
    launches += 1
    out = out if d == d_out else out[..., :d_out].contiguous()
    return (out, lse[..., :s]) if with_lse else out


def attention_lse_ref(q: torch.Tensor, k: torch.Tensor,
                      sm_scale: float) -> torch.Tensor:
    """Plain version of the logsumexp B1 keeps for its backward: per query
    row, log2 of the sum over keys of 2^(c q.k), c = sm_scale * log2(e) (the
    exp2 domain of the kernels' softmax); [B, H, S] in f32 (f64 for f64
    inputs)."""
    acc = acc_dtype(q)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(acc) * sm_scale, k.to(acc))
    return torch.logsumexp(logits, dim=-1) * LOG2E


def attention_bwd_ref(q, k, v, out, dout, sm_scale: float):
    """Plain version of B1's backward, from its formula (not by autograd):
    with P = softmax(s Q K^T) in f32 (f64 for f64 inputs), dV = P^T dO,
    dP = dO V^T, Delta = rowsum(dO * O) over the forward's output O,
    dS = P (dP - Delta), dQ = s dS K, dK = s dS^T Q. [B, S, H, D] in; dq,
    dk, dv in q's, k's and v's dtypes."""
    acc = acc_dtype(q)
    qf, kf, vf, of, gf = (t.to(acc) for t in (q, k, v, out, dout))
    p = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", qf * sm_scale, kf),
                      dim=-1)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, gf)
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
    delta = (gf * of).sum(-1).permute(0, 2, 1)[..., None]     # [B, H, S, 1]
    ds = p * (dp - delta)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * sm_scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * sm_scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_lse(lse: torch.Tensor, b: int, s: int, h: int, device) -> None:
    """Raise unless ``lse`` is [B, H, S] f32 on ``device`` with rows
    ``lse_pitch(S)`` apart on a 16-byte aligned base: the view
    ``_self_attention_cuda(..., with_lse=True)`` returns, which B1b's tensor
    map reads."""
    sp = lse_pitch(s)
    if not (lse.shape == (b, h, s) and lse.dtype == torch.float32
            and lse.device == device and lse.stride() == (h * sp, sp, 1)
            and lse.data_ptr() % 16 == 0):
        raise ValueError("attention backward takes the logsumexp as the "
                         "forward returns it: f32 [B, H, S], rows "
                         f"{sp} apart, got {tuple(lse.shape)} {lse.dtype} "
                         f"strides {lse.stride()}")


def _attention_bwd_cuda(q, k, v, out, dout, sm_scale: float, lse=None):
    """B1b (``csrc/attention_bwd.cu``): bf16 dq, dk, dv of one call; two
    launches (Delta, then dK/dV by key blocks beside dQ by query blocks),
    one count.
    ``lse``: each query row's logsumexp in the exp2 domain, [B, H, S] f32,
    as the forward under autograd keeps it (``_self_attention_cuda(...,
    with_lse=True)``); without it the call first runs that forward for it
    (the same bits). Head dims that are not a multiple of 8 are padded with
    zero columns, which add nothing to any product."""
    global bwd_launches
    for t in (q, k, v, out, dout):
        if t.shape != q.shape or t.dtype != torch.bfloat16 \
                or t.device != q.device or not t.is_cuda:
            raise ValueError("attention backward takes bf16 q/k/v/out/dout "
                             "of one [B,S,H,D] shape on one GPU")
    b, s, h, d = q.shape
    if d > 128 or b * h > 65535:
        raise ValueError(f"attention backward takes D <= 128 and B*H <= "
                         f"65535, got D={d}, B*H={b * h}")
    d8 = max(8, -(-d // 8) * 8)

    def ready(t):
        t = t.contiguous()
        if d8 != d:
            t = F.pad(t, (0, d8 - d))
        return t if t.data_ptr() % 16 == 0 else t.clone()

    q, k, v, out, dout = (ready(t) for t in (q, k, v, out, dout))
    if lse is None:
        lse = _launch_lse(q, k, v, torch.empty_like(q), sm_scale)
    else:
        _check_lse(lse, b, s, h, q.device)
    sp = lse_pitch(s)
    delta = torch.empty((b, h, sp), dtype=torch.float32, device=q.device)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    err = _build.library("attention_bwd").sdt_attention_bwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), b, s, h, d8, sp,
        float(sm_scale), _build.stream_ptr(q.device))
    _build.check(err, "sdt_attention_bwd_bf16")
    bwd_launches += 1
    if d8 != d:
        dq, dk, dv = (t[..., :d].contiguous() for t in (dq, dk, dv))
    return dq, dk, dv


class SelfAttention(torch.autograd.Function):
    """B1 with a backward: on CUDA (bf16) the forward launches B1 as the
    no-grad path does, bit for bit and counted the same, keeping each row's
    logsumexp, and the backward launches B1b on it; on the CPU the plain
    version and ``attention_bwd_ref``."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale):
        lse = None
        if _build.takes_plain(q):
            out = attention_ref(q, k, v, sm_scale)
        else:
            out, lse = _self_attention_cuda(q, k, v, sm_scale, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.sm_scale = sm_scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        if _build.takes_plain(q):
            grads = attention_bwd_ref(q, k, v, out, dout, ctx.sm_scale)
        else:
            grads = _attention_bwd_cuda(q, k, v, out, dout.to(q.dtype),
                                        ctx.sm_scale, lse)
        return (*grads, None)


def i8_width(d: int) -> int:
    """The int8 tiles' padded head dim: D rounded up to 64, as the TPU
    kernel pads its int8 contraction (40 -> 64, 80 -> 128)."""
    return -(-d // 64) * 64


def i8_pitch(s: int) -> int:
    """The row pitch of the dequant factors: S rounded up to 4."""
    return -(-s // 4) * 4


def i8_dequant_scales(sm_scale: float) -> tuple[float, float]:
    """The TPU kernel's dequant constants as f32: c / 127 with c = sm_scale
    * log2(e) (taken to f32 from double, as JAX's weak-typed constant) for
    the query amax, 1/127 for the key amax."""
    return (torch.tensor(sm_scale * LOG2E / 127.0).item(),
            torch.tensor(1.0 / 127.0).item())


def quantize_i8_ref(q: torch.Tensor, k: torch.Tensor, sm_scale: float):
    """Plain version of B8's quantize pass: q and k [B, S, H, D] ->
    (qi, ki) int8 [B*H, S, i8_width(D)] (the padded columns zero) and
    (q_deq, k_deq) f32 [B*H, S]: q_amax * c/127 and k_amax * 1/127, each
    row quantized as ``quantize_rows_i8`` quantizes it."""
    b, s, h, d = q.shape
    out = []
    for x, c in zip((q, k), i8_dequant_scales(sm_scale)):
        # head-major rows, zero-padded to the tile width first, as the
        # kernel's lanes past D read zeros
        xf = F.pad(x.permute(0, 2, 1, 3).reshape(b * h, s, d).float(),
                   (0, i8_width(d) - d))
        amax = xf.abs().amax(dim=-1)
        r = 127.0 / torch.clamp(amax, min=1e-20)
        xi = torch.clamp(torch.round(xf * r[..., None]), -127.0, 127.0)
        out += [xi.to(torch.int8), amax * torch.tensor(c)]
    qi, qd, ki, kd = out
    return qi, ki, qd, kd


def attention_i8_from_quantized(qi: torch.Tensor, ki: torch.Tensor,
                                q_deq: torch.Tensor, k_deq: torch.Tensor,
                                v: torch.Tensor) -> torch.Tensor:
    """Plain version of the core's int8 form on ``quantize_i8_ref``'s
    output: exact integer logits (f32 sums of integer products stay exact
    below 2^24), dequantized in the TPU kernel's order, (float(s32) *
    q_deq) * k_deq, in the exp2 domain; softmax by exp2, probabilities cast
    to v's dtype for P V, f32 sums, output in v's dtype. v [B, S, H, D];
    returns [B, S, H, D]."""
    b, s, h, d = v.shape
    s32 = torch.einsum("nqd,nkd->nqk", qi.float(), ki.float())
    logits = (s32 * q_deq[:, :, None]) * k_deq[:, None, :]
    p = torch.exp2(logits - logits.amax(dim=-1, keepdim=True))
    vh = v.permute(0, 2, 1, 3).reshape(b * h, s, d)
    out = torch.einsum("nqk,nkd->nqd", p.to(v.dtype).float(), vh.float())
    out = out / p.sum(dim=-1, keepdim=True)
    return out.reshape(b, h, s, d).permute(0, 2, 1, 3).to(v.dtype)


def attention_i8_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     sm_scale: float) -> torch.Tensor:
    """Plain version of the int8-QK^T attention (B8): q quantized per
    query row and k per key token over D, as the TPU kernel's ``_i8``,
    exact integer logits dequantized with (amax_q * c/127) * (amax_k / 127),
    c = sm_scale * log2(e), and a softmax in the exp2 domain; the kernel's
    two steps, ``quantize_i8_ref`` then ``attention_i8_from_quantized``."""
    return attention_i8_from_quantized(*quantize_i8_ref(q, k, sm_scale), v)


def _self_attention_i8_cuda(q, k, v, sm_scale: float) -> torch.Tensor:
    global i8_launches
    check_no_grad("attention_i8 (B8)", q, k, v)
    _check_qkv(q, k, v, (torch.bfloat16,))
    d_out = q.shape[3]
    # the quantize pass reads q and k with any strides; v goes through the
    # core's tensor map, so views it cannot take are copied first (all three,
    # to keep one set of strides)
    if not tensor_map_ready(v, v, v):
        q, k, v = _staged(q, k, v)
    b, s, h, d = q.shape
    fn = _build.library("attention_i8").sdt_self_attention_i8_bf16
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    qi = torch.empty(2, b * h * s * i8_width(d), dtype=torch.int8,
                     device=q.device)
    deq = torch.empty(2 * b * h * i8_pitch(s), dtype=torch.float32,
                      device=q.device)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             qi[0].data_ptr(), qi[1].data_ptr(), deq.data_ptr(),
             b, s, h, d, q.stride(0), q.stride(1), q.stride(2),
             *i8_dequant_scales(sm_scale), _build.stream_ptr(q.device))
    _build.check(err, "sdt_self_attention_i8_bf16")
    i8_launches += 1
    return out if d == d_out else out[..., :d_out].contiguous()


def attention_nt_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     sm_scale: float, valid_kv: int | None = None
                     ) -> torch.Tensor:
    """Plain version of the head-major kernel: q/k/v [BH, S, D] -> [BH, S,
    D] in v's dtype; keys at or past ``valid_kv`` (a sequence's zero padding
    to the block grid) get no weight. f32 logits and softmax, probabilities
    cast to v's dtype for the second product."""
    logits = torch.einsum("bqd,bkd->bqk", q.float() * sm_scale, k.float())
    if valid_kv is not None and valid_kv < k.shape[1]:
        logits[..., valid_kv:] = float("-inf")
    p = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bqk,bkd->bqd", p.float(), v.float()).to(v.dtype)


def attention_bshd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       sm_scale: float) -> torch.Tensor:
    """Plain version of the natural-layout kernel: [B, S, H, D] in and out,
    S a multiple of the 512 grid, as the TPU kernel takes."""
    if q.shape[1] % BLOCK:
        raise ValueError(f"the bshd kernel takes S % {BLOCK} == 0, got "
                         f"S={q.shape[1]}")
    return attention_ref(q, k, v, sm_scale)


def repack_to_heads_ref(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """[B, S, H*D] -> [B, H, S, D], one head slice at a time as the TPU
    kernel copies them."""
    d = x.shape[2] // n_heads
    return torch.stack([x[:, :, i * d:(i + 1) * d] for i in range(n_heads)],
                       dim=1)


def repack_from_heads_ref(x: torch.Tensor) -> torch.Tensor:
    """[B, H, S, D] -> [B, S, H*D], the heads' slices side by side."""
    return torch.cat(x.unbind(1), dim=-1)


def _check_same(what: str, tensors, dtypes, dim: int) -> None:
    """One GPU, one dtype of ``dtypes``, one shape of ``dim`` dims, all
    contiguous: what the layout kernels take."""
    t0 = tensors[0]
    if not (t0.is_cuda and all(t.device == t0.device for t in tensors)):
        raise ValueError(f"{what}: the tensors must all lie on one GPU")
    if t0.dtype not in dtypes or any(t.dtype != t0.dtype for t in tensors):
        raise ValueError(f"{what} takes {dtypes}, got "
                         f"{[t.dtype for t in tensors]}")
    if t0.dim() != dim or any(t.shape != t0.shape for t in tensors):
        raise ValueError(f"{what}: one {dim}-dim shape expected, got "
                         f"{[tuple(t.shape) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what} takes contiguous tensors")


_FLOAT = (torch.bfloat16, torch.float32)
_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}


def _attention_nt_cuda(q, k, v, sm_scale: float, valid_kv: int | None):
    global nt_launches
    check_no_grad("attention_nt (B9)", q, k, v)
    _check_same("attention_nt", (q, k, v), _FLOAT, 3)
    bh, s, d = q.shape
    valid = s if valid_kv is None else int(valid_kv)
    if d > 256 or not 1 <= valid <= s:
        raise ValueError(f"attention_nt: head dim {d} (<= 256) and valid_kv "
                         f"{valid} (1..{s})")
    if q.dtype == torch.bfloat16:     # as B1's [B, S, H, D] with H = 1
        q, k, v = (t[:, :, 0] for t in _staged(*(t[:, :, None]
                                                   for t in (q, k, v))))
    d_map = q.shape[2]
    entry = f"sdt_attention_nt_{_SUFFIX[q.dtype]}"
    out = torch.empty_like(q)
    err = getattr(_build.library("attention_nt"), entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, s,
        d_map, valid, float(sm_scale), _build.stream_ptr(q.device))
    _build.check(err, entry)
    nt_launches += 1
    return out if d_map == d else out[..., :d].contiguous()


def attention_nt(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 sm_scale: float, valid_kv: int | None = None
                 ) -> torch.Tensor:
    """Head-major attention over contiguous [BH, S, D] q/k/v, keys at or
    past ``valid_kv`` masked (B9, ``csrc/attention_nt.cu``)."""
    if _build.takes_plain(q):
        return attention_nt_ref(q, k, v, sm_scale, valid_kv)
    return _attention_nt_cuda(q, k, v, sm_scale, valid_kv)


def _attention_bshd_cuda(q, k, v, sm_scale: float):
    global bshd_launches
    check_no_grad("attention_bshd (B10)", q, k, v)
    _check_same("attention_bshd", (q, k, v), _FLOAT, 4)
    b, s, h, d = q.shape
    if s % BLOCK or d > 256:
        raise ValueError(f"attention_bshd takes S % {BLOCK} == 0 and D <= "
                         f"256, got S={s}, D={d}")
    if q.dtype == torch.bfloat16:
        q, k, v = _staged(q, k, v)
    d_map = q.shape[3]
    entry = f"sdt_attention_bshd_{_SUFFIX[q.dtype]}"
    out = torch.empty_like(q)           # the kernel's [B, S, H*D] rows
    err = getattr(_build.library("attention_bshd"), entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, h,
        d_map, float(sm_scale), _build.stream_ptr(q.device))
    _build.check(err, entry)
    bshd_launches += 1
    return out if d_map == d else out[..., :d].contiguous()


def attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   sm_scale: float) -> torch.Tensor:
    """Natural-layout attention over contiguous [B, S, H, D] q/k/v with S %
    512 == 0; returns [B, S, H, D] (B10, ``csrc/attention_bshd.cu``)."""
    if _build.takes_plain(q):
        return attention_bshd_ref(q, k, v, sm_scale)
    return _attention_bshd_cuda(q, k, v, sm_scale)


def _repack_cuda(entry: str, x, out, b, s, h, d) -> None:
    if x.element_size() not in (2, 4):
        raise ValueError(f"{entry} moves 2- or 4-byte elements, got "
                         f"{x.dtype}")
    err = getattr(_build.library("repack_heads"), entry)(
        x.data_ptr(), out.data_ptr(), b, s, h, d, x.element_size(),
        _build.stream_ptr(x.device))
    _build.check(err, entry)


def repack_to_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """[B, S, H*D] -> [B, H, S, D], a copy in x's dtype (B11,
    ``csrc/repack_heads.cu``)."""
    global to_heads_launches
    if _build.takes_plain(x):
        return repack_to_heads_ref(x, n_heads)
    check_no_grad("repack_to_heads (B11)", x)
    _check_same("repack_to_heads", (x,), (x.dtype,), 3)
    b, s, hd = x.shape
    if hd % n_heads:
        raise ValueError(f"repack_to_heads: {hd} columns in {n_heads} heads")
    d = hd // n_heads
    out = torch.empty((b, n_heads, s, d), dtype=x.dtype, device=x.device)
    _repack_cuda("sdt_repack_to_heads", x, out, b, s, n_heads, d)
    to_heads_launches += 1
    return out


def repack_from_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, H, S, D] -> [B, S, H*D], a copy in x's dtype (B12,
    ``csrc/repack_heads.cu``)."""
    global from_heads_launches
    if _build.takes_plain(x):
        return repack_from_heads_ref(x)
    check_no_grad("repack_from_heads (B12)", x)
    _check_same("repack_from_heads", (x,), (x.dtype,), 4)
    b, h, s, d = x.shape
    out = torch.empty((b, s, h * d), dtype=x.dtype, device=x.device)
    _repack_cuda("sdt_repack_from_heads", x, out, b, s, h, d)
    from_heads_launches += 1
    return out


def _self_attention_nt(q, k, v, sm_scale: float, dtype) -> torch.Tensor:
    """The nt layout of ``self_attention``: zero-pad S to the 512 grid,
    split the heads (B11 with ``SDT_ATTN_REPACK=1``, else transposes), B9
    with the padded keys masked, merge the heads, drop the padded rows."""
    b, s, h, d = q.shape
    s_pad = -(-s // BLOCK) * BLOCK
    valid = s if s_pad != s else None
    if s_pad != s:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, s_pad - s)) for t in (q, k, v))
    if os.environ.get("SDT_ATTN_REPACK") == "1":
        # the JAX package repacks before the cast
        qf, kf, vf = (repack_to_heads(t.reshape(b, s_pad, h * d)
                                      .contiguous(), h)
                      .reshape(b * h, s_pad, d).to(dtype) for t in (q, k, v))
        out = attention_nt(qf, kf, vf, sm_scale, valid)
        out = repack_from_heads(out.reshape(b, h, s_pad, d))
        return out[:, :s].reshape(b, s, h, d)
    qf, kf, vf = (t.permute(0, 2, 1, 3).contiguous().reshape(b * h, s_pad, d)
                  .to(dtype) for t in (q, k, v))
    out = attention_nt(qf, kf, vf, sm_scale, valid)
    return out.reshape(b, h, s_pad, d).permute(0, 2, 1, 3)[:, :s]


def self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   sm_scale: float) -> torch.Tensor:
    """Unmasked self-attention over [B, S, H, D]; returns [B, S, H, D] in
    v's dtype, computed in bf16 if v is bf16, else in f32. The JAX
    package's branches, in its order:

    1. a wide head (D > 256, S % 512 == 0): the q-chunked plain path;
    2. ``SDT_FLASH2_LAYOUT=bshd`` and S % 512 == 0: B10;
    3. ``SDT_FLASH2_LAYOUT=nt``: B9 on head-major copies (B11/B12 for the
       head split with ``SDT_ATTN_REPACK=1``), never int8;
    4. otherwise (bhsd): B8 for bf16 with ``SDT_INT8_ATTN=1``, else B1;
       under autograd B1 through ``SelfAttention`` (bf16 on CUDA).

    Each kernel's wrapper launches it for CUDA tensors and takes its plain
    version for CPU tensors; a kernel without a backward raises under
    autograd."""
    b, s, h, d = q.shape
    out_dtype = v.dtype
    dtype = torch.bfloat16 if v.dtype == torch.bfloat16 else torch.float32
    layout = os.environ.get("SDT_FLASH2_LAYOUT", "bhsd")
    if d > 256 and s % BLOCK == 0:
        q, k, v = (t.to(dtype) for t in (q, k, v))
        return chunked_attention(q, k, v, sm_scale).to(out_dtype)
    if layout == "bshd" and s % BLOCK == 0:
        q, k, v = (t.to(dtype).contiguous() for t in (q, k, v))
        return attention_bshd(q, k, v, sm_scale).to(out_dtype)
    quant = (os.environ.get("SDT_INT8_ATTN") == "1" and layout != "nt"
             and dtype == torch.bfloat16)
    if layout == "nt":
        return _self_attention_nt(q, k, v, sm_scale, dtype).to(out_dtype)
    q, k, v = (t.to(dtype) for t in (q, k, v))
    if (not quant and needs_grad(q, k, v)
            and (_build.takes_plain(q) or dtype == torch.bfloat16)):
        out = SelfAttention.apply(q, k, v, sm_scale)
    elif _build.takes_plain(q):
        out = (attention_i8_ref if quant else attention_ref)(q, k, v,
                                                             sm_scale)
    else:
        out = (_self_attention_i8_cuda if quant else _self_attention_cuda)(
            q, k, v, sm_scale)
    return out.to(out_dtype)


def flops(b: int, s: int, h: int, d: int) -> int:
    """Operations of one call: two [S,S,D] products per head (for the
    int8-QK^T form, half of them int8)."""
    return 4 * b * h * s * s * d


def bwd_flops(b: int, s: int, h: int, d: int) -> int:
    """The backward's necessary operations: five [S,S,D] products per head
    (Q K^T again, dO V^T, P^T dO, dS K, dS^T Q)."""
    return 10 * b * h * s * s * d
