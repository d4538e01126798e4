"""Unmasked self-attention: the CUDA kernels (``csrc/attention.cu``, and
``csrc/attention_i8.cu`` for the int8-QK^T option) and their plain PyTorch
versions.

Counterpart of ``safe_denoiser_tpu/ops/attention.py``. The public layout is
the JAX package's ``[B, S, H, D]``. A CPU tensor takes the plain version; a
CUDA tensor launches the kernel or raises. ``SDT_INT8_ATTN=1`` runs bf16
attention with QK^T in int8 (the JAX package's ``quant_i8``); f32 always
keeps the bf16/f32 kernel. The TPU's layout variants (nt, bshd, the repack
kernels) are not ported yet.
"""

from __future__ import annotations

import math
import os

import torch

from . import _build

launches = 0      # kernel launches of the bf16/f32 kernel on CUDA tensors
i8_launches = 0   # kernel launches of the int8-QK^T kernel
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
    dtype for the product with v [B, S, H, D]; output in v's dtype."""
    p = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", p.float(), v.float())
    return out.to(v.dtype)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  sm_scale: float, mask: torch.Tensor | None = None
                  ) -> torch.Tensor:
    """Plain version: f32 logits and softmax, probabilities cast to v's
    dtype for the second product, output in v's dtype. q/k/v [B, S, H, D];
    ``mask`` broadcasts against [B, H, Sq, Skv] (True keeps)."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float() * sm_scale, k.float())
    if mask is not None:
        logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
    return _softmax_pv(logits, v)


def quantize_rows_i8(x: torch.Tensor):
    """Symmetric int8 over the last dim, as the TPU kernel's ``_i8``:
    r = 127 / max(amax, 1e-20), round half to even, clip to +-127. Returns
    (the int8 values as f32, amax [..., 1] f32)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    r = 127.0 / torch.clamp(amax, min=1e-20)
    return torch.clamp(torch.round(xf * r), -127.0, 127.0), amax


def attention_i8_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     sm_scale: float) -> torch.Tensor:
    """Plain version of the int8-QK^T attention: q quantized per query row
    and k per key token (over D), exact integer logits (f32 sums of
    products of integers up to 127^2 stay exact below 2^24, i.e. for
    D <= 1040), dequantized with (amax_q / 127) * (amax_k / 127) * sm_scale,
    then ``attention_ref``'s softmax and P V."""
    qi, q_amax = quantize_rows_i8(q)                  # [B, S, H, D], [.., 1]
    ki, k_amax = quantize_rows_i8(k)
    s32 = torch.einsum("bqhd,bkhd->bhqk", qi, ki)
    q_deq = (q_amax * (sm_scale / 127.0)).permute(0, 2, 1, 3)  # [B,H,Sq,1]
    k_deq = (k_amax * (1.0 / 127.0)).permute(0, 2, 3, 1)       # [B,H,1,Sk]
    return _softmax_pv(s32 * q_deq * k_deq, v)


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


def _self_attention_cuda(q, k, v, sm_scale: float) -> torch.Tensor:
    global launches
    _check_qkv(q, k, v, tuple(_ENTRY))
    b, s, h, d = q.shape
    fn = getattr(_build.library("attention"), _ENTRY[q.dtype])
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             b, s, h, d, q.stride(0), q.stride(1), q.stride(2),
             float(sm_scale), _build.stream_ptr(q.device))
    _build.check(err, _ENTRY[q.dtype])
    launches += 1
    return out


def _self_attention_i8_cuda(q, k, v, sm_scale: float) -> torch.Tensor:
    global i8_launches
    _check_qkv(q, k, v, (torch.bfloat16,))
    b, s, h, d = q.shape
    fn = _build.library("attention_i8").sdt_self_attention_i8_bf16
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    # the TPU kernel's dequant constants: c / 127 with c = sm_scale*log2(e)
    # (taken to f32 from double, as JAX's weak-typed constant), and 1/127
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             b, s, h, d, q.stride(0), q.stride(1), q.stride(2),
             float(sm_scale * LOG2E / 127.0), float(1.0 / 127.0),
             _build.stream_ptr(q.device))
    _build.check(err, "sdt_self_attention_i8_bf16")
    i8_launches += 1
    return out


def self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   sm_scale: float) -> torch.Tensor:
    """Unmasked self-attention over [B, S, H, D]; returns [B, S, H, D] in
    v's dtype. A wide head (D > 256, S % 512 == 0) takes the q-chunked
    plain path on any device. Otherwise bf16 with ``SDT_INT8_ATTN=1``
    takes the int8-QK^T form, the rest the bf16/f32 kernel: a CUDA tensor
    launches the kernel, a CPU tensor takes the plain version."""
    b, s, h, d = q.shape
    if d > 256 and s % 512 == 0:
        return chunked_attention(q, k, v, sm_scale)
    # the JAX package's dispatch: int8-QK^T for bf16 only, f32 bypasses it
    quant = (os.environ.get("SDT_INT8_ATTN") == "1"
             and v.dtype == torch.bfloat16)
    if q.device.type == "cpu":
        return (attention_i8_ref if quant else attention_ref)(q, k, v,
                                                              sm_scale)
    return (_self_attention_i8_cuda if quant else _self_attention_cuda)(
        q, k, v, sm_scale)


def flops(b: int, s: int, h: int, d: int) -> int:
    """Operations of one call: two [S,S,D] products per head (for the
    int8-QK^T form, half of them int8)."""
    return 4 * b * h * s * s * d
