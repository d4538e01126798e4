"""Shared building blocks, with diffusers parameter names.

Counterpart of ``safe_denoiser_tpu/models/layers.py``. Modules take NCHW
(or [B, S, C] token) tensors and compute in the dtype of their parameters;
normalization statistics and softmax stay f32. Under bf16 the JAX package's
fast forms are kept, behind its switches read at each call: GroupNorm and
LayerNorm affine and SiLU at bf16 (SDT_FAST_SILU, default 1), tanh GELU
(SDT_FAST_GELU, default 1).
"""

from __future__ import annotations

import math
import os

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import attention as attn_ops
from ..ops.group_norm import fast_act_ok, gn_affine_coefs, group_norm
from ..ops.quant import int8_dense

_FLASH_MIN_SEQ = 512


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       max_period: float = 10000.0,
                       flip_sin_to_cos: bool = True,
                       downscale_freq_shift: float = 0.0,
                       scale: float = 1.0) -> torch.Tensor:
    """Sinusoidal timestep embedding (diffusers get_timestep_embedding)."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device)
    exponent = exponent / (half - downscale_freq_shift)
    emb = torch.exp(exponent)[None, :] * timesteps.float()[:, None]
    emb = scale * emb
    sin, cos = torch.sin(emb), torch.cos(emb)
    emb = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class GroupNorm32(nn.Module):
    """GroupNorm with f32 statistics and an optional fused SiLU, over NCHW.
    The work happens on the [B, H*W, C] view (free when the tensor is
    channels_last) through ``ops.group_norm.group_norm``: the fused kernel
    under SDT_FUSED_GN=1 for the shapes its gate admits, else the plain
    form, where bf16 activations large enough take the one-read statistics
    kernel."""

    def __init__(self, num_channels: int, num_groups: int = 32,
                 eps: float = 1e-6, act: str | None = None):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.act = act
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor, coefs_only: bool = False):
        """GroupNorm(x) (+ SiLU); with ``coefs_only`` the f32 per-(batch,
        channel) affine (a_c, b_c) [B, C] with GN(x) == x*a_c + b_c, which
        the fused conv (ops.conv3x3) applies in its prologue instead."""
        b, c, h, w = x.shape
        xs = x.permute(0, 2, 3, 1).reshape(b, h * w, c)
        if coefs_only:
            return gn_affine_coefs(xs.contiguous(), self.weight, self.bias,
                                   self.num_groups, self.eps)
        y = group_norm(xs.contiguous(), self.weight, self.bias,
                       self.num_groups, self.eps, self.act)
        return y.reshape(b, h, w, c).permute(0, 3, 1, 2)


class LayerNormFp32(nn.Module):
    """LayerNorm with f32 statistics; where ``fast_act_ok`` holds (bf16,
    SDT_FAST_SILU=1) the affine is applied at bf16, as in the JAX
    package."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = ((xf - mean) ** 2).mean(-1, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        if fast_act_ok(x.dtype):
            return y.to(x.dtype) * self.weight.to(x.dtype) \
                + self.bias.to(x.dtype)
        return (y * self.weight.float() + self.bias.float()).to(x.dtype)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask: torch.Tensor | None = None) -> torch.Tensor:
    """[B, S, H, D] attention with f32 softmax. Unmasked self-attention of
    the shapes ``ops.attention.supports`` takes goes to ``self_attention``
    (the kernel for CUDA tensors, the plain version on the CPU); the rest
    -- cross-attention, masked attention, short sequences -- runs the plain
    einsum form, as in the JAX package."""
    depth = q.shape[-1]
    s_q, s_kv = q.shape[1], k.shape[1]
    if mask is None and attn_ops.supports(s_q, s_kv, depth):
        return attn_ops.self_attention(q, k, v, float(depth) ** -0.5)
    return attn_ops.attention_ref(q, k, v, float(depth) ** -0.5, mask)


class QDense(nn.Linear):
    """``nn.Linear`` (same parameters, bit-identical on float weights) that
    runs W8A8 int8 once ``set_int8`` has replaced its weight by an int8 one
    with per-output-row scales (``ops.quant``). Counterpart of the JAX
    package's ``QDense``. The scales are f32 and never stored; quantize
    after the module's dtype is set, since ``.to(dtype)`` would cast them
    too."""

    def set_int8(self, wq: torch.Tensor, sw: torch.Tensor) -> None:
        if wq.dtype != torch.int8 or tuple(wq.shape) != tuple(
                self.weight.shape):
            raise ValueError(f"int8 weight of shape {tuple(self.weight.shape)}"
                             f" expected, got {wq.dtype} {tuple(wq.shape)}")
        dev = self.weight.device
        self.weight = nn.Parameter(wq.to(dev), requires_grad=False)
        self.register_buffer("weight_scale", sw.float().to(dev),
                             persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.weight.dtype != torch.int8:
            return super().forward(x)
        sw = getattr(self, "weight_scale", None)
        if sw is None or sw.dtype != torch.float32:
            raise ValueError("int8 weight without its f32 scales: load them "
                             "with ops.quant.load_quantized")
        return int8_dense(x, self.weight, sw, self.bias, x.dtype)


class Attention(nn.Module):
    """Multi-head attention over [B, S, C] with optional cross-attention
    context; diffusers names (to_q, to_k, to_v, to_out.0)."""

    def __init__(self, query_dim: int, num_heads: int, head_dim: int,
                 context_dim: int | None = None, qkv_bias: bool = False,
                 out_bias: bool = True):
        super().__init__()
        inner = num_heads * head_dim
        context_dim = context_dim or query_dim
        self.num_heads = num_heads
        self.head_dim = head_dim
        self.to_q = QDense(query_dim, inner, bias=qkv_bias)
        self.to_k = QDense(context_dim, inner, bias=qkv_bias)
        self.to_v = QDense(context_dim, inner, bias=qkv_bias)
        self.to_out = nn.ModuleList([QDense(inner, query_dim, bias=out_bias),
                                     nn.Dropout(0.0)])

    def forward(self, x: torch.Tensor, context: torch.Tensor | None = None,
                mask: torch.Tensor | None = None) -> torch.Tensor:
        context = x if context is None else context
        b, s, _ = x.shape
        q = self.to_q(x).view(b, s, self.num_heads, self.head_dim)
        k = self.to_k(context).view(b, context.shape[1], self.num_heads,
                                    self.head_dim)
        v = self.to_v(context).view(b, context.shape[1], self.num_heads,
                                    self.head_dim)
        out = dot_product_attention(q, k, v, mask=mask)
        return self.to_out[0](out.reshape(b, s, -1))


def gelu_for(dtype: torch.dtype):
    """Exact-erf GELU under f32; the tanh form under bf16 unless
    SDT_FAST_GELU is set to another value than "1" (the two are within bf16
    quantization of each other), as the JAX package's ``_gelu_for``."""
    if (dtype == torch.bfloat16
            and os.environ.get("SDT_FAST_GELU", "1") == "1"):
        return lambda x: F.gelu(x, approximate="tanh")
    return F.gelu


class GEGLU(nn.Module):
    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = QDense(dim_in, dim_out * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * gelu_for(x.dtype)(gate)


class FeedForward(nn.Module):
    """GEGLU feed-forward; diffusers names ff.net.0.proj / ff.net.2."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * mult), nn.Dropout(0.0),
                                  QDense(dim * mult, dim)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net[2](self.net[0](x))
