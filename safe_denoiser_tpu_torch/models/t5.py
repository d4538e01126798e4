"""T5 encoder stack, SD3's third text tower (T5-XXL), with HF transformers
``T5EncoderModel`` parameter names.

Counterpart of ``safe_denoiser_tpu/models/t5.py``: relative-position-bias
attention without q scaling, RMSNorm pre-norm, gated-GELU (tanh) feed
forward. The attention carries a position bias, so it runs the plain
PyTorch form (the JAX package computes it outside Pallas too): f32 logits
plus bias, f32 softmax, probabilities in the compute dtype.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 4096
    d_kv: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    num_heads: int = 64
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6


T5_XXL = T5Config()


def relative_position_bucket(relative_position: np.ndarray, num_buckets: int,
                             max_distance: int) -> np.ndarray:
    """Bidirectional bucketing (HF T5 semantics)."""
    num_buckets //= 2
    ret = (relative_position > 0).astype(np.int64) * num_buckets
    n = np.abs(relative_position)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_large = max_exact + (
        np.log(np.maximum(n, 1) / max_exact) / np.log(max_distance / max_exact)
        * (num_buckets - max_exact)).astype(np.int64)
    val_large = np.minimum(val_large, num_buckets - 1)
    return ret + np.where(is_small, n, val_large)


class RMSNormFp32(nn.Module):
    """x * rsqrt(mean(x^2) + eps) * weight in f32, cast back to x's dtype."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        xf = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + self.eps)
        return (xf * self.weight.float()).to(x.dtype)


class T5SelfAttention(nn.Module):
    def __init__(self, cfg: T5Config, has_bias: bool):
        super().__init__()
        inner = cfg.num_heads * cfg.d_kv
        self.cfg = cfg
        self.q = nn.Linear(cfg.d_model, inner, bias=False)
        self.k = nn.Linear(cfg.d_model, inner, bias=False)
        self.v = nn.Linear(cfg.d_model, inner, bias=False)
        self.o = nn.Linear(inner, cfg.d_model, bias=False)
        if has_bias:
            self.relative_attention_bias = nn.Embedding(
                cfg.relative_attention_num_buckets, cfg.num_heads)

    def forward(self, x: torch.Tensor, position_bias: torch.Tensor
                ) -> torch.Tensor:
        b, s, _ = x.shape
        shape = (b, s, self.cfg.num_heads, self.cfg.d_kv)
        q, k, v = (p(x).view(shape) for p in (self.q, self.k, self.v))
        # T5: no 1/sqrt(d) scaling
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        p = torch.softmax(logits + position_bias, dim=-1).to(v.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", p.float(), v.float())
        return self.o(out.to(v.dtype).reshape(b, s, -1))


class _LayerAttn(nn.Module):
    def __init__(self, cfg: T5Config, has_bias: bool):
        super().__init__()
        self.SelfAttention = T5SelfAttention(cfg, has_bias)
        self.layer_norm = RMSNormFp32(cfg.d_model, cfg.layer_norm_epsilon)


class _DenseGatedGelu(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.wi_0 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wi_1 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wo = nn.Linear(cfg.d_ff, cfg.d_model, bias=False)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return self.wo(F.gelu(self.wi_0(h), approximate="tanh")
                       * self.wi_1(h))


class _LayerFF(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.DenseReluDense = _DenseGatedGelu(cfg)
        self.layer_norm = RMSNormFp32(cfg.d_model, cfg.layer_norm_epsilon)


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config, has_bias: bool):
        super().__init__()
        self.layer = nn.ModuleList([_LayerAttn(cfg, has_bias),
                                    _LayerFF(cfg)])

    def forward(self, x: torch.Tensor, position_bias: torch.Tensor
                ) -> torch.Tensor:
        attn, ff = self.layer
        x = x + attn.SelfAttention(attn.layer_norm(x), position_bias)
        return x + ff.DenseReluDense(ff.layer_norm(x))


class _Stack(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.block = nn.ModuleList([T5Block(cfg, has_bias=(i == 0))
                                    for i in range(cfg.num_layers)])
        self.final_layer_norm = RMSNormFp32(cfg.d_model,
                                            cfg.layer_norm_epsilon)


class T5Encoder(nn.Module):
    """forward(input_ids [B, S]) -> last hidden state [B, S, d_model] in the
    parameters' dtype. The layer-0 relative-position table serves every
    layer, as in HF."""

    def __init__(self, config: T5Config = T5_XXL):
        super().__init__()
        self.config = config
        self.shared = nn.Embedding(config.vocab_size, config.d_model)
        self.encoder = _Stack(config)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        s = input_ids.shape[1]
        x = self.shared(input_ids)
        pos = np.arange(s, dtype=np.int64)
        buckets = torch.from_numpy(relative_position_bucket(
            pos[None, :] - pos[:, None], cfg.relative_attention_num_buckets,
            cfg.relative_attention_max_distance)).to(input_ids.device)
        table = self.encoder.block[0].layer[0].SelfAttention \
            .relative_attention_bias.weight
        bias = table.float()[buckets].permute(2, 0, 1)[None]   # [1, H, S, S]
        for blk in self.encoder.block:
            x = blk(x, bias)
        return self.encoder.final_layer_norm(x)
