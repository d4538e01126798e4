"""T5 encoder (HF transformers ``T5EncoderModel``, SD3's third text tower),
plain PyTorch in float32: relative-position bias from the first block,
no query scaling, RMSNorm, gated tanh-GELU feed-forward.

Config keys are those of ``text_encoder_3/config.json``: ``vocab_size``,
``d_model``, ``d_kv``, ``d_ff``, ``num_layers``, ``num_heads``,
``relative_attention_num_buckets``, ``relative_attention_max_distance``,
``layer_norm_epsilon``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .layers import Params, attention, linear, rms_norm, spec_linear, \
    spec_norm


def param_spec(cfg: dict) -> list:
    d, inner, ff = cfg["d_model"], cfg["num_heads"] * cfg["d_kv"], cfg["d_ff"]
    out: list = [("shared.weight", (cfg["vocab_size"], d), "embedding", 0)]
    for i in range(cfg["num_layers"]):
        n = f"encoder.block.{i}.layer"
        for proj in ("q", "k", "v"):
            spec_linear(out, f"{n}.0.SelfAttention.{proj}", d, inner,
                        bias=False)
        spec_linear(out, f"{n}.0.SelfAttention.o", inner, d, bias=False)
        if i == 0:
            out.append((f"{n}.0.SelfAttention.relative_attention_bias.weight",
                        (cfg["relative_attention_num_buckets"],
                         cfg["num_heads"]), "embedding", 0))
        spec_norm(out, f"{n}.0.layer_norm", d, bias=False)
        spec_linear(out, f"{n}.1.DenseReluDense.wi_0", d, ff, bias=False)
        spec_linear(out, f"{n}.1.DenseReluDense.wi_1", d, ff, bias=False)
        spec_linear(out, f"{n}.1.DenseReluDense.wo", ff, d, bias=False)
        spec_norm(out, f"{n}.1.layer_norm", d, bias=False)
    spec_norm(out, "encoder.final_layer_norm", d, bias=False)
    return out


def _bucket(rel: torch.Tensor, num_buckets: int, max_distance: int):
    """HF T5's bidirectional relative-position buckets."""
    num_buckets //= 2
    ret = (rel > 0).long() * num_buckets
    n = rel.abs()
    max_exact = num_buckets // 2
    large = max_exact + (torch.log(n.float().clamp(min=1) / max_exact)
                         / math.log(max_distance / max_exact)
                         * (num_buckets - max_exact)).long()
    large = large.clamp(max=num_buckets - 1)
    return ret + torch.where(n < max_exact, n, large)


def forward(p: Params, cfg: dict, ids: torch.Tensor) -> torch.Tensor:
    """Last hidden state [B, S, d_model] of token ids [B, S]."""
    b, s = ids.shape
    heads, dk, eps = cfg["num_heads"], cfg["d_kv"], cfg["layer_norm_epsilon"]
    pos = torch.arange(s, device=ids.device)
    buckets = _bucket(pos[None, :] - pos[:, None],
                      cfg["relative_attention_num_buckets"],
                      cfg["relative_attention_max_distance"])
    table = p.raw("encoder.block.0.layer.0.SelfAttention."
                  "relative_attention_bias.weight")
    bias = table[buckets].permute(2, 0, 1)                 # [H, S, S]
    x = p.raw("shared.weight")[ids]
    for i in range(cfg["num_layers"]):
        n = f"encoder.block.{i}.layer"
        h = rms_norm(p, f"{n}.0.layer_norm", x, eps)
        q, k, v = (linear(p, f"{n}.0.SelfAttention.{proj}", h).view(
            b, s, heads, dk) for proj in ("q", "k", "v"))
        att = attention(q, k, v, 1.0, bias=bias, quant=p.quant)
        x = x + linear(p, f"{n}.0.SelfAttention.o", att.reshape(b, s, -1))
        h = rms_norm(p, f"{n}.1.layer_norm", x, eps)
        ff = f"{n}.1.DenseReluDense"
        x = x + linear(p, ff + ".wo",
                       F.gelu(linear(p, ff + ".wi_0", h), approximate="tanh")
                       * linear(p, ff + ".wi_1", h))
    return rms_norm(p, "encoder.final_layer_norm", x, eps)
